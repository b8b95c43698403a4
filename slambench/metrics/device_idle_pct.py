"""The share of the traced window (host clock from the traced stretch's
start to the card's end) in which no operation ran on the card."""
from slambench import harness as H


def read(ctx):
    ops = ctx["summary"]["device_ops"]
    window_us = ctx["summary"]["window_s"] * 1e6
    if not ops or window_us <= 0:
        return None
    return 100.0 * (1.0 - H.busy_us(ops) / window_us)
