"""The union of the card's operation time a live scan (us): the device
chain every live scan waits for before its pose can be read."""
from slambench import harness as H


def read(ctx):
    ops = ctx["summary"]["device_ops"]
    return H.busy_us(ops) / ctx["steps"] if ops and ctx["steps"] else None
