"""Kernels a step: the device kernels of the traced steps (memory copies
and sets left out) over the steps traced.  A step is one scan of one robot,
one batch-scan of a fleet, or one sharded scan on rank 0.  Reads the
trace; moves ``scans_per_s`` (each launch costs the host ~10 us)."""
from slambench import harness as H


def read(ctx):
    n = sum(1 for name, _, _ in ctx["summary"]["device_ops"]
            if H.is_kernel(name))
    return n / ctx["steps"] if n and ctx["steps"] else None
