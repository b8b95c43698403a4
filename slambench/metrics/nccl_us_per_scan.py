"""Rank 0's NCCL kernel time a scan (us): the collectives' kernels in the
trace, which include the time a card waits inside them for the other
ranks."""


def read(ctx):
    t = sum(e - s for name, s, e in ctx["summary"]["device_ops"]
            if "nccl" in name.lower())
    return t / ctx["steps"] if t and ctx["steps"] else None
