"""The host time of one searched keyframe event's frontend:
``frontend.match_scans`` (the old scan's local grid, K4, and the new scan's
match on it, K3, at 128 px) and the acceptance read (us): the median
duration of the program's ``slamnet.graph.loop_match`` spans in the traced
stretch. None where the program records no such span; moves
``scans_per_s``."""
import statistics

SPAN = "slamnet.graph.loop_match"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
