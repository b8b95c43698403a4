"""The host time of one keyframe event's pose-graph GN steps
(``posegraph.optimize``: the normal equations and their dense solve) (us):
the median duration of the program's ``slamnet.graph.optimize`` spans in
the traced stretch. None where the program records no such span; moves
``scans_per_s``."""
import statistics

SPAN = "slamnet.graph.optimize"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
