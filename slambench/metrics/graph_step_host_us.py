"""The host time of one graph-SLAM scan: ``graph_slam.update`` enqueueing
Hector's step, reading the keyframe gate and, on a keyframe scan, running
the keyframe event; none of the harness's loop around it (us): the median
duration of the program's ``slamnet.graph.update`` spans in the traced
stretch. None where the program records no such span; moves
``scans_per_s``."""
import statistics

SPAN = "slamnet.graph.update"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
