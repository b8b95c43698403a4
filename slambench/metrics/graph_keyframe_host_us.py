"""The host time of one keyframe event: the node, its edges and cloud, the
loop search, the optimize and the re-anchor (us): the median duration of
the program's ``slamnet.graph.keyframe`` spans in the traced stretch. None
where the program records no such span; moves ``scans_per_s``."""
import statistics

SPAN = "slamnet.graph.keyframe"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
