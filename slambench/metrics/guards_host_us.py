"""The host time of one robot's guards a step (us): the median duration of
the program's ``slamnet.hector.guards`` spans in the traced stretch, the
phase of ``hector.update`` between the match and the map update (the
in-map and jump guards where the configuration sets them, the force select
and the motion gate).  None where the program records no such span; moves
``scans_per_s``."""
import statistics

SPAN = "slamnet.hector.guards"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
