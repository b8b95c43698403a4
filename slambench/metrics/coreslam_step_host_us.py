"""The host time of one CoreSLAM scan (us): the median duration of the
program's ``slamnet.coreslam.update`` spans in the traced stretch, one a
scan: ``coreslam.update`` enqueueing its de-skew, its search and its map
update, none of the harness's loop around it.  None where the program
records no such span; moves ``scans_per_s``."""
import statistics

SPAN = "slamnet.coreslam.update"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
