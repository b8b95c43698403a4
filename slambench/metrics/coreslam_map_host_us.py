"""The host time of one CoreSLAM map update (us): the median duration of
the program's ``slamnet.coreslam.map_update`` spans in the traced stretch,
one a scan: the hole map's ray walk and blend (``ops/holemap.py``) and the
obstacle map's hits and decay (``ops/obstacle.py``).  None where the
program records no such span; moves ``scans_per_s``."""
import statistics

SPAN = "slamnet.coreslam.map_update"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
