"""The host time of one CoreSLAM search (us): the median duration of the
program's ``slamnet.coreslam.search`` spans in the traced stretch, one a
searched scan: the candidates' draw, their scores against the hole map and
the first minimum (``ops/score.py``).  None where the program records no
such span; moves ``scans_per_s``."""
import statistics

SPAN = "slamnet.coreslam.search"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
