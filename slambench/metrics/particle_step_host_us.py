"""The host time of one particle-layer scan (us): the median duration of
the program's ``slamnet.particle.update`` spans in the traced stretch, one
a scan: ``particle.update`` enqueueing its draws, the population's score,
the refine, the resampling and the map update, none of the harness's loop
around it.  None where the program records no such span; moves
``scans_per_s``."""
import statistics

SPAN = "slamnet.particle.update"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
