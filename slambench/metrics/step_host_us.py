"""The host time of one robot's step (us): the median duration of the
program's ``slamnet.hector.update`` spans in the traced stretch, one a
scan.  A span covers ``hector.update`` enqueueing its match, guards and map
update, and none of the harness's loop around it.  The spans are host
events of the same profiler session as the card's operations, on the same
clock.  None where the program records no such span.  Read as
``step_host_us`` (moves ``scans_per_s``) and ``step_host_us.live`` (moves
``scans_in_time_pct``)."""
import statistics

SPAN = "slamnet.hector.update"


def read(ctx):
    d = [e - s for name, s, e in ctx["summary"]["host_ops"] if name == SPAN]
    return statistics.median(d) if d else None
