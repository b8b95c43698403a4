"""The share (%) of one robot's steps replayed as a CUDA graph: of the
program's ``slamnet.hector.update`` spans in the traced stretch, those that
hold a ``slamnet.hector.graph_replay`` span.  None where the program records
no update span.  Read as ``graph_replay_pct`` (moves ``scans_per_s``) and
``graph_replay_pct.live`` (moves ``scans_in_time_pct``)."""
import bisect

STEP = "slamnet.hector.update"
REPLAY = "slamnet.hector.graph_replay"


def read(ctx):
    ops = ctx["summary"]["host_ops"]
    steps = [(s, e) for name, s, e in ops if name == STEP]
    if not steps:
        return None
    starts = sorted(s for name, s, _ in ops if name == REPLAY)
    held = sum(1 for s, e in steps
               if (i := bisect.bisect_left(starts, s)) < len(starts)
               and starts[i] < e)
    return 100.0 * held / len(steps)
