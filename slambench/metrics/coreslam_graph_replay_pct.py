"""The share (%) of CoreSLAM's scans replayed as a CUDA graph: of the
program's ``slamnet.coreslam.update`` spans in the traced stretch, those
that hold a ``slamnet.coreslam.graph_replay`` span.  None where the program
records no update span, or where its ``coreslam.update`` keeps no count of
replays (a program without the step's graph); moves ``scans_per_s``."""
import bisect

STEP = "slamnet.coreslam.update"
REPLAY = "slamnet.coreslam.graph_replay"


def read(ctx):
    from slamnet_tpu_torch.models import coreslam
    if getattr(coreslam.update, "graph_replays", None) is None:
        return None
    ops = ctx["summary"]["host_ops"]
    steps = [(s, e) for name, s, e in ops if name == STEP]
    if not steps:
        return None
    starts = sorted(s for name, s, _ in ops if name == REPLAY)
    held = sum(1 for s, e in steps
               if (i := bisect.bisect_left(starts, s)) < len(starts)
               and starts[i] < e)
    return 100.0 * held / len(steps)
