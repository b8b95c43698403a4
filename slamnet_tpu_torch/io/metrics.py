"""Observability: per-scan metrics, EMA timings, divergence monitor, device
trace.

Port of ``slamnet_tpu/io/metrics.py``, the reference's instrumentation
rebuilt as host-side components (SURVEY.md §5.1/§5.3/§5.5):

- ``EmaTimer``          — the 4-tap EMA ``t = (3t + dt)/4`` of MatchTiming /
  UpdateTiming (HectorSLAMProcessor.cs:92-96, 111-115)
- ``DivergenceMonitor`` — the simulator's first-divergence oracle: flags the
  first scan where estimate-vs-truth error exceeds 1 m / 10 deg and dumps the
  recent log ring (MainWindow.xaml.cs:182-196)
- ``ScanMetrics``       — structured per-scan record (score, timings, gating)
- ``RingLog``           — BufferedLogger with the scan loop's ring trimming
  (Simulation/BufferedLogger.cs; MainWindow.xaml.cs:199-202)
- ``device_trace``      — ``torch.profiler`` over the host and the card,
  written as a Chrome trace (JAX's is ``jax.profiler.trace``)
- ``span``              — one named range of host time, recorded only while
  a profiler session runs

The program's spans, each a ``cpu_op`` on the profiler's host timeline:
``slamnet.hector.update`` (one ``hector.update`` call, one scan of one
robot) and inside it, where the step runs eagerly, in order,
``slamnet.hector.match`` (the K1/K3 match and its stats),
``slamnet.hector.guards`` (the in-map and jump guards, the force select and
the motion gate) and ``slamnet.hector.map_update`` (K2/K4 and the
last-update pose); where the step is replayed as a CUDA graph
(``models/hector.StepGraphs``), one ``slamnet.hector.graph_replay`` (the
input copies, the graph's launch and the copy of its results) and no
phase.  The step that captures a graph holds the phases twice: its eager
run's, then the capture's.  ``slamnet.coreslam.update`` is one CoreSLAM
scan (one ``coreslam.update`` or ``coreslam.update_cloud`` call), holding,
where the step runs eagerly, in order ``slamnet.coreslam.search`` (the
Monte-Carlo or correlative search, on a searched scan only) and
``slamnet.coreslam.map_update`` (the hole and obstacle maps' update), and
where it is replayed as a CUDA graph (``models/coreslam.StepGraphs``) one
``slamnet.coreslam.graph_replay`` (the input copies, the generator's
hand-over, the graph's launch and the clones of its results).
``slamnet.graph.update`` is one graph-SLAM scan (one ``graph_slam.update``
call, never nested in another),
holding ``slamnet.hector.update`` and, on a keyframe scan,
``slamnet.graph.keyframe``, which holds in order ``slamnet.graph.loop_match``
(the frontend's match and its acceptance read, on a searched event only)
and ``slamnet.graph.optimize`` (the pose graph's GN steps); the host
counters beside them are ``graph_slam.update``'s ``syncs``, ``searches``,
``keyframes``, ``closures``, ``solves`` and ``solve_unknowns``.  They are
recorded with
``torch._C._profiler._RecordFunctionFast``, not ``record_function``: a
``record_function`` range is a user annotation, which the profiler mirrors
onto the card's timeline as a ``gpu_user_annotation`` event that a reader
of the device trace would count as a device operation.

All but ``device_trace`` and ``span`` are plain Python, copied as they are.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# a cpu_op range that is no user annotation; None in a torch without it,
# and then every span stays off
_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast",
                              None)


class _NoSpan:
    """The span while no profiler records: enters and exits, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """Context manager: the host time of a phase as a ``cpu_op`` range named
    ``slamnet.<name>`` while a ``torch.profiler`` session records (the
    benchmark's traced stretch, ``device_trace``).  Otherwise it costs one
    read of the profiler's flag and returns the shared ``NO_SPAN``: no
    allocation, no dispatcher call, no clock read.  A span holds no tensor
    and reads nothing from the card.  Names must not contain the kernel
    names the trace's readers select by (``match_kernel``, ``nccl``, ...)."""
    if not _autograd_profiler._is_profiler_enabled or \
            _RecordFunctionFast is None:
        return NO_SPAN
    return _RecordFunctionFast("slamnet." + name)


def _cuda_probe_session() -> bool:
    """A throwaway profiler session over 100 tiny kernels, launched 10 ms
    into it; True when the session recorded any of them (see
    ``device_trace``: the session after a teardown records none, and a
    long-running CUPTI drops only a window's first few)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        time.sleep(0.01)
        x = torch.zeros(1, device="cuda")
        for _ in range(100):
            x.add_(1.0)
        torch.cuda.synchronize()
    return any(e.device_type == DeviceType.CUDA for e in p.events())


class device_trace:
    """Context manager: ``torch.profiler.profile`` over the CPU and (when
    there is one) the CUDA device; on exit the trace is written to
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto), and ``path`` names it.  The profiler object is ``prof`` for
    ``key_averages()`` and the like.

    On the card the traced session runs on a freshly started CUPTI (the
    tracer under ``torch.profiler``).  Two faults drop kernel records from
    a short window while every CUDA runtime launch record is kept, as
    measured on an H100 (PERF.md): the session that follows a CUPTI
    teardown records no kernel, and when CUPTI has run long without a
    restart, the first kernels of a window fall outside it (7 of a scan's
    28 after 90 s idle).  So ``__enter__`` asks for a teardown at the end
    of each session (``TEARDOWN_CUPTI=1``), runs throwaway sessions of
    tiny kernels until one records nothing (the restart: the next session
    is a fresh one), and then starts the traced session with the device
    idle; ``__exit__`` restores the variable and runs one more throwaway
    session, so that a later profiler in the process does not start on
    the torn-down CUPTI.

    The trace holds the program's spans (``span``) on the host's rows:
    each ``slamnet.hector.update`` with its ``slamnet.hector.match``,
    ``slamnet.hector.guards`` and ``slamnet.hector.map_update``, or its
    ``slamnet.hector.graph_replay``, each ``slamnet.coreslam.update``
    with its ``.search`` and ``.map_update``, or its ``.graph_replay``,
    and each
    ``slamnet.graph.update`` with its ``.keyframe``, ``.loop_match`` and
    ``.optimize``, beside the kernels each
    launched.  The kernels of a replayed graph are recorded one by one,
    whether the graph was captured before the session or inside it (an
    H100, CUDA 12.8).

    Usage: ``with device_trace('/tmp/trace') as t: run_replay()``.
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "trace.json")
        self.prof = None
        self._teardown = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
            self._teardown = os.environ.get("TEARDOWN_CUPTI")
            os.environ["TEARDOWN_CUPTI"] = "1"
            for _ in range(2):        # the sessions alternate: <= 2 tries
                if not _cuda_probe_session():
                    break
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if cuda:
            if self._teardown is None:
                os.environ.pop("TEARDOWN_CUPTI", None)
            else:
                os.environ["TEARDOWN_CUPTI"] = self._teardown
            _cuda_probe_session()
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        return False


class EmaTimer:
    """4-tap EMA in milliseconds; ``update`` takes seconds."""

    def __init__(self):
        self.ms = 0.0

    def update(self, seconds: float) -> float:
        self.ms = (3.0 * self.ms + seconds * 1000.0) / 4.0
        return self.ms

    def time(self):
        return _TimerCtx(self)


class _TimerCtx:
    def __init__(self, ema: EmaTimer):
        self.ema = ema

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ema.update(time.perf_counter() - self.t0)
        return False


class RingLog:
    """Append-only log trimmed like the simulator's buffer: when over
    `high_water` entries, drop the oldest `drop` (MainWindow.xaml.cs:199-202)."""

    def __init__(self, high_water: int = 130, drop: int = 100):
        self.items: List[str] = []
        self.high_water = high_water
        self.drop = drop

    def log(self, msg: str, level: str = "Information"):
        self.items.append(f"{level}: {msg}")
        if len(self.items) > self.high_water:
            del self.items[: self.drop]

    def tail(self, n: int = 30) -> List[str]:
        return self.items[-n:]


@dataclass
class ScanMetrics:
    """Structured per-scan record (SURVEY.md §5.5 target schema)."""

    scan_index: int
    pose: tuple
    match_ms: float = 0.0
    update_ms: float = 0.0
    score: Optional[float] = None
    map_updated: bool = False
    gn_residual: Optional[float] = None


class DivergenceMonitor:
    """First-divergence oracle with log-dump, as real assertions.

    dist_limit / ang_limit default to the simulator's 1 m / 10 deg
    (MainWindow.xaml.cs:187).
    """

    def __init__(self, dist_limit: float = 1.0,
                 ang_limit_deg: float = 10.0, log: RingLog | None = None):
        self.dist_limit = dist_limit
        self.ang_limit = math.radians(ang_limit_deg)
        self.log = log
        self.diverged_at: Optional[int] = None
        self.report: List[str] = []

    def check(self, scan_index: int, estimate, truth) -> bool:
        """Returns True on the FIRST divergence (then latches)."""
        if self.diverged_at is not None:
            return False
        dx = float(estimate[0]) - float(truth[0])
        dy = float(estimate[1]) - float(truth[1])
        dth = (float(estimate[2]) - float(truth[2]) + math.pi) \
            % (2 * math.pi) - math.pi
        dist = math.hypot(dx, dy)
        if dist > self.dist_limit or abs(dth) > self.ang_limit:
            self.diverged_at = scan_index
            self.report = [
                f"divergence at scan {scan_index}: "
                f"dist {dist:.2f} m, ang {math.degrees(dth):.2f} deg",
            ]
            if self.log is not None:
                self.report += self.log.tail(30)
            return True
        return False
