"""What every kind of traffic shares: the benchmark's files found by name,
the device's description, the trace of a stretch of steps and its
reduction, the comparison with the reference, and the result's line.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]      # the checkout
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "slamnet_tpu")
MAP_CELL_TOL = 0.1   # log-odds: a changed mark moves a cell by >= 0.405
TRACE_ATTEMPTS = 3   # traced stretches a run tries before it gives up


# --------------------------------------------------------------- the files
def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> tuple:
    """(the workload entry, its configuration, its traffic), by name."""
    bench = benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return (w, load_json(ROOT / conf["file"]),
            load_json(HERE / "traffic" / f"{w['traffic']}.json"))


def metrics_of(cell_name: str, group: str) -> list:
    """The ``group`` metrics ("end_to_end" or "per_layer") the cell reports:
    those that list it under ``workloads``, and those that list no cells
    (every cell, as ``setup_s``)."""
    return [m for m in benchmark()[group]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """The per-layer metric's reader: ``metrics/<name>.py``'s ``read``, or
    where there is no such file the reader of the name's part before its
    first dot (``kernels_per_step.live`` is read as ``kernels_per_step``;
    the split names a metric that moves another end-to-end metric)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def say(msg: str) -> None:
    print(f"[slambench] {msg}", file=sys.stderr, flush=True)


# -------------------------------------------------------------- the device
def require_cards(n: int) -> None:
    """Exit 2, printing no result, unless ``n`` CUDA cards are here."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        say(f"this cell needs {n} CUDA card(s); found {have}")
        sys.exit(2)


def device_info(device, count: int, peak_bytes: int) -> dict:
    """The result's ``device``: the card's name, the cards used and the
    fullest card's peak (a CPU run, as the tests make, says so)."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_pace(device, rounds: int = 5) -> dict:
    """The host's pace as the window closes, beside the run's numbers (a
    line on standard error and a key of the result): the medians over
    ``rounds`` of a fixed pure-Python loop (us) and of enqueuing one tiny
    kernel (us a launch, 500 a round).  A host-bound rate that moves with
    these from run to run moved with the host, not with the program."""
    py, launch = [], []
    x = torch.zeros(1, device=device)
    for _ in range(rounds):
        t = time.perf_counter()
        sum(i * i for i in range(20000))
        py.append((time.perf_counter() - t) * 1e6)
        sync(device)
        t = time.perf_counter()
        for _ in range(500):
            x.add_(1.0)
        launch.append((time.perf_counter() - t) * 1e6 / 500)
        sync(device)
    return {"python_loop_us": float(np.median(py)),
            "launch_us": float(np.median(launch))}


# --------------------------------------------------------------- the trace
def _probe_session() -> bool:
    """A throwaway profiler session over 100 tiny kernels, launched 10 ms
    into it: True when it recorded any of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        time.sleep(0.01)
        x = torch.zeros(1, device="cuda")
        for _ in range(100):
            x.add_(1.0)
        torch.cuda.synchronize()
    return any(e.device_type == DeviceType.CUDA for e in p.events())


def start_profiler() -> None:
    """Bring the profiler and CUPTI up once in set-up: their first start
    takes seconds, which must not fall inside the window."""
    _probe_session()


class Trace:
    """``torch.profiler`` over the host and the card for a stretch of steps,
    kept in memory (nothing is written).  As ``io/metrics.device_trace``
    does, the traced session runs on a freshly started CUPTI: a session
    after a CUPTI teardown records no kernel, and a long-running CUPTI
    drops a short window's first kernels, so throwaway sessions run until
    one records nothing, and the traced one starts with the card idle.
    ``window_s`` is the host clock from the start to the card's end;
    ``recorded`` says whether the card's operations reached the trace (a
    stretch that lost them is traced again by the caller)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.window_s = 0.0
        self.recorded = False
        self._summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._teardown = os.environ.get("TEARDOWN_CUPTI")
        os.environ["TEARDOWN_CUPTI"] = "1"
        for _ in range(2):
            if not _probe_session():
                break
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        if self._teardown is None:
            os.environ.pop("TEARDOWN_CUPTI", None)
        else:
            os.environ["TEARDOWN_CUPTI"] = self._teardown
        _probe_session()
        self._summary = self._read()
        self.recorded = bool(self._summary["device_ops"])
        return False

    def _read(self) -> dict:
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in self.prof.events():
            item = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if not e.name.startswith("nccl:"):
                    dev.append(item)
            else:
                host.append(item)
        return {"device_ops": dev, "host_ops": host,
                "window_s": self.window_s}

    def summary(self) -> dict:
        """The device operations and host operations of the stretch as
        (name, start_us, end_us) lists.  ProcessGroupNCCL's ``nccl:<op>``
        ranges on the card's timeline are annotations, not operations."""
        return self._summary


def no_trace() -> RuntimeError:
    return RuntimeError(f"the profiler recorded no operation of the card in "
                        f"{TRACE_ATTEMPTS} traced stretches")


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_us(ops) -> float:
    """The union of the operations' intervals (us)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((s, e) for _, s, e in ops):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def short(name: str, n: int = 90) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:n]


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the card with the host operation running in each."""
    by = {}
    for name, s, e in summary["device_ops"]:
        k = short(name)
        by[k] = by.get(k, 0.0) + (e - s) * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s, e, n) for n, s, e in summary["device_ops"])
    merged = []
    for s, e, n in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e, n])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][2]) for i in range(len(merged) - 1)),
                  reverse=True)[:top]
    host = summary["host_ops"]
    out = []
    for length, g0, nxt in gaps:
        mid = g0 + length / 2
        on = [(s, e, n) for n, s, e in host if s <= mid < e]
        if on:
            outer = min(on)[2]
            inner = max(on)[2]
            what = outer if outer == inner else f"{outer} > {inner}"
        else:
            what = "python between operations"
        out.append([f"host: {what}; next: {short(nxt, 40)}"[:160],
                    length * 1e-6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}


# -------------------------------------------------------- the comparison
def pose_gaps(prog: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(widest xy gap in m, widest heading gap in rad) of the program's
    poses f32[..., 3] from the reference's, NaN where a pose is not
    finite."""
    d = prog.double() - ref.double()
    xy = torch.hypot(d[..., 0], d[..., 1])
    th = torch.remainder(d[..., 2] + math.pi, 2 * math.pi) - math.pi
    bad = ~torch.isfinite(prog).all(dim=-1)
    if bool(bad.any()):
        return float("nan"), float("nan")
    return float(xy.max()), float(th.abs().max())


def say_robot_gaps(jobs, lens, ref: torch.Tensor) -> None:
    """How the widest pose gap spreads over the robots: how many robots
    ever part from the reference by more than 1e-4 m and 1e-3 m, and the
    median robot's widest gap (a line on standard error)."""
    worst = torch.zeros(ref.shape[1], dtype=torch.float64, device=ref.device)
    for j, n in zip(jobs, lens):
        d = (j.double() - ref[:n].double())[..., :2]
        worst = torch.maximum(worst, torch.hypot(d[..., 0], d[..., 1])
                              .amax(dim=0))
    say(f"robots parting by > 1e-4 m: {int((worst > 1e-4).sum())}, > 1e-3 m:"
        f" {int((worst > 1e-3).sum())} of {worst.numel()}; median robot's "
        f"widest gap {float(worst.median()):.3e} m, worst robot "
        f"{int(worst.argmax())}")


def cells_differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Map cells whose log-odds differ by more than MAP_CELL_TOL (every mark
    moves a cell by 0.405 or more), NaN cells counted."""
    return int((~((a - b).abs() <= MAP_CELL_TOL)).sum())


def checks_of(limits: dict, pose_gap: float, heading_gap: float,
              cells: int, failed: int) -> dict:
    """Every number compared, with its limit from the configuration."""
    return {"pose_gap_m": (pose_gap, limits["pose_gap_m"]),
            "heading_gap_rad": (heading_gap, limits["heading_gap_rad"]),
            "map_cells_differing": (cells, limits["map_cells_differing"]),
            "failed_scans": (failed, 0)}


def judge(checks: dict) -> bool:
    """True when every number compared is within its limit (NaN is not)."""
    return all(v <= lim for v, lim in checks.values())


def emit(result: dict, checks: dict) -> None:
    """The numbers compared beside their limits as the last lines of
    standard error, then the result as the last line of standard output,
    with the checks as its last key."""
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)


def percentile(xs, q: float) -> float:
    """The q-th percentile of all samples (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


class Reservoir:
    """One item drawn uniformly from a stream, by a seeded generator."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(int(seed) % (1 << 63))
        self.n = 0
        self.item = None

    def offer(self, item) -> None:
        self.n += 1
        if self.rng.integers(self.n) == 0:
            self.item = item
