"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 slambench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (configuration x traffic) is found by name in ``BENCHMARK.json``;
its configuration's file, its traffic's file under ``slambench/traffic/``
and the traffic's kind under ``slambench/kinds/`` say what to run.  With
``--trace 0`` the result's metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones, read from a traced stretch of the window
by the readers under ``slambench/metrics/``.  A run needs the cards the
cell asks for: without them it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse            # noqa: E402
import importlib           # noqa: E402
import os                  # noqa: E402
import sys                 # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "slambench"
                                         / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "slambench" / "triton")
os.environ["OMP_NUM_THREADS"] = "1"     # one process, few threads

import torch                          # noqa: E402

from slambench import harness as H   # noqa: E402

RESULT_ORDER = ("correct", "attempted", "failed", "metrics", "device",
                "breakdown")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, cfg: dict | None = None,
             traffic: dict | None = None) -> tuple:
    """The cell's run on ``device`` without the look for cards: (result,
    checks).  ``cfg`` / ``traffic`` replace the cell's files (the CPU
    tests' small sizes)."""
    _, cfg0, traffic0 = H.cell(name)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    kind = importlib.import_module(f"slambench.kinds.{traffic['kind']}")
    metrics = H.metrics_of(name, "per_layer" if trace else "end_to_end")
    result, checks = kind.run(name, cfg, traffic, seed, seconds, trace,
                              device, t_start, metrics)
    units = {m["name"]: m["unit"] for m in metrics}
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in result["metrics"].items() if k in units}
    ordered = {k: result.pop(k) for k in RESULT_ORDER if k in result}
    return {**ordered, **result}, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    work, _, _ = H.cell(args.workload)
    H.require_cards(work["chips"])
    torch.set_num_threads(1)
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = H.forbidden_modules()
    if bad:
        H.say(f"modules of JAX or the JAX package are loaded: {bad}")
        return 3
    H.say(f"card: {H.power_limit()}")
    H.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
