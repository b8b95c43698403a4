"""The control and the planted faults of CoreSLAM's cells: a run of the cell,
as ``run.py`` drives it at the cell's own size, with the timed path replaced
or broken underneath, judged by the run's own comparison.  Each has to
come out as not correct.

    python3 slambench/control_coreslam.py --workload coreslam_replay
        --seeds 1 2 3 [--seconds S] [--plants control half_search
        holes_skipped] [--device cuda]

``control``: the plain reference put in the program's place, its candidate
transform in bfloat16 (the precision below the configuration's float32).
``half_search``: the program's search scores only the first half of its
candidates (the first 2,000 of 4,001), though it draws them all.
``holes_skipped``: the program's hole-map update leaves the map as it was
on every other call.  For each seed and plant this prints one JSON line:
the verdict and every number compared beside its limit.  The benchmark's
own runs do not run it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from slambench import harness as H                      # noqa: E402
from slambench import program_coreslam                  # noqa: E402
from slambench import reference_coreslam as R           # noqa: E402
from slambench.run import run_cell                      # noqa: E402

PLANTS = ("control", "half_search", "holes_skipped")


class ControlCoreSlam(program_coreslam.CoreSlam):
    """The reference, its candidate transform in bfloat16, behind the
    program's interface."""

    def __init__(self, cfg_dict: dict, device):
        super().__init__(cfg_dict, device)
        self.rcfg = R.RefConfig(cfg_dict)

    def init(self, start_pose, seed):
        return R.init(self.rcfg, start_pose, seed, self.device)

    def step(self, state, angles, radii, valid):
        state, total = R.step(state, angles, radii, valid, self.rcfg,
                              torch.bfloat16)
        return state, state.pose, total.to(torch.int32)


def _half(real):
    def best_of(cands, *args, **kwargs):
        return real(cands[:cands.shape[0] // 2], *args, **kwargs)
    return best_of


def _every_other(real):
    calls = {"n": 0}

    def update(hole_map_flat, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            return hole_map_flat
        return real(hole_map_flat, *args, **kwargs)
    return update


@contextlib.contextmanager
def planted(plant: str):
    """The run's timed path with ``plant`` in place."""
    if plant == "control":
        with mock.patch.object(program_coreslam, "CoreSlam", ControlCoreSlam):
            yield
    elif plant == "half_search":
        from slamnet_tpu_torch.ops import score
        with mock.patch.object(score, "best_of", _half(score.best_of)):
            yield
    elif plant == "holes_skipped":
        from slamnet_tpu_torch.ops import holemap
        with mock.patch.object(holemap, "update_hole_map",
                               _every_other(holemap.update_hole_map)):
            yield
    else:
        raise ValueError(f"no plant {plant!r}; known: {PLANTS}")


def run_planted(name: str, plant: str, seed: int, seconds: float, device,
                cfg: dict | None = None, traffic: dict | None = None):
    """(result, checks) of one run of the cell with ``plant`` in place."""
    with planted(plant):
        return run_cell(name, seed, seconds, False, device, time.time(),
                        cfg, traffic)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float,
                    default=H.benchmark()["run_seconds"])
    ap.add_argument("--plants", nargs="+", default=list(PLANTS),
                    choices=PLANTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    ok = True
    for seed in args.seeds:
        for plant in args.plants:
            result, checks = run_planted(args.workload, plant, seed,
                                         args.seconds, args.device)
            ok &= not result["correct"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "plant": plant, "correct": result["correct"],
                              "checks": {k: {"value": v, "limit": lim}
                                         for k, (v, lim) in checks.items()}}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
