"""The control and the planted faults: a run of the cell, as ``run.py``
drives it at the cell's own size, with the timed path replaced or broken
underneath, judged by the run's own comparison.  Each has to come out as
not correct.

    python3 slambench/control.py --workload NAME --seeds 1 2 3 [--seconds S]
        [--plants control unchanged altered] [--device cuda]

``control``: the plain reference put in the program's place, its per-beam
arithmetic in bfloat16 (the precision below the configurations' float32).
``unchanged``: a step that returns its state unchanged.  ``altered``: the
4th match of the window moves one robot's x by five times the cell's pose
limit where the match produces it.  For each seed and plant this prints one
JSON line: the verdict and every number compared beside its limit.  The
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from slambench import harness as H              # noqa: E402
from slambench import program, reference        # noqa: E402
from slambench.run import run_cell              # noqa: E402

PLANTS = ("control", "unchanged", "altered")


class ControlRobots(program.Robots):
    """The reference in bfloat16 behind the program's interface."""

    def __init__(self, cfg_dict: dict, robots: int, device):
        super().__init__(cfg_dict, robots, device)
        self.rcfg = reference.RefConfig(cfg_dict)
        self.full_scan = robots == 1 and self.rcfg.matcher_mode != "pallas"

    def init(self, start_poses):
        return reference.init(self.rcfg, start_poses)

    def step(self, state, points, valid, force, cfg=None):
        rcfg = self.rcfg if cfg is None else reference.RefConfig(
            {k: getattr(cfg, k) for k in reference.RefConfig.FIELDS})
        state, fired = reference.step(state, points, valid, rcfg, force,
                                      self.full_scan, torch.bfloat16)
        return state, state.match_pose, fired

    def set_pose(self, state, poses):
        return state._replace(match_pose=poses.clone())


def _unchanged_step(real):
    def step(self, state, points, valid, force, cfg=None):
        if force:
            return real(self, state, points, valid, force, cfg)
        pose = state.match_pose if self.robots > 1 else \
            state.match_pose[None]
        return state, pose, torch.zeros(self.robots, dtype=torch.bool,
                                        device=pose.device)
    return step


def _altered_match(real, at: int, shift: float):
    """``real`` with its ``at``-th answer moved; it carries ``real``'s
    attributes (the launch counters ``real`` updates through its module's
    name)."""
    calls = {"n": 0}

    @functools.wraps(real)
    def match(*args, **kwargs):
        out = real(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] == at:
            out = out.clone()
            if out.dim() == 1:
                out[0] += shift
            else:
                out[0, 0] += shift
        return out
    return match


@contextlib.contextmanager
def planted(plant: str, cfg: dict, traffic: dict):
    """The run's timed path with ``plant`` in place, for a run of the cell
    with the configuration ``cfg`` and the traffic ``traffic``."""
    if plant == "control":
        with mock.patch.object(program, "Robots", ControlRobots):
            yield
    elif plant == "unchanged":
        real = program.Robots.step
        with mock.patch.object(program.Robots, "step", _unchanged_step(real)):
            yield
    elif plant == "altered":
        from slamnet_tpu_torch.ops import match as match_op
        robots = traffic.get("logs", 1) * traffic.get("shifts", 1)
        fn = "match" if robots == 1 else "match_batch"
        at = traffic["bootstrap"] + traffic["warmup_steps"] + 4
        shift = 5 * cfg["limits"]["pose_gap_m"]
        with mock.patch.object(match_op, fn, _altered_match(
                getattr(match_op, fn), at, shift)):
            yield
    else:
        raise ValueError(f"no plant {plant!r}; known: {PLANTS}")


def run_planted(name: str, plant: str, seed: int, seconds: float, device,
                cfg: dict | None = None, traffic: dict | None = None):
    """(result, checks) of one run of the cell with ``plant`` in place."""
    _, cfg0, traffic0 = H.cell(name)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    with planted(plant, cfg, traffic):
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
