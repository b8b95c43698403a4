"""The control and the planted faults of the particle layer's cells: a run
of the cell, as ``run.py`` drives it at the cell's own size, with the timed
path replaced or broken underneath, judged by the run's own comparison.
Each has to come out as not correct.

    python3 slambench/control_particle.py --workload particle8192_replay
        --seeds 1 2 3 [--seconds S] [--plants control no_resample
        unrefined half_scored holes_skipped] [--device cuda]

``control``: the plain reference put in the program's place, its candidate
transform in bfloat16 (the precision below the configuration's float32).
``no_resample``: the program's resampling never fires (the population and
its sums pass through; the ESS is still computed).
``unrefined``: the survivors are kept unrefined (the refine's draws are
made, then zeroed, so each survivor's refinements are itself).
``half_scored``: the program scores only the first half of the population
and leaves the rest at int-max.
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
from slambench import program_particle                  # noqa: E402
from slambench import reference_coreslam as C           # noqa: E402
from slambench import reference_particle as R           # noqa: E402
from slambench.control_coreslam import _every_other     # noqa: E402
from slambench.run import run_cell                      # noqa: E402

PLANTS = ("control", "no_resample", "unrefined", "half_scored",
          "holes_skipped")


class ControlParticles(program_particle.Particles):
    """The reference, its candidate transform in bfloat16, behind the
    program's interface."""

    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.rcfg = C.RefConfig(cfg["coreslam"])
        self.rpcfg = R.PConfig(cfg["particle"])

    def init(self, start_pose, seed):
        return R.init(self.rcfg, self.rpcfg, start_pose, seed, self.device)

    def step(self, state, points, valid):
        state, info = R.step(state, points, valid, self.rcfg, self.rpcfg,
                             torch.bfloat16)
        return state, (state.pose, info.best_sum.to(torch.int32), info.ess,
                       info.resampled)

    @staticmethod
    def final(state) -> tuple:
        return state.particles, state.hole, state.obstacle


def _never(real):
    def resample(particles, eff, *args, **kwargs):
        _, _, ess, fired = real(particles, eff, *args, **kwargs)
        return particles, eff, ess, torch.zeros_like(fired)
    return resample


def _still(real):
    def draw(*args, **kwargs):
        noise = real(*args, **kwargs)
        return noise._replace(refine_xy=torch.zeros_like(noise.refine_xy),
                              refine_th=torch.zeros_like(noise.refine_th))
    return draw


def _half(real):
    def score(state, cfg, points, valid, poses):
        if poses.shape[0] != state.particles.shape[0]:
            return real(state, cfg, points, valid, poses)   # the refine's
        h = poses.shape[0] // 2
        eff = real(state, cfg, points, valid, poses[:h])
        return torch.cat([eff, torch.full((poses.shape[0] - h,),
                                          C.INT32_MAX, dtype=eff.dtype,
                                          device=eff.device)])
    return score


@contextlib.contextmanager
def planted(plant: str):
    """The run's timed path with ``plant`` in place."""
    from slamnet_tpu_torch.models import particle
    if plant == "control":
        with mock.patch.object(program_particle, "Particles",
                               ControlParticles):
            yield
    elif plant == "no_resample":
        with mock.patch.object(particle, "resample",
                               _never(particle.resample)):
            yield
    elif plant == "unrefined":
        with mock.patch.object(particle, "draw", _still(particle.draw)):
            yield
    elif plant == "half_scored":
        with mock.patch.object(particle, "_score", _half(particle._score)):
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
