"""The control and the planted faults of graph-SLAM's cells: a run of the
cell, as ``run.py`` drives it at the cell's own size, with the timed path
replaced or broken underneath, judged by the run's own comparison.  Each has
to come out as not correct.

    python3 slambench/control_graph.py --workload graph_loop_replay
        --seeds 1 2 3 [--seconds S] [--plants control no_closures
        optimize_skipped wide_gate] [--device cuda]

``control``: the plain reference put in the program's place, the frontend's
local grid rounded to bfloat16 (the precision below the configuration's
float32).  ``no_closures``: no loop closure is ever accepted (the frontend
matches, and its inlier share reads 0).  ``optimize_skipped``: a keyframe
event that accepted a closure runs no optimize.  ``wide_gate``: the
keyframe gate at twice its distance.  For each seed and plant this prints
one JSON line: the verdict and every number compared beside its limit.  The
benchmark's own runs do not run it.
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
from slambench import program_graph                     # noqa: E402
from slambench import reference_graph as R              # noqa: E402
from slambench.run import run_cell                      # noqa: E402

PLANTS = ("control", "no_closures", "optimize_skipped", "wide_gate")


class ControlGraphSlam(program_graph.GraphSlam):
    """The reference, its frontend's local grid in bfloat16, behind the
    program's interface: a state is a ``reference_graph.Job``."""

    def __init__(self, cfg: dict, num_beams: int, device):
        super().__init__(cfg, num_beams, device)
        self.cfg = cfg

    def init(self, start_pose):
        return R.Job(self.cfg, start_pose, torch.bfloat16)

    def step(self, state, points, valid, boot_pose=None):
        return state, state.step(points, valid, boot_pose)[0]

    @contextlib.contextmanager
    def recorded_searches(self):
        """The control's own loop matches, as the program's are recorded."""
        found, real = [], R.match_scans

        def match_scans(ref_pts, ref_val, pts, val, init_rel, *args):
            rel, frac = real(ref_pts, ref_val, pts, val, init_rel, *args)
            found.append((ref_pts, ref_val, pts, val, init_rel, rel))
            return rel, frac
        R.match_scans = match_scans
        try:
            yield found
        finally:
            R.match_scans = real


def _outcome(real):
    def outcome(state):
        if not isinstance(state, R.Job):
            return real(state)
        snap = state.snapshot()
        return {"keyframes": snap.keyframes, "closures": snap.closures,
                "kf_poses": snap.kf_poses, "maps": snap.maps}
    return outcome


def _no_closures(real):
    def match_scans(*args, **kwargs):
        rel, q = real(*args, **kwargs)
        return rel, q._replace(inlier_frac=torch.zeros_like(q.inlier_frac))
    return match_scans


def _optimize_skipped(real, gcfg):
    def optimize(g, iterations, *args, **kwargs):
        if iterations == gcfg.optimize_iterations_loop != \
                gcfg.optimize_iterations:
            return g
        return real(g, iterations, *args, **kwargs)
    return optimize


def _wide_gate(real):
    def keyframe_due(last, pose, dist, angle):
        return real(last, pose, 2.0 * dist, angle)
    return keyframe_due


@contextlib.contextmanager
def planted(plant: str, cfg: dict):
    """The run's timed path with ``plant`` in place (``cfg``: the cell's
    configuration, whose optimize iterations the ``optimize_skipped``
    plant reads)."""
    from slamnet_tpu_torch.graph import frontend, posegraph
    if plant == "control":
        with mock.patch.object(program_graph, "GraphSlam", ControlGraphSlam), \
                mock.patch.object(program_graph, "outcome",
                                  _outcome(program_graph.outcome)):
            yield
    elif plant == "no_closures":
        with mock.patch.object(frontend, "match_scans",
                               _no_closures(frontend.match_scans)):
            yield
    elif plant == "optimize_skipped":
        gcfg = program_graph.graph_config(cfg["graph"])
        with mock.patch.object(posegraph, "optimize", _optimize_skipped(
                posegraph.optimize, gcfg)):
            yield
    elif plant == "wide_gate":
        with mock.patch.object(frontend, "keyframe_due",
                               _wide_gate(frontend.keyframe_due)):
            yield
    else:
        raise ValueError(f"no plant {plant!r}; known: {PLANTS}")


def run_planted(name: str, plant: str, seed: int, seconds: float, device,
                cfg: dict | None = None, traffic: dict | None = None):
    """(result, checks) of one run of the cell with ``plant`` in place."""
    _, cfg0, _ = H.cell(name)
    with planted(plant, cfg or cfg0):
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
