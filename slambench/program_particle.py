"""The system under test in the particle layer's cells:
``models/particle.update`` stepped through the loop log, and a
configuration's ``"coreslam"`` and ``"particle"`` groups turned into the
program's configs.

Each scan is the log's cloud (its robot-local points and flags) tagged with
the layer's own current estimate, which also goes in as the odometry: the
simulator has no odometry and feeds the estimate back
(MainWindow.xaml.cs:380-407), so the prior is the constant-velocity one.
The counters are read with defaults, so a program without them reads
None.
"""
from __future__ import annotations

import torch

from slamnet_tpu_torch.core.config import CoreSlamConfig, ParticleConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import particle

COUNTERS = ("steps", "warm_steps", "poses_scored")


class Particles:
    """One particle layer: ``init`` a state at a start pose f32[3] with the
    draws' generator seeded, ``step`` it one scan, ``final`` its
    population and maps."""

    def __init__(self, cfg: dict, device):
        self.ccfg = CoreSlamConfig(**cfg["coreslam"])
        self.pcfg = ParticleConfig(**cfg["particle"])
        self.device = torch.device(device)

    def init(self, start_pose: torch.Tensor, seed: int):
        return particle.init(self.ccfg, self.pcfg, start_pose, seed=seed,
                             device=self.device)

    def step(self, state, points, valid):
        """One scan of points f32[N, 2] and flags bool[N]: (state, (the
        estimate f32[3], the best refined sum i32[], the effective sample
        size f32[], resampled bool[])) on the device."""
        state, info = particle.update(state, Scan(points, valid, state.pose),
                                      state.pose, self.ccfg, self.pcfg)
        return state, (state.pose, info.best_sum, info.ess, info.resampled)

    @staticmethod
    def final(state) -> tuple:
        """(population f32[P, 3], hole map, obstacle map)."""
        return state.particles, state.hole_map, state.obstacle_map


def counters() -> dict:
    """The program's counts so far: scans, scans past the warm-up and poses
    scored (None where the program has no such counter)."""
    return {k: getattr(particle.update, k, None) for k in COUNTERS}
