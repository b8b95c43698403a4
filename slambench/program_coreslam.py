"""The system under test in CoreSLAM's cells: ``models/coreslam.update`` as
slam.net's simulator calls it, and a configuration's ``"coreslam"`` group
turned into the program's ``CoreSlamConfig``.

Each scan is one segment of the revolution's rays (their angles and
ranges), tagged with CoreSLAM's own current pose: the simulator has no
odometry and feeds the estimate back (MainWindow.xaml.cs:380-407), so the
search prior is the constant-velocity one.  The counters are read with
defaults, so a program without them reads None.
"""
from __future__ import annotations

import torch

from slamnet_tpu_torch.core.config import CoreSlamConfig
from slamnet_tpu_torch.core.scan import SegmentScan
from slamnet_tpu_torch.models import coreslam


def coreslam_config(d: dict) -> CoreSlamConfig:
    """A configuration's ``"coreslam"`` group as the program's config."""
    return CoreSlamConfig(**d)


class CoreSlam:
    """One CoreSLAM: ``init`` a state at a start pose f32[3] with the
    search's generator seeded, ``step`` it one scan."""

    def __init__(self, cfg_dict: dict, device):
        self.cfg = coreslam_config(cfg_dict)
        self.device = torch.device(device)

    def init(self, start_pose: torch.Tensor, seed: int):
        return coreslam.init(self.cfg, start_pose, seed=seed,
                             device=self.device)

    def step(self, state, angles, radii, valid):
        """One scan of rays f32[N] (angles, ranges) and bool[N]: (state,
        pose f32[3], the best candidate's sum i32[]) on the device."""
        seg = SegmentScan(angles[None], radii[None], valid[None],
                          state.pose[None])
        state, info = coreslam.update(state, seg, self.cfg)
        return state, state.pose, info.best_sum


def counters() -> dict:
    """The program's counts so far: searched scans and candidates scored
    (None where the program has no such counter)."""
    f = coreslam.update_cloud
    return {"searches": getattr(f, "searches", None),
            "candidates": getattr(f, "candidates", None)}
