"""Scan container as fixed-shape tensors plus a validity mask.

Port of ``slamnet_tpu/core/scan.py::Scan`` (the analogue of
BaseSLAM/ScanCloud.cs): a lidar revolution is a fixed-width point array and a
mask, misses masked rather than dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Scan(NamedTuple):
    """A cartesian scan cloud with fixed width N.

    points: f32[N, 2] robot-local meters; valid: bool[N]; pose: f32[3] — the
    pose the cloud is expressed relative to (ScanCloud.Pose; zero in the
    simulator).
    """

    points: torch.Tensor
    valid: torch.Tensor
    pose: torch.Tensor

    @property
    def n(self) -> int:
        return self.points.shape[-2]

    @staticmethod
    def from_points(points, valid=None, pose=None) -> "Scan":
        points = torch.as_tensor(points, dtype=torch.float32)
        device = points.device
        if valid is None:
            valid = torch.ones(points.shape[:-1], dtype=torch.bool, device=device)
        if pose is None:
            pose = torch.zeros(points.shape[:-2] + (3,), dtype=torch.float32,
                               device=device)
        return Scan(points, torch.as_tensor(valid, dtype=torch.bool, device=device),
                    torch.as_tensor(pose, dtype=torch.float32, device=device))
