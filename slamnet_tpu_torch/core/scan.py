"""Scan containers as fixed-shape tensors plus a validity mask.

Port of ``slamnet_tpu/core/scan.py``: a lidar revolution is a fixed-width
point array and a mask, misses masked rather than dropped.

- ``Scan``: the cartesian cloud (BaseSLAM/ScanCloud.cs);
- ``SegmentScan``: polar rays grouped into segments, each with its capture
  pose (ScanSegment lists), de-skewed by ``segments_to_cloud``
  (CoreSLAMProcessor.ScanSegmentsToCloud, CoreSLAMProcessor.cs:187-207).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import cos_rn, sin_rn


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


class SegmentScan(NamedTuple):
    """Polar rays grouped into S segments of up to N rays each.

    angles / radii: f32[S, N] (robot-frame angle, meters); valid: bool[S, N];
    poses: f32[S, 3], the odometry pose at each segment's capture.  The last
    segment's pose is the newest odometry pose (CoreSLAMProcessor.cs:719).
    """

    angles: torch.Tensor
    radii: torch.Tensor
    valid: torch.Tensor
    poses: torch.Tensor

    @property
    def odometry_pose(self) -> torch.Tensor:
        return self.poses[-1]

    @staticmethod
    def single(angles, radii, valid=None, pose=None) -> "SegmentScan":
        """One whole-revolution segment (the simulator's case,
        MainWindow.xaml.cs:385)."""
        angles = torch.as_tensor(angles, dtype=torch.float32)[None]
        device = angles.device
        radii = torch.as_tensor(radii, dtype=torch.float32, device=device)[None]
        if valid is None:
            valid = torch.ones(angles.shape, dtype=torch.bool, device=device)
        else:
            valid = torch.as_tensor(valid, dtype=torch.bool, device=device)[None]
        if pose is None:
            pose = torch.zeros((1, 3), dtype=torch.float32, device=device)
        else:
            pose = torch.as_tensor(pose, dtype=torch.float32,
                                   device=device)[None]
        return SegmentScan(angles, radii, valid, pose)


def segments_to_cloud(seg: SegmentScan) -> Scan:
    """De-skew segments into one cloud relative to the newest odometry pose:
    ``pose = segment.Pose - odometryPose`` component by component (NOT an
    SE(2) relative pose), each ray at ``(pose.x + r cos(angle + pose.z),
    pose.y + r sin(angle + pose.z))`` (CoreSLAMProcessor.cs:187-207)."""
    rel = seg.poses - seg.odometry_pose                  # [S, 3]
    a = seg.angles + rel[:, None, 2]
    x = rel[:, None, 0] + seg.radii * cos_rn(a)
    y = rel[:, None, 1] + seg.radii * sin_rn(a)
    pts = torch.stack([x, y], dim=-1).reshape(-1, 2)
    return Scan(pts, seg.valid.reshape(-1),
                torch.zeros(3, dtype=torch.float32, device=pts.device))


def polar_scan(angles, radii, valid=None) -> Scan:
    """Robot-local polar rays -> cartesian Scan (the simulator's cloud path,
    MainWindow.xaml.cs:167-177)."""
    r = torch.as_tensor(radii, dtype=torch.float32)
    a = torch.as_tensor(angles, dtype=torch.float32, device=r.device)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a)], dim=-1)
    return Scan.from_points(pts, valid)
