"""Simulated lidar: fixed-width noisy scans from the polygon field.

Port of ``slamnet_tpu/sim/lidar.py`` (MainWindow.ScanSegments,
Simulation/MainWindow.xaml.cs:380-407): evenly spaced angles accumulated in
float32 as the reference does, ray-traced at the REAL pose, uniform noise on
the grid {-1.00, -0.99, ..., 0.99} * measure_error, plus optional Gaussian
range error, misses masked.  The noise comes from a caller-seeded
``torch.Generator``, so its numbers differ from ``jax.random`` for the same
seed; the distribution is the same.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.scan import Scan, SegmentScan
from . import field as field_mod


def revolution_angles(num_scan_points: int) -> np.ndarray:
    """Reference angle set: f32 accumulation until >= 2*pi (MainWindow.xaml.cs:391)."""
    step = np.float32(2.0 * math.pi) / np.float32(num_scan_points)
    out = []
    a = np.float32(0.0)
    two_pi = np.float32(2.0 * math.pi)
    while a < two_pi:
        out.append(a)
        a = np.float32(a + step)
    return np.asarray(out, np.float32)


def scan_revolution(fld: field_mod.Field, real_pose: torch.Tensor,
                    angles: torch.Tensor, max_dist: float,
                    measure_error: float,
                    generator: torch.Generator,
                    range_error_std: float = 0.0,
                    dropout_prob: float = 0.0) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Revolutions at ``real_pose`` f32[..., 3]; returns (radii f32[..., R],
    valid bool[..., R]).

    Noise model of MainWindow.xaml.cs:397: ``hit += (rnd.Next(-100,100)/100) *
    err``; ``range_error_std`` > 0 adds Gaussian range error (the
    reference's declared-but-unused Field.RayTraceError, Field.cs:36, as
    ``slamnet_tpu/sim/lidar.py:33-57`` makes it real), and ``dropout_prob``
    > 0 drops each ray that hit with that probability (sensor dropouts,
    ``slamnet_tpu/sim/lidar.py:55-56``).  ``generator`` must live on the
    device of ``real_pose``; it gives, in this order, the uniform steps of
    every ray, then (with ``dropout_prob``) the dropout draws, then (with
    ``range_error_std``) the normals.  A draw that is not asked for takes
    nothing from the generator.
    """
    lidar_angles = angles + real_pose[..., 2:3]
    hit, dist = field_mod.ray_cast(fld, real_pose[..., :2], lidar_angles,
                                   max_dist)
    steps = torch.randint(-100, 100, dist.shape, generator=generator,
                          device=dist.device)
    noise = steps.to(torch.float32) / 100.0 * measure_error
    valid = hit
    if dropout_prob > 0.0:
        valid = hit & (torch.rand(dist.shape, generator=generator,
                                  device=dist.device) >= dropout_prob)
    if range_error_std > 0.0:
        noise = noise + torch.randn(dist.shape, generator=generator,
                                    device=dist.device) * range_error_std
    return torch.where(valid, dist + noise, torch.zeros_like(dist)), valid


def make_cloud(angles: torch.Tensor, radii: torch.Tensor,
               valid: torch.Tensor) -> Scan:
    """Robot-local cartesian cloud for Hector (MainWindow.xaml.cs:167-177)."""
    pts = torch.stack([radii * torch.cos(angles), radii * torch.sin(angles)],
                      dim=-1)
    return Scan(pts, valid, torch.zeros(3, dtype=torch.float32,
                                        device=radii.device))


def make_segment_scan(angles, radii, valid, odometry_pose) -> SegmentScan:
    """A revolution as a single-segment scan tagged with the odometry pose
    (the simulator tags segments with the estimated pose,
    MainWindow.xaml.cs:387)."""
    return SegmentScan.single(angles, radii, valid, odometry_pose)
