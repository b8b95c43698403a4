"""Angle math, SE(2) poses and reference rounding (torch, pure functions).

Port of the parts of ``slamnet_tpu/core/geometry.py`` that the Hector and
graph-SLAM paths use.  Same numerical contracts (BaseSLAM/MathEx.cs,
BaseSLAM/VectorEx.cs, SURVEY.md §2.1); every function takes and returns
tensors on any device.  The 2x2 rotations are written out as products and
sums (no matrix product), so a pose costs the same few element-wise
operations on every device.
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def _floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floored modulo with the sign of ``y``, built on ``fmod`` exactly as
    ``jnp.mod`` is (no ``x - floor(x / y) * y`` rounding)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def normalize_angle_pos(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle to [0, 2*pi) (MathEx.NormalizeAnglePos, BaseSLAM/MathEx.cs:116-121)."""
    return _floor_mod(_floor_mod(angle, TWO_PI) + TWO_PI, TWO_PI)


def normalize_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle to (-pi, pi] (MathEx.NormalizeAngle, BaseSLAM/MathEx.cs:128-138)."""
    a = normalize_angle_pos(angle)
    return torch.where(a > math.pi, a - TWO_PI, a)


def rad_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed smallest difference a-b between two angles in radians
    (MathEx.RadDiff, BaseSLAM/MathEx.cs:94-98)."""
    d = ((a - b) + math.pi) / TWO_PI
    return (d - torch.floor(d)) * TWO_PI - math.pi


def deg_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed smallest difference a-b between two angles in degrees
    (MathEx.DegDiff, BaseSLAM/MathEx.cs:69-73); kept for the reference quirk
    behind ``HectorConfig.angle_gate_compat``."""
    d = ((a - b) + 180.0) / 360.0
    return (d - torch.floor(d)) * 360.0 - 180.0


def csharp_trunc(x: torch.Tensor) -> torch.Tensor:
    """C# (int) cast: truncate toward zero (CoreSLAMProcessor.cs:240-241)."""
    return torch.trunc(x).to(torch.int32)


def dotnet_round(x: torch.Tensor) -> torch.Tensor:
    """.NET MathF.Round: round half to even (VectorEx.ToRoundPoint,
    OccGridMap.cs:127,134).  ``torch.round`` rounds half to even."""
    return torch.round(x).to(torch.int32)


def rot2(theta: torch.Tensor) -> torch.Tensor:
    """2x2 rotation matrix (stacked as [..., 2, 2]) for CCW rotation by theta."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def _rotate(r: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """``r @ (x, y)`` for rotations r [..., 2, 2] and vectors (x, y)."""
    return (r[..., 0, 0] * x + r[..., 0, 1] * y,
            r[..., 1, 0] * x + r[..., 1, 1] * y)


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Rigid-transform robot-local points f32[..., N, 2] into the frame of
    ``pose`` f32[..., 3]: ``R(theta) @ p + (x, y)``."""
    r = rot2(pose[..., 2])[..., None, :, :]
    x, y = _rotate(r, points[..., 0], points[..., 1])
    return torch.stack([x + pose[..., None, 0], y + pose[..., None, 1]], dim=-1)


def pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SE(2) composition a (+) b: apply b in the frame of a:
    (a.xy + R(a.th) @ b.xy, a.th + b.th)."""
    x, y = _rotate(rot2(a[..., 2]), b[..., 0], b[..., 1])
    return torch.stack([a[..., 0] + x, a[..., 1] + y, a[..., 2] + b[..., 2]],
                       dim=-1)


def pose_inverse(a: torch.Tensor) -> torch.Tensor:
    """SE(2) inverse: a (+) inverse(a) = identity."""
    x, y = _rotate(rot2(-a[..., 2]), a[..., 0], a[..., 1])
    return torch.stack([-x, -y, -a[..., 2]], dim=-1)


def pose_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative pose from a to b: inverse(a) (+) b (b in a's frame)."""
    return pose_compose(pose_inverse(a), b)
