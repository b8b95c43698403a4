"""Angle math, SE(2) poses and reference rounding (torch, pure functions).

Port of ``slamnet_tpu/core/geometry.py``.  Same numerical contracts (BaseSLAM/MathEx.cs,
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


def deg_to_rad(deg: torch.Tensor) -> torch.Tensor:
    """Degrees to radians (MathEx.DegToRad, BaseSLAM/MathEx.cs:45-48)."""
    return torch.as_tensor(deg) * (math.pi / 180.0)


def rad_to_deg(rad: torch.Tensor) -> torch.Tensor:
    """Radians to degrees (MathEx.RadToDeg, BaseSLAM/MathEx.cs:56-59)."""
    return torch.as_tensor(rad) * (180.0 / math.pi)


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


def cos_rn(x: torch.Tensor) -> torch.Tensor:
    """cos of f32 ``x``, evaluated in float64 and rounded once to f32: the
    correctly rounded value in all but rare near-tie cases, on every device,
    so the CPU and the card snap the same pixels (torch's f32 ``cos`` and
    XLA's differ from it, and from each other, by an ulp on a few percent of
    inputs)."""
    return torch.cos(x.double()).float()


def sin_rn(x: torch.Tensor) -> torch.Tensor:
    """sin of f32 ``x`` rounded once from float64 (see ``cos_rn``)."""
    return torch.sin(x.double()).float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as IEEE (and XLA) define it;
    torch's f32 ``sqrt`` on some CPUs is an ulp off.  A float64 root of an
    f32 value rounds to f32 exactly."""
    return torch.sqrt(x.double()).float()


def atan2_rn(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 of f32 ``y``, ``x`` rounded once from float64 (see ``cos_rn``)."""
    return torch.atan2(y.double(), x.double()).float()


def true_div(a, b) -> torch.Tensor:
    """``a / b`` rounded once, as IEEE (and JAX outside jit) divides, where
    one side is a Python number: PyTorch's CUDA division by a Python number
    multiplies by its reciprocal, and ``number / tensor`` is
    ``reciprocal(tensor) * number`` on every device; a 0-dim tensor on the
    other operand's device divides exactly."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def dotnet_round(x: torch.Tensor) -> torch.Tensor:
    """.NET MathF.Round: round half to even (VectorEx.ToRoundPoint,
    OccGridMap.cs:127,134).  ``torch.round`` rounds half to even."""
    return torch.round(x).to(torch.int32)


def polar_to_cartesian(radius: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Polar to cartesian, stacked on the last axis (MathEx.PolarToCartesian,
    BaseSLAM/MathEx.cs:147-152)."""
    return torch.stack([radius * torch.cos(angle), radius * torch.sin(angle)],
                       dim=-1)


def limit(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """Clamp (MathEx.Limit float/int overloads, BaseSLAM/MathEx.cs:21-36)."""
    return torch.clamp(torch.as_tensor(x), lo, hi)


def find_position_on_line(p, a, b) -> torch.Tensor:
    """Project point p onto the infinite line through a-b
    (VectorEx.FindPositionOnLine, BaseSLAM/VectorEx.cs:35-46)."""
    p, a, b = (torch.as_tensor(v, dtype=torch.float32) for v in (p, a, b))
    ab = b - a
    denom = (ab * ab).sum(dim=-1, keepdim=True).clamp(min=1e-12)
    t = ((p - a) * ab).sum(dim=-1, keepdim=True) / denom
    return a + t * ab


def point_to_line_distance(p, a, b) -> torch.Tensor:
    """Distance from p to the infinite line through a-b
    (VectorEx.PointToLine, BaseSLAM/VectorEx.cs:55-61)."""
    proj = find_position_on_line(p, a, b)
    return torch.linalg.vector_norm(
        torch.as_tensor(p, dtype=torch.float32) - proj, dim=-1)


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
