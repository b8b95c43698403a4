"""Angle math and reference rounding (torch, pure functions).

Port of the parts of ``slamnet_tpu/core/geometry.py`` that the Hector path
uses.  Same numerical contracts (BaseSLAM/MathEx.cs, BaseSLAM/VectorEx.cs,
SURVEY.md §2.1); every function takes and returns tensors on any device.
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
