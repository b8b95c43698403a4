"""Bilinear occupancy probability and its gradients at continuous map
coordinates (ScanMatcher.InterpMapValueWithDerivatives, ScanMatcher.cs:211-249,
with OccGridMap.GetCachedProbability, OccGridMap.cs:97-107).

Port of ``slamnet_tpu/ops/bilinear.py::interp_value_and_gradients`` (plain
PyTorch; JAX runs it in XLA, with no kernel).  The graph frontend reads it
for a match's quality.  Gradient quirk, kept on purpose: the reference (and
upstream hector_slam) interpolates the x-difference pair with the x factors
and the y pair with the y factors (ScanMatcher.cs:247-248), where textbook
bilinear gradients use the other axis.
"""
from __future__ import annotations

from typing import Tuple

import torch


def interp_value_and_gradients(logodds_flat: torch.Tensor, width: int,
                               coords: torch.Tensor, valid: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Probability value and (gx, gy) at map pixel coords f32[N, 2] of the
    log-odds grid ``logodds_flat`` f32[width*width]; ``valid`` bool[N].
    Points outside [0, width-2] (the reference's Limits margin,
    MapProperties.cs:42,83-87), invalid or not finite give (0, 0, 0), as
    ScanMatcher.cs:216-219."""
    x, y = coords[:, 0], coords[:, 1]
    in_b = (valid & (x >= 0.0) & (x <= width - 2) & (y >= 0.0)
            & (y <= width - 2) & torch.isfinite(x) & torch.isfinite(y))
    # floor, then the clip keeps the gather in the grid (a NaN's cell is
    # masked by in_b)
    x0 = torch.floor(x).to(torch.int32).clamp(0, width - 2)
    y0 = torch.floor(y).to(torch.int32).clamp(0, width - 2)
    fx = x - x0
    fy = y - y0
    idx = (y0 * width + x0).long()
    i0 = torch.sigmoid(logodds_flat[idx])
    i1 = torch.sigmoid(logodds_flat[idx + 1])
    i2 = torch.sigmoid(logodds_flat[idx + width])
    i3 = torch.sigmoid(logodds_flat[idx + width + 1])
    xf, yf = 1.0 - fx, 1.0 - fy
    value = (i0 * xf + i1 * fx) * yf + (i2 * xf + i3 * fx) * fy
    gx = -((i0 - i1) * xf + (i2 - i3) * fx)   # the reference's factor axes
    gy = -((i0 - i2) * yf + (i1 - i3) * fy)
    z = torch.zeros_like(value)
    return (torch.where(in_b, value, z), torch.where(in_b, gx, z),
            torch.where(in_b, gy, z))
