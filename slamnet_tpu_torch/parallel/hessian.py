"""Beam-sharded Gauss-Newton accumulation: partial sums over a beam axis.

Port of ``slamnet_tpu/parallel/hessian.py``: the reference splits beams
across worker threads and sums their partial (H, dTr) on the host
(ScanMatcher.cs:149-196); here each rank of the ``axis`` holds a contiguous
slice of the beams, accumulates ``ops.gn.hessian_derivs`` over it, and the
3x3 Hessian and the residual vector are psum'd in ONE collective (the 12
numbers as one tensor).  The map and the pose are replicated; the solve is
replicated (it is 3x3).  Equal to the dense sums up to their order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import gn
from .mesh import Mesh


def sharded_hessian_derivs(mesh: Mesh, logodds_flat: torch.Tensor, width: int,
                           points: torch.Tensor, valid: torch.Tensor,
                           pose_px: torch.Tensor, scale_to_map: float,
                           axis: str = "beam"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H f32[3, 3], dTr f32[3]) of the whole beam axis, replicated; this
    rank passes its own beam shard ``points`` f32[n, 2], ``valid`` bool[n]
    (``mesh.shard_range`` of the global N)."""
    h, dtr = gn.hessian_derivs(logodds_flat, width, points, valid, pose_px,
                               scale_to_map)
    s = mesh.psum(torch.cat([h.reshape(-1), dtr]), axis)
    return s[:9].reshape(3, 3), s[9:]


def sharded_gn_iteration(mesh: Mesh, logodds_flat, width, points, valid,
                         pose_px, scale_to_map, deriv_clamp: float = 0.2,
                         axis: str = "beam") -> torch.Tensor:
    """One beam-sharded GN step: the pose plus the replicated solve's step."""
    H, dtr = sharded_hessian_derivs(mesh, logodds_flat, width, points, valid,
                                    pose_px, scale_to_map, axis)
    return pose_px + gn.solve_gn_step(H, dtr, deriv_clamp)
