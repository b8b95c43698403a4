"""Obstacle-map scan update: CoreSLAM's second map, line and dense.

Port of ``slamnet_tpu/ops/obstacle.py``: UpdateObstacleMap +
DrawLaserRayOnObstacleMap (CoreSLAMProcessor.cs:456-593).  The reference
walks each beam with the symmetric Bresenham, marks the cells it crosses,
counts a hit at the endpoint (capped), then steps every marked cell toward 0.
Hits come before the decay and the marks are idempotent, so a scan's result
does not depend on the beams' order:

  hit_cnt   = the endpoints' hits (``index_add_``, int32)
  traversed = the crossed cells' marks (``scatter_reduce`` "amax")
  v1 = min(v0 + hit_cnt, max(v0, max_hits))     # the per-beam cap, composed
  v2 = v1 +/- 1 toward zero where traversed      # the decay sweep

on an int8 map.  ``update_obstacle_map_dense`` marks the swept polygon
instead: every cell nearer than its sector's shortest beam less half a cell,
with the hole map's quantized min-range lookup (JAX's documented divergence,
``slamnet_tpu/ops/obstacle.py:84-95``).

``update_obstacle_map`` runs K7's obstacle launch (``csrc/coreslam_map.cu``:
one block, the hits and marks in shared memory, bit for bit
``update_obstacle_map_plain``) for a CUDA tensor and
``update_obstacle_map_plain`` (torch operators) for a CPU tensor; the
dense update is torch operators on the tensors' device.  The kernel
replaces no TPU kernel (the JAX package runs this in XLA).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.geometry import csharp_trunc, sqrt_rn
from . import _build
from .holemap import cell_ranges, min_range_table, pose_frame
from .rasterize import rosetta_line_cells


def _apply(obstacle_map: torch.Tensor, hit_cnt: torch.Tensor,
           traversed: torch.Tensor, max_hits: int,
           robot_in: torch.Tensor) -> torch.Tensor:
    """The capped hits, then the decay of the traversed cells; the map is
    left as it was when the robot pixel is outside it (:557-560)."""
    v0 = obstacle_map.reshape(-1).to(torch.int32)
    v1 = torch.minimum(v0 + hit_cnt, v0.clamp(min=max_hits))
    v2 = torch.where(traversed & (v1 < 0), v1 + 1,
                     torch.where(traversed & (v1 > 0), v1 - 1, v1))
    new = v2.to(torch.int8).view(obstacle_map.shape)
    return torch.where(robot_in, new, obstacle_map)


def _hits(x2: torch.Tensor, y2: torch.Tensor, ok: torch.Tensor,
          size: int) -> torch.Tensor:
    """i32[size*size] hit counts of the endpoints where ``ok``."""
    flat = torch.where(ok, y2 * size + x2, torch.zeros_like(x2)).long()
    return torch.zeros(size * size, dtype=torch.int32,
                       device=x2.device).index_add_(0, flat, ok.to(torch.int32))


class _ObstacleParams(ctypes.Structure):
    """``struct ObstacleParams`` of csrc/coreslam_map.cu, passed by value."""

    _fields_ = [("size", ctypes.c_int), ("n", ctypes.c_int),
                ("max_hits", ctypes.c_int), ("scale", ctypes.c_float)]


@functools.cache
def _launcher():
    fn = _build.library()[0].slamnet_obstacle
    fn.argtypes = [ctypes.c_void_p] * 5 + [_ObstacleParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_obstacle_inputs(obstacle_map: torch.Tensor, size: int,
                          points: torch.Tensor, valid: torch.Tensor,
                          pose: torch.Tensor) -> int:
    """Raise ValueError unless K7 takes the inputs: contiguous i8[size,
    size] map, f32[N, 2] points, bool[N] valid and f32[3] pose on one
    device.  Returns N."""
    n = points.shape[0] if points.dim() == 2 else -1
    _build.check_tensors("K7 obstacle map", obstacle_map.device, (
        ("obstacle_map", obstacle_map, torch.int8, (size, size)),
        ("points", points, torch.float32, (n, 2)),
        ("valid", valid, torch.bool, (n,)),
        ("pose", pose, torch.float32, (3,))))
    return n


def update_obstacle_map(obstacle_map: torch.Tensor, size: int, scale: float,
                        points: torch.Tensor, valid: torch.Tensor,
                        pose: torch.Tensor, max_hits: int) -> torch.Tensor:
    """One scan's line update of the i8[size, size] map (row-major y, x);
    returns the new map and leaves ``obstacle_map`` as it was.  CPU tensors
    take ``update_obstacle_map_plain``; CUDA tensors K7's obstacle launch
    on the current stream (no host read), or a ValueError for inputs it
    does not take."""
    if obstacle_map.device.type == "cpu":
        return update_obstacle_map_plain(obstacle_map, size, scale, points,
                                         valid, pose, max_hits)
    n = check_obstacle_inputs(obstacle_map, size, points, valid, pose)
    dev = obstacle_map.device
    out = torch.empty((size, size), dtype=torch.int8, device=dev)
    _build.launch("K7 obstacle map", _launcher(), dev, obstacle_map.data_ptr(),
                  out.data_ptr(), points.data_ptr(), valid.data_ptr(),
                  pose.data_ptr(), _ObstacleParams(size, n, max_hits, scale),
                  kernel="K7_obstacle")
    return out


def update_obstacle_map_plain(obstacle_map: torch.Tensor, size: int,
                              scale: float, points: torch.Tensor,
                              valid: torch.Tensor, pose: torch.Tensor,
                              max_hits: int) -> torch.Tensor:
    """K7's obstacle launch's plain version: the closed-form walk
    (``rosetta_line_cells``), the hits' ``index_add_``, the marks'
    ``scatter_reduce`` and ``_apply``; any device."""
    f = pose_frame(pose, size, scale)
    x1c = f.x1.clamp(0, size - 1)
    y1c = f.y1.clamp(0, size - 1)
    x2 = csharp_trunc(f.px + f.c * points[:, 0] - f.s * points[:, 1])
    y2 = csharp_trunc(f.py + f.s * points[:, 0] + f.c * points[:, 1])
    begin = torch.stack([torch.zeros_like(x2) + x1c,
                         torch.zeros_like(y2) + y1c], dim=1)
    cells, _, end_ok = rosetta_line_cells(begin, torch.stack([x2, y2], dim=1),
                                          size, max_steps=2 * size)

    cmask = cells.mask & valid[:, None]
    traversed = torch.zeros(size * size, dtype=torch.int32,
                            device=x2.device).scatter_reduce(
        0, torch.where(cmask, cells.flat, torch.zeros_like(cells.flat))
        .reshape(-1).long(), cmask.reshape(-1).to(torch.int32), "amax") > 0
    return _apply(obstacle_map, _hits(x2, y2, end_ok & valid, size),
                  traversed, max_hits, f.robot_in)


def update_obstacle_map_dense(obstacle_map: torch.Tensor, size: int,
                              scale: float, points: torch.Tensor,
                              valid: torch.Tensor, pose: torch.Tensor,
                              max_hits: int,
                              angle_bins: int = 256) -> torch.Tensor:
    """The scatter-free update: the endpoint hits as in the line mode, the
    traversed region as a dense polar test (strictly before the endpoint
    cell: the looked-up range less 0.5)."""
    f = pose_frame(pose, size, scale)
    x2p = f.c * points[:, 0] - f.s * points[:, 1]
    y2p = f.s * points[:, 0] + f.c * points[:, 1]
    x2 = csharp_trunc(f.px + x2p)
    y2 = csharp_trunc(f.py + y2p)
    dist = sqrt_rn(x2p * x2p + y2p * y2p)
    beam_ok = valid & (dist > 1e-6)
    end_ok = (x2 >= 0) & (x2 < size) & (y2 >= 0) & (y2 < size) & valid

    table = min_range_table(x2p, y2p, dist, beam_ok, angle_bins)
    r_c, r_m = cell_ranges(f, size, table, angle_bins)
    traversed = (r_c < r_m - 0.5).reshape(-1)
    return _apply(obstacle_map, _hits(x2, y2, end_ok, size), traversed,
                  max_hits, f.robot_in)
