"""Hole-map scan update: CoreSLAM's map, line and dense.

Port of ``slamnet_tpu/ops/holemap.py``: UpdateHoleMap + DrawLaserRayOnHoleMap
(CoreSLAMProcessor.cs:496-534, 359-443).  Each beam is alpha-blended along a
Bresenham walk with a V-shaped value profile: free space at TS_NO_OBSTACLE
ramping down into the "hole" at the measured hit.

- ``update_hole_map`` (the parity mode's line update): for a CUDA tensor
  K7's walk and blend (``csrc/coreslam_map.cu``, two launches, bit for bit
  ``update_hole_map_plain``); for a CPU tensor ``update_hole_map_plain``:
  the walk and profile from ``ops/rasterize.hole_ray_cells``, then the
  per-pixel blend
  ``p' = ((256 - a) p + a v) >> 8`` of every visit composed as
  ``floor(beta^k (p - v_bar) + v_bar)`` with beta = (256 - a) / 256, the
  visit count k and the visits' mean value v_bar from two int32
  ``index_add_``s (int32 sums are exact, so the order of the adds does not
  matter).  Exact for a pixel visited once; JAX's documented bounded
  divergence for multi-visit pixels (``slamnet_tpu/ops/holemap.py:12-23``).
  beta^k is evaluated in float64 and rounded once to f32: JAX's f32 ``pow``
  gives the same value below k = 331.
- ``update_hole_map_dense`` (the production mode's fill): the V-profile as a
  dense polar field around the robot: a ``angle_bins`` min-range table
  (``scatter_reduce`` "amin") and one blend a cell.  The table's lookup keeps
  the value JAX's one-hot bf16 matmul gives (``_onehot_lookup``, :93-128):
  ranges quantized to 1/4096 of a pixel in [-1024, 3072), "no beam" as
  -1024.  The port computes each bin's quantized value once, with JAX's
  expression, and gathers it.
- ``update_hole_map_sequential_blend``: the beams composed one at a time
  with the reference's integer blend (the bit-exact oracle; tests only).

Transcendentals and roots are rounded once from float64
(``core/geometry.py``) and divisions by Python numbers are true divisions,
so the CPU and the card snap the same pixels.  The dense fill and the
sequential blend are torch operators on the tensors' device; the line
update's kernel replaces no TPU kernel (the JAX package runs this in XLA).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..core.geometry import (atan2_rn, cos_rn, csharp_trunc, sin_rn, sqrt_rn,
                             true_div)
from . import _build
from .rasterize import hole_ray_cells

TS_NO_OBSTACLE = 65500
TS_OBSTACLE = 0
_LOOKUP_SHIFT = 1024.0      # the lookup admits values in [-1024, 3072)
_LOOKUP_K = 4096.0          # quantized to 1/4096 of a unit
_NO_BEAM = 1e9              # the min-range table's empty-bin value


class PoseFrame(NamedTuple):
    """A pose in map pixels: the +0.5-biased position, the scaled rotation,
    the robot pixel (C# truncation) and whether it lies in the map."""
    px: torch.Tensor
    py: torch.Tensor
    c: torch.Tensor
    s: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    robot_in: torch.Tensor


def pose_frame(pose: torch.Tensor, size: int, scale: float) -> PoseFrame:
    """UpdateHoleMap's / UpdateObstacleMap's pose geometry
    (CoreSLAMProcessor.cs:498-512, 540-560)."""
    px = pose[0] * scale + 0.5
    py = pose[1] * scale + 0.5
    x1, y1 = csharp_trunc(px), csharp_trunc(py)
    return PoseFrame(px, py, cos_rn(pose[2]) * scale, sin_rn(pose[2]) * scale,
                     x1, y1, (x1 >= 0) & (x1 < size) & (y1 >= 0) & (y1 < size))


def _rays(size, scale, points, valid, pose, hole_width):
    """The line modes' rays: the robot pixel (clamped; the caller gates on
    ``robot_in``), each beam's hit pixel and its endpoint extended by
    hole_width / 2 past the hit (:513-530), walked by hole_ray_cells."""
    f = pose_frame(pose, size, scale)
    x1c = f.x1.clamp(0, size - 1)
    y1c = f.y1.clamp(0, size - 1)
    x2p = f.c * points[:, 0] - f.s * points[:, 1]
    y2p = f.s * points[:, 0] + f.c * points[:, 1]
    xp = csharp_trunc(f.px + x2p)
    yp = csharp_trunc(f.py + y2p)
    dist = sqrt_rn(x2p * x2p + y2p * y2p)
    beam_ok = valid & (dist > 1e-6)
    add = true_div(hole_width * scale / 2.0, dist.clamp(min=1e-6))
    x2 = csharp_trunc(f.px + x2p * (1.0 + add))
    y2 = csharp_trunc(f.py + y2p * (1.0 + add))
    rays = hole_ray_cells(x1c, y1c, x2, y2, xp, yp, TS_OBSTACLE,
                          TS_NO_OBSTACLE, size, max_steps=size)
    return rays, rays.mask & beam_ok[:, None], f.robot_in


class _HoleParams(ctypes.Structure):
    """``struct HoleParams`` of csrc/coreslam_map.cu, passed by value."""

    _fields_ = [("size", ctypes.c_int), ("n", ctypes.c_int),
                ("scale", ctypes.c_float), ("half", ctypes.c_float)]


@functools.cache
def _launchers():
    lib = _build.library()[0]
    walk, blend = lib.slamnet_hole_walk, lib.slamnet_hole_blend
    walk.argtypes = [ctypes.c_void_p] * 4 + [_HoleParams, ctypes.c_void_p]
    blend.argtypes = [ctypes.c_void_p] * 5 + [_HoleParams, ctypes.c_void_p]
    walk.restype = blend.restype = ctypes.c_int
    return walk, blend


@functools.cache
def _visits(device: torch.device, cells: int) -> torch.Tensor:
    """K7's scratch on ``device``: a u64 a pixel (visits and value sum), all
    0 between launches (the blend leaves it so).  One a device and map
    size: the walk and blend of a scan run on one stream, so two maps of a
    size on one device updated from two streams at once would share it."""
    return torch.zeros(cells, dtype=torch.int64, device=device)


@functools.cache
def decay_table(quality: int, n: int, device: torch.device) -> torch.Tensor:
    """f32[n + 1]: beta^k for k = 0..n visits, beta = (256 - quality) / 256,
    by ``blend_visits``'s own float64 ``pow`` rounded once to f32 (a beam
    visits a pixel at most once, so a scan of n beams needs k <= n)."""
    beta = torch.full((), (256.0 - quality) / 256.0, dtype=torch.float64,
                      device=device)
    return torch.pow(beta, torch.arange(n + 1, dtype=torch.float64,
                                        device=device)).to(torch.float32)


def check_hole_inputs(hole_map_flat: torch.Tensor, size: int,
                      points: torch.Tensor, valid: torch.Tensor,
                      pose: torch.Tensor) -> int:
    """Raise ValueError unless K7 takes the inputs: contiguous i32[size^2]
    map, f32[N, 2] points, bool[N] valid and f32[3] pose on one device.
    Returns N."""
    n = points.shape[0] if points.dim() == 2 else -1
    _build.check_tensors("K7 hole map", hole_map_flat.device, (
        ("hole_map", hole_map_flat, torch.int32, (size * size,)),
        ("points", points, torch.float32, (n, 2)),
        ("valid", valid, torch.bool, (n,)),
        ("pose", pose, torch.float32, (3,))))
    return n


def update_hole_map(hole_map_flat: torch.Tensor, size: int, scale: float,
                    points: torch.Tensor, valid: torch.Tensor,
                    pose: torch.Tensor, hole_width: float,
                    quality: int) -> torch.Tensor:
    """One scan's line update at ``pose``; returns the new i32[size*size]
    map and leaves ``hole_map_flat`` as it was.  A robot pixel outside the
    map skips the update (:509-512).  CPU tensors take
    ``update_hole_map_plain``; CUDA tensors K7's two launches on the
    current stream (no host read: the robot's gate is read on the card),
    or a ValueError for inputs it does not take."""
    if hole_map_flat.device.type == "cpu":
        return update_hole_map_plain(hole_map_flat, size, scale, points,
                                     valid, pose, hole_width, quality)
    n = check_hole_inputs(hole_map_flat, size, points, valid, pose)
    dev = hole_map_flat.device
    out = torch.empty(size * size, dtype=torch.int32, device=dev)
    acc = _visits(dev, size * size)
    params = _HoleParams(size, n, scale, hole_width * scale / 2.0)
    walk, blend = _launchers()
    _build.launch("K7 hole walk", walk, dev, acc.data_ptr(),
                  points.data_ptr(), valid.data_ptr(), pose.data_ptr(), params,
                  kernel="K7_hole_walk")
    _build.launch("K7 hole blend", blend, dev, hole_map_flat.data_ptr(),
                  out.data_ptr(), acc.data_ptr(),
                  decay_table(quality, n, dev).data_ptr(), pose.data_ptr(),
                  params, kernel="K7_hole_blend")
    return out


def update_hole_map_plain(hole_map_flat: torch.Tensor, size: int,
                          scale: float, points: torch.Tensor,
                          valid: torch.Tensor, pose: torch.Tensor,
                          hole_width: float, quality: int) -> torch.Tensor:
    """K7's plain version: the closed-form walk (``hole_ray_cells``), two
    int32 ``index_add_``s and ``blend_visits``; any device."""
    rays, mask, robot_in = _rays(size, scale, points, valid, pose,
                                 hole_width)
    flat = torch.where(mask, rays.flat, torch.zeros_like(rays.flat))
    idx = flat.reshape(-1).long()
    ncells = size * size
    visits = torch.zeros(ncells, dtype=torch.int32,
                         device=flat.device).index_add_(
        0, idx, mask.reshape(-1).to(torch.int32))
    pixv = torch.where(mask, rays.pixval, torch.zeros_like(rays.pixval))
    vsum = torch.zeros(ncells, dtype=torch.int32,
                       device=flat.device).index_add_(0, idx, pixv.reshape(-1))
    return torch.where(robot_in, blend_visits(hole_map_flat, visits, vsum,
                                              quality), hole_map_flat)


def blend_visits(hole: torch.Tensor, visits: torch.Tensor, vsum: torch.Tensor,
                 quality: int) -> torch.Tensor:
    """Every visited pixel's composed blend ``floor(beta^k (p - v_bar) +
    v_bar)`` from its visit count ``visits`` and value sum ``vsum`` (i32,
    shaped as ``hole``); unvisited pixels unchanged."""
    vbar = vsum.to(torch.float32) / visits.clamp(min=1).to(torch.float32)
    beta = (256.0 - quality) / 256.0
    decay = torch.pow(torch.full((), beta, dtype=torch.float64,
                                 device=hole.device),
                      visits.to(torch.float64)).to(torch.float32)
    old = hole.to(torch.float32)
    blended = torch.floor(decay * (old - vbar) + vbar).to(torch.int32)
    return torch.where(visits > 0, blended, hole)


def lookup_values(table: torch.Tensor) -> torch.Tensor:
    """The value JAX's one-hot lookup (``_onehot_lookup``) returns for each
    entry of the f32 ``table``: quantized to 1/4096 in [-1024, 3072) as
    three 8-bit slices, recombined in f32 in JAX's order (exact: the
    quantum and the shift are powers of two)."""
    q = ((table + _LOOKUP_SHIFT) * _LOOKUP_K).clamp(0.0, 2.0 ** 24 - 1).to(
        torch.int32)
    s0 = (q >> 16).to(torch.float32)
    s1 = ((q >> 8) & 255).to(torch.float32)
    s2 = (q & 255).to(torch.float32)
    return (s0 * (65536.0 / _LOOKUP_K) + s1 * (256.0 / _LOOKUP_K)
            + s2 * (1.0 / _LOOKUP_K) - _LOOKUP_SHIFT)


def _bins(y: torch.Tensor, x: torch.Tensor, angle_bins: int) -> torch.Tensor:
    """The polar sector of direction (x, y): ``((atan2 + pi) * bins / 2pi)``
    truncated, clipped to the table."""
    return ((atan2_rn(y, x) + math.pi) * (angle_bins / (2.0 * math.pi))).to(
        torch.int32).clamp(0, angle_bins - 1)


def min_range_table(x2p: torch.Tensor, y2p: torch.Tensor, dist: torch.Tensor,
                    beam_ok: torch.Tensor, angle_bins: int) -> torch.Tensor:
    """f32[angle_bins]: the shortest beam of each sector (scatter_reduce
    "amin"), -1e9 where no beam falls (the dense fills' "not covered")."""
    bins = _bins(y2p, x2p, angle_bins)
    big = torch.full_like(dist, _NO_BEAM)
    table = torch.full((angle_bins,), _NO_BEAM, dtype=torch.float32,
                       device=dist.device).scatter_reduce(
        0, torch.where(beam_ok, bins, torch.zeros_like(bins)).long(),
        torch.where(beam_ok, dist, big), "amin")
    return torch.where(table < _NO_BEAM, table, -table)


def cell_ranges(f: PoseFrame, size: int, table: torch.Tensor,
                angle_bins: int, r0: int = 0, rows: int | None = None):
    """Every cell's distance from the robot (cell centres at +0.5) and its
    sector's looked-up beam range, both f32[rows, size], for the map rows
    [r0, r0 + rows) (default all)."""
    rows = size if rows is None else rows
    ii = torch.arange(size, dtype=torch.float32, device=table.device)
    yy = torch.arange(r0, r0 + rows, dtype=torch.float32, device=table.device)
    dx = (ii + 0.5)[None, :] - f.px
    dy = (yy + 0.5)[:, None] - f.py
    dx, dy = dx.expand(rows, size), dy.expand(rows, size)
    r_c = sqrt_rn(dx * dx + dy * dy)
    r_m = lookup_values(table)[_bins(dy, dx, angle_bins).long()]
    return r_c, r_m


def update_hole_map_dense(hole_map_flat: torch.Tensor, size: int,
                          scale: float, points: torch.Tensor,
                          valid: torch.Tensor, pose: torch.Tensor,
                          hole_width: float, quality: int,
                          angle_bins: int = 256, r0: int = 0,
                          rows: int | None = None) -> torch.Tensor:
    """The scatter-free update: every cell nearer than its sector's beam
    plus hole_width / 2 blends once with the V-profile's value at its range
    (``v = NO_OBSTACLE`` short of the hit, ramping to ``OBSTACLE`` at it and
    back at the extended end).  JAX's documented divergence from the line
    mode (``slamnet_tpu/ops/holemap.py:149-157``).  With ``rows``,
    ``hole_map_flat`` holds only the map rows [r0, r0 + rows) (a row tile:
    each cell's update depends on nothing but the replicated range table)."""
    rows = size if rows is None else rows
    f = pose_frame(pose, size, scale)
    x2p = f.c * points[:, 0] - f.s * points[:, 1]
    y2p = f.s * points[:, 0] + f.c * points[:, 1]
    dist = sqrt_rn(x2p * x2p + y2p * y2p)
    beam_ok = valid & (dist > 1e-6)
    hw2 = hole_width * scale / 2.0          # the hole's half-width, pixels

    table = min_range_table(x2p, y2p, dist, beam_ok, angle_bins)
    r_c, r_m = cell_ranges(f, size, table, angle_bins, r0, rows)
    covered = r_c < r_m + hw2
    ramp = (1.0 - true_div((r_c - r_m).abs(), max(hw2, 1e-6))).clamp(0.0, 1.0)
    v = TS_NO_OBSTACLE + (TS_OBSTACLE - TS_NO_OBSTACLE) * ramp

    old = hole_map_flat.view(rows, size)
    blended = torch.div((256 - quality) * old + quality * v.to(torch.int32),
                        256, rounding_mode="floor")
    new = torch.where(covered, blended, old).reshape(-1)
    return torch.where(f.robot_in, new, hole_map_flat)


def update_hole_map_sequential_blend(hole_map_flat: torch.Tensor, size: int,
                                     scale: float, points: torch.Tensor,
                                     valid: torch.Tensor, pose: torch.Tensor,
                                     hole_width: float,
                                     quality: int) -> torch.Tensor:
    """The line update's geometry with the beams composited one at a time in
    order by the reference's integer blend: the bit-exact oracle of the
    composed update (tests only; a Python loop over beams)."""
    rays, mask, robot_in = _rays(size, scale, points, valid, pose,
                                 hole_width)
    out = hole_map_flat.clone()
    for b in range(rays.flat.shape[0]):
        idx = rays.flat[b][mask[b]].long()
        newv = torch.div((256 - quality) * out[idx]
                         + quality * rays.pixval[b][mask[b]], 256,
                         rounding_mode="floor")
        out[idx] = newv
    return torch.where(robot_in, out, hole_map_flat)
