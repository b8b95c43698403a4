"""K4: the line-mode (Bresenham) occupancy update of all pyramid levels
(``csrc/line.cu``), for one robot or a fleet.

Replaces ``slamnet_tpu/ops/pallas_scatter.py::occupancy_scatter_pallas``
with the free-cell and endpoint lists its caller builds: ``update_maps_line``
applies one scan to every level of the concatenated pyramid ``maps`` IN
PLACE as ``slamnet_tpu/ops/logodds.py::update_occupancy`` computes it, gated
by the device-side flag ``do_update`` (the JAX pipeline's ``lax.cond`` at
``models/hector.py:324``, with ``dense_free_fill=False``);
``update_maps_line_batch`` does the same for a fleet's flat f32[B*C] maps,
instance b gated by ``fire[b]``.  One launch a scan or batch-scan, the
single robot being the batch of one, and the host never waits.  The
arguments are ``ops/fill.py``'s.

The launch is K2's device work list (``ops/fill.py::grid_size`` blocks, at
most as many an SM as it holds at once, rank the firing instances
themselves and split the items in contiguous, even shares); an item is a
square tile of ``TILE`` x ``TILE`` cells of one level of one firing
instance, numbered row by row and level by level (``tile_starts``).  The marks live in each block's shared memory, so K4
uses no global scratch.  ``tile_walk`` is the kernel's per-(beam, tile)
arithmetic in plain Python, for the tests.

``update_maps_line_batch_plain`` is the plain version: the ported
``ops/logodds.py::update_occupancy`` applied per level, vectorized over the
instance axis; ``update_maps_line_plain`` is its one-robot case.  The
kernel equals it bit for bit.  The wrappers check their inputs on any
device, run the plain version for CPU tensors only, and for CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.config import HectorConfig
from . import _build
from .fill import (BLOCKS_PER_SM, MAX_LEVELS, check_update_inputs, grid_size,
                   sm_count)
from .logodds import update_occupancy

TILE = 45                 # cells a side of a work item (csrc/line.cu kTile)


class _LineParams(ctypes.Structure):
    """``struct LineParams`` of csrc/line.cu, passed by value."""

    _fields_ = [("num_levels", ctypes.c_int), ("n", ctypes.c_int),
                ("cells", ctypes.c_int), ("batch", ctypes.c_int),
                ("grid", ctypes.c_int),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("tiles", ctypes.c_int * MAX_LEVELS),
                ("tile_start", ctypes.c_int * (MAX_LEVELS + 1)),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("lof", ctypes.c_float), ("loo", ctypes.c_float),
                ("cap", ctypes.c_float)]


def tiles_per_side(width: int) -> int:
    return -(-width // TILE)


def tile_starts(level_sizes) -> list[int]:
    """An instance's work items level by level: level l's square tiles are
    items ``[starts[l], starts[l+1])``, tile k of a level of
    ``n = tiles_per_side(w)`` covering columns ``[(k % n)*TILE, ...)`` and
    rows ``[(k // n)*TILE, ...)``, each to ``TILE`` cells or the edge."""
    starts = [0]
    for w in level_sizes:
        starts.append(starts[-1] + tiles_per_side(w) ** 2)
    return starts


@functools.cache
def _params(cfg: HectorConfig, n: int, batch: int, sms: int,
            resident: int) -> _LineParams:
    """The launch's parameters; the grid is K2's, at most ``resident``
    blocks an SM (as many as it holds at once, so no block of a fleet's
    launch waits for another to end before it can rank the flags)."""
    pad = [0] * (MAX_LEVELS - cfg.num_levels)
    starts = tile_starts(cfg.level_sizes)
    return _LineParams(
        cfg.num_levels, n, cfg.total_cells, batch,
        grid_size(batch, starts[-1], sms, resident),
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_sizes, *pad),
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_offsets, *pad),
        (ctypes.c_int * MAX_LEVELS)(
            *[tiles_per_side(w) for w in cfg.level_sizes], *pad),
        (ctypes.c_int * (MAX_LEVELS + 1))(*starts, *pad),
        (ctypes.c_float * MAX_LEVELS)(
            *[1.0 / r for r in cfg.level_resolutions], *pad),
        cfg.log_odds_free, cfg.log_odds_occupied, cfg.occupied_cap)


@functools.cache
def _launcher():
    lib = _build.library()[0]
    fn = lib.slamnet_line
    fn.argtypes = [ctypes.c_void_p] * 6 + [_LineParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _resident() -> int:
    """Blocks of the kernel an SM holds at once, up to BLOCKS_PER_SM."""
    blocks = ctypes.c_int(0)
    _build.raise_on_error(
        _build.library()[0].slamnet_line_blocks_per_sm(ctypes.byref(blocks)),
        "K4 occupancy")
    return max(1, min(blocks.value, BLOCKS_PER_SM))


def _launch(kernel: str, maps, points, valid, poses, scan_poses, fire,
            cfg: HectorConfig, batch: int) -> None:
    """One launch of ``kernel`` (its ``_build.KERNELS`` key)."""
    dev = maps.device
    _build.launch(f"{kernel} line", _launcher(), dev, maps.data_ptr(),
                  points.data_ptr(), valid.data_ptr(), poses.data_ptr(),
                  scan_poses.data_ptr(), fire.data_ptr(),
                  _params(cfg, points.shape[-2], batch, sm_count(dev.index),
                          _resident()), kernel=kernel)


def update_maps_line(maps: torch.Tensor, points: torch.Tensor,
                     valid: torch.Tensor, pose: torch.Tensor,
                     scan_pose: torch.Tensor, do_update: torch.Tensor,
                     cfg: HectorConfig) -> torch.Tensor:
    """Line-update every level of ``maps`` f32[total_cells] in place with the
    scan (``points`` f32[N, 2], ``valid`` bool[N], cloud pose ``scan_pose``
    f32[3]) seen from ``pose`` f32[3] (world), where the 0-dim bool
    ``do_update`` is set.  Returns ``maps``."""
    check_update_inputs("K4", maps, points[None], valid[None], pose[None],
                        scan_pose[None], do_update.reshape(1), cfg)
    if maps.device.type == "cpu":
        return maps.copy_(update_maps_line_plain(maps, points, valid, pose,
                                                 scan_pose, do_update, cfg))
    _launch("K4", maps, points, valid, pose, scan_pose, do_update, cfg, 1)
    return maps


def update_maps_line_batch(maps: torch.Tensor, points: torch.Tensor,
                           valid: torch.Tensor, poses: torch.Tensor,
                           scan_poses: torch.Tensor, fire: torch.Tensor,
                           cfg: HectorConfig) -> torch.Tensor:
    """Line-update every level of every firing instance of the fleet table
    ``maps`` f32[B*C] in place: instance b with its scan (``points[b]``,
    ``valid[b]``, cloud pose ``scan_poses[b]``) seen from ``poses[b]``
    (world), where the device flag ``fire[b]`` is set; the other instances'
    maps stay as they are, bit for bit.  Returns ``maps``."""
    b = check_update_inputs("K4 batch", maps, points, valid, poses,
                            scan_poses, fire, cfg)
    if maps.device.type == "cpu":
        return maps.copy_(update_maps_line_batch_plain(
            maps, points, valid, poses, scan_poses, fire, cfg))
    _launch("K4_batch", maps, points, valid, poses, scan_poses, fire, cfg, b)
    return maps


def update_maps_line_plain(maps: torch.Tensor, points: torch.Tensor,
                           valid: torch.Tensor, pose: torch.Tensor,
                           scan_pose: torch.Tensor, do_update: torch.Tensor,
                           cfg: HectorConfig) -> torch.Tensor:
    """K4's plain version: a new f32[total_cells] with every level updated
    (MapRepMultiMap.UpdateByScan, MapRepMultiMap.cs:73-77) where
    ``do_update`` is set, ``maps`` unchanged otherwise."""
    return update_maps_line_batch_plain(maps, points[None], valid[None],
                                        pose[None], scan_pose[None],
                                        do_update.reshape(1), cfg)


def update_maps_line_batch_plain(maps: torch.Tensor, points: torch.Tensor,
                                 valid: torch.Tensor, poses: torch.Tensor,
                                 scan_poses: torch.Tensor, fire: torch.Tensor,
                                 cfg: HectorConfig) -> torch.Tensor:
    """The batched K4's plain version: a new f32[B*C] with every level of
    instance b updated where ``fire[b]`` is set and left as it was
    otherwise; each instance as ``update_maps_line_plain`` computes it."""
    b = points.shape[0]
    grids = maps.view(b, cfg.total_cells)
    out = []
    for level in range(cfg.num_levels):
        w = cfg.level_sizes[level]
        off = cfg.level_offsets[level]
        out.append(update_occupancy(
            grids[:, off:off + w * w], w, points, valid, poses,
            scan_poses[:, :2], 1.0 / cfg.level_resolutions[level],
            cfg.log_odds_free, cfg.log_odds_occupied, cfg.occupied_cap))
    return torch.where(fire[:, None], torch.cat(out, dim=1), grids).reshape(-1)


class TileWalk(NamedTuple):
    """A beam's free cells in one tile: steps ``k0..k1`` of its walk, the
    walk's error term at ``k0`` (in ``[0, abs_da)``), and the flat map
    cells ``y * width + x`` of those steps."""

    k0: int
    k1: int
    err: int
    cells: list


def tile_walk(begin, end, width: int, x0: int, y0: int,
              tile: int = TILE) -> TileWalk | None:
    """``csrc/line.cu::walk_tile`` in plain Python, for the tests: the free
    cells of the beam ``begin`` -> ``end`` (integer pixel (x, y) pairs,
    begin != end, both in the map) that lie in the tile
    ``[x0, x0 + tile) x [y0, y0 + tile)``, by the closed-form k-interval and
    Bresenham2D's recurrence restarted at its first step; None where the
    walk misses the tile.  Integer division here is on non-negative
    operands only, so C's truncation and Python's floor agree."""
    (bx, by), (ex, ey) = begin, end
    if max(bx, ex) < x0 or min(bx, ex) >= x0 + tile \
            or max(by, ey) < y0 or min(by, ey) >= y0 + tile:
        return None
    dx, dy = ex - bx, ey - by
    sx, sy = (dx > 0) - (dx < 0), (dy > 0) - (dy < 0)
    x_major = abs(dx) >= abs(dy)
    maj, mino = (abs(dx), abs(dy)) if x_major else (abs(dy), abs(dx))
    su, sv = (sx, sy) if x_major else (sy, sx)
    u0, v0 = (bx, by) if x_major else (by, bx)
    ulo, vlo = (x0, y0) if x_major else (y0, x0)
    k0 = max(ulo - u0 if su > 0 else u0 - (ulo + tile - 1), 0)
    k1 = min(ulo + tile - 1 - u0 if su > 0 else u0 - ulo, maj - 1)
    e0 = maj // 2
    if mino > 0:
        mlo = vlo - v0 if sv > 0 else v0 - (vlo + tile - 1)
        mhi = vlo + tile - 1 - v0 if sv > 0 else v0 - vlo
        a = mlo * maj - e0
        if a > 0:
            k0 = max(k0, (a + mino - 1) // mino)
        b = (mhi + 1) * maj - e0 - 1
        if b < 0:
            return None
        k1 = min(k1, b // mino)
    if k0 > k1:
        return None
    num = e0 + k0 * mino
    m = num // maj
    err = num - m * maj
    lu, lv = u0 + k0 * su - ulo, v0 + m * sv - vlo
    cell = lv * tile + lu if x_major else lu * tile + lv
    off_major = su if x_major else su * tile
    off_minor = sv * tile if x_major else sv
    cells, e = [], err
    for _ in range(k0, k1 + 1):
        cells.append((y0 + cell // tile) * width + x0 + cell % tile)
        cell += off_major
        e += mino
        if e >= maj:
            e -= maj
            cell += off_minor
    return TileWalk(k0, k1, err, cells)
