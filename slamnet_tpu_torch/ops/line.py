"""K4: the line-mode (Bresenham) occupancy update of all pyramid levels
(``csrc/line.cu``), for one robot or a fleet.

Replaces ``slamnet_tpu/ops/pallas_scatter.py::occupancy_scatter_pallas``
with the free-cell and endpoint lists its caller builds: ``update_maps_line``
applies one scan to every level of the concatenated pyramid ``maps`` IN
PLACE as ``slamnet_tpu/ops/logodds.py::update_occupancy`` computes it, gated
by the device-side flag ``do_update`` (the JAX pipeline's ``lax.cond`` at
``models/hector.py:324``, with ``dense_free_fill=False``);
``update_maps_line_batch`` does the same for a fleet's flat f32[B*C] maps,
instance b gated by ``fire[b]``.  Two launches a scan or batch-scan, the
single robot being the batch of one, and the host never waits.  The
arguments are ``ops/fill.py``'s.

``marks`` u8 (one byte a cell) is the kernel's scratch: all zero between
scans (launch A writes a firing instance's free and occupied marks, launch B
applies and clears them).

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

import torch

from ..core.config import HectorConfig
from . import _build
from .fill import MAX_LEVELS, check_update_inputs
from .logodds import update_occupancy


class _LineParams(ctypes.Structure):
    """``struct LineParams`` of csrc/line.cu, passed by value."""

    _fields_ = [("num_levels", ctypes.c_int), ("n", ctypes.c_int),
                ("cells", ctypes.c_int), ("batch", ctypes.c_int),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("lof", ctypes.c_float), ("loo", ctypes.c_float),
                ("cap", ctypes.c_float)]


@functools.cache
def _params(cfg: HectorConfig, n: int, batch: int) -> _LineParams:
    pad = [0] * (MAX_LEVELS - cfg.num_levels)
    return _LineParams(
        cfg.num_levels, n, cfg.total_cells, batch,
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_sizes, *pad),
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_offsets, *pad),
        (ctypes.c_float * MAX_LEVELS)(
            *[1.0 / r for r in cfg.level_resolutions], *pad),
        cfg.log_odds_free, cfg.log_odds_occupied, cfg.occupied_cap)


@functools.cache
def _launcher():
    lib = _build.library()[0]
    fn = lib.slamnet_line
    fn.argtypes = [ctypes.c_void_p] * 7 + [_LineParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(what: str, maps, marks, points, valid, poses, scan_poses, fire,
            cfg: HectorConfig, batch: int) -> None:
    code = _launcher()(maps.data_ptr(), marks.data_ptr(), points.data_ptr(),
                       valid.data_ptr(), poses.data_ptr(),
                       scan_poses.data_ptr(), fire.data_ptr(),
                       _params(cfg, points.shape[-2], batch),
                       _build.stream_handle(maps.device))
    _build.raise_on_error(code, what)


def update_maps_line(maps: torch.Tensor, marks: torch.Tensor,
                     points: torch.Tensor, valid: torch.Tensor,
                     pose: torch.Tensor, scan_pose: torch.Tensor,
                     do_update: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """Line-update every level of ``maps`` f32[total_cells] in place with the
    scan (``points`` f32[N, 2], ``valid`` bool[N], cloud pose ``scan_pose``
    f32[3]) seen from ``pose`` f32[3] (world), where the 0-dim bool
    ``do_update`` is set.  Returns ``maps``."""
    check_update_inputs("K4", maps, marks, points[None], valid[None],
                        pose[None], scan_pose[None], do_update.reshape(1), cfg)
    if maps.device.type == "cpu":
        return maps.copy_(update_maps_line_plain(maps, points, valid, pose,
                                                 scan_pose, do_update, cfg))
    _launch("K4 line", maps, marks, points, valid, pose, scan_pose, do_update,
            cfg, 1)
    update_maps_line.launches += 1
    return maps


update_maps_line.launches = 0


def update_maps_line_batch(maps: torch.Tensor, marks: torch.Tensor,
                           points: torch.Tensor, valid: torch.Tensor,
                           poses: torch.Tensor, scan_poses: torch.Tensor,
                           fire: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """Line-update every level of every firing instance of the fleet table
    ``maps`` f32[B*C] in place: instance b with its scan (``points[b]``,
    ``valid[b]``, cloud pose ``scan_poses[b]``) seen from ``poses[b]``
    (world), where the device flag ``fire[b]`` is set; the other instances'
    maps stay as they are, bit for bit.  Returns ``maps``."""
    b = check_update_inputs("K4 batch", maps, marks, points, valid, poses,
                            scan_poses, fire, cfg)
    if maps.device.type == "cpu":
        return maps.copy_(update_maps_line_batch_plain(
            maps, points, valid, poses, scan_poses, fire, cfg))
    _launch("K4 line_batch", maps, marks, points, valid, poses, scan_poses,
            fire, cfg, b)
    update_maps_line_batch.launches += 1
    return maps


update_maps_line_batch.launches = 0


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
