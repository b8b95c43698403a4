"""K2: the dense polar occupancy fill of all pyramid levels (``csrc/fill.cu``).

Replaces ``slamnet_tpu/ops/pallas_fill.py::polar_fill_pallas`` (with the
beam-side prolog of ``update_occupancy_dense_pallas``).  ``update_maps``
applies one scan to every level of the concatenated pyramid ``maps`` IN
PLACE, gated by the device-side flag ``do_update`` (the JAX pipeline's
``lax.cond`` at ``models/hector.py:324``): two launches a scan, and the host
never waits.

``marks`` u8[total_cells] is the kernel's occupied-endpoint scratch: all zero
between scans (launch A sets the marks, launch B reads and clears them).

``update_maps_plain`` is the plain version: the ported
``ops/logodds.py::update_occupancy_dense`` applied per level.  ``update_maps``
runs it for CPU tensors only; for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import HectorConfig
from . import _build
from .logodds import update_occupancy_dense

MAX_LEVELS = 4
ANGLE_BINS = 256          # logodds.update_occupancy_dense's default
CELL_THREADS = 256        # launch B block size (csrc/fill.cu kCellThreads)


class _FillParams(ctypes.Structure):
    """``struct FillParams`` of csrc/fill.cu, passed by value."""

    _fields_ = [("num_levels", ctypes.c_int), ("n", ctypes.c_int),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("block_start", ctypes.c_int * (MAX_LEVELS + 1)),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("lof", ctypes.c_float), ("loo", ctypes.c_float),
                ("cap", ctypes.c_float), ("margin", ctypes.c_float)]


@functools.cache
def _params(cfg: HectorConfig, n: int) -> _FillParams:
    nl = cfg.num_levels
    pad = [0] * (MAX_LEVELS - nl)
    starts = [0]
    for w in cfg.level_sizes:
        starts.append(starts[-1] + -(-w * w // CELL_THREADS))
    return _FillParams(
        nl, n,
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_sizes, *pad),
        (ctypes.c_int * MAX_LEVELS)(*cfg.level_offsets, *pad),
        (ctypes.c_int * (MAX_LEVELS + 1))(*starts, *pad),
        (ctypes.c_float * MAX_LEVELS)(
            *[1.0 / r for r in cfg.level_resolutions], *pad),
        cfg.log_odds_free, cfg.log_odds_occupied, cfg.occupied_cap,
        cfg.dense_free_margin_px)


@functools.cache
def _launcher():
    lib = _build.library()[0]
    fn = lib.slamnet_fill
    fn.argtypes = [ctypes.c_void_p] * 9 + [_FillParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def update_maps(maps: torch.Tensor, marks: torch.Tensor, points: torch.Tensor,
                valid: torch.Tensor, pose: torch.Tensor,
                scan_pose: torch.Tensor, do_update: torch.Tensor,
                cfg: HectorConfig) -> torch.Tensor:
    """Dense-fill every level of ``maps`` f32[total_cells] in place with the
    scan (``points`` f32[N, 2], ``valid`` bool[N], cloud pose ``scan_pose``
    f32[3]) seen from ``pose`` f32[3] (world), where the 0-dim bool
    ``do_update`` is set.  Returns ``maps``."""
    if not 1 <= cfg.num_levels <= MAX_LEVELS:
        raise ValueError(f"K2 takes 1..{MAX_LEVELS} levels, got {cfg.num_levels}")
    if maps.device.type == "cpu":
        return maps.copy_(update_maps_plain(maps, points, valid, pose,
                                            scan_pose, do_update, cfg))
    dev = maps.device
    n = points.shape[0]
    _build.check_tensors("K2", dev, (
        ("maps", maps, torch.float32, (cfg.total_cells,)),
        ("marks", marks, torch.uint8, (cfg.total_cells,)),
        ("points", points, torch.float32, (n, 2)),
        ("valid", valid, torch.bool, (n,)),
        ("pose", pose, torch.float32, (3,)),
        ("scan_pose", scan_pose, torch.float32, (3,)),
        ("do_update", do_update, torch.bool, ())))
    if n < 1:
        raise ValueError("K2 needs at least one beam")
    tables = torch.empty((cfg.num_levels, ANGLE_BINS), dtype=torch.float32,
                         device=dev)
    robot = torch.empty((cfg.num_levels, 4), dtype=torch.int32, device=dev)
    code = _launcher()(maps.data_ptr(), marks.data_ptr(), points.data_ptr(),
                       valid.data_ptr(), pose.data_ptr(), scan_pose.data_ptr(),
                       do_update.data_ptr(), tables.data_ptr(),
                       robot.data_ptr(), _params(cfg, n),
                       _build.stream_handle(dev))
    _build.raise_on_error(code, "K2 fill")
    update_maps.launches += 1
    return maps


update_maps.launches = 0


def update_maps_plain(maps: torch.Tensor, points: torch.Tensor,
                      valid: torch.Tensor, pose: torch.Tensor,
                      scan_pose: torch.Tensor, do_update: torch.Tensor,
                      cfg: HectorConfig) -> torch.Tensor:
    """K2's plain version: a new f32[total_cells] with every level updated
    (MapRepMultiMap.UpdateByScan, MapRepMultiMap.cs:73-77) where
    ``do_update`` is set, ``maps`` unchanged otherwise."""
    out = []
    for level in range(cfg.num_levels):
        w = cfg.level_sizes[level]
        off = cfg.level_offsets[level]
        out.append(update_occupancy_dense(
            maps[off:off + w * w], w, points, valid, pose, scan_pose[:2],
            1.0 / cfg.level_resolutions[level], cfg.log_odds_free,
            cfg.log_odds_occupied, cfg.occupied_cap, ANGLE_BINS,
            cfg.dense_free_margin_px))
    return torch.where(do_update, torch.cat(out), maps)
