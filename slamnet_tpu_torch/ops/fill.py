"""K2: the dense polar occupancy fill of all pyramid levels (``csrc/fill.cu``),
for one robot or a fleet.

Replaces ``slamnet_tpu/ops/pallas_fill.py::polar_fill_pallas`` (with the
beam-side prolog of ``update_occupancy_dense_pallas``).  ``update_maps``
applies one scan to every level of the concatenated pyramid ``maps`` IN
PLACE, gated by the device-side flag ``do_update`` (the JAX pipeline's
``lax.cond`` at ``models/hector.py:324``); ``update_maps_batch`` does the
same for a fleet's flat f32[B*C] maps, instance b gated by ``fire[b]`` (the
fleet's scan-over-instances ``lax.cond``, ``models/fleet.py:244-266``).  One
launch a scan or batch-scan, the single robot being the batch of one, and
the host never waits.

The launch is a work list on the device: ``grid_size`` blocks, from B and
the card's SM count, rank the firing instances themselves and split the
(firing instance, level, tile of ``TILE`` cells) items between them in
contiguous, even shares; ``tile_starts`` numbers an instance's
tiles level by level.  Bin tables and occupied marks live in each block's
shared memory, so K2 uses no global scratch.  K4 (``ops/line.py``) takes
the same arguments and the same work list.

``update_maps_batch_plain`` is the plain version: the ported
``ops/logodds.py::update_occupancy_dense`` applied per level, vectorized over
the instance axis; ``update_maps_plain`` is its one-robot case.  The wrappers
run it for CPU tensors only; for CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import HectorConfig
from . import _build
from .logodds import update_occupancy_dense

MAX_LEVELS = 4
MAX_BATCH = 65535         # instances a launch
ANGLE_BINS = 256          # logodds.update_occupancy_dense's default
TILE = 1536               # cells a work item (csrc/fill.cu kTile)
BLOCKS_PER_SM = 4         # blocks a launch gives each SM at most


class _FillParams(ctypes.Structure):
    """``struct FillParams`` of csrc/fill.cu, passed by value."""

    _fields_ = [("num_levels", ctypes.c_int), ("n", ctypes.c_int),
                ("cells", ctypes.c_int), ("batch", ctypes.c_int),
                ("grid", ctypes.c_int),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("tile_start", ctypes.c_int * (MAX_LEVELS + 1)),
                ("scale", ctypes.c_float * MAX_LEVELS),
                ("lof", ctypes.c_float), ("loo", ctypes.c_float),
                ("cap", ctypes.c_float), ("margin", ctypes.c_float)]


def tile_starts(level_sizes) -> list[int]:
    """An instance's work items level by level: level l's tiles of ``TILE``
    cells are items ``[starts[l], starts[l+1])``, tile k covering the
    level's cells ``[k*TILE, min((k+1)*TILE, w*w))``."""
    starts = [0]
    for w in level_sizes:
        starts.append(starts[-1] + -(-w * w // TILE))
    return starts


def grid_size(batch: int, items_per_instance: int, sms: int,
              blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Blocks of a launch: one an SM a robot, up to ``blocks_per_sm`` an SM,
    and no more than B instances have items; never a function of how many
    fire.  Every block costs its dispatch on every call, firing or not, so
    one robot (gated off on most scans) gets one block an SM."""
    return max(1, min(batch * items_per_instance,
                      min(batch, blocks_per_sm) * sms))


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _params(cfg: HectorConfig, n: int, batch: int, sms: int) -> _FillParams:
    nl = cfg.num_levels
    pad = [0] * (MAX_LEVELS - nl)
    starts = tile_starts(cfg.level_sizes)
    return _FillParams(
        nl, n, cfg.total_cells, batch, grid_size(batch, starts[-1], sms),
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
    fn.argtypes = [ctypes.c_void_p] * 6 + [_FillParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_levels(cfg: HectorConfig, kernel: str = "K2") -> None:
    if not 1 <= cfg.num_levels <= MAX_LEVELS:
        raise ValueError(f"{kernel} takes 1..{MAX_LEVELS} levels, got "
                         f"{cfg.num_levels}")


def _launch(what: str, maps, points, valid, poses, scan_poses, fire,
            cfg: HectorConfig, batch: int) -> None:
    dev = maps.device
    _build.launch(what, _launcher(), dev, maps.data_ptr(), points.data_ptr(),
                  valid.data_ptr(), poses.data_ptr(), scan_poses.data_ptr(),
                  fire.data_ptr(),
                  _params(cfg, points.shape[-2], batch, sm_count(dev.index)))


def update_maps(maps: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                pose: torch.Tensor, scan_pose: torch.Tensor,
                do_update: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """Dense-fill every level of ``maps`` f32[total_cells] in place with the
    scan (``points`` f32[N, 2], ``valid`` bool[N], cloud pose ``scan_pose``
    f32[3]) seen from ``pose`` f32[3] (world), where the 0-dim bool
    ``do_update`` is set.  Returns ``maps``."""
    _check_levels(cfg)
    if maps.device.type == "cpu":
        return maps.copy_(update_maps_plain(maps, points, valid, pose,
                                            scan_pose, do_update, cfg))
    n = points.shape[0]
    _build.check_tensors("K2", maps.device, (
        ("maps", maps, torch.float32, (cfg.total_cells,)),
        ("points", points, torch.float32, (n, 2)),
        ("valid", valid, torch.bool, (n,)),
        ("pose", pose, torch.float32, (3,)),
        ("scan_pose", scan_pose, torch.float32, (3,)),
        ("do_update", do_update, torch.bool, ())))
    if n < 1:
        raise ValueError("K2 needs at least one beam")
    _launch("K2 fill", maps, points, valid, pose, scan_pose, do_update, cfg, 1)
    update_maps.launches += 1
    return maps


update_maps.launches = 0


def check_update_inputs(kernel: str, maps: torch.Tensor, points: torch.Tensor,
                        valid: torch.Tensor, poses: torch.Tensor,
                        scan_poses: torch.Tensor, fire: torch.Tensor,
                        cfg: HectorConfig) -> int:
    """Raise ValueError, naming ``kernel``, unless the fleet inputs fit a
    batched map update (K2 here, K4 in ``ops/line.py``): contiguous maps
    f32[B*C], points f32[B, N, 2] with N >= 1, valid
    bool[B, N], poses and scan_poses f32[B, 3], fire bool[B] on one device.
    Returns B."""
    _check_levels(cfg, kernel)
    if points.dim() != 3 or points.shape[1] < 1:
        raise ValueError(f"{kernel} points: want [B, N >= 1, 2], got "
                         f"{tuple(points.shape)}")
    b, n = points.shape[:2]
    if b > MAX_BATCH:
        raise ValueError(f"{kernel} takes at most {MAX_BATCH} instances, got {b}")
    cells = b * cfg.total_cells
    _build.check_tensors(kernel, maps.device, (
        ("maps", maps, torch.float32, (cells,)),
        ("points", points, torch.float32, (b, n, 2)),
        ("valid", valid, torch.bool, (b, n)),
        ("poses", poses, torch.float32, (b, 3)),
        ("scan_poses", scan_poses, torch.float32, (b, 3)),
        ("fire", fire, torch.bool, (b,))))
    return b


def update_maps_batch(maps: torch.Tensor, points: torch.Tensor,
                      valid: torch.Tensor, poses: torch.Tensor,
                      scan_poses: torch.Tensor, fire: torch.Tensor,
                      cfg: HectorConfig) -> torch.Tensor:
    """Dense-fill every level of every firing instance of the fleet table
    ``maps`` f32[B*C] in place: instance b with its scan (``points[b]``,
    ``valid[b]``, cloud pose ``scan_poses[b]``) seen from ``poses[b]``
    (world), where the device flag ``fire[b]`` is set; the other instances'
    maps stay as they are, bit for bit.  Returns ``maps``."""
    b = check_update_inputs("K2 batch", maps, points, valid, poses,
                            scan_poses, fire, cfg)
    if maps.device.type == "cpu":
        return maps.copy_(update_maps_batch_plain(maps, points, valid, poses,
                                                  scan_poses, fire, cfg))
    _launch("K2 fill_batch", maps, points, valid, poses, scan_poses, fire,
            cfg, b)
    update_maps_batch.launches += 1
    return maps


update_maps_batch.launches = 0


def update_maps_plain(maps: torch.Tensor, points: torch.Tensor,
                      valid: torch.Tensor, pose: torch.Tensor,
                      scan_pose: torch.Tensor, do_update: torch.Tensor,
                      cfg: HectorConfig) -> torch.Tensor:
    """K2's plain version: a new f32[total_cells] with every level updated
    (MapRepMultiMap.UpdateByScan, MapRepMultiMap.cs:73-77) where
    ``do_update`` is set, ``maps`` unchanged otherwise."""
    return update_maps_batch_plain(maps, points[None], valid[None], pose[None],
                                   scan_pose[None], do_update.reshape(1), cfg)


def update_maps_batch_plain(maps: torch.Tensor, points: torch.Tensor,
                            valid: torch.Tensor, poses: torch.Tensor,
                            scan_poses: torch.Tensor, fire: torch.Tensor,
                            cfg: HectorConfig) -> torch.Tensor:
    """The batched K2's plain version: a new f32[B*C] with every level of
    instance b updated where ``fire[b]`` is set and left as it was
    otherwise; each instance as ``update_maps_plain`` computes it."""
    b = points.shape[0]
    grids = maps.view(b, cfg.total_cells)
    out = []
    for level in range(cfg.num_levels):
        w = cfg.level_sizes[level]
        off = cfg.level_offsets[level]
        out.append(update_occupancy_dense(
            grids[:, off:off + w * w], w, points, valid, poses,
            scan_poses[:, :2], 1.0 / cfg.level_resolutions[level],
            cfg.log_odds_free, cfg.log_odds_occupied, cfg.occupied_cap,
            ANGLE_BINS, cfg.dense_free_margin_px))
    return torch.where(fire[:, None], torch.cat(out, dim=1), grids).reshape(-1)
