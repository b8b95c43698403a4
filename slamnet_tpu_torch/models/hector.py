"""HectorSLAM pipeline: multi-resolution pyramid + coarse-to-fine Gauss-Newton.

Port of ``slamnet_tpu/models/hector.py``: HectorSLAMProcessor +
MapRepMultiMap + ScanMatcher (HectorSLAM/Main/*.cs, Matcher/ScanMatcher.cs).
The state holds one flat f32 table with every pyramid level concatenated,
finest first (``cfg.level_offsets``).  Level i+1 has half the pixels and
twice the cell length of level i (MapRepMultiMap.cs:49-57); every level is
updated from the raw scan.

The configuration picks the kernels (``ops/match.py``, ``ops/fill.py``,
``ops/line.py``):

* matcher: ``matcher_mode`` ``"gather"`` (the default, reference-exact) or
  ``"onehot_highest"`` (bit-identical to it in JAX) -> K3 on the f32 table;
  ``"pallas"`` or ``"onehot_bf16"`` (the serving profile's) -> K1 on the
  bf16-rounded table;
* map update: ``dense_free_fill=False`` (the default, the reference's
  Bresenham lines) -> K4; ``True`` (the dense polar fill) -> K2.

So ``HectorConfig()``'s defaults (the bench's ``fixed`` mode) run K3 + K4
and ``pallas_dense`` runs K1 + K2.  ``early_exit_tol > 0`` stops each
level's GN iterations early, as JAX's while loop does, under K3 and
``"onehot_bf16"``; ``"pallas"`` refuses it with ValueError, as JAX's does.
Other modes and a non-zero ``offset`` raise NotImplementedError.

The entry points (``init``, ``HectorSLAM``) put the state on the card
unless the caller names another device.

One scan costs one match launch, a few small PyTorch operators for the
guards and the motion gate, and one map-update call that reads the gate as
a device flag.  Nothing in ``update`` waits for the device or branches on a
device value.  ``update`` changes ``state.maps`` IN PLACE and returns a
state that shares it (JAX returns a new array).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from ..core.config import HectorConfig
from ..core.geometry import deg_diff, rad_diff
from ..core.scan import Scan
from ..ops import fill, line, match as match_op

# float.MinValue (-3.4028235e38, the f32 lowest): the first squared distance
# to it overflows to +inf in f32, so the first scan always updates the maps
# (HectorSLAMProcessor.cs:66-77, 131-138)
FLOAT_MIN = torch.finfo(torch.float32).min


class HectorState(NamedTuple):
    maps: torch.Tensor              # f32[total_cells], all levels, finest first
    match_pose: torch.Tensor        # f32[3] world
    last_update_pose: torch.Tensor  # f32[3] world


class HectorInfo(NamedTuple):
    map_updated: torch.Tensor       # bool
    residual: torch.Tensor          # mean (1-M(p))^2 at the final GN evaluation
    gn_iterations: torch.Tensor     # i32 GN iterations executed (all levels)
    solve_failures: torch.Tensor    # i32 iterations with a singular H


class MatchStats(NamedTuple):
    residual: torch.Tensor        # f32 mean squared occupancy residual, finest level
    iterations: torch.Tensor      # i32 total GN iterations (all levels)
    solve_failures: torch.Tensor  # i32 iterations where the 3x3 solve failed
    in_map_frac: torch.Tensor     # f32 in-bounds fraction of valid matcher beams


MATCHERS = match_op.F32_MATCHERS + match_op.BF16_MATCHERS


def _check_cfg(cfg: HectorConfig) -> None:
    if cfg.matcher_mode not in MATCHERS or tuple(cfg.offset) != (0.0, 0.0):
        raise NotImplementedError(
            f"slamnet_tpu_torch runs matcher_mode in {MATCHERS} with offset "
            f"(0, 0); got matcher_mode={cfg.matcher_mode!r}, "
            f"offset={cfg.offset}")
    if cfg.early_exit_tol > 0.0 and \
            cfg.matcher_mode not in match_op.EXIT_MATCHERS:
        raise ValueError(
            f"matcher_mode={cfg.matcher_mode!r} runs fixed per-level "
            "iterations, as JAX's does (slamnet_tpu/models/hector.py:172-176); "
            f"early_exit_tol is unsupported (got {cfg.early_exit_tol})")


def init(cfg: HectorConfig, start_pose,
         device: torch.device | str = "cuda") -> HectorState:
    """Ctor/Reset semantics (HectorSLAMProcessor.cs:66-77, 131-138): zeroed
    maps, match pose at start, last-update pose at float.MinValue."""
    return HectorState(
        maps=torch.zeros(cfg.total_cells, dtype=torch.float32, device=device),
        match_pose=torch.as_tensor(start_pose, dtype=torch.float32,
                                   device=device).clone(),
        last_update_pose=torch.full((3,), FLOAT_MIN, dtype=torch.float32,
                                    device=device))


def level_view(maps: torch.Tensor, cfg: HectorConfig, level: int) -> torch.Tensor:
    """The [S, S] log-odds grid of one pyramid level (a view of ``maps``)."""
    off = cfg.level_offsets[level]
    s = cfg.level_sizes[level]
    return maps[off:off + s * s].view(s, s)


def map_extents(maps: torch.Tensor, cfg: HectorConfig, level: int = 0):
    """Bounding box of touched (non-zero) cells at one level: (found, x_min,
    y_min, x_max, y_max) as 0-dim tensors — GridMap.GetMapExtends
    (GridMap.cs:147-207)."""
    grid = level_view(maps, cfg, level)
    touched = grid != 0.0
    any_t = touched.any()
    s = grid.shape[0]
    idx = torch.arange(s, device=maps.device)
    cols, rows = touched.any(dim=0), touched.any(dim=1)
    big = torch.full_like(idx, s)
    neg = torch.full_like(idx, -1)
    z = torch.zeros((), dtype=idx.dtype, device=maps.device)
    x_min = torch.where(cols, idx, big).min()
    y_min = torch.where(rows, idx, big).min()
    x_max = torch.where(cols, idx, neg).max()
    y_max = torch.where(rows, idx, neg).max()
    return (any_t, torch.where(any_t, x_min, z), torch.where(any_t, y_min, z),
            torch.where(any_t, x_max, z), torch.where(any_t, y_max, z))


def world_to_map(pose_world: torch.Tensor, scale_to_map: float,
                 offset) -> torch.Tensor:
    """GetMapCoordsPose (GridMap.cs:122-137): p_map = p * scale + offset."""
    return torch.stack([pose_world[0] * scale_to_map + offset[0],
                        pose_world[1] * scale_to_map + offset[1],
                        pose_world[2]])


def map_to_world(pose_map: torch.Tensor, scale_to_map: float,
                 offset) -> torch.Tensor:
    return torch.stack([(pose_map[0] - offset[0]) / scale_to_map,
                        (pose_map[1] - offset[1]) / scale_to_map,
                        pose_map[2]])


def match_with_stats(maps: torch.Tensor, scan: Scan, hint_pose_world: torch.Tensor,
                     cfg: HectorConfig, plain: bool = False
                     ) -> Tuple[torch.Tensor, MatchStats]:
    """ScanMatcher.MatchData over the pyramid (ScanMatcher.cs:41-84) through
    K1 or K3 (by ``cfg.matcher_mode``), plus matcher health
    (ScanMatcher.cs:99-115).  ``plain=True`` runs the kernel's plain version
    whatever the device (for comparisons)."""
    _check_cfg(cfg)
    fn = match_op.match_plain if plain else match_op.match
    out = fn(maps, scan.points, scan.valid, hint_pose_world, cfg)
    n_valid = scan.valid[::cfg.match_subsample].sum(dtype=torch.float32)
    stats = MatchStats(
        residual=out[4] / out[5].clamp(min=1.0),
        iterations=out[6].to(torch.int32),
        solve_failures=out[3].to(torch.int32),
        in_map_frac=out[5] / n_valid.clamp(min=1.0))
    return out[:3], stats


def match(maps: torch.Tensor, scan: Scan, hint_pose_world: torch.Tensor,
          cfg: HectorConfig) -> torch.Tensor:
    """ScanMatcher.MatchData over the pyramid: the matched world pose
    f32[3] (``match_with_stats`` without the stats)."""
    return match_with_stats(maps, scan, hint_pose_world, cfg)[0]


def update_maps(state: HectorState, scan: Scan, pose_world: torch.Tensor,
                do_update: torch.Tensor, cfg: HectorConfig,
                plain: bool = False) -> torch.Tensor:
    """MapRepMultiMap.UpdateByScan (MapRepMultiMap.cs:73-77), in place on
    ``state.maps`` where the 0-dim bool ``do_update`` is set: the dense fill
    (K2) or the Bresenham line update (K4), by ``cfg.dense_free_fill``.
    ``plain=True`` runs the kernel's plain version whatever the device."""
    _check_cfg(cfg)
    if plain:
        plain_fn = (fill.update_maps_plain if cfg.dense_free_fill
                    else line.update_maps_line_plain)
        return state.maps.copy_(plain_fn(state.maps, scan.points, scan.valid,
                                         pose_world, scan.pose, do_update, cfg))
    fn = fill.update_maps if cfg.dense_free_fill else line.update_maps_line
    return fn(state.maps, scan.points, scan.valid, pose_world, scan.pose,
              do_update, cfg)


def update(state: HectorState, scan: Scan, pose_hint_world: torch.Tensor,
           cfg: HectorConfig, map_without_matching: bool | torch.Tensor = False,
           plain: bool = False) -> Tuple[HectorState, HectorInfo]:
    """HectorSLAMProcessor.Update (HectorSLAMProcessor.cs:86-126): match,
    then update the maps only if the pose moved beyond the distance/angle
    thresholds or mapping is forced (``map_without_matching``, a Python bool
    or a 0-dim bool tensor).  ``state.maps`` is updated in place."""
    dev = state.maps.device
    hint = torch.as_tensor(pose_hint_world, dtype=torch.float32, device=dev)
    if isinstance(map_without_matching, torch.Tensor):
        force = map_without_matching.to(device=dev, dtype=torch.bool)
    else:   # a fill on the device: no host-to-device copy, no wait
        force = torch.full((), bool(map_without_matching), dtype=torch.bool,
                           device=dev)

    matched, mstats = match_with_stats(state.maps, scan, hint, cfg, plain)
    if cfg.min_match_in_map_frac > 0.0:
        # a match resting on too few in-map beams is a one-sided degenerate
        # solve: keep the odometry hint
        matched = torch.where(mstats.in_map_frac >= cfg.min_match_in_map_frac,
                              matched, hint)
    if cfg.max_match_jump > 0.0:
        # a physically impossible per-scan jump is a degenerate-view solve
        jump2 = ((matched[:2] - hint[:2]) ** 2).sum()
        matched = torch.where(jump2 <= cfg.max_match_jump ** 2, matched, hint)
    match_pose = torch.where(force, hint, matched)

    last = state.last_update_pose
    dist2 = ((match_pose[:2] - last[:2]) ** 2).sum()
    if cfg.angle_gate_compat:
        # reference quirk: DegDiff (degrees formula) on radian values, SIGNED
        # compare (HectorSLAMProcessor.cs:108)
        ang_gate = deg_diff(match_pose[2], last[2]) \
            > cfg.min_angle_diff_for_map_update
    else:
        ang_gate = rad_diff(match_pose[2], last[2]).abs() \
            > cfg.min_angle_diff_for_map_update
    do_update = (dist2 > cfg.min_distance_diff_for_map_update ** 2) \
        | ang_gate | force

    maps = update_maps(state, scan, match_pose, do_update, cfg, plain)
    new_last = torch.where(do_update, match_pose, last)
    return (HectorState(maps, match_pose, new_last),
            HectorInfo(map_updated=do_update, residual=mstats.residual,
                       gn_iterations=mstats.iterations,
                       solve_failures=mstats.solve_failures))


class HectorSLAM(nn.Module):
    """Stateful wrapper: the state lives in buffers, so ``.to(device)`` moves
    it.  ``forward(scan, hint, force)`` runs one ``update`` in place and
    returns its ``HectorInfo``."""

    def __init__(self, cfg: HectorConfig, start_pose=(20.0, 20.0, 0.0),
                 device: torch.device | str = "cuda"):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        st = init(cfg, start_pose, device)
        self.register_buffer("maps", st.maps)
        self.register_buffer("match_pose", st.match_pose)
        self.register_buffer("last_update_pose", st.last_update_pose)

    @property
    def state(self) -> HectorState:
        return HectorState(self.maps, self.match_pose, self.last_update_pose)

    def forward(self, scan: Scan, pose_hint_world: torch.Tensor | None = None,
                map_without_matching: bool | torch.Tensor = False) -> HectorInfo:
        hint = self.match_pose if pose_hint_world is None else pose_hint_world
        st, info = update(self.state, scan, hint, self.cfg, map_without_matching)
        self.match_pose.copy_(st.match_pose)
        self.last_update_pose.copy_(st.last_update_pose)
        return info
