"""Pose-graph frontend: keyframe selection, scan-to-scan matching, loop
closures.

Port of ``slamnet_tpu/graph/frontend.py``.  A keyframe's scan is rasterized
into a small local grid with the robot at its centre, and another scan is
Gauss-Newton matched against it: a one-level Hector map and match, so the
frontend runs the Hector kernels at the local grid's shape (``grid_config``:
one level of ``grid_size`` px, ``gn_iterations`` iterations, every beam):

* ``rasterize_scan``: K4 (``ops/line.py``, the Bresenham line update), or K2
  (``ops/fill.py``, the dense fill at ``free_margin_px``) when
  ``dense_fill`` is set, on a fresh zero grid with the fire flag set;
* ``match_scans``: K3 (``ops/match.py``, the f32 table) for ``"gather"`` /
  ``"onehot_highest"``, K1 (the bf16-rounded table) for ``"pallas"`` /
  ``"onehot_bf16"``.  JAX's gather frontend loops 20 fused GN iterations
  (``frontend.py:133-138``) and its ``"pallas"`` frontend pads the beams to
  8 (``:106-119``); the port takes the 400 beams as they are, through the
  same kernel as the Hector match.  An empty query scan gives ``init_rel``
  in every mode: with no valid beam JAX's loop solves a zero H, fails and
  does not step, and the kernels return the hint;
* the match's quality reads ``ops/bilinear.py`` on the f32 grid in every
  mode, as JAX does.

``plain=True`` runs the kernels' plain versions whatever the device.  No
function here waits for the device.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from ..core.config import HectorConfig
from ..core.geometry import normalize_angle
from ..core.scan import Scan
from ..ops import bilinear, fill, line, match


class ScanMatchConfig(NamedTuple):
    """Local grid and matcher settings for scan-to-scan constraints
    (``slamnet_tpu/graph/frontend.py:20-43``)."""

    grid_size: int = 128        # local grid pixels
    resolution: float = 0.25    # m/px: the local grid spans 32 m
    gn_iterations: int = 20
    log_odds_free: float = -0.40546511
    log_odds_occupied: float = 2.19722458
    inlier_prob: float = 0.6    # a query point "hits" if M(p) > this
    # "gather" | "onehot_highest" (K3) | "onehot_bf16" | "pallas" (K1)
    matcher_mode: str = "gather"
    dense_fill: bool = False    # K2 instead of K4 for the local grid
    free_margin_px: float = 0.5


class MatchQuality(NamedTuple):
    """Acceptance evidence for a scan-to-scan match: ``residual``, the mean
    (1 - M(p))^2 over in-bounds valid query points (~0.25 on unvisited
    cells); ``inlier_frac``, the fraction of valid query points on occupied
    cells (M > inlier_prob), the accept/reject signal."""

    residual: torch.Tensor
    inlier_frac: torch.Tensor


def _odds(log_odds: float) -> float:
    """The update factor p whose log(p / (1 - p)) is ``log_odds``."""
    return 1.0 / (1.0 + math.exp(-log_odds))


@functools.cache
def grid_config(cfg: ScanMatchConfig) -> HectorConfig:
    """The local grid as a one-level Hector pyramid (``frontend.py:103-105``)
    with the frontend's log-odds, free margin, fill and matcher: the
    configuration the kernels take."""
    return HectorConfig(
        map_size=cfg.grid_size, map_resolution=cfg.resolution, num_levels=1,
        estimate_iterations=(cfg.gn_iterations,),
        update_factor_free=_odds(cfg.log_odds_free),
        update_factor_occupied=_odds(cfg.log_odds_occupied),
        dense_free_fill=cfg.dense_fill,
        dense_free_margin_px=cfg.free_margin_px,
        matcher_mode=cfg.matcher_mode)


def _center(cfg: ScanMatchConfig, device) -> torch.Tensor:
    """The grid centre (x, y, 0) in the grid's world frame, made on the
    device with fills (no copy from the host)."""
    c = torch.full((3,), cfg.grid_size // 2 * cfg.resolution,
                   dtype=torch.float32, device=device)
    c[2] = 0.0
    return c


def rasterize_scan(scan: Scan, cfg: ScanMatchConfig,
                   plain: bool = False) -> torch.Tensor:
    """A local log-odds grid f32[grid_size**2] from one scan, the robot at
    the grid centre: K2 (``dense_fill``) or K4 on a fresh zero grid."""
    hcfg = grid_config(cfg)
    dev = scan.points.device
    grid = torch.zeros(hcfg.total_cells, dtype=torch.float32, device=dev)
    fire = torch.ones((), dtype=torch.bool, device=dev)
    args = (scan.points, scan.valid, _center(cfg, dev), scan.pose, fire, hcfg)
    if plain:
        fn = fill.update_maps_plain if cfg.dense_fill \
            else line.update_maps_line_plain
        return fn(grid, *args)
    fn = fill.update_maps if cfg.dense_fill else line.update_maps_line
    return fn(grid, *args)


def match_scans(scan_ref: Scan, scan_qry: Scan, init_rel: torch.Tensor,
                cfg: ScanMatchConfig, plain: bool = False
                ) -> Tuple[torch.Tensor, MatchQuality]:
    """Relative pose f32[3] of scan_qry's robot in scan_ref's frame, and the
    match's quality: scan_ref rasterized at the centre of a local grid, then
    scan_qry GN-matched against it from ``init_rel`` f32[3] (e.g. the
    odometry delta or the pose graph's guess).  The quality is occupancy
    based: a match against an unrelated place converges with near-zero
    gradients, but its points do not land on occupied cells."""
    hcfg = grid_config(cfg)
    s = cfg.grid_size
    scale = 1.0 / cfg.resolution
    grid = rasterize_scan(scan_ref, cfg, plain)
    center = _center(cfg, grid.device)
    fn = match.match_plain if plain else match.match
    out = fn(grid, scan_qry.points, scan_qry.valid, init_rel + center, hcfg)
    # out is world = px / scale with the heading wrapped; scale is a power of
    # two, so out * scale is the pixel pose JAX's loop ends at
    rel = torch.stack([out[0] - center[0], out[1] - center[1],
                       normalize_angle(out[2])])

    # quality: bilinear map probability at every matched query point
    c = torch.cos(out[2]) * scale
    sn = torch.sin(out[2]) * scale
    X, Y, V = scan_qry.points[:, 0], scan_qry.points[:, 1], scan_qry.valid
    mx = c * X - sn * Y + out[0] * scale
    my = sn * X + c * Y + out[1] * scale
    val, _, _ = bilinear.interp_value_and_gradients(
        grid, s, torch.stack([mx, my], dim=1), V)
    in_b = V & (mx >= 0.0) & (mx <= s - 2) & (my >= 0.0) & (my <= s - 2)
    n_valid = V.sum().clamp(min=1)
    resid = torch.where(in_b, (1.0 - val) ** 2, 0.0).sum() \
        / in_b.sum().clamp(min=1)
    inlier_frac = ((val > cfg.inlier_prob) & in_b).sum() / n_valid
    return rel, MatchQuality(residual=resid, inlier_frac=inlier_frac)


def keyframe_due(last_kf_pose: torch.Tensor, pose: torch.Tensor,
                 dist_thresh: float, angle_thresh: float) -> torch.Tensor:
    """0-dim bool: spawn a new keyframe when moved far enough from the last."""
    d = torch.linalg.vector_norm(pose[:2] - last_kf_pose[:2])
    a = normalize_angle(pose[2] - last_kf_pose[2]).abs()
    return (d > dist_thresh) | (a > angle_thresh)


def loop_candidates(poses: torch.Tensor, node_valid: torch.Tensor,
                    cur_idx, radius: float, min_index_gap: int) -> torch.Tensor:
    """bool[K] mask of keyframes within ``radius`` of node ``cur_idx`` but at
    least ``min_index_gap`` older: loop-closure candidates by proximity."""
    cur = poses[cur_idx]
    d = torch.linalg.vector_norm(poses[:, :2] - cur[None, :2], dim=1)
    idx = torch.arange(poses.shape[0], device=poses.device)
    return node_valid & (d < radius) & (idx < cur_idx - min_index_gap)
