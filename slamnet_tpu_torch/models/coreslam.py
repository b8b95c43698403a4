"""CoreSLAM: a hole map, an obstacle map and a pose searched against the
hole map each scan.

Port of ``slamnet_tpu/models/coreslam.py`` (CoreSLAMProcessor.cs): ``update``
de-skews a segment scan and ``update_cloud`` takes a cloud; each searches the
pose (Monte-Carlo, ``ops/score.py``, or correlative, ``ops/correlate.py``)
from the last pose plus the odometry delta, then updates both maps at the new
pose (``ops/holemap.py``, ``ops/obstacle.py``; line or dense by the config).

Two of JAX's constructs change form:

- JAX carries a PRNG key and splits it in each step (``coreslam.py:76``);
  the state here carries a seeded ``torch.Generator`` on its device, which
  the Monte-Carlo search draws from.  Its numbers differ from
  ``jax.random``'s; the distribution is the same.
- JAX's ``lax.cond(warm, ...)`` (``:97``) is a Python branch on the host's
  count of warm-up scans (``CoreSlamState.scans``, as the graph keeps its
  node count), so no step reads the device.  ``scan_count`` stays in the
  state as a tensor, for ``convert``.

``searched`` and ``best_sum`` stay device tensors.  No hand kernel runs
here: the JAX package computes CoreSLAM in XLA.  The entry point (``init``)
puts the state on the card unless the caller names another device.

Under a profiler a scan is the span ``slamnet.coreslam.update`` (the whole
``update`` or ``update_cloud`` call), holding ``.search`` on a searched scan
and then ``.map_update`` (``io/metrics``).  ``update_cloud.searches`` and
``update_cloud.candidates`` count the searched scans and the candidate
poses they scored, on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.config import CoreSlamConfig
from ..core.geometry import normalize_angle
from ..core.scan import Scan, SegmentScan, segments_to_cloud
from ..io import metrics
from ..ops import correlate, holemap, obstacle, score

HOLE_INIT = (holemap.TS_OBSTACLE + holemap.TS_NO_OBSTACLE) // 2  # 32750 (:169)


class CoreSlamState(NamedTuple):
    hole_map: torch.Tensor         # i32[S*S] flat (HoleMap.cs's ushort[])
    obstacle_map: torch.Tensor     # i8[OS, OS]
    pose: torch.Tensor             # f32[3]
    last_odometry: torch.Tensor    # f32[3]
    scan_count: torch.Tensor       # i32[] warm-up scans counted so far
    generator: torch.Generator     # the Monte-Carlo search's draws
    scans: int                     # the host's copy of scan_count


class CoreSlamInfo(NamedTuple):
    searched: torch.Tensor         # bool: did the search run this scan?
    best_sum: torch.Tensor         # i32: the best candidate's pixel sum


def init(cfg: CoreSlamConfig, start_pose, seed: int = 0,
         device: torch.device | str = "cuda",
         generator: torch.Generator | None = None) -> CoreSlamState:
    """Reset semantics of CoreSLAMProcessor.Reset (CoreSLAMProcessor.cs:
    167-175): the hole map at HOLE_INIT, the obstacle map at
    ``unmapped_obstacle_hits``; a generator on ``device`` seeded with
    ``seed`` unless one is given."""
    s, os_ = cfg.hole_map_size, cfg.obstacle_map_size
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return CoreSlamState(
        hole_map=torch.full((s * s,), HOLE_INIT, dtype=torch.int32,
                            device=device),
        obstacle_map=torch.full((os_, os_), cfg.unmapped_obstacle_hits,
                                dtype=torch.int8, device=device),
        pose=torch.as_tensor(start_pose, dtype=torch.float32,
                             device=device).clone(),
        last_odometry=torch.zeros(3, dtype=torch.float32, device=device),
        scan_count=torch.zeros((), dtype=torch.int32, device=device),
        generator=generator, scans=0)


def reset(state: CoreSlamState, cfg: CoreSlamConfig,
          start_pose) -> CoreSlamState:
    """A fresh state on the same device that keeps drawing from the same
    generator (JAX's reset keeps its key)."""
    return init(cfg, start_pose, device=state.hole_map.device,
                generator=state.generator)


def update(state: CoreSlamState, segments: SegmentScan,
           cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """One scan from segments: de-skew against the newest odometry pose,
    then ``update_cloud`` (CoreSLAMProcessor.Update, :717-752)."""
    with metrics.span("coreslam.update"):
        return _update_cloud(state, segments_to_cloud(segments),
                             segments.odometry_pose, cfg)


def search(state: CoreSlamState, cloud: Scan, search_pose: torch.Tensor,
           cfg: CoreSlamConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The config's search around ``search_pose``: (pose f32[3], sum i32[])."""
    if cfg.search_mode == "correlative":
        span = cfg.corr_theta_span or 3.0 * cfg.sigma_theta
        return correlate.correlative_search(
            state.hole_map, cfg.hole_map_size, cfg.hole_scale, cloud.points,
            cloud.valid, search_pose, cfg.corr_window, cfg.corr_num_theta,
            span)
    if cfg.search_mode != "mc":
        raise ValueError(f"search_mode {cfg.search_mode!r}: 'mc' or "
                         "'correlative'")
    return score.monte_carlo_search(
        state.hole_map, cfg.hole_map_size, cfg.hole_scale, cloud.points,
        cloud.valid, search_pose, cfg.sigma_xy, cfg.sigma_theta,
        cfg.num_candidates, state.generator)


def update_obstacle(obstacle_map: torch.Tensor, cloud: Scan,
                    pose: torch.Tensor, cfg: CoreSlamConfig) -> torch.Tensor:
    """The obstacle map updated at ``pose``, line or dense by the config."""
    if cfg.dense_obstacle_fill:
        return obstacle.update_obstacle_map_dense(
            obstacle_map, cfg.obstacle_map_size, cfg.obstacle_scale,
            cloud.points, cloud.valid, pose, cfg.max_obstacle_hits,
            cfg.angle_bins)
    return obstacle.update_obstacle_map(
        obstacle_map, cfg.obstacle_map_size, cfg.obstacle_scale,
        cloud.points, cloud.valid, pose, cfg.max_obstacle_hits)


def update_maps(state: CoreSlamState, cloud: Scan, pose: torch.Tensor,
                cfg: CoreSlamConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both maps updated at ``pose``, line or dense by the config."""
    if cfg.dense_hole_fill:
        hole = holemap.update_hole_map_dense(
            state.hole_map, cfg.hole_map_size, cfg.hole_scale, cloud.points,
            cloud.valid, pose, cfg.hole_width, cfg.quality, cfg.angle_bins)
    else:
        hole = holemap.update_hole_map(
            state.hole_map, cfg.hole_map_size, cfg.hole_scale, cloud.points,
            cloud.valid, pose, cfg.hole_width, cfg.quality)
    return hole, update_obstacle(state.obstacle_map, cloud, pose, cfg)


def candidates_scored(cfg: CoreSlamConfig) -> int:
    """The candidate poses one search scores: ``num_candidates`` draws, or
    the correlative grid's headings x window x window."""
    if cfg.search_mode == "correlative":
        return cfg.corr_num_theta * cfg.corr_window * cfg.corr_window
    return cfg.num_candidates


def update_cloud(state: CoreSlamState, cloud: Scan, odometry_pose,
                 cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """One scan from a de-skewed cloud: the search prior is the last pose
    plus the odometry delta (:728); during the first
    ``position_search_beginning`` scans the odometry pose is adopted as it
    is (:739-743); the heading is normalised (:746); both maps update at the
    new pose."""
    with metrics.span("coreslam.update"):
        return _update_cloud(state, cloud, odometry_pose, cfg)


update_cloud.searches = 0
update_cloud.candidates = 0


def _update_cloud(state: CoreSlamState, cloud: Scan, odometry_pose,
                  cfg: CoreSlamConfig) -> Tuple[CoreSlamState, CoreSlamInfo]:
    """``update_cloud`` without its span (``update`` holds its own)."""
    dev = state.pose.device
    odo = torch.as_tensor(odometry_pose, dtype=torch.float32, device=dev)
    warm = state.scans >= cfg.position_search_beginning
    if warm:
        with metrics.span("coreslam.search"):
            best, best_sum = search(
                state, cloud, state.pose + (odo - state.last_odometry), cfg)
        update_cloud.searches += 1
        update_cloud.candidates += candidates_scored(cfg)
    else:
        best, best_sum = odo, torch.zeros((), dtype=torch.int32, device=dev)
    new_pose = torch.stack([best[0], best[1], normalize_angle(best[2])])
    with metrics.span("coreslam.map_update"):
        hole, obst = update_maps(state, cloud, new_pose, cfg)
    new_state = state._replace(
        hole_map=hole, obstacle_map=obst, pose=new_pose, last_odometry=odo,
        scan_count=state.scan_count if warm else state.scan_count + 1,
        scans=state.scans if warm else state.scans + 1)
    return new_state, CoreSlamInfo(
        searched=torch.full((), warm, dtype=torch.bool, device=dev),
        best_sum=best_sum)
