"""Sharded full-pipeline CoreSLAM: the hole map row-tiled, the search sharded.

Port of ``slamnet_tpu/models/coreslam_sharded.py``.  The per-scan step runs
on every rank of a ('tile' x 'search') mesh:

  * the hole map is ROW-TILED over 'tile' with no halo (scoring reads single
    cells): each rank scores the points that land in its rows, and the
    per-candidate integer sums psum over 'tile', exactly;
  * ``search_mode="mc"``: the candidates are drawn REPLICATED from the
    state's generator, as the dense pipeline draws them (every rank holds
    the same generator state, so the same draws), and each rank of 'search'
    scores its contiguous slice; the winner is the lexicographic (score,
    candidate index) minimum, one ``pmin`` of the pair packed in an int64 —
    the dense argmin's first minimum;
  * ``search_mode="correlative"`` (production): the heading bins shard over
    'search'; each tile sums the shifted cells in its rows of the port's
    gather form (``ops/correlate.correlative_scores``), psum'd over 'tile'
    (integers, exact), the [K, W, W] grid all_gathers over 'search' and the
    sub-pixel refinement runs replicated;
  * the line-mode hole update: the beams shard over 'search'; each rank
    counts (visits, value sum) for the cells in its rows from its beams, the
    pair psums over 'search' (integers, exact) and blends element-wise;
    the dense fill updates each tile's own rows from the replicated range
    table;
  * the 64x64 obstacle map stays replicated: every rank computes the same
    update.

So every step equals ``models/coreslam.update_cloud`` bit for bit: track,
hole map, obstacle map.  The warm-up is the host's replicated count, a
Python branch taken alike on every rank.  The entry points put the state on
the mesh's device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.config import CoreSlamConfig
from ..core.geometry import normalize_angle
from ..core.scan import Scan
from ..ops import correlate, holemap, score
from ..parallel.mesh import Mesh
from . import coreslam

INDEX_BITS = 32


class ShardedCoreSlamState(NamedTuple):
    local_hole: torch.Tensor       # i32[rows * S] this rank's rows (no halo)
    obstacle_map: torch.Tensor     # i8[OS, OS] replicated
    pose: torch.Tensor             # f32[3]
    last_odometry: torch.Tensor    # f32[3]
    scan_count: torch.Tensor       # i32[]
    generator: torch.Generator     # replicated: the same state on every rank
    scans: int                     # the host's copy of scan_count


def _rows(mesh: Mesh, cfg: CoreSlamConfig, tile_axis: str) -> int:
    n = mesh.axis_size(tile_axis)
    if cfg.hole_map_size % n:
        raise ValueError(f"hole map of {cfg.hole_map_size} rows over {n} "
                         "tiles")
    return cfg.hole_map_size // n


def _copy_generator(gen: torch.Generator, device) -> torch.Generator:
    out = torch.Generator(device=device)
    out.set_state(gen.get_state())
    return out


def shard_state(mesh: Mesh, dense: coreslam.CoreSlamState,
                cfg: CoreSlamConfig,
                tile_axis: str = "tile") -> ShardedCoreSlamState:
    """This rank's share of a dense state: its hole-map rows, the rest
    replicated (the generator a copy of the dense one's state)."""
    rows = _rows(mesh, cfg, tile_axis)
    n = rows * cfg.hole_map_size
    t = mesh.axis_index(tile_axis)
    dev = mesh.device
    return ShardedCoreSlamState(
        local_hole=dense.hole_map[t * n:(t + 1) * n].to(dev).clone(),
        obstacle_map=dense.obstacle_map.to(dev).clone(),
        pose=dense.pose.to(dev).clone(),
        last_odometry=dense.last_odometry.to(dev).clone(),
        scan_count=dense.scan_count.to(dev).clone(),
        generator=_copy_generator(dense.generator, dev), scans=dense.scans)


def init(mesh: Mesh, cfg: CoreSlamConfig, start_pose, seed: int = 0,
         tile_axis: str = "tile") -> ShardedCoreSlamState:
    return shard_state(mesh, coreslam.init(cfg, start_pose, seed,
                                           device=mesh.device), cfg, tile_axis)


def to_dense(mesh: Mesh, state: ShardedCoreSlamState,
             tile_axis: str = "tile") -> coreslam.CoreSlamState:
    """The dense state (the hole map gathered over 'tile': a collective)."""
    return coreslam.CoreSlamState(
        hole_map=mesh.all_gather(state.local_hole, tile_axis, tiled=True),
        obstacle_map=state.obstacle_map, pose=state.pose,
        last_odometry=state.last_odometry, scan_count=state.scan_count,
        generator=_copy_generator(state.generator, state.pose.device),
        scans=state.scans)


def _mc_search(mesh: Mesh, state: ShardedCoreSlamState, cfg: CoreSlamConfig,
               points, valid, search_pose, rows, tile_axis, search_axis):
    n_search = mesh.axis_size(search_axis)
    if cfg.num_candidates % n_search:
        raise ValueError(f"{cfg.num_candidates} candidates over {n_search} "
                         "search shards")
    lb = cfg.num_candidates // n_search
    srank = mesh.axis_index(search_axis)
    r0 = mesh.axis_index(tile_axis) * rows
    size = cfg.hole_map_size
    cands_all = score.sample_candidates(search_pose, cfg.sigma_xy,
                                        cfg.sigma_theta, cfg.num_candidates,
                                        state.generator)
    cands = cands_all[srank * lb:(srank + 1) * lb]
    x, y = score.candidate_pixels(cands, points, cfg.hole_scale)
    mine = ((x >= 0) & (x < size) & (y >= r0) & (y < r0 + rows)
            & valid[None, :])
    zero = torch.zeros_like(x)
    flat = torch.where(mine, (y - r0) * size + x, zero)
    vals = torch.where(mine, state.local_hole[flat.long()], zero)
    sums_nb = mesh.psum(torch.stack([vals.sum(dim=1, dtype=torch.int32),
                                     mine.sum(dim=1, dtype=torch.int32)]),
                        tile_axis)
    eff = torch.where(sums_nb[1] > 0, sums_nb[0],
                      torch.full_like(sums_nb[0], score.INT32_MAX))
    li = torch.argmin(eff).reshape(1)
    # (score, global index) packed so that one pmin is the lexicographic
    # minimum: the dense argmin's first minimum (shards hold contiguous
    # candidate slices)
    key = (eff.index_select(0, li).to(torch.int64) << INDEX_BITS) \
        + (li + srank * lb)
    best = mesh.pmin(key, search_axis)
    best_idx = best & ((1 << INDEX_BITS) - 1)
    return (cands_all.index_select(0, best_idx)[0],
            (best >> INDEX_BITS).to(torch.int32)[0])


def correlative_eff(mesh: Mesh, local_hole: torch.Tensor, size: int,
                    rows: int, scale: float, points: torch.Tensor,
                    valid: torch.Tensor, search_pose: torch.Tensor,
                    thetas: torch.Tensor, window: int,
                    tile_axis: str = "tile", search_axis: str = "search"
                    ) -> torch.Tensor:
    """The correlative score grid eff i32[K, W, W] (int-max where no point
    is in bounds), replicated: this rank scores its share of the K headings
    ``thetas`` on its tile's rows, the sums psum over 'tile' and the grid
    all_gathers over 'search'.  ``ops/correlate.correlative_scores``'s
    values, with int-max where its count is 0."""
    n_search = mesh.axis_size(search_axis)
    K = thetas.shape[0]
    if K % n_search:
        raise ValueError(f"{K} heading bins over {n_search} search shards")
    kloc = K // n_search
    srank = mesh.axis_index(search_axis)
    r0 = mesh.axis_index(tile_axis) * rows
    R = window // 2
    xb, yb = correlate.correlative_pixels(
        search_pose, thetas[srank * kloc:(srank + 1) * kloc], points, scale)
    ok = (valid[None, :] & (xb >= -R) & (xb < size + R)
          & (yb >= -R) & (yb < size + R))
    d = torch.arange(window, dtype=torch.int32, device=xb.device) - R
    y = yb[:, None, :] + d[None, :, None]                         # [k, W, N]
    x = xb[:, None, :] + d[None, :, None]
    col_in = (x >= 0) & (x < size)
    cell = ((ok[:, None, :] & (y >= r0) & (y < r0 + rows))[:, :, None, :]
            & col_in[:, None, :, :])                              # [k,W,W,N]
    idx = ((y - r0) * size)[:, :, None, :] + x[:, None, :, :]
    vals = torch.where(cell, local_hole[
        torch.where(cell, idx, torch.zeros_like(idx)).long()],
        torch.zeros_like(idx))
    sums = mesh.psum(vals.sum(dim=3, dtype=torch.int32), tile_axis)
    # JAX's value: the sum as its f32 recombination rounds it
    sums = sums.to(torch.float32).to(torch.int32)
    rows_in = ok[:, None, :] & (y >= 0) & (y < size)
    nb = (rows_in[:, :, None, :] & col_in[:, None, :, :]).sum(
        dim=3, dtype=torch.int32)
    eff = torch.where(nb > 0, sums, torch.full_like(sums, score.INT32_MAX))
    return mesh.all_gather(eff, search_axis, tiled=True)


def _correlative_search(mesh: Mesh, state: ShardedCoreSlamState,
                        cfg: CoreSlamConfig, points, valid, search_pose,
                        rows, tile_axis, search_axis):
    span = cfg.corr_theta_span or 3.0 * cfg.sigma_theta
    eff = correlative_eff(
        mesh, state.local_hole, cfg.hole_map_size, rows, cfg.hole_scale,
        points, valid, search_pose,
        correlate.theta_grid(search_pose[2], cfg.corr_num_theta, span),
        cfg.corr_window, tile_axis, search_axis)
    return correlate.refine_from_scores(eff, search_pose, cfg.hole_scale,
                                        cfg.corr_window, cfg.corr_num_theta,
                                        span)


def _line_hole_update(mesh: Mesh, local_hole, cfg: CoreSlamConfig, points,
                      valid, pose, r0, rows, search_axis):
    n_search = mesh.axis_size(search_axis)
    n = points.shape[0]
    if n % n_search:
        raise ValueError(f"{n} beams over {n_search} search shards")
    nloc = n // n_search
    s = mesh.axis_index(search_axis)
    size = cfg.hole_map_size
    rays, mask, robot_in = holemap._rays(
        size, cfg.hole_scale, points[s * nloc:(s + 1) * nloc],
        valid[s * nloc:(s + 1) * nloc], pose, cfg.hole_width)
    cy = torch.div(rays.flat, size, rounding_mode="floor")
    m = mask & (cy >= r0) & (cy < r0 + rows)
    idx = torch.where(m, rays.flat - r0 * size,
                      torch.zeros_like(rays.flat)).reshape(-1).long()
    ncl = rows * size
    counts = torch.zeros((2, ncl), dtype=torch.int32, device=local_hole.device)
    counts[0].index_add_(0, idx, m.reshape(-1).to(torch.int32))
    counts[1].index_add_(0, idx, torch.where(
        m, rays.pixval, torch.zeros_like(rays.pixval)).reshape(-1))
    counts = mesh.psum(counts, search_axis)
    return torch.where(robot_in, holemap.blend_visits(
        local_hole, counts[0], counts[1], cfg.quality), local_hole)


def make_step(mesh: Mesh, cfg: CoreSlamConfig, tile_axis: str = "tile",
              search_axis: str = "search"):
    """The sharded step: ``step(state, points f32[N, 2], valid bool[N],
    odometry_pose f32[3]) -> (state, CoreSlamInfo)``, ``coreslam.
    update_cloud``'s contract in both search modes and both fill modes
    (N divisible by the search axis in the line mode)."""
    if cfg.search_mode not in ("mc", "correlative"):
        raise ValueError(f"search_mode {cfg.search_mode!r}: 'mc' or "
                         "'correlative'")
    rows = _rows(mesh, cfg, tile_axis)

    def step(state: ShardedCoreSlamState, points: torch.Tensor,
             valid: torch.Tensor, odometry_pose
             ) -> Tuple[ShardedCoreSlamState, coreslam.CoreSlamInfo]:
        dev = state.pose.device
        odo = torch.as_tensor(odometry_pose, dtype=torch.float32, device=dev)
        r0 = mesh.axis_index(tile_axis) * rows
        warm = state.scans >= cfg.position_search_beginning
        if warm:
            search_pose = state.pose + (odo - state.last_odometry)
            search = (_mc_search if cfg.search_mode == "mc"
                      else _correlative_search)
            best, best_sum = search(mesh, state, cfg, points, valid,
                                    search_pose, rows, tile_axis,
                                    search_axis)
        else:
            best, best_sum = odo, torch.zeros((), dtype=torch.int32,
                                              device=dev)
        new_pose = torch.stack([best[0], best[1], normalize_angle(best[2])])
        size = cfg.hole_map_size
        if cfg.dense_hole_fill:
            hole = holemap.update_hole_map_dense(
                state.local_hole, size, cfg.hole_scale, points, valid,
                new_pose, cfg.hole_width, cfg.quality, cfg.angle_bins, r0,
                rows)
        else:
            hole = _line_hole_update(mesh, state.local_hole, cfg, points,
                                     valid, new_pose, r0, rows, search_axis)
        obst = coreslam.update_obstacle(state.obstacle_map,
                                        Scan(points, valid, odo), new_pose,
                                        cfg)
        new_state = state._replace(
            local_hole=hole, obstacle_map=obst, pose=new_pose,
            last_odometry=odo,
            scan_count=state.scan_count if warm else state.scan_count + 1,
            scans=state.scans if warm else state.scans + 1)
        return new_state, coreslam.CoreSlamInfo(
            searched=torch.full((), warm, dtype=torch.bool, device=dev),
            best_sum=best_sum)

    return step
