"""Sharded full-pipeline HectorSLAM: the pyramid row-tiled, the beams sharded.

Port of ``slamnet_tpu/models/hector_sharded.py``.  The whole per-scan step
runs on every rank of a ('tile' x 'search') mesh (``parallel/mesh.py``):

  * every pyramid level is ROW-TILED over 'tile': a rank holds its tile's
    rows of every level, each level's owned rows followed by ONE halo row
    (the south neighbour's first row; bilinear reads y + 1);
  * the beam axis is sharded over 'search': a rank holds a contiguous chunk
    of the scan padded to ``_beam_pad`` beams (JAX's lane padding decides
    which beams a rank holds, and nothing else here);
  * each Gauss-Newton iteration sums its 11-number partial (H, dTr,
    residual, in-map count) over (own beams x own rows) and psums it over
    BOTH axes; the 3x3 solve is replicated;
  * the map update: each rank walks its beam shard, marks the cells in its
    rows, the marks of all levels combine by ONE pmax over 'search' (free
    and occupied as one code, ``parallel/tiles.line_marks``), the log-odds
    apply is element-wise on owned rows, and ONE ppermute over 'tile'
    refreshes every level's halo row.

So a scan costs sum(estimate_iterations) + 2 collectives, and the line
update's maps equal ``models/hector.update``'s bit for bit (the marks are
unions over beams); the matcher's sums differ from the dense ones in their
order only.

The matcher modes are ``gather``, ``onehot_highest`` (the gather, bit for
bit, as in JAX: its one-hot row matmuls select entries exactly) and
``onehot_bf16`` (the gather from the bf16-rounded table, what its bf16
one-hot matmuls select), with ``early_exit_tol``.  JAX's guards are kept
exactly: ``max_match_jump``, and NO ``min_match_in_map_frac`` (JAX's sharded
step does not apply it, ``hector_sharded.py:367-372``, so a scan whose
in-map fraction is under it moves here where the dense step keeps its
pose).  JAX's sharded step reads neither ``dense_free_fill`` nor
``match_subsample`` nor ``gn_damping``, and neither does this one: a config
that sets them (``serving_hector_config()``) runs the line update on every
beam without damping, as in JAX.

JAX's ``lax.cond(do_update, ...)`` and its early-exit ``while_loop`` become
computed-and-masked steps: every rank runs every iteration and every update,
issuing the same collectives in the same order each scan, and the results
are selected by ``do_update`` and the exit flag, which stay device tensors
(a collective's result, the same bits on every rank).  No step reads a
device value on the host, beyond the host copies gloo itself needs.

A rank's state holds its own tile's table (no leading tile axis); the
entry points put it on the rank's card unless the mesh names another
device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.config import HectorConfig
from ..core.geometry import deg_diff, normalize_angle, rad_diff, true_div
from ..ops.gn import _solve_scalar
from ..parallel import tiles
from ..parallel.mesh import Mesh
from . import hector

MATCHERS = ("gather", "onehot_highest", "onehot_bf16")


class ShardedHectorState(NamedTuple):
    local_maps: torch.Tensor         # f32[local_cells] this rank's tile
    match_pose: torch.Tensor         # f32[3] (replicated)
    last_update_pose: torch.Tensor   # f32[3] (replicated)


def _check_cfg(cfg: HectorConfig) -> None:
    if cfg.matcher_mode not in MATCHERS or tuple(cfg.offset) != (0.0, 0.0):
        raise NotImplementedError(
            f"the sharded Hector step runs matcher_mode in {MATCHERS} with "
            f"offset (0, 0); got {cfg.matcher_mode!r}, {cfg.offset}")


# --------------------------- static layout helpers ---------------------------

def level_rows(cfg: HectorConfig, n_tiles: int) -> Tuple[int, ...]:
    """Owned rows a tile holds of each level: ceil(size / n_tiles); the
    last tile(s) own padding rows beyond the grid, never read or written."""
    return tuple(-(-s // n_tiles) for s in cfg.level_sizes)


def local_level_offsets(cfg: HectorConfig, n_tiles: int) -> Tuple[int, ...]:
    """Start of each level inside a tile's flat table."""
    out, off = [], 0
    for s, rows in zip(cfg.level_sizes, level_rows(cfg, n_tiles)):
        out.append(off)
        off += (rows + 1) * s             # owned rows + 1 halo row
    return tuple(out)


def local_cells(cfg: HectorConfig, n_tiles: int) -> int:
    return sum((rows + 1) * s for s, rows in zip(cfg.level_sizes,
                                                 level_rows(cfg, n_tiles)))


def _beam_pad(n: int, n_search: int) -> int:
    """JAX's beam axis: padded to a lane multiple and divisible by the
    search axis (the chunk a rank holds is pad / n_search beams)."""
    pad = max(256, -(-n // 128) * 128)
    while pad % n_search:
        pad += 128
    return pad


def beam_range(mesh: Mesh, num_beams: int,
               search_axis: str = "search") -> Tuple[int, int]:
    """[start, stop) of this rank's beams in the padded axis."""
    k = _beam_pad(num_beams, mesh.axis_size(search_axis)) \
        // mesh.axis_size(search_axis)
    s = mesh.axis_index(search_axis)
    return s * k, (s + 1) * k


def beam_shard(mesh: Mesh, x: torch.Tensor, num_beams: int, fill,
               search_axis: str = "search") -> torch.Tensor:
    """This rank's chunk of a full scan array ``x`` [N, ...]: the axis
    padded with ``fill`` to ``_beam_pad`` beams, then ``beam_range``."""
    lo, hi = beam_range(mesh, num_beams, search_axis)
    pad = _beam_pad(num_beams, mesh.axis_size(search_axis))
    x = torch.as_tensor(x)
    if x.shape[0] < pad:
        x = torch.cat([x, torch.full((pad - x.shape[0],) + tuple(x.shape[1:]),
                                     fill, dtype=x.dtype, device=x.device)])
    return x[lo:hi].to(mesh.device)


# ------------------------------ shard/unshard -------------------------------

def shard_tiles_host(dense_maps: torch.Tensor, cfg: HectorConfig,
                     n_tiles: int) -> torch.Tensor:
    """[n_tiles, local_cells]: every tile's table of a dense concatenated
    pyramid (owned rows, padding rows zero, then the halo row, a level at a
    time); also the oracle of what each tile must hold."""
    dense_maps = torch.as_tensor(dense_maps)
    lrows = level_rows(cfg, n_tiles)
    out = []
    for t in range(n_tiles):
        parts = []
        for level in range(cfg.num_levels):
            s, rows = cfg.level_sizes[level], lrows[level]
            grid = dense_maps[cfg.level_offsets[level]:
                              cfg.level_offsets[level] + s * s].reshape(s, s)
            owned = grid[t * rows:(t + 1) * rows]
            pad = torch.zeros((rows + 1 - owned.shape[0], s),
                              dtype=grid.dtype, device=grid.device)
            if (t + 1) * rows < s:          # the halo row, else zeros
                pad[-1] = grid[(t + 1) * rows]
            parts.append(torch.cat([owned, pad]).reshape(-1))
        out.append(torch.cat(parts))
    return torch.stack(out)


def unshard_tiles_host(stacked: torch.Tensor, cfg: HectorConfig) -> torch.Tensor:
    """The dense concatenated pyramid from [n_tiles, local_cells] tables
    (halo and padding rows dropped)."""
    n_tiles = stacked.shape[0]
    loffs = local_level_offsets(cfg, n_tiles)
    lrows = level_rows(cfg, n_tiles)
    levels = []
    for level in range(cfg.num_levels):
        s, rows = cfg.level_sizes[level], lrows[level]
        per_tile = [stacked[t, loffs[level]:loffs[level] + rows * s].reshape(
            rows, s) for t in range(n_tiles)]
        levels.append(torch.cat(per_tile)[:s].reshape(-1))
    return torch.cat(levels)


def shard_state(mesh: Mesh, dense: hector.HectorState, cfg: HectorConfig,
                tile_axis: str = "tile") -> ShardedHectorState:
    """This rank's share of a dense state (its tile's table; the poses
    replicated), on the mesh's device."""
    t = mesh.axis_index(tile_axis)
    local = shard_tiles_host(dense.maps, cfg, mesh.axis_size(tile_axis))[t]
    return ShardedHectorState(local.to(mesh.device).clone(),
                              dense.match_pose.to(mesh.device).clone(),
                              dense.last_update_pose.to(mesh.device).clone())


def gather_tiles(mesh: Mesh, state: ShardedHectorState,
                 tile_axis: str = "tile") -> torch.Tensor:
    """[n_tiles, local_cells]: every tile's table, on every rank of this
    rank's tile line (one all_gather; a collective every rank of the mesh
    calls)."""
    return mesh.all_gather(state.local_maps, tile_axis)


def unshard_maps(mesh: Mesh, state: ShardedHectorState, cfg: HectorConfig,
                 tile_axis: str = "tile") -> torch.Tensor:
    """The dense concatenated pyramid (a collective: ``gather_tiles``)."""
    return unshard_tiles_host(gather_tiles(mesh, state, tile_axis), cfg)


def to_dense(mesh: Mesh, state: ShardedHectorState, cfg: HectorConfig,
             tile_axis: str = "tile") -> hector.HectorState:
    return hector.HectorState(unshard_maps(mesh, state, cfg, tile_axis),
                              state.match_pose, state.last_update_pose)


def init(mesh: Mesh, cfg: HectorConfig, start_pose,
         tile_axis: str = "tile") -> ShardedHectorState:
    """Zeroed tiles, hector.init's poses, on the mesh's device."""
    _check_cfg(cfg)
    dense = hector.init(cfg, start_pose, device=mesh.device)
    n_tiles = mesh.axis_size(tile_axis)
    return ShardedHectorState(
        torch.zeros(local_cells(cfg, n_tiles), dtype=torch.float32,
                    device=mesh.device),
        dense.match_pose, dense.last_update_pose)


# ----------------------------- the SPMD step --------------------------------

def _local_gn_reduce(mesh: Mesh, table, loff, width, rows, r0, scale,
                     pose_px, X, Y, valid, n_valid, axes) -> torch.Tensor:
    """f32[12]: the 11-number GN partial over (own beams x own rows) and
    this rank's valid-beam count, psum'd over both axes (the sharded twin of
    ``ops.gn._gn_tail``'s reduction; the 12th entry answers JAX's
    any-valid psum in the same collective)."""
    sr = torch.sin(pose_px[2]) * scale
    cr = torch.cos(pose_px[2]) * scale
    mx = cr * X - sr * Y + pose_px[0]
    my = sr * X + cr * Y + pose_px[1]
    in_b = (valid & (mx >= 0.0) & (mx <= width - 2) & (my >= 0.0)
            & (my <= width - 2))
    xi = mx.to(torch.int32).clamp(0, width - 2)
    yi = my.to(torch.int32).clamp(0, width - 2)
    mine = in_b & (yi >= r0) & (yi < r0 + rows)
    zi = torch.zeros_like(yi)
    # the halo row follows the owned rows: base + width is inside the view
    # even on the last owned row
    base = (loff + torch.where(mine, yi - r0, zi) * width
            + torch.where(mine, xi, zi)).long()
    v = torch.sigmoid(table[torch.stack([base, base + 1, base + width,
                                         base + width + 1])])
    fx = mx - xi
    fy = my - yi
    xf, yf = 1.0 - fx, 1.0 - fy
    val = (v[0] * xf + v[1] * fx) * yf + (v[2] * xf + v[3] * fx) * fy
    z = torch.zeros_like(val)
    gx = torch.where(mine, -((v[0] - v[1]) * xf + (v[2] - v[3]) * fx), z)
    gy = torch.where(mine, -((v[0] - v[2]) * yf + (v[1] - v[3]) * fy), z)
    fun = torch.where(mine, 1.0 - val, z)
    rot = (-sr * X - cr * Y) * gx + (cr * X - sr * Y) * gy
    red = torch.stack([gx * fun, gy * fun, rot * fun,
                       gx * gx, gx * gy, gx * rot,
                       gy * gy, gy * rot, rot * rot,
                       fun * fun, mine.to(torch.float32)]).sum(dim=1)
    return mesh.psum(torch.cat([red, n_valid[None]]), axes)


def local_full_step(mesh: Mesh, local: torch.Tensor, match_pose: torch.Tensor,
                    last_update_pose: torch.Tensor, X: torch.Tensor,
                    Y: torch.Tensor, valid: torch.Tensor, force: torch.Tensor,
                    cfg: HectorConfig, tile_axis: str = "tile",
                    search_axis: str = "search"):
    """One scan on this rank: ``local`` its tile's table f32[C], ``X``,
    ``Y``, ``valid`` its beam chunk, ``force`` a 0-dim bool tensor.  Returns
    (new_local, new_pose, new_last, HectorInfo); poses and info replicated.
    The body of ``make_step``, exposed for compositions that run it inside
    their own step over the same mesh."""
    n_tiles = mesh.axis_size(tile_axis)
    loffs = local_level_offsets(cfg, n_tiles)
    lrows = level_rows(cfg, n_tiles)
    axes = (tile_axis, search_axis)
    tile = mesh.axis_index(tile_axis)
    dev = local.device
    table = (local if cfg.matcher_mode != "onehot_bf16"
             else local.to(torch.bfloat16).to(torch.float32))
    n_valid = valid.sum(dtype=torch.float32)
    tol2 = cfg.early_exit_tol ** 2

    # ---------------- match: coarse-to-fine over the pyramid -----------
    estimate = match_pose
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    fails = torch.zeros((), dtype=torch.int32, device=dev)
    resid_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_in = torch.zeros((), dtype=torch.float32, device=dev)
    any_valid = None
    for level in range(cfg.num_levels - 1, -1, -1):
        width, rows = cfg.level_sizes[level], lrows[level]
        scale = 1.0 / cfg.level_resolutions[level]
        est = torch.stack([estimate[0] * scale, estimate[1] * scale,
                           estimate[2]])
        live = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(cfg.estimate_iterations[level]):
            red = _local_gn_reduce(mesh, table, loffs[level], width, rows,
                                   tile * rows, scale, est, X, Y, valid,
                                   n_valid, axes)
            if any_valid is None:
                any_valid = red[11] > 0
            s0, s1, s2, ok = _solve_scalar(*red[3:9], *red[:3],
                                           cfg.deriv_clamp,
                                           cfg.xy_step_clamp_px)
            new = torch.stack([est[0] + s0, est[1] + s1, est[2] + s2])
            if tol2 > 0.0:
                # JAX's while_loop, masked: an iteration counts only while
                # the previous one moved more than the tolerance
                d = new - est
                est = torch.where(live, new, est)
                fails = fails + (~ok & live).to(torch.int32)
                resid_sum = torch.where(live, red[9], resid_sum)
                n_in = torch.where(live, red[10], n_in)
                iters = iters + live.to(torch.int32)
                live = live & ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
                               > tol2)
            else:
                est = new
                fails = fails + (~ok).to(torch.int32)
                resid_sum, n_in = red[9], red[10]
        if tol2 == 0.0:
            iters = iters + cfg.estimate_iterations[level]
        estimate = torch.stack([true_div(est[0], scale),
                                true_div(est[1], scale),
                                normalize_angle(est[2])])
    if any_valid is None:
        any_valid = mesh.psum(n_valid, search_axis) > 0
    matched = torch.where(any_valid, estimate, match_pose)
    if cfg.max_match_jump > 0.0:
        # reject physically impossible per-scan jumps (models/hector.update)
        jump2 = ((matched[:2] - match_pose[:2]) ** 2).sum()
        matched = torch.where(jump2 <= cfg.max_match_jump ** 2, matched,
                              match_pose)
    new_pose = torch.where(force, match_pose, matched)

    # ---------------- motion gate (replicated scalars) ------------------
    dist2 = ((new_pose[:2] - last_update_pose[:2]) ** 2).sum()
    if cfg.angle_gate_compat:
        ang_gate = deg_diff(new_pose[2], last_update_pose[2]) \
            > cfg.min_angle_diff_for_map_update
    else:
        ang_gate = rad_diff(new_pose[2], last_update_pose[2]).abs() \
            > cfg.min_angle_diff_for_map_update
    do_update = (dist2 > cfg.min_distance_diff_for_map_update ** 2) \
        | ang_gate | force

    # ------- the update of every level, masked by do_update, + halos -------
    marks = mesh.pmax(torch.cat([
        tiles.line_marks(X, Y, valid, new_pose,
                         1.0 / cfg.level_resolutions[level],
                         cfg.level_sizes[level], tile * lrows[level],
                         lrows[level])
        for level in range(cfg.num_levels)]), search_axis)
    owned, m0 = [], 0
    for level in range(cfg.num_levels):
        n = lrows[level] * cfg.level_sizes[level]
        owned.append(tiles.apply_marks(
            local[loffs[level]:loffs[level] + n], marks[m0:m0 + n],
            cfg.log_odds_free, cfg.log_odds_occupied, cfg.occupied_cap))
        m0 += n
    halos = mesh.ppermute(
        torch.cat([o[:cfg.level_sizes[lv]] for lv, o in enumerate(owned)]),
        tile_axis, [(i, i - 1) for i in range(1, n_tiles)])
    parts, h0 = [], 0
    for level, o in enumerate(owned):
        w = cfg.level_sizes[level]
        parts += [o, halos[h0:h0 + w]]
        h0 += w
    new_local = torch.where(do_update, torch.cat(parts), local)
    new_last = torch.where(do_update, new_pose, last_update_pose)
    info = hector.HectorInfo(
        map_updated=do_update, residual=resid_sum / n_in.clamp(min=1.0),
        gn_iterations=iters, solve_failures=fails)
    return new_local, new_pose, new_last, info


class Step:
    """The sharded per-scan step over ``mesh`` (``make_step``).

    ``step(state, points f32[N, 2], valid bool[N], force)`` takes the whole
    scan and keeps this rank's beam chunk; ``step.local(state, X, Y, valid,
    force)`` takes the chunk itself (``beam_shard``, or built by the rank
    alone).  Both return (state, HectorInfo), ``models.hector.update``'s
    contract with the hint the state's match pose."""

    def __init__(self, mesh: Mesh, cfg: HectorConfig, num_beams: int,
                 tile_axis: str = "tile", search_axis: str = "search"):
        _check_cfg(cfg)
        self.mesh, self.cfg, self.num_beams = mesh, cfg, num_beams
        self.tile_axis, self.search_axis = tile_axis, search_axis

    def local(self, state: ShardedHectorState, X: torch.Tensor,
              Y: torch.Tensor, valid: torch.Tensor, force
              ) -> Tuple[ShardedHectorState, hector.HectorInfo]:
        dev = state.local_maps.device
        force = torch.as_tensor(force, device=dev).to(torch.bool)
        loc, pose, last, info = local_full_step(
            self.mesh, state.local_maps, state.match_pose,
            state.last_update_pose, X, Y, valid, force, self.cfg,
            self.tile_axis, self.search_axis)
        return ShardedHectorState(loc, pose, last), info

    def __call__(self, state: ShardedHectorState, points: torch.Tensor,
                 valid: torch.Tensor, force
                 ) -> Tuple[ShardedHectorState, hector.HectorInfo]:
        m, n, ax = self.mesh, self.num_beams, self.search_axis
        return self.local(state, beam_shard(m, points[:, 0], n, 0.0, ax),
                          beam_shard(m, points[:, 1], n, 0.0, ax),
                          beam_shard(m, valid, n, False, ax), force)


def make_step(mesh: Mesh, cfg: HectorConfig, num_beams: int,
              tile_axis: str = "tile", search_axis: str = "search") -> Step:
    """The sharded step for scans of ``num_beams`` beams (see ``Step``)."""
    return Step(mesh, cfg, num_beams, tile_axis, search_axis)
