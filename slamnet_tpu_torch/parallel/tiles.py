"""Map-row tiling with a halo row: a grid's memory sharded across ranks.

Port of ``slamnet_tpu/parallel/tiles.py``.  A global [H, W] grid is
row-tiled over the ``tile`` axis: tile t owns rows [t * rows, (t + 1) *
rows) plus ONE halo row, a copy of the south neighbour's first owned row,
because a bilinear read at row y also reads y + 1 (ScanMatcher.cs:230-233).
The last tile's halo is zeros (bilinear reads stop at H - 2, inside it).
The halo is refreshed by one ``ppermute`` after every map update.

Beam geometry is replicated (every rank walks every beam and keeps the cells
in its rows); only the grid's memory and its gathers and scatters are
sharded.  Functions ending in ``_local`` run on every rank of the axis with
that rank's tile f32[rows + 1, W].  ``line_marks`` / ``apply_marks`` are the
per-tile line update that ``models/hector_sharded.py`` also runs: free and
occupied marks as one code a cell (0 none, 1 free, 2 or 3 occupied), so that
marks from several beam shards combine by one ``pmax`` (occupied wins over
free, as ``ops/logodds.update_occupancy`` rules).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.geometry import dotnet_round
from ..ops import gn
from ..ops.rasterize import hector_line_cells
from .mesh import Mesh


def halo_exchange_local(mesh: Mesh, local: torch.Tensor,
                        axis: str) -> torch.Tensor:
    """``local`` f32[rows + 1, W] with its last (halo) row replaced by the
    south neighbour's first owned row (zeros on the last tile)."""
    n = mesh.axis_size(axis)
    halo = mesh.ppermute(local[0], axis, [(i, i - 1) for i in range(1, n)])
    return torch.cat([local[:-1], halo[None]])


def tiled_hessian_derivs_local(mesh: Mesh, local: torch.Tensor, width: int,
                               rows: int, points: torch.Tensor,
                               valid: torch.Tensor, pose_px: torch.Tensor,
                               scale_to_map: float, axis: str
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, dTr) of the whole grid from the points landing in this tile's
    rows, psum'd over ``axis`` (``ops.gn.hessian_derivs``' values, summed in
    another order)."""
    r0 = mesh.axis_index(axis) * rows
    height = rows * mesh.axis_size(axis)
    sin_r = torch.sin(pose_px[2]) * scale_to_map
    cos_r = torch.cos(pose_px[2]) * scale_to_map
    X, Y = points[:, 0], points[:, 1]
    mx = cos_r * X - sin_r * Y + pose_px[0]
    my = sin_r * X + cos_r * Y + pose_px[1]
    in_b = (valid & (mx >= 0.0) & (mx <= width - 2) & (my >= 0.0)
            & (my <= height - 2))
    x0 = mx.to(torch.int32).clamp(0, width - 2)
    y0 = my.to(torch.int32).clamp(0, height - 2)
    mine = in_b & (y0 >= r0) & (y0 < r0 + rows)
    zi = torch.zeros_like(y0)
    base = (torch.where(mine, y0 - r0, zi) * width
            + torch.where(mine, x0, zi)).long()
    flat = local.reshape(-1)
    v = torch.sigmoid(flat[torch.stack([base, base + 1, base + width,
                                        base + width + 1])])
    fx = mx - x0
    fy = my - y0
    xf, yf = 1.0 - fx, 1.0 - fy
    val = (v[0] * xf + v[1] * fx) * yf + (v[2] * xf + v[3] * fx) * fy
    z = torch.zeros_like(val)
    gx = torch.where(mine, -((v[0] - v[1]) * xf + (v[2] - v[3]) * fx), z)
    gy = torch.where(mine, -((v[0] - v[2]) * yf + (v[1] - v[3]) * fy), z)
    fun = torch.where(mine, 1.0 - val, z)
    rot = (-sin_r * X - cos_r * Y) * gx + (cos_r * X - sin_r * Y) * gy
    s = mesh.psum(torch.stack([gx * fun, gy * fun, rot * fun, gx * gx,
                               gy * gy, rot * rot, gx * gy, gx * rot,
                               gy * rot]).sum(dim=1), axis)
    H = torch.stack([torch.stack([s[3], s[6], s[7]]),
                     torch.stack([s[6], s[4], s[8]]),
                     torch.stack([s[7], s[8], s[5]])])
    return H, s[:3]


def tiled_gn_iteration_local(mesh: Mesh, local, width, rows, points, valid,
                             pose_px, scale_to_map, axis,
                             deriv_clamp: float = 0.2) -> torch.Tensor:
    H, dtr = tiled_hessian_derivs_local(mesh, local, width, rows, points,
                                        valid, pose_px, scale_to_map, axis)
    return pose_px + gn.solve_gn_step(H, dtr, deriv_clamp)


def line_marks(points_x: torch.Tensor, points_y: torch.Tensor,
               valid: torch.Tensor, pose: torch.Tensor, scale: float,
               width: int, r0: int, rows: int) -> torch.Tensor:
    """u8[rows * width]: the line update's marks on rows [r0, r0 + rows) of
    a width x width level from these beams at ``pose`` (world; the scan's
    own pose zero, as every model passes it): 2 + free where a beam
    ends (occupied), 1 where one crosses (free), 0 elsewhere.  The geometry
    is ``ops/logodds.update_occupancy``'s, op for op."""
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    tx, ty = pose[0], pose[1]
    begin = torch.stack([dotnet_round(tx * scale), dotnet_round(ty * scale)])
    ex = (c * points_x - s * points_y + tx) * scale
    ey = (s * points_x + c * points_y + ty) * scale
    end = torch.stack([dotnet_round(ex), dotnet_round(ey)], dim=-1)

    def in_dims(p):
        return ((p[..., 0] >= 0) & (p[..., 0] < width) & (p[..., 1] >= 0)
                & (p[..., 1] < width))

    begin_b = begin.expand_as(end)
    same = (end[:, 0] == begin_b[:, 0]) & (end[:, 1] == begin_b[:, 1])
    beam_ok = valid & ~same & in_dims(begin_b) & in_dims(end)
    cells = hector_line_cells(begin_b, end, width, max_steps=width)
    cy = torch.div(cells.flat, width, rounding_mode="floor")
    fmask = cells.mask & beam_ok[:, None] & (cy >= r0) & (cy < r0 + rows)
    zero = torch.zeros_like(cells.flat)
    lflat = torch.where(fmask, cells.flat - r0 * width, zero)
    n = rows * width
    free = torch.zeros(n, dtype=torch.int32, device=valid.device).scatter_reduce(
        0, lflat.reshape(-1).long(), fmask.reshape(-1).to(torch.int32), "amax")
    omask = beam_ok & (end[:, 1] >= r0) & (end[:, 1] < r0 + rows)
    oflat = torch.where(omask, (end[:, 1] - r0) * width + end[:, 0],
                        torch.zeros_like(end[:, 0]))
    occ = torch.zeros(n, dtype=torch.int32, device=valid.device).scatter_reduce(
        0, oflat.long(), omask.to(torch.int32), "amax")
    return (free + 2 * occ).to(torch.uint8)


def apply_marks(owned: torch.Tensor, marks: torch.Tensor, log_odds_free: float,
                log_odds_occupied: float, occupied_cap: float) -> torch.Tensor:
    """The log-odds update of ``owned`` f32[rows * width] from combined
    ``marks``: occupied cells (2, 3) gain ``log_odds_occupied`` under the
    cap, free cells (1) ``log_odds_free`` — ``update_occupancy``'s sum, in
    its order."""
    zero = torch.zeros_like(owned)
    return (owned + torch.where(marks == 1, log_odds_free, zero)
            + torch.where((marks >= 2) & (owned < occupied_cap),
                          log_odds_occupied, zero))


def tiled_occupancy_update_local(mesh: Mesh, local: torch.Tensor, width: int,
                                 rows: int, points: torch.Tensor,
                                 valid: torch.Tensor,
                                 robot_pose_world: torch.Tensor,
                                 scale_to_map: float, log_odds_free: float,
                                 log_odds_occupied: float, axis: str,
                                 occupied_cap: float = 50.0) -> torch.Tensor:
    """This tile's rows of ``ops.logodds.update_occupancy`` (scan pose
    zero), then the halo refresh: bit for bit the dense update's rows.
    Every rank walks every beam and keeps the cells in its rows."""
    r0 = mesh.axis_index(axis) * rows
    marks = line_marks(points[:, 0], points[:, 1], valid, robot_pose_world,
                       scale_to_map, width, r0, rows)
    owned = apply_marks(local[:rows].reshape(-1), marks, log_odds_free,
                        log_odds_occupied, occupied_cap)
    return halo_exchange_local(
        mesh, torch.cat([owned.reshape(rows, width), local[rows:]]), axis)


# ------------------------------ host side -----------------------------------

def shard_grid(grid: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """[n_tiles, rows + 1, W]: each tile's owned rows and halo row of the
    global [H, W] ``grid`` (H divisible by ``n_tiles``)."""
    h, w = grid.shape
    if h % n_tiles:
        raise ValueError(f"{h} rows do not divide into {n_tiles} tiles")
    rows = h // n_tiles
    zero = torch.zeros((1, w), dtype=grid.dtype, device=grid.device)
    return torch.stack([
        torch.cat([grid[t * rows:(t + 1) * rows],
                   grid[(t + 1) * rows][None] if t + 1 < n_tiles else zero])
        for t in range(n_tiles)])


def local_tile(mesh: Mesh, grid: torch.Tensor, axis: str = "tile"
               ) -> torch.Tensor:
    """This rank's tile of the global ``grid`` (on the mesh's device)."""
    return shard_grid(grid, mesh.axis_size(axis))[
        mesh.axis_index(axis)].to(mesh.device)


def unshard_grid(stacked: torch.Tensor) -> torch.Tensor:
    """The global grid from stacked [T, rows + 1, W] tiles (halos dropped)."""
    return torch.cat([t[:-1] for t in stacked])


def gather_grid(mesh: Mesh, local: torch.Tensor, axis: str = "tile"
                ) -> torch.Tensor:
    """The global grid, on every rank of the ``axis`` line, from each
    rank's tile (one ``all_gather``)."""
    return unshard_grid(mesh.all_gather(local, axis))
