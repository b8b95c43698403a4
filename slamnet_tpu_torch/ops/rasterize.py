"""Closed-form Hector Bresenham line rasterization (PyTorch).

Port of ``slamnet_tpu/ops/rasterize.py::hector_line_cells`` (:67-97), the
vectorised form of Bresenham2D (OccGridMap.cs:155-239): the cell at step k of
a beam is a pure function of k, so a scan rasterizes as one dense
``[beams, max_steps]`` computation.  It is K4's plain version's geometry
(``ops/logodds.py::update_occupancy``); the kernel (``csrc/line.cu``)
inverts the same formula for the steps of a beam that fall in each square
map tile and walks only those (``ops/line.py::tile_walk``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LineCells(NamedTuple):
    """Rasterized cells: flat index per (beam, step) + validity mask."""

    flat: torch.Tensor   # i32[..., K] flat index y * width + x (garbage where ~mask)
    mask: torch.Tensor   # bool[..., K]


def hector_line_cells(begin_xy: torch.Tensor, end_xy: torch.Tensor, width: int,
                      max_steps: int) -> LineCells:
    """Free cells of Hector's Bresenham2D for i32[..., 2] pixel ``begin_xy``
    and ``end_xy``: the abs_da cells from begin toward end, endpoint
    EXCLUDED (the reference marks it occupied separately); a begin == end
    beam gives none.  Geometry only: the caller masks beams with an end
    outside the map (UpdateLineBresenhami bails, OccGridMap.cs:158-161)."""
    dx = end_xy[..., 0] - begin_xy[..., 0]
    dy = end_xy[..., 1] - begin_xy[..., 1]
    adx, ady = dx.abs(), dy.abs()
    sx, sy = dx.sign(), dy.sign()

    x_major = adx >= ady
    maj = torch.where(x_major, adx, ady)                       # abs_da
    mino = torch.where(x_major, ady, adx)                      # abs_db
    off_major = torch.where(x_major, sx, sy * width)
    off_minor = torch.where(x_major, sy * width, sx)
    e0 = maj // 2                                              # error_b init

    k = torch.arange(max_steps, dtype=torch.int32, device=begin_xy.device)
    safe_maj = maj.clamp(min=1)[..., None]
    # minor steps before drawing cell k: m_k = floor((e0 + k*abs_db) / abs_da)
    m = (e0[..., None] + k * mino[..., None]) // safe_maj
    start = begin_xy[..., 1] * width + begin_xy[..., 0]
    flat = start[..., None] + k * off_major[..., None] + m * off_minor[..., None]
    mask = (k < maj[..., None]) & (maj[..., None] > 0)
    return LineCells(flat, mask)
