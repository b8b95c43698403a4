"""Closed-form line rasterization (PyTorch): the Bresenham walks of the
reference as pure functions of the step index.

Port of ``slamnet_tpu/ops/rasterize.py``.  Each of the reference's three
error recurrences is a "staircase" (a running value gains a constant and is
knocked down by D when it crosses a threshold), whose overflow count after n
steps has an exact closed form, so the cell at step k of a beam is a pure
function of k and a scan rasterizes as one dense ``[beams, max_steps]``
computation:

- ``hector_line_cells``: Hector's Bresenham2D (OccGridMap.cs:155-239), K4's
  plain version's geometry (``ops/logodds.py::update_occupancy``); the kernel
  (``csrc/line.cu``) inverts the same formula for the steps of a beam that
  fall in each square map tile and walks only those (``ops/line.py::
  tile_walk``);
- ``rosetta_line_cells``: CoreSLAM's obstacle-map walk
  (DrawLaserRayOnObstacleMap, CoreSLAMProcessor.cs:456-490);
- ``hole_ray_cells``: CoreSLAM's hole-map walk and V-profile
  (DrawLaserRayOnHoleMap, CoreSLAMProcessor.cs:359-443), with
  ``clip_ray_endpoint`` (ClipRay, :320-345).

All integer arithmetic is int32; C#'s truncating division is ``idiv_trunc``
where the reference divides, Python's floor division where the closed forms
floor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def idiv_trunc(a, b: torch.Tensor) -> torch.Tensor:
    """C# integer division: truncation toward zero (``//`` floors instead).
    ``a`` may be a Python int."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return torch.div(a, b, rounding_mode="trunc")


def staircase_count(e0, a, n, d, threshold) -> torch.Tensor:
    """Overflow count of ``e_j = e_{j-1} + a; if e_j > threshold: e_j -= d``
    after n steps, exact for a >= 0, clipped to [0, n] (the minor axis steps
    at most once an iteration).  For a < 0 use ``staircase_count_cummax``."""
    raw = torch.div(e0 + n * a - threshold - 1, d, rounding_mode="floor") + 1
    return torch.minimum(raw.clamp(min=0), n)


def staircase_count_cummax(e0, a, n, d, threshold, dim: int = -1
                           ) -> torch.Tensor:
    """Sign-robust overflow count: the running max of ``staircase_count``
    along the (monotone in n) step axis."""
    return torch.cummax(staircase_count(e0, a, n, d, threshold), dim=dim)[0]


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


def rosetta_line_cells(begin_xy: torch.Tensor, end_xy: torch.Tensor,
                       size: int, max_steps: int):
    """Cells of the symmetric Bresenham of the obstacle map
    (DrawLaserRayOnObstacleMap, CoreSLAMProcessor.cs:456-490) for i32[B, 2]
    pixel ``begin_xy`` and ``end_xy``: both axes may step in one iteration;
    the walk visits max(|dx|, |dy|) intermediate cells, then the endpoint,
    and a cell outside the map is dropped (a monotone path from an in-map
    start never re-enters).

    Returns (LineCells of the intermediate "no-hit" cells, i32[B] endpoint
    flat index, bool[B] endpoint in the map)."""
    dx = end_xy[:, 0] - begin_xy[:, 0]
    dy = end_xy[:, 1] - begin_xy[:, 1]
    adx, ady = dx.abs(), dy.abs()
    sx, sy = dx.sign(), dy.sign()

    x_major = adx > ady                        # err = (dx>dy ? dx : -dy)/2
    maj = torch.maximum(adx, ady)
    mino = torch.minimum(adx, ady)
    e0 = torch.where(x_major, adx // 2, ady // 2)   # |err| of the C# init

    k = torch.arange(max_steps, dtype=torch.int32,
                     device=begin_xy.device)[None, :]
    safe_maj = maj.clamp(min=1)[:, None]
    # minor steps before visiting cell k (fire on err < minor, checked after
    # the major-axis update): floor((k*mino - e0 + maj - 1) / maj)
    m = torch.div(k * mino[:, None] - e0[:, None] + safe_maj - 1, safe_maj,
                  rounding_mode="floor")
    m = torch.minimum(m.clamp(min=0), k)

    xm = x_major[:, None]
    x = torch.where(xm, begin_xy[:, 0:1] + k * sx[:, None],
                    begin_xy[:, 0:1] + m * sx[:, None])
    y = torch.where(xm, begin_xy[:, 1:2] + m * sy[:, None],
                    begin_xy[:, 1:2] + k * sy[:, None])

    in_map = (x >= 0) & (x < size) & (y >= 0) & (y < size)
    cells_mask = (k < maj[:, None]) & in_map
    end_flat = end_xy[:, 1] * size + end_xy[:, 0]
    end_ok = ((end_xy[:, 0] >= 0) & (end_xy[:, 0] < size)
              & (end_xy[:, 1] >= 0) & (end_xy[:, 1] < size))
    return LineCells(y * size + x, cells_mask), end_flat, end_ok


def clip_ray_endpoint(x1, y1, x2, y2, size: int):
    """CoreSLAM's ClipRay pair (CoreSLAMProcessor.cs:320-345, 365-366):
    clip the (x2, y2) end of the segment from (x1, y1) to the map box with
    the reference's integer arithmetic (C# truncating division).  Returns
    (x2c, y2c, ok); ok False is the reference's early return (a degenerate
    clip)."""
    def clip_axis(xyc, yxc, xy, yx):
        lo = xyc < 0
        denom = torch.where(xyc == xy, torch.ones_like(xyc), xyc - xy)
        yxc1 = yxc + idiv_trunc((yxc - yx) * (-xyc), denom)
        bad_lo = lo & (xyc == xy)
        yxc = torch.where(lo, yxc1, yxc)
        xyc = torch.where(lo, torch.zeros_like(xyc), xyc)
        hi = xyc >= size
        denom = torch.where(xyc == xy, torch.ones_like(xyc), xyc - xy)
        yxc2 = yxc + idiv_trunc((yxc - yx) * (size - 1 - xyc), denom)
        bad_hi = hi & (xyc == xy)
        yxc = torch.where(hi, yxc2, yxc)
        xyc = torch.where(hi, torch.full_like(xyc, size - 1), xyc)
        return xyc, yxc, ~(bad_lo | bad_hi)

    x2c, y2c, ok1 = clip_axis(x2, y2, x1, y1)
    y2c, x2c, ok2 = clip_axis(y2c, x2c, y1, x1)
    return x2c, y2c, ok1 & ok2


class HoleRay(NamedTuple):
    """Rasterized hole-map rays: per (beam, step) flat index, V-profile value
    and mask."""

    flat: torch.Tensor    # i32[B, K]
    pixval: torch.Tensor  # i32[B, K] the V-profile value blended at that cell
    mask: torch.Tensor    # bool[B, K]


def hole_ray_cells(x1, y1, x2, y2, xp, yp, value: int, no_obstacle: int,
                   size: int, max_steps: int) -> HoleRay:
    """DrawLaserRayOnHoleMap's walk and V-profile (CoreSLAMProcessor.cs:
    359-443) in closed form, exact against the reference recurrences.

    x1, y1: the robot pixel (0-dim i32 tensors or ints, shared by the
    beams); x2, y2: i32[B] extended endpoints; xp, yp: i32[B] measured hit
    pixels; value: the obstacle value (TS_OBSTACLE = 0); no_obstacle:
    TS_NO_OBSTACLE = 65500."""
    b = x2.shape[0]
    x1b = torch.zeros(b, dtype=torch.int32, device=x2.device) + x1
    y1b = torch.zeros(b, dtype=torch.int32, device=x2.device) + y1

    x2c, y2c, clip_ok = clip_ray_endpoint(x1b, y1b, x2, y2, size)

    dx, dy = (x2 - x1b).abs(), (y2 - y1b).abs()
    dxc, dyc = (x2c - x1b).abs(), (y2c - y1b).abs()
    incptrx = (x2 - x1b).sign()
    incptry = (y2 - y1b).sign() * size
    sincv = (value > no_obstacle) - (value < no_obstacle)

    x_major = dx > dy
    derrorv = torch.where(x_major, (xp - x2).abs(), (yp - y2).abs())
    # the axis swap (CoreSLAMProcessor.cs:383-386)
    dxs = torch.where(x_major, dx, dy)
    dxcs = torch.where(x_major, dxc, dyc)
    dycs = torch.where(x_major, dyc, dxc)
    inc_major = torch.where(x_major, incptrx, incptry)
    inc_minor = torch.where(x_major, incptry, incptrx)

    beam_ok = clip_ok & (derrorv != 0)
    sd = derrorv.clamp(min=1)

    # the V-profile's increments, C# truncating division (:398-399)
    vn = value - no_obstacle
    incv = idiv_trunc(vn, sd)
    incerrorv = vn - sd * incv

    k = torch.arange(max_steps, dtype=torch.int32, device=x2.device)[None, :]
    dxs_, dxcs_, dycs_ = dxs[:, None], dxcs[:, None], dycs[:, None]
    sd_ = sd[:, None]

    # the walk: error starts at 2*dyc - dxc; a strict "error > 0" check
    e0 = 2 * dycs_ - dxcs_
    safe_d = (2 * dxcs_).clamp(min=1)
    m = torch.div(e0 + (k - 1) * 2 * dycs_ - 1, safe_d,
                  rounding_mode="floor") + 1
    m = torch.minimum(m.clamp(min=0), k)
    start = y1 * size + x1
    flat = start + k * inc_major[:, None] + m * inc_minor[:, None]

    # the V-profile's value at step k (:404-428)
    ramp_start = dxs_ - 2 * sd_          # pixval changes for k > ramp_start
    bottom = dxs_ - sd_                  # down-leg for k <= bottom, up after
    # the ramp may begin before iteration 0; only iterations >= 0 run
    ramp_lo = (ramp_start + 1).clamp(min=0)
    total_down = (bottom - ramp_lo + 1).clamp(min=0)
    n_down = torch.minimum((k - ramp_lo + 1).clamp(min=0), total_down)
    n_up = (k - bottom.clamp(min=-1)).clamp(min=0)

    e0v = sd_ // 2                               # errorv = derrorv / 2
    a = incerrorv[:, None]
    # down-leg overflows: check after the add, strict "> derrorv"
    o_down = staircase_count_cummax(e0v, a, n_down, sd_, sd_)
    # the error entering the up-leg, after every down-step ran
    o_down_full = o_down[:, -1:]
    e_end = e0v + total_down * a - sd_ * o_down_full
    # up-leg: "errorv -= incerrorv; if errorv < 0: +=", negated to the same
    # staircase with threshold 0
    o_up = staircase_count_cummax(-e_end, a, n_up, sd_, 0)

    pixval = (no_obstacle + n_down * incv[:, None] + sincv * o_down
              - n_up * incv[:, None] - sincv * o_up)
    mask = (k <= dxcs_) & beam_ok[:, None]
    return HoleRay(flat, pixval, mask)
