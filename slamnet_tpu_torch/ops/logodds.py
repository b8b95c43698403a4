"""Log-odds occupancy updates of one pyramid level (PyTorch).

Ports of ``slamnet_tpu/ops/logodds.py``:

* ``update_occupancy`` (:26-73), the reference's line update: every beam's
  Bresenham free cells and its occupied endpoint as two order-independent
  scattered masks (OccGridMap.cs:114-239 rules: occupied overrides free,
  ``log_odds_free`` on free cells, ``log_odds_occupied`` on occupied cells
  under the cap).  K4's plain version, applied per level by
  ``ops/line.py::update_maps_line_plain``.
* ``update_occupancy_dense`` (:76-179), the branch its CPU backend takes (an
  exact ``table[cbin]`` lookup): K2's plain version, applied per level by
  ``ops/fill.py::update_maps_plain``.  The free region of one scan is
  star-shaped around the robot: scatter the beam ranges into an
  ``angle_bins`` polar table (per-bin minimum, empty bins 0), then mark
  every cell free whose range is under its bin's entry minus
  ``free_margin_px`` (the wall-erosion guard).

Both take an optional leading instance axis (the fleet).
"""
from __future__ import annotations

import math

import torch

from ..core.geometry import dotnet_round
from .rasterize import hector_line_cells


def update_occupancy(logodds_flat: torch.Tensor, width: int,
                     points: torch.Tensor, valid: torch.Tensor,
                     robot_pose_world: torch.Tensor, scan_pose: torch.Tensor,
                     scale_to_map: float, log_odds_free: float,
                     log_odds_occupied: float,
                     occupied_cap: float = 50.0) -> torch.Tensor:
    """One scan's line update of one level; returns a new f32[width*width].

    Batched over instances when ``logodds_flat`` is f32[B, width*width]:
    points f32[B, N, 2], valid bool[B, N], robot_pose_world f32[B, 3],
    scan_pose f32[B, 2] give f32[B, width*width], each row computed as the
    unbatched call computes it.  Endpoints are p_map = (R(theta) p + t) *
    scale rounded half to even (.NET ToRoundPoint); a beam counts when it is
    valid, its begin differs from its end, and both lie in the map."""
    if logodds_flat.dim() == 1:
        return update_occupancy(
            logodds_flat[None], width, points[None], valid[None],
            robot_pose_world[None], scan_pose[None], scale_to_map,
            log_odds_free, log_odds_occupied, occupied_cap)[0]
    b = logodds_flat.shape[0]
    theta = robot_pose_world[:, 2:3]                     # [B, 1]
    c, s = torch.cos(theta), torch.sin(theta)
    tx, ty = robot_pose_world[:, 0:1], robot_pose_world[:, 1:2]
    bx = (c * scan_pose[:, 0:1] - s * scan_pose[:, 1:2] + tx) * scale_to_map
    by = (s * scan_pose[:, 0:1] + c * scan_pose[:, 1:2] + ty) * scale_to_map
    begin = torch.stack([dotnet_round(bx), dotnet_round(by)], dim=-1)  # [B, 1, 2]

    ex = (c * points[..., 0] - s * points[..., 1] + tx) * scale_to_map
    ey = (s * points[..., 0] + c * points[..., 1] + ty) * scale_to_map
    end = torch.stack([dotnet_round(ex), dotnet_round(ey)], dim=-1)    # [B, N, 2]

    def in_dims(p):
        return ((p[..., 0] >= 0) & (p[..., 0] < width) & (p[..., 1] >= 0)
                & (p[..., 1] < width))

    begin_b = begin.expand_as(end)
    same = (end[..., 0] == begin_b[..., 0]) & (end[..., 1] == begin_b[..., 1])
    beam_ok = valid & ~same & in_dims(begin_b) & in_dims(end)

    cells = hector_line_cells(begin_b, end, width, max_steps=width)
    fmask = cells.mask & beam_ok[..., None]
    ncells = width * width
    free = torch.zeros((b, ncells), dtype=torch.int32, device=points.device)
    free = free.scatter_reduce(
        1, torch.where(fmask, cells.flat, 0).reshape(b, -1).long(),
        fmask.reshape(b, -1).to(torch.int32), "amax")
    end_flat = end[..., 1] * width + end[..., 0]
    occ = torch.zeros((b, ncells), dtype=torch.int32, device=points.device)
    occ = occ.scatter_reduce(1, torch.where(beam_ok, end_flat, 0).long(),
                             beam_ok.to(torch.int32), "amax")

    is_occ = occ > 0
    is_free = (free > 0) & ~is_occ
    zero = torch.zeros_like(logodds_flat)
    return (logodds_flat
            + torch.where(is_free, log_odds_free, zero)
            + torch.where(is_occ & (logodds_flat < occupied_cap),
                          log_odds_occupied, zero))


def update_occupancy_dense(logodds_flat: torch.Tensor, width: int,
                           points: torch.Tensor, valid: torch.Tensor,
                           robot_pose_world: torch.Tensor,
                           scan_pose: torch.Tensor, scale_to_map: float,
                           log_odds_free: float, log_odds_occupied: float,
                           occupied_cap: float = 50.0,
                           angle_bins: int = 256,
                           free_margin_px: float = 0.75) -> torch.Tensor:
    """One scan's dense update of one level; returns a new f32[width*width].

    Batched over instances when ``logodds_flat`` is f32[B, width*width]:
    points f32[B, N, 2], valid bool[B, N], robot_pose_world f32[B, 3],
    scan_pose f32[B, 2] give f32[B, width*width], each row computed as the
    unbatched call computes it."""
    if logodds_flat.dim() == 1:
        return update_occupancy_dense(
            logodds_flat[None], width, points[None], valid[None],
            robot_pose_world[None], scan_pose[None], scale_to_map,
            log_odds_free, log_odds_occupied, occupied_cap, angle_bins,
            free_margin_px)[0]
    dev = logodds_flat.device
    b = logodds_flat.shape[0]
    theta = robot_pose_world[:, 2:3]                     # [B, 1]
    c, s = torch.cos(theta), torch.sin(theta)
    tx, ty = robot_pose_world[:, 0:1], robot_pose_world[:, 1:2]
    bx = (c * scan_pose[:, 0:1] - s * scan_pose[:, 1:2] + tx) * scale_to_map
    by = (s * scan_pose[:, 0:1] + c * scan_pose[:, 1:2] + ty) * scale_to_map
    bxi, byi = dotnet_round(bx), dotnet_round(by)        # [B, 1]

    ex = (c * points[..., 0] - s * points[..., 1] + tx) * scale_to_map
    ey = (s * points[..., 0] + c * points[..., 1] + ty) * scale_to_map
    exi, eyi = dotnet_round(ex), dotnet_round(ey)        # [B, N]

    def in_dims(x, y):
        return (x >= 0) & (x < width) & (y >= 0) & (y < width)

    same = (exi == bxi) & (eyi == byi)
    beam_ok = valid & ~same & in_dims(bxi, byi) & in_dims(exi, eyi)

    # polar range table: per bin the MIN valid beam range (px); empty bins 0
    dxe = (exi - bxi).to(torch.float32)
    dye = (eyi - byi).to(torch.float32)
    r_beam = torch.sqrt(dxe * dxe + dye * dye)
    bin_scale = angle_bins / (2.0 * math.pi)
    bins = ((torch.atan2(dye, dxe) + math.pi) * bin_scale).to(torch.int32)
    bins = bins.clamp(0, angle_bins - 1)
    big = 1e9
    table = torch.full((b, angle_bins), big, dtype=torch.float32, device=dev)
    table = table.scatter_reduce(
        1, torch.where(beam_ok, bins, 0).long(),
        torch.where(beam_ok, r_beam, torch.full_like(r_beam, big)), "amin")
    table = torch.where(table >= big, torch.zeros_like(table), table)

    # dense per-cell test
    idx = torch.arange(width, dtype=torch.int32, device=dev)
    dx = (idx[None, None, :] - bxi[:, :, None]).to(torch.float32)  # [B, 1, W]
    dy = (idx[None, :, None] - byi[:, :, None]).to(torch.float32)  # [B, W, 1]
    r_cell = torch.sqrt(dx * dx + dy * dy).reshape(b, -1)         # [B, W*W]
    shape = (b, width, width)
    cbin = ((torch.atan2(dy.expand(shape), dx.expand(shape)) + math.pi)
            * bin_scale).to(torch.int32).clamp(0, angle_bins - 1)
    r_lim = table.gather(1, cbin.reshape(b, -1).long())
    is_free_img = (r_cell < r_lim - free_margin_px) & (r_cell > 0.0)

    # occupied endpoints: a per-instance N-point scatter
    end_flat = torch.where(beam_ok, eyi * width + exi, 0).long()
    occ = torch.zeros((b, width * width), dtype=torch.int32, device=dev)
    occ = occ.scatter_reduce(1, end_flat, beam_ok.to(torch.int32), "amax")

    is_occ = occ > 0
    is_free = is_free_img & ~is_occ & beam_ok.any(dim=1, keepdim=True)
    zero = torch.zeros_like(logodds_flat)
    return (logodds_flat
            + torch.where(is_free, log_odds_free, zero)
            + torch.where(is_occ & (logodds_flat < occupied_cap),
                          log_odds_occupied, zero))
