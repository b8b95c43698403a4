"""Correlative candidate search: CoreSLAM's deterministic production matcher.

Port of ``slamnet_tpu/ops/correlate.py``.  The Monte-Carlo search samples
continuous poses, but the score snaps each candidate to hole-map pixels, so
this search scores the whole reachable neighbourhood instead:

    sums[k, dy, dx] = sum_p H[yb_kp + dy - R, xb_kp + dx - R]

for K heading bins x a W x W window of pixel shifts (R = W // 2), with the
cloud snapped once a heading (``xb``, ``yb``).  Then the first minimum and a
clamped 1-D quadratic fit along each axis for the sub-pixel / sub-bin
optimum.

Direct form.  The JAX package builds the sums from a one-hot outer-product
count grid, W x W shifted map copies split into 8-bit planes, and an f32
matmul, and ``nb`` (the in-bounds count) from a separable einsum: all three
stand in for a gather the TPU lacks.  Here the sums are one gather of
[K, W, W, N] cells from a zero-padded map and an int32 sum, and ``nb`` the
count of points whose shifted pixel lies in the map.  JAX's sums pass
through its f32 recombination ``256 * hi + lo``, which rounds a sum above
2^24 to the nearest f32; the port rounds its exact int32 sum to f32 and
back, the same value, so both results equal JAX's.  Points outside the
padded range [-R, size + R) count nowhere (the reference skips an
out-of-bounds point, CoreSLAMProcessor.cs:251-254); a candidate with none
in bounds scores int-max (:256-258).

Torch operators on the tensors' device; no hand kernel (the JAX package
runs this in XLA, not in a Pallas kernel).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..core.geometry import cos_rn, csharp_trunc, sin_rn, true_div
from .score import INT32_MAX


def correlative_pixels(search_pose: torch.Tensor, thetas: torch.Tensor,
                       points: torch.Tensor, scale: float):
    """The cloud snapped at ``search_pose``'s xy under each heading:
    (xb, yb) i32[K, N], the +0.5 bias and C# truncation."""
    px = search_pose[0] * scale + 0.5
    py = search_pose[1] * scale + 0.5
    c = (cos_rn(thetas) * scale)[:, None]
    s = (sin_rn(thetas) * scale)[:, None]
    X = points[:, 0][None, :]
    Y = points[:, 1][None, :]
    return (csharp_trunc(px + c * X - s * Y),
            csharp_trunc(py + s * X + c * Y))


def correlative_scores(hole_map_flat: torch.Tensor, size: int, scale: float,
                       points: torch.Tensor, valid: torch.Tensor,
                       search_pose: torch.Tensor, thetas: torch.Tensor,
                       window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw score grid: (sums i32[K, W, W], nb i32[K, W, W]).  Shift
    (dy, dx) is the pixel offset (dy - W//2, dx - W//2) from the cloud
    snapped at ``search_pose``'s xy; ``thetas`` f32[K] are absolute
    headings."""
    R = window // 2
    sp = size + 4 * R
    xb, yb = correlative_pixels(search_pose, thetas, points, scale)
    ok = (valid[None, :] & (xb >= -R) & (xb < size + R)
          & (yb >= -R) & (yb < size + R))

    # the map at offset 2R in a zero plane: every shifted pixel of an ok
    # point lands in [0, size + 4R)
    pad = torch.zeros((sp, sp), dtype=torch.int32, device=hole_map_flat.device)
    pad[2 * R:2 * R + size, 2 * R:2 * R + size] = hole_map_flat.view(size,
                                                                     size)
    shift = torch.arange(window, dtype=torch.int32, device=xb.device)
    zero = torch.zeros_like(xb)
    row = torch.where(ok, (yb + R) * sp, zero)[:, None, :] \
        + (shift * sp)[None, :, None]                           # [K, W, N]
    col = torch.where(ok, xb + R, zero)[:, None, :] + shift[None, :, None]
    cells = pad.view(-1)[(row[:, :, None, :] + col[:, None, :, :]).long()]
    okc = ok[:, None, None, :]
    sums = torch.where(okc, cells, torch.zeros_like(cells)).sum(
        dim=3, dtype=torch.int32)
    # JAX's value: the sum as its f32 recombination rounds it
    sums = sums.to(torch.float32).to(torch.int32)

    d = shift - R
    rows_in = ok[:, None, :] & ((yb[:, None, :] + d[None, :, None]) >= 0) \
        & ((yb[:, None, :] + d[None, :, None]) < size)
    cols_in = ((xb[:, None, :] + d[None, :, None]) >= 0) \
        & ((xb[:, None, :] + d[None, :, None]) < size)
    nb = (rows_in[:, :, None, :] & cols_in[:, None, :, :]).sum(
        dim=3, dtype=torch.int32)
    return sums, nb


@functools.cache
def _linspace(num: int, span: float, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(-span, span, num)``'s expression (``start * (1 - i /
    div) + stop * i / div`` in f32, the stop appended), evaluated op by op
    on ``device`` once (made there: no copy from the host, which would wait
    for the device).  XLA's fused linspace can differ from it by an ulp in a
    few entries."""
    start, stop = -float(span), float(span)
    if num > 1:
        step = true_div(torch.arange(num - 1, dtype=torch.float32,
                                     device=device), float(num - 1))
        return torch.cat([start * (1.0 - step) + stop * step,
                          torch.full((1,), stop, device=device)])
    return torch.full((num,), start, device=device)


def theta_grid(search_heading: torch.Tensor, num_theta: int,
               theta_span: float) -> torch.Tensor:
    """The absolute headings searched: ``search_heading + linspace(-span,
    span, num_theta)``."""
    return search_heading + _linspace(num_theta, float(theta_span),
                                      search_heading.device)


@functools.cache
def _neighbours(device: torch.device):
    """(dk, dy, dx) i64[7]: the minimum, then its -/+ neighbours along x, y
    and the heading (dk = (0, 0, 0, 0, 0, -1, 1), dy = (0, 0, 0, -1, 1, 0,
    0), dx = (0, -1, 1, 0, 0, 0, 0)), on ``device``."""
    i = torch.arange(7, device=device)       # made there, as _linspace
    return tuple((i == up).long() - (i == up - 1).long() for up in (6, 4, 2))


def _quad_offset(fm, f0, fp):
    """Sub-sample offset of the parabola through (-1, fm), (0, f0), (+1, fp);
    0 where the fit is degenerate or not convex, clamped to +/-0.5."""
    d = fm - 2.0 * f0 + fp
    safe = torch.where(d == 0, torch.ones_like(d), d)
    off = torch.where(d > 1e-6, 0.5 * (fm - fp) / safe, torch.zeros_like(d))
    return off.clamp(-0.5, 0.5)


def correlative_search(hole_map_flat: torch.Tensor, size: int, scale: float,
                       points: torch.Tensor, valid: torch.Tensor,
                       search_pose: torch.Tensor, window: int, num_theta: int,
                       theta_span: float, subpixel: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best (pose f32[3], sum i32[]) over the (heading, dy, dx) grid
    around ``search_pose``: ``monte_carlo_search``'s contract (lower is
    better, int-max where nothing is in bounds, the first minimum wins)."""
    thetas = theta_grid(search_pose[2], num_theta, theta_span)
    sums, nb = correlative_scores(hole_map_flat, size, scale, points, valid,
                                  search_pose, thetas, window)
    eff = torch.where(nb > 0, sums, torch.full_like(sums, INT32_MAX))
    return refine_from_scores(eff, search_pose, scale, window, num_theta,
                              theta_span, subpixel)


def refine_from_scores(eff: torch.Tensor, search_pose: torch.Tensor,
                       scale: float, window: int, num_theta: int,
                       theta_span: float, subpixel: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first minimum of eff i32[K, W, W] (int-max = invalid) and the
    sub-pixel / sub-bin quadratic refinement around it, in f32 in JAX's
    order.  No host read: the indices stay device tensors."""
    R = window // 2
    w2 = window * window
    flat = eff.reshape(-1)
    flat_idx = torch.argmin(flat).reshape(1)
    k = flat_idx // w2
    iy = flat_idx % w2 // window
    ix = flat_idx % window
    pos = torch.cat([ix, iy, k]).to(torch.float32)          # x, y, heading
    if subpixel:
        # the minimum and its six neighbours (clamped to the grid) in one
        # gather: a 1-element index from argmin stays on the device
        dk, dy, dx = _neighbours(flat.device)
        v = flat.index_select(0, (k + dk).clamp(0, num_theta - 1) * w2
                              + (iy + dy).clamp(0, window - 1) * window
                              + (ix + dx).clamp(0, window - 1)).to(
            torch.float32)
        pos = pos + _quad_offset(v[1::2], v[0:1], v[2::2])

    dtheta = 2.0 * theta_span / max(num_theta - 1, 1)
    pose = torch.cat([search_pose[:2] + true_div(pos[:2] - R, scale),
                      search_pose[2:3] - theta_span + pos[2:] * dtheta])
    return pose, flat.index_select(0, flat_idx)[0]
