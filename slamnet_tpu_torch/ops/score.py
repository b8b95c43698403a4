"""Monte-Carlo candidate scoring against the hole map (CoreSLAM's parity
search).

Port of ``slamnet_tpu/ops/score.py``: MonteCarloSearch + CalculateDistanceSISD
(CoreSLAMProcessor.cs:624-653, 226-259).  The reference perturbs the same
search pose ``iterations`` times a thread and keeps the argmin, so its
4 x 1000 draws are one batch of independent candidates scored at once: a
rotate-translate of the cloud per candidate, the pixel snap with C#
truncation, a gather from the hole map, an int32 masked sum, one argmin.

The search is split in two so that each half can be held on its own:
``sample_candidates`` draws the batch from a ``torch.Generator`` (its
numbers differ from ``jax.random``'s; the distribution is the same) and
``best_of`` scores any candidate set and keeps the first minimum, as the
reference's strict-improvement update does.  The score's ordering is the
in-bounds pixel sum's: the reference's ``sum * 1024 / count`` has the same
denominator for every candidate.  An out-of-bounds point is skipped and a
candidate with no point in bounds scores int-max (:251-258).

Torch operators in direct form on the tensors' device; no hand kernel (the
JAX package runs this in XLA, not in a Pallas kernel).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.geometry import cos_rn, csharp_trunc, sin_rn

INT32_MAX = 2**31 - 1


def candidate_pixels(poses: torch.Tensor, points: torch.Tensor,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every candidate's snapped cloud, (x, y) i32[B, N]: the +0.5 centre
    bias, then C#'s (int) truncation (CalculateDistanceSISD, :232-241)."""
    px = poses[:, 0] * scale + 0.5
    py = poses[:, 1] * scale + 0.5
    c = cos_rn(poses[:, 2]) * scale
    s = sin_rn(poses[:, 2]) * scale
    X = points[:, 0][None, :]
    Y = points[:, 1][None, :]
    return (csharp_trunc(px[:, None] + c[:, None] * X - s[:, None] * Y),
            csharp_trunc(py[:, None] + s[:, None] * X + c[:, None] * Y))


def score_candidates(hole_map_flat: torch.Tensor, size: int, scale: float,
                     points: torch.Tensor, valid: torch.Tensor,
                     poses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score B candidate poses; returns (sum i32[B], in-bounds points
    i32[B]).  hole_map_flat: i32[size*size]; points: f32[N, 2]; valid:
    bool[N]; poses: f32[B, 3].  The sums stay below N x 65500 < 2^31."""
    x, y = candidate_pixels(poses, points, scale)
    in_b = (x >= 0) & (x < size) & (y >= 0) & (y < size) & valid[None, :]
    flat = torch.where(in_b, y * size + x, torch.zeros_like(x))
    vals = torch.where(in_b, hole_map_flat[flat.long()],
                       torch.zeros_like(x))
    return (vals.sum(dim=1, dtype=torch.int32),
            in_b.sum(dim=1, dtype=torch.int32))


def reference_score(sums: torch.Tensor, nb: torch.Tensor,
                    total_points) -> torch.Tensor:
    """The reference's score ``sum * 1024 / count`` (int64; for metrics and
    parity checks); int-max where no point is in bounds."""
    total = max(int(total_points), 1)
    score = torch.div(sums.to(torch.int64) * 1024, total,
                      rounding_mode="floor")
    return torch.where(nb > 0, score, torch.full_like(score, INT32_MAX))


def sample_candidates(search_pose: torch.Tensor, sigma_xy: float,
                      sigma_theta: float, num_candidates: int,
                      generator: torch.Generator) -> torch.Tensor:
    """f32[num_candidates, 3] candidates ~ N(search_pose, diag(sxy, sxy,
    stheta)); candidate 0 is the search pose itself (the reference scores it
    first as the initial best, CoreSLAMProcessor.cs:626-628).  Draws the xy
    normals, then the heading normals, from ``generator`` (on the pose's
    device)."""
    dev = search_pose.device
    dxy = torch.randn((num_candidates, 2), generator=generator,
                      device=dev) * sigma_xy
    dth = torch.randn((num_candidates, 1), generator=generator,
                      device=dev) * sigma_theta
    deltas = torch.cat([dxy, dth], dim=1)
    deltas[0] = 0.0
    return search_pose[None, :] + deltas


def best_of(cands: torch.Tensor, hole_map_flat: torch.Tensor, size: int,
            scale: float, points: torch.Tensor, valid: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best pose f32[3], its sum i32[]) over the candidate set f32[B, 3]:
    the first minimum of the effective sums (int-max where nothing is in
    bounds).  Both stay on the device."""
    sums, nb = score_candidates(hole_map_flat, size, scale, points, valid,
                                cands)
    eff = torch.where(nb > 0, sums, torch.full_like(sums, INT32_MAX))
    # a 1-element index tensor: indexing with argmin's 0-dim one would read
    # it to the host
    best = torch.argmin(eff).reshape(1)
    return cands.index_select(0, best)[0], eff.index_select(0, best)[0]


def monte_carlo_search(hole_map_flat: torch.Tensor, size: int, scale: float,
                       points: torch.Tensor, valid: torch.Tensor,
                       search_pose: torch.Tensor, sigma_xy: float,
                       sigma_theta: float, num_candidates: int,
                       generator: torch.Generator
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``best_of`` over ``sample_candidates``: (best pose f32[3], best sum
    i32[])."""
    cands = sample_candidates(search_pose, sigma_xy, sigma_theta,
                              num_candidates, generator)
    return best_of(cands, hole_map_flat, size, scale, points, valid)
