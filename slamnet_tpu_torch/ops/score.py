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

On the card ``best_of`` is K8 (``csrc/mc_search.cu``): the scores and the
first minimum in one launch, bit for bit ``best_of_plain``; CPU tensors
take ``best_of_plain``.  The rest are torch operators in direct form on the
tensors' device (the JAX package runs the search in XLA, not in a Pallas
kernel).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..core.geometry import cos_rn, csharp_trunc, sin_rn
from . import _build

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


class _SearchParams(ctypes.Structure):
    """``struct SearchParams`` of csrc/mc_search.cu, passed by value."""

    _fields_ = [("b", ctypes.c_int), ("n", ctypes.c_int),
                ("size", ctypes.c_int), ("scale", ctypes.c_float)]


@functools.cache
def _launcher():
    fn = _build.library()[0].slamnet_mc_search
    fn.argtypes = [ctypes.c_void_p] * 6 + [_SearchParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _slot(device: torch.device) -> torch.Tensor:
    """K8's reduction slot and block ticket on ``device`` (u64 ~0 and 0
    between launches; the last block re-arms them).  One a device: two
    searches on one device launched from two streams at once would share
    it."""
    return torch.tensor([-1, 0], dtype=torch.int64, device=device)


def check_search_inputs(cands: torch.Tensor, hole_map_flat: torch.Tensor,
                        size: int, points: torch.Tensor,
                        valid: torch.Tensor) -> Tuple[int, int]:
    """Raise ValueError unless K8 takes the inputs: contiguous f32[B, 3]
    candidates (B >= 1), i32[size^2] map, f32[N, 2] points and bool[N]
    valid on one device.  Reads only the tensors' metadata.  Returns
    (B, N)."""
    b = cands.shape[0] if cands.dim() == 2 and cands.shape[0] >= 1 else -1
    n = points.shape[0] if points.dim() == 2 else -1
    _build.check_tensors("K8 search", cands.device, (
        ("cands", cands, torch.float32, (b, 3)),
        ("hole_map", hole_map_flat, torch.int32, (size * size,)),
        ("points", points, torch.float32, (n, 2)),
        ("valid", valid, torch.bool, (n,))))
    return b, n


def best_of(cands: torch.Tensor, hole_map_flat: torch.Tensor, size: int,
            scale: float, points: torch.Tensor, valid: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best pose f32[3], its sum i32[]) over the candidate set f32[B, 3]:
    the first minimum of the effective sums (int-max where nothing is in
    bounds).  CPU tensors take ``best_of_plain``; CUDA tensors K8's one
    launch on the current stream (both results in one i32[4] buffer, the
    pose viewed as f32; no host read), or a ValueError for inputs it does
    not take."""
    if cands.device.type == "cpu":
        return best_of_plain(cands, hole_map_flat, size, scale, points, valid)
    b, n = check_search_inputs(cands, hole_map_flat, size, points, valid)
    dev = cands.device
    out = torch.empty(4, dtype=torch.int32, device=dev)
    _build.launch("K8 search", _launcher(), dev, cands.data_ptr(),
                  hole_map_flat.data_ptr(), points.data_ptr(),
                  valid.data_ptr(), _slot(dev).data_ptr(), out.data_ptr(),
                  _SearchParams(b, n, size, scale), kernel="K8_search")
    return out[:3].view(torch.float32), out[3]


def best_of_plain(cands: torch.Tensor, hole_map_flat: torch.Tensor,
                  size: int, scale: float, points: torch.Tensor,
                  valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's plain version: ``score_candidates``, the effective sums and
    ``torch.argmin``'s first minimum; any device, no host read."""
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
    i32[]).  ``best_of`` is looked up by its module name at each call, so a
    caller that wraps it (the benchmark's ``half_search`` plant) is
    obeyed."""
    cands = sample_candidates(search_pose, sigma_xy, sigma_theta,
                              num_candidates, generator)
    return best_of(cands, hole_map_flat, size, scale, points, valid)
