"""Candidate-sharded Monte-Carlo search: data parallelism over candidates.

Port of ``slamnet_tpu/parallel/search.py``: the reference forks threads that
each score their own candidate stream and the host keeps the best
(CoreSLAMProcessor.cs:674-710); here each rank of the ``search`` axis draws
and scores its own ``num_candidates / S`` candidates against the replicated
hole map, and the global argmin is collectives: ``pmin`` of the best score,
``pmin`` of the first shard that holds it, then a ``psum`` of that shard's
pose (the others contribute zeros) — the first shard wins ties, as the host
loop's strict improvement does.

JAX folds the key with the shard index; here shard ``i`` draws from a
``torch.Generator`` seeded with ``shard_seed(seed, i)`` on the mesh's device.
Its draws are not ``jax.random``'s (the distribution is the same), as in
``ops/score.py``.  Shard 0's first candidate is the search pose itself.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import score
from .mesh import Mesh

SEED_STRIDE = 1 << 20


def shard_seed(seed: int, shard: int) -> int:
    """The generator seed of shard ``shard`` under ``seed``."""
    return seed * SEED_STRIDE + shard


def shard_candidates(search_pose: torch.Tensor, sigma_xy: float,
                     sigma_theta: float, local_b: int, seed: int,
                     shard: int) -> torch.Tensor:
    """Shard ``shard``'s f32[local_b, 3] candidates: xy normals, then
    heading normals, from its own generator; shard 0's first candidate is
    the search pose."""
    gen = torch.Generator(device=search_pose.device).manual_seed(
        shard_seed(seed, shard))
    dev = search_pose.device
    dxy = torch.randn((local_b, 2), generator=gen, device=dev) * sigma_xy
    dth = torch.randn((local_b, 1), generator=gen, device=dev) * sigma_theta
    deltas = torch.cat([dxy, dth], dim=1)
    if shard == 0:
        deltas[0] = 0.0
    return search_pose[None, :] + deltas


def sharded_monte_carlo_search(mesh: Mesh, hole_map_flat: torch.Tensor,
                               size: int, scale: float, points: torch.Tensor,
                               valid: torch.Tensor, search_pose: torch.Tensor,
                               sigma_xy: float, sigma_theta: float,
                               num_candidates: int, seed: int,
                               axis: str = "search"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.score.monte_carlo_search`` with the candidates split over
    ``axis``: (best pose f32[3], best sum i32[]), replicated.  The map,
    points and pose are replicated."""
    n_shards = mesh.axis_size(axis)
    if num_candidates % n_shards:
        raise ValueError(f"{num_candidates} candidates do not divide over "
                         f"{n_shards} shards")
    idx = mesh.axis_index(axis)
    cands = shard_candidates(search_pose, sigma_xy, sigma_theta,
                             num_candidates // n_shards, seed, idx)
    local_pose, local_best = score.best_of(cands, hole_map_flat, size, scale,
                                           points, valid)
    gmin = mesh.pmin(local_best, axis)
    first = mesh.pmin(torch.where(local_best == gmin, idx, n_shards).to(
        torch.int32), axis)
    contrib = torch.where(first == idx, local_pose,
                          torch.zeros_like(local_pose))
    return mesh.psum(contrib, axis), gmin
