"""Edge-sharded pose-graph Gauss-Newton: the normal equations summed over ranks.

Port of ``slamnet_tpu/graph/distributed.py``: the constraint edges shard
over one mesh axis; each rank builds the dense (H, b) share of its edges
(``posegraph.edge_normal_terms``), the shares psum over the axis in ONE
collective (H and b as one tensor), and the small dense solve runs
replicated with the gauge prior and damping added once.  Equal to
``posegraph.gn_step`` up to the order of the edge sums.
"""
from __future__ import annotations

import torch

from ..core.geometry import normalize_angle
from ..parallel.mesh import Mesh, shard_range
from . import posegraph


def sharded_gn_step(mesh: Mesh, g: posegraph.PoseGraph,
                    anchor_weight: float = 1e6, damping: float = 1e-6,
                    axis: str = "edge") -> posegraph.PoseGraph:
    """One GN step of the whole graph ``g`` (replicated on every rank; the
    edge count divisible by the axis size), each rank summing its
    contiguous share of the edges; the new graph is replicated."""
    k = g.poses.shape[0]
    lo, hi = shard_range(g.edge_i.shape[0], mesh, axis)
    H, b = posegraph.edge_normal_terms(
        g.poses, g.edge_i[lo:hi], g.edge_j[lo:hi], g.edge_meas[lo:hi],
        g.edge_w[lo:hi], g.edge_valid[lo:hi], k)
    s = mesh.psum(torch.cat([H.reshape(-1), b]), axis)
    H = s[:9 * k * k].reshape(3 * k, 3 * k) + torch.diag(
        posegraph.prior_diagonal(g.node_valid, k, anchor_weight, damping))
    dx = posegraph._solve(H, -s[9 * k * k:]).reshape(k, 3)
    dx = torch.where(g.node_valid[:, None], dx, 0.0)
    poses = g.poses + dx
    poses = torch.cat([poses[:, :2], normalize_angle(poses[:, 2:3])], dim=1)
    return g._replace(poses=poses)


def sharded_optimize(mesh: Mesh, g: posegraph.PoseGraph, iterations: int = 10,
                     anchor_weight: float = 1e6, damping: float = 1e-6,
                     axis: str = "edge") -> posegraph.PoseGraph:
    """``iterations`` edge-sharded GN steps."""
    for _ in range(iterations):
        g = sharded_gn_step(mesh, g, anchor_weight, damping, axis)
    return g
