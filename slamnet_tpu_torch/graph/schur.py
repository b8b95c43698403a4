"""Node-sharded Gauss-Newton by Schur-complement reduction.

Port of ``slamnet_tpu/graph/schur.py``.  The graph's nodes shard in
contiguous blocks of m = K / S over one mesh axis; each rank eliminates the
interior nodes of its block locally (one-level nested dissection), and only
the SEPARATOR nodes (touched by an edge that crosses blocks, a static
``sep_capacity`` of them a rank) enter a small system that every rank
solves the same way.  A step on each rank of the axis:

  1. classify: an edge is INTERNAL when both ends lie in this rank's block,
     CROSS when its ends lie in two blocks; a node is a separator when a
     cross edge touches it (node 0 always, so the gauge prior lands in the
     reduced system);
  2. the local dense (H_loc [3m, 3m], b_loc) of the internal edges, with the
     interior damping;
  3. the interiors eliminated by identity-decoupling: C = D H D + (I - D)
     with D the interior mask, so C^-1 = H_II^-1 (+) I; then
     S_loc = H_SS - H_SI H_II^-1 H_IS and rhs_loc = b_S - H_SI H_II^-1 b_I;
  4. this rank's separators packed into ``sep_capacity`` slots (a stable
     sort of the separator mask), the slot tables ALL_GATHERED over the
     axis, the cross edges' blocks added at their packed slots, and the
     packed system [3 S P + 3]^2 PSUMMED over the axis;
  5. the packed system solved on every rank, the interiors
     back-substituted locally, the new poses ALL_GATHERED.

Collectives: JAX issues five a step (the overflow psum, the slot
all_gather, the two psums of the system and its right side, the pose
all_gather).  Here the overflow count (an integer below 2^24, exact in
f32) and the right side ride in the system's psum: three a step.

Departure from JAX's formulation, none in the numbers: the blocks are
summed as products with edge-incidence matrices (as ``posegraph.py``
assembles H), not as ``.at[].add`` scatters.  A rank and its twin on
another tile line of a ('tile' x 'search') mesh compute the same block
from the same graph, and the graph-SLAM step reads flags derived from the
result on the host: accumulating scatters on the card sum in no fixed
order, so the twins could part in their last bits and then in their
collectives; products sum in one order, so they cannot.

``sep_overflow`` counts the separators beyond the slots, summed over the
axis: nonzero means rows were left out of the reduced system and the step
is WRONG, and callers surface it (``models/graph_slam_sharded.py``).
``check_separator_capacity`` is the host's check of the same count.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.geometry import normalize_angle
from ..parallel.mesh import Mesh
from . import posegraph


def _incidence(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32[E, n]: row e is one at column ``idx[e]`` (none when out of
    range)."""
    return (idx.long()[:, None] == torch.arange(n, device=idx.device)
            ).to(torch.float32)


def _jacobian(oi: torch.Tensor, oj: torch.Tensor, ji: torch.Tensor,
              jj: torch.Tensor) -> torch.Tensor:
    """J f32[3E, 3n] from the incidences [E, n] and the Jacobians [E, 3, 3]:
    J[3e + r, 3a + c] = oi[e, a] ji[e, r, c] + oj[e, a] jj[e, r, c]."""
    n = oi.shape[1]
    return (oi[:, None, :, None] * ji[:, :, None, :]
            + oj[:, None, :, None] * jj[:, :, None, :]).reshape(-1, 3 * n)


def _normal(J: torch.Tensor, w: torch.Tensor, r: torch.Tensor):
    """(J^T W J, J^T W r) with W the edges' weights w f32[E, 3]."""
    wr = w.reshape(-1, 1)
    return J.T @ (wr * J), J.T @ (wr[:, 0] * r.reshape(-1))


def schur_local_step(mesh: Mesh, poses: torch.Tensor,
                     node_valid: torch.Tensor, ei: torch.Tensor,
                     ej: torch.Tensor, em: torch.Tensor, ew: torch.Tensor,
                     ev: torch.Tensor, *, sep_capacity: int,
                     anchor_weight: float, damping: float, axis: str,
                     huber_delta: float = 0.0, robust_kernel: str = "dcs"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Schur GN step on this rank of ``axis`` (every rank of the axis
    calls it with the same replicated graph arrays).  ``huber_delta > 0``
    scales each edge's information by ``robust_kernel`` as
    ``posegraph.build_normal_equations`` does (every rank the same scale).

    Returns (new poses f32[K, 3], replicated; sep_overflow i32[], the
    separators beyond ``sep_capacity`` summed over the axis)."""
    k = poses.shape[0]
    n_shards = mesh.axis_size(axis)
    if k % n_shards:
        raise ValueError(f"{k} nodes do not divide over axis {axis!r} of "
                         f"size {n_shards}")
    m = k // n_shards
    p = min(sep_capacity, m)       # a rank never has more than m separators
    sp = n_shards * p
    s = mesh.axis_index(axis)
    dev = poses.device
    f32 = torch.float32

    shard_i = ei.long() // m
    shard_j = ej.long() // m
    internal = ev & (shard_i == s) & (shard_j == s)
    cross = ev & (shard_i != shard_j)

    # ---- separators: nodes a cross edge touches, and node 0 -------------
    oi_all, oj_all = _incidence(ei, k), _incidence(ej, k)
    sep_all = (((oi_all + oj_all) * cross[:, None].to(f32)).sum(0) > 0)
    sep_all[0] = True
    valid_loc = node_valid[s * m:(s + 1) * m]
    sep_loc = sep_all[s * m:(s + 1) * m] & valid_loc
    overflow = (sep_loc.sum() - p).clamp(min=0).to(f32)

    # ---- the local normal equations of the internal edges ----------------
    r, ji, jj = posegraph.edge_residuals_and_jacobians(poses, ei, ej, em, ev)
    if huber_delta > 0.0:
        ew = ew * posegraph.robust_scale(r, ew * ev[:, None], huber_delta,
                                         robust_kernel)[:, None]
    w = ew * internal[:, None]
    li = torch.where(internal, ei.long() - s * m, -1)
    lj = torch.where(internal, ej.long() - s * m, -1)
    H_loc, b_loc = _normal(_jacobian(_incidence(li, m), _incidence(lj, m),
                                     ji, jj), w, r)

    int_loc = valid_loc & ~sep_loc                 # interior and valid
    dmask = int_loc.repeat_interleave(3).to(f32)   # [3m]
    smask = sep_loc.repeat_interleave(3).to(f32)
    inval = (~valid_loc).repeat_interleave(3)      # identity rows
    H_loc = H_loc + torch.diag(torch.where(inval, 1.0, dmask * damping))

    # ---- eliminate the interiors: C^-1 = H_II^-1 (+) I -------------------
    Hm = H_loc * dmask[:, None] * dmask[None, :] + torch.diag(
        torch.where(inval, 1.0, 1.0 - dmask))
    Cinv = torch.linalg.inv(Hm)
    A_si = H_loc * smask[:, None] * dmask[None, :]
    G = A_si @ Cinv
    S_loc = H_loc * smask[:, None] * smask[None, :] - G @ A_si.T
    rhs_loc = smask * b_loc - G @ (dmask * b_loc)

    # ---- pack this rank's separators into p slots ------------------------
    order = torch.argsort((~sep_loc).to(torch.uint8), stable=True)
    slot_node = order[:p]                          # local node of each slot
    slot_valid = sep_loc[slot_node]
    valid3 = slot_valid.repeat_interleave(3).to(f32)
    idx3 = (slot_node[:, None] * 3 + torch.arange(3, device=dev)).reshape(-1)
    S_pack = S_loc[idx3][:, idx3] * valid3[:, None] * valid3[None, :]
    rhs_pack = rhs_loc[idx3] * valid3

    # the slot tables: every rank's slot -> node (k where a slot is empty)
    mine_glob = torch.where(slot_valid, s * m + slot_node,
                            torch.full_like(slot_node, k))
    all_slots = mesh.all_gather(mine_glob, axis, tiled=True)    # [sp]
    # node -> packed slot, sp (the pad slot) for a node in no slot
    in_slot = all_slots[:, None] == torch.arange(k, device=dev)  # [sp, k]
    slot_of = torch.where(
        in_slot.any(0),
        (in_slot.to(torch.int64)
         * torch.arange(sp, device=dev)[:, None]).sum(0),
        torch.full((k,), sp, dtype=torch.int64, device=dev))

    # ---- the packed separator system -------------------------------------
    n3 = 3 * (sp + 1)
    Sg = torch.zeros((n3, n3), dtype=f32, device=dev)
    rg = torch.zeros(n3, dtype=f32, device=dev)
    o = s * 3 * p
    Sg[o:o + 3 * p, o:o + 3 * p] = S_pack
    rg[o:o + 3 * p] = rhs_pack
    # the cross edges whose i-end this rank owns, at their ends' slots
    mine = cross & (shard_i == s)
    si = torch.where(mine, slot_of[ei.long()], sp)
    sj = torch.where(mine, slot_of[ej.long()], sp)
    Sx, rx = _normal(_jacobian(_incidence(si, sp + 1),
                               _incidence(sj, sp + 1), ji, jj),
                     ew * mine[:, None], r)
    Sg = Sg + Sx
    rg = rg + rx

    # THE exchange: one psum of the system, its right side and the overflow
    red = mesh.psum(torch.cat([Sg.reshape(-1), rg, overflow[None]]), axis)
    Sg = red[:n3 * n3].reshape(n3, n3)
    rg = red[n3 * n3:n3 * n3 + n3]
    sep_overflow = red[-1].to(torch.int32)

    # damping, the gauge prior at node 0's slot, identity pad rows
    live3 = torch.cat([(all_slots < k).repeat_interleave(3),
                       torch.zeros(3, dtype=torch.bool, device=dev)])
    diag = torch.where(live3, damping, 1.0)
    anchor = torch.arange(n3, device=dev) // 3 == slot_of[0]
    diag = diag + torch.where(anchor, anchor_weight, 0.0)
    dx_sep = posegraph._solve(Sg + torch.diag(diag), -rg)

    # ---- back-substitute the interiors -----------------------------------
    x_fill = torch.zeros(3 * m, dtype=f32, device=dev)
    x_fill[idx3] = dx_sep[o:o + 3 * p] * valid3
    x_int = Cinv @ (dmask * (-b_loc - H_loc @ x_fill))
    dx_loc = (dmask * x_int + x_fill).reshape(m, 3)

    old = poses[s * m:(s + 1) * m]
    new = torch.where(valid_loc[:, None], old + dx_loc, old)
    new = torch.cat([new[:, :2], normalize_angle(new[:, 2:3])], dim=1)
    return mesh.all_gather(new, axis, tiled=True), sep_overflow


def schur_gn_step(mesh: Mesh, g: posegraph.PoseGraph,
                  anchor_weight: float = 1e6, damping: float = 1e-6,
                  sep_capacity: int = 16, axis: str = "node",
                  huber_delta: float = 0.0
                  ) -> Tuple[posegraph.PoseGraph, torch.Tensor]:
    """One GN step of the replicated graph ``g`` with its nodes sharded over
    ``axis`` (K divisible by its size).  Returns (graph, sep_overflow
    i32[]): a nonzero overflow means separators were left out of the
    reduced system and the step must not be trusted."""
    poses, overflow = schur_local_step(
        mesh, g.poses, g.node_valid, g.edge_i, g.edge_j, g.edge_meas,
        g.edge_w, g.edge_valid, sep_capacity=sep_capacity,
        anchor_weight=anchor_weight, damping=damping, axis=axis,
        huber_delta=huber_delta)
    return g._replace(poses=poses), overflow


def check_separator_capacity(g: posegraph.PoseGraph, n_shards: int,
                             sep_capacity: int) -> bool:
    """The host's check: every shard's separators fit its slots."""
    k = g.poses.shape[0]
    m = k // n_shards
    ei = np.asarray(g.edge_i.cpu())
    ej = np.asarray(g.edge_j.cpu())
    ev = np.asarray(g.edge_valid.cpu())
    cross = ev & (ei // m != ej // m)
    sep = np.zeros(k, bool)
    sep[ei[cross]] = True
    sep[ej[cross]] = True
    sep[0] = True
    return bool((sep.reshape(n_shards, m).sum(axis=1) <= sep_capacity).all())


def schur_optimize(mesh: Mesh, g: posegraph.PoseGraph, iterations: int = 10,
                   anchor_weight: float = 1e6, damping: float = 1e-6,
                   sep_capacity: int = 16, axis: str = "node"
                   ) -> Tuple[posegraph.PoseGraph, torch.Tensor]:
    """``iterations`` Schur GN steps.  Returns (graph, the largest
    sep_overflow of the steps); callers must surface the overflow."""
    worst = torch.zeros((), dtype=torch.int32, device=g.poses.device)
    for _ in range(iterations):
        g, overflow = schur_gn_step(mesh, g, anchor_weight, damping,
                                    sep_capacity, axis)
        worst = torch.maximum(worst, overflow)
    return g, worst
