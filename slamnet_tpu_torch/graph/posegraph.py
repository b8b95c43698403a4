"""Keyframe pose graph with Gauss-Newton optimization.

Port of ``slamnet_tpu/graph/posegraph.py``: K node slots and E edge slots
with validity masks (fixed shapes; a node or an edge is written at its
counter's index), SE(2) relative-pose residuals with analytic Jacobians, the
dense [3K, 3K] normal equations with robust (Huber / DCS) weighting and a
strong prior on node 0, one GN step solved on the active node prefix, and
the Schur-complement solve.

Departures from the JAX formulation, none in the numbers it defines:

* ``add_node`` and ``add_edge`` write the graph's tensors IN PLACE and
  return the graph with its new counters (JAX returns new arrays).  The
  capacity guards stay device values: nothing here waits for the device.
* The assembly is a product with the edge-incidence matrix, not JAX's
  ``.at[].add`` block scatters (``posegraph.py:194-201``).  Scatters that
  accumulate are atomics in no fixed order on the card, so H would change in
  its last bits from run to run, and the loop-closure accept and the
  keyframe gate downstream are thresholds.  Row 3e+r of J [3E, 3k] holds
  edge e's Jacobian row r at node i's and node j's columns; H = J^T W J and
  b = J^T W r are matrix products, which sum in a fixed order: two
  assemblies give the same H bit for bit.  The products run in full f32:
  ``torch.backends.cuda.matmul.allow_tf32`` must stay False, PyTorch's
  default (TF32 keeps ~3 digits, and H carries a 1e6 anchor beside
  weights of 1e2).
* The active prefix's bucket (``_size_buckets``) is chosen by the caller's
  host-side count of nodes (``num_nodes``), where JAX switches on the
  traced count.
* The solves are ``torch.linalg.solve_ex`` without its error check (a
  singular system gives non-finite numbers, as ``jnp.linalg.solve`` does,
  and the host never waits to check it).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.geometry import normalize_angle


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # f32[K, 3] current node estimates (world)
    node_valid: torch.Tensor  # bool[K]
    num_nodes: torch.Tensor   # i32[]
    edge_i: torch.Tensor      # i32[E] from-node
    edge_j: torch.Tensor      # i32[E] to-node
    edge_meas: torch.Tensor   # f32[E, 3] measured relative pose (i -> j, in i's frame)
    edge_w: torch.Tensor      # f32[E, 3] diagonal information (wx, wy, wth)
    edge_valid: torch.Tensor  # bool[E]
    num_edges: torch.Tensor   # i32[]


def init(max_nodes: int, max_edges: int,
         device: torch.device | str = "cuda") -> PoseGraph:
    """An empty graph of ``max_nodes`` and ``max_edges`` slots, on the card
    unless ``device`` names another."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return PoseGraph(
        poses=z(max_nodes, 3), node_valid=z(max_nodes, dtype=torch.bool),
        num_nodes=z(dtype=torch.int32), edge_i=z(max_edges, dtype=torch.int32),
        edge_j=z(max_edges, dtype=torch.int32), edge_meas=z(max_edges, 3),
        edge_w=torch.ones((max_edges, 3), dtype=torch.float32, device=device),
        edge_valid=z(max_edges, dtype=torch.bool),
        num_edges=z(dtype=torch.int32))


def has_node_room(g: PoseGraph) -> torch.Tensor:
    """True while another keyframe node fits (the guard for callers that
    would otherwise wire edges to a clamped index when the graph is full)."""
    return g.num_nodes < g.poses.shape[0]


def _value(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a tensor, a Python number or a tuple of them) as a tensor
    of ``like``'s type on its device.  Python numbers go in as fills: a
    tensor made from host data would be a copy that waits for the device."""
    if isinstance(value, torch.Tensor):
        return value.to(like.dtype)
    vals = tuple(value) if isinstance(value, (tuple, list)) else (value,)
    out = torch.empty(len(vals), dtype=like.dtype, device=like.device)
    for n, v in enumerate(vals):
        out[n] = v
    return out


def _put(t: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
         value) -> None:
    """``t[idx] = value where ok, else t[idx]``, in place; ``idx`` and
    ``ok`` are 0-dim device tensors."""
    i = idx.reshape(1).long()
    old = t.index_select(0, i)
    new = _value(value, t).reshape(old.shape[1:])
    t.index_put_((i,), torch.where(ok, new, old))


def add_node(g: PoseGraph, pose) -> Tuple[PoseGraph, torch.Tensor]:
    """Append a keyframe node in place (a no-op when full); returns (graph,
    node index).  The index is CLAMPED to the last slot when the graph is
    full, so gathers stay in bounds; callers that add edges must also gate
    on ``has_node_room`` (``models/graph_slam.py`` does)."""
    idx = g.num_nodes
    ok = idx < g.poses.shape[0]
    safe = idx.clamp(max=g.poses.shape[0] - 1)
    _put(g.poses, safe, ok, pose)
    _put(g.node_valid, safe, ok, True)
    return g._replace(num_nodes=torch.where(ok, idx + 1, idx)), safe


def add_edge(g: PoseGraph, i, j, meas, weights=(1.0, 1.0, 1.0),
             enable=True) -> PoseGraph:
    """Append a relative-pose constraint i -> j in place (a no-op when full
    or when ``enable``, a bool or a 0-dim bool tensor, is False)."""
    e = g.num_edges
    if isinstance(enable, bool):
        if not enable:
            return g
        enable = torch.ones((), dtype=torch.bool, device=e.device)
    ok = (e < g.edge_i.shape[0]) & enable
    safe = e.clamp(max=g.edge_i.shape[0] - 1)
    _put(g.edge_i, safe, ok, i)
    _put(g.edge_j, safe, ok, j)
    _put(g.edge_meas, safe, ok, meas)
    _put(g.edge_w, safe, ok, weights)
    _put(g.edge_valid, safe, ok, True)
    return g._replace(num_edges=torch.where(ok, e + 1, e))


def edge_residuals_and_jacobians(poses, edge_i, edge_j, edge_meas, edge_valid):
    """Residual r = [R_i^T (t_j - t_i) - t_m ; wrap(th_j - th_i - th_m)] per
    edge and the analytic Jacobians with respect to node i and node j.
    Returns (r f32[E, 3], Ji f32[E, 3, 3], Jj f32[E, 3, 3]), zero where an
    edge is invalid."""
    xi = poses[edge_i.long()]
    xj = poses[edge_j.long()]
    th = xi[:, 2]
    c, s = torch.cos(th), torch.sin(th)
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    lx = c * dx + s * dy                       # R_i^T dt
    ly = -s * dx + c * dy
    r = torch.stack([lx - edge_meas[:, 0], ly - edge_meas[:, 1],
                     normalize_angle(xj[:, 2] - xi[:, 2] - edge_meas[:, 2])], 1)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    ji = torch.stack([torch.stack([-c, -s, -s * dx + c * dy], 1),
                      torch.stack([s, -c, -c * dx - s * dy], 1),
                      torch.stack([zero, zero, -one], 1)], 1)
    jj = torch.stack([torch.stack([c, s, zero], 1),
                      torch.stack([-s, c, zero], 1),
                      torch.stack([zero, zero, one], 1)], 1)
    m = edge_valid[:, None]
    return (torch.where(m, r, 0.0), torch.where(m[..., None], ji, 0.0),
            torch.where(m[..., None], jj, 0.0))


def robust_scale(r: torch.Tensor, w: torch.Tensor, delta: float,
                 kernel: str) -> torch.Tensor:
    """Per-edge IRLS information scale.  'huber': min(1, delta/e) with
    e = sqrt(r^T W r) (bounds an outlier's pull, never rejects it); 'dcs':
    dynamic covariance scaling (Agarwal et al. 2013),
    s = (min(1, 2 delta^2 / (delta^2 + chi2)))^2, which redescends: a gross
    outlier (a false loop) loses its influence."""
    chi2 = torch.clamp((r * r * w).sum(dim=1), min=1e-12)
    if kernel == "huber":
        return torch.clamp(delta / torch.sqrt(chi2), max=1.0)
    if kernel == "dcs":
        s = torch.clamp(2.0 * delta * delta / (delta * delta + chi2), max=1.0)
        return s * s
    raise ValueError(f"unknown robust kernel {kernel!r}")


def build_normal_equations(g: PoseGraph, anchor_weight: float = 1e6,
                           damping: float = 1e-6, huber_delta: float = 0.0,
                           robust_kernel: str = "dcs",
                           active_k: int | None = None):
    """Dense (H f32[3k, 3k], b f32[3k]) from all valid edges and the node-0
    gauge prior, k = K or ``active_k`` (valid when num_nodes <= active_k:
    nodes are allocated in order, valid edges join valid nodes, invalid edge
    slots carry zero weight).  ``huber_delta > 0`` weights the edges by
    ``robust_kernel``.  Invalid nodes get identity rows.  Deterministic: see
    the module's note on the incidence product."""
    k = g.poses.shape[0] if active_k is None else active_k
    dev = g.poses.device
    r, ji, jj = edge_residuals_and_jacobians(g.poses, g.edge_i, g.edge_j,
                                             g.edge_meas, g.edge_valid)
    w = g.edge_w * g.edge_valid[:, None]                     # [E, 3]
    if huber_delta > 0.0:
        w = w * robust_scale(r, w, huber_delta, robust_kernel)[:, None]
    nodes = torch.arange(k, device=dev)
    oi = (g.edge_i.long()[:, None] == nodes).to(torch.float32)   # [E, k]
    oj = (g.edge_j.long()[:, None] == nodes).to(torch.float32)
    # J[3e + r, 3a + c] = [a = i_e] Ji[e, r, c] + [a = j_e] Jj[e, r, c]
    J = (oi[:, None, :, None] * ji[:, :, None, :]
         + oj[:, None, :, None] * jj[:, :, None, :]).reshape(-1, 3 * k)
    wr = w.reshape(-1, 1)
    # full-f32 products (allow_tf32 False, PyTorch's default): see above
    H = J.T @ (wr * J)
    b = J.T @ (wr[:, 0] * r.reshape(-1))
    diag = torch.full((3 * k,), damping, dtype=torch.float32, device=dev)
    diag[:3] += anchor_weight
    invalid = (~g.node_valid[:k]).repeat_interleave(3)
    diag = torch.where(invalid, 1.0, diag)
    return H + torch.diag(diag), b


def _size_buckets(k: int) -> list:
    """The active prefix's sizes: 32, 64, ... below k, then k."""
    buckets, n = [], 32
    while n < k:
        buckets.append(n)
        n *= 2
    buckets.append(k)
    return buckets


def bucket(k: int, num_nodes: int) -> int:
    """The smallest bucket of ``_size_buckets(k)`` that holds ``num_nodes``."""
    return next(n for n in _size_buckets(k) if n >= num_nodes or n == k)


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _active_gn_dx(g: PoseGraph, anchor_weight: float, damping: float,
                  huber_delta: float, num_nodes: int) -> torch.Tensor:
    """dx f32[3K] of one GN step, built and solved on the active prefix only.
    H is block-diagonal between the first ``bucket(K, num_nodes)`` nodes and
    the rest (invalid rows: identity diagonal, zero b), so the prefix's
    solve is exact and the trailing dx is zero."""
    k = g.poses.shape[0]
    n = bucket(k, num_nodes)
    H, b = build_normal_equations(g, anchor_weight, damping, huber_delta,
                                  active_k=n)
    dx = _solve(H, -b)
    if n == k:
        return dx
    return torch.cat([dx, torch.zeros(3 * (k - n), dtype=dx.dtype,
                                      device=dx.device)])


def gn_step(g: PoseGraph, anchor_weight: float = 1e6, damping: float = 1e-6,
            huber_delta: float = 0.0, *, num_nodes: int) -> PoseGraph:
    """One Gauss-Newton step: solve H dx = -b, apply, re-wrap headings.
    ``num_nodes`` is the host's count of ``g.num_nodes`` (it picks the
    solve's bucket)."""
    k = g.poses.shape[0]
    dx = _active_gn_dx(g, anchor_weight, damping, huber_delta,
                       num_nodes).reshape(k, 3)
    dx = torch.where(g.node_valid[:, None], dx, 0.0)
    poses = g.poses + dx
    poses = torch.cat([poses[:, :2], normalize_angle(poses[:, 2:3])], dim=1)
    return g._replace(poses=poses)


def optimize(g: PoseGraph, iterations: int = 10, anchor_weight: float = 1e6,
             damping: float = 1e-6, huber_delta: float = 0.0, *,
             num_nodes: int) -> PoseGraph:
    """``iterations`` GN steps."""
    for _ in range(iterations):
        g = gn_step(g, anchor_weight, damping, huber_delta,
                    num_nodes=num_nodes)
    return g


def total_error(g: PoseGraph) -> torch.Tensor:
    r, _, _ = edge_residuals_and_jacobians(g.poses, g.edge_i, g.edge_j,
                                           g.edge_meas, g.edge_valid)
    return ((r ** 2) * g.edge_w * g.edge_valid[:, None]).sum()


def solve_schur(H: torch.Tensor, b: torch.Tensor, n_keep: int) -> torch.Tensor:
    """Solve H dx = -b by Schur elimination of the trailing block: with
    x = [x_a (3*n_keep); x_b], solve the reduced system
    (A - B C^-1 B^T) x_a = -(b_a - B C^-1 b_b), then back-substitute x_b.
    Equal to the dense solve."""
    na = 3 * n_keep
    A, B, C = H[:na, :na], H[:na, na:], H[na:, na:]
    ba, bb = b[:na], b[na:]
    cinv_bt = _solve(C, B.T)
    cinv_bb = _solve(C, bb)
    S = A - B @ cinv_bt
    xa = _solve(S, -(ba - B @ cinv_bb))
    xb = _solve(C, -bb - B.T @ xa)
    return torch.cat([xa, xb])
