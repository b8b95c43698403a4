"""Distributed graph-SLAM: the sharded Hector step, the keyframe graph, the
keyframe clouds sharded, and the node-sharded Schur GN.

Port of ``slamnet_tpu/models/graph_slam_sharded.py``.  Every rank of a
('tile' x 'search') mesh (``parallel/mesh.py``) runs a scan:

  * scan-to-map matching and the gated map update by the row-tiled,
    beam-sharded Hector step (``hector_sharded.local_full_step``: psum'd
    GN sums over both axes, the halo ppermute over 'tile');
  * the keyframe gate and the graph's bookkeeping on replicated values
    (the graph is K pose triples and the edge lists, on every rank);
  * the keyframe CLOUDS sharded over 'search': a rank holds K / S of them,
    slot ``k`` on search index ``k // (K / S)``; a keyframe's cloud is
    written on its owner, and a loop candidate's comes to every rank by
    ONE psum over 'search' (the owner adds the cloud, the others zeros);
  * the loop-closure match on every rank (``frontend.match_scans``: K4 +
    K3 under the default ``gather`` frontend, K2 + K1 under
    ``onehot_bf16`` / ``pallas`` with ``dense_fill``), which issues no
    collective;
  * the pose graph optimized by ``opt_iterations`` node-sharded Schur GN
    steps over 'search' (``graph/schur.py``, three collectives a step) on
    every keyframe event: JAX's fixed count, not the dense model's 1, or 3
    after a closure.  The separator overflow is in the info, never silent.

The keyframe branch.  JAX branches with two ``lax.cond``s, on ``due``
(``graph_slam_sharded.py:230``) and on ``has_cand`` (``:199``).  Here, as in
``models/graph_slam.py``, each is a Python branch on a flag copied to the
host: ``due`` once a scan, ``has_cand`` once a keyframe event, and
``looped`` once a search (counted in ``Step.syncs``; ``Step.flags`` keeps
each scan's three).  The flags are replicated values: ``due`` comes from
the psum'd GN sums and the replicated 3x3 solves, the graph from the
Schur step's psum and all_gather, both the same bits on every rank, and
every operation after them is deterministic (the Schur blocks are matrix
products, not accumulating scatters).  So every rank takes the same
branch, and every collective of a keyframe event runs on all ranks or on
none: the cloud's psum and 3 x ``opt_iterations`` Schur collectives,
``sum(estimate_iterations) + 2`` a scan before them.  ``has_cand`` and
``looped`` gate only the frontend's match and the loop edge.

A rank's state holds its tile's table, its K / S clouds, the replicated
poses and graph, and ``nodes``, the host's count of graph nodes (as the
dense ``GraphSlamState`` keeps it).  The step changes the graph and the
clouds in place.  The entry points put the state on the mesh's device (the
rank's card unless the mesh names another).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..core.config import HectorConfig, PoseGraphConfig
from ..core.geometry import normalize_angle, pose_between
from ..core.scan import Scan
from ..graph import frontend, posegraph, schur
from ..parallel.mesh import Mesh, shard_range
from . import graph_slam, hector_sharded

ANCHOR_WEIGHT = 1e6    # the Schur steps' gauge prior and damping
DAMPING = 1e-6         # (graph_slam_sharded.py:148-149)


class ShardedGraphSlamState(NamedTuple):
    local_maps: torch.Tensor        # f32[local_cells] this rank's tile
    match_pose: torch.Tensor        # f32[3] replicated
    last_update_pose: torch.Tensor  # f32[3] replicated
    graph: posegraph.PoseGraph      # replicated
    kf_points: torch.Tensor         # f32[K / S, N, 2] this rank's clouds
    kf_valid: torch.Tensor          # bool[K / S, N]
    last_kf_pose: torch.Tensor      # f32[3] replicated
    loop_count: torch.Tensor        # i32[] replicated
    nodes: int                      # the host's count of graph.num_nodes


class ShardedGraphSlamInfo(NamedTuple):
    keyframe_added: torch.Tensor    # bool
    loop_closed: torch.Tensor       # bool
    map_updated: torch.Tensor       # bool
    sep_overflow: torch.Tensor      # i32: nonzero = Schur capacity breached


def _per(mesh: Mesh, k: int, search_axis: str) -> int:
    """The keyframe slots a search shard holds, K / S."""
    s = mesh.axis_size(search_axis)
    if k % s:
        raise ValueError(f"max_keyframes {k} does not divide over the "
                         f"{search_axis!r} axis of size {s}")
    return k // s


def shard_dense(mesh: Mesh, dense: graph_slam.GraphSlamState,
                hcfg: HectorConfig, tile_axis: str = "tile",
                search_axis: str = "search") -> ShardedGraphSlamState:
    """This rank's share of a dense state: its tile's table, its search
    shard of the clouds, the rest replicated (copies on the mesh's
    device)."""
    hs = hector_sharded.shard_state(mesh, dense.hector, hcfg, tile_axis)
    lo, hi = shard_range(dense.kf_points.shape[0], mesh, search_axis)

    def put(t):
        return t.to(mesh.device).clone()
    return ShardedGraphSlamState(
        local_maps=hs.local_maps, match_pose=hs.match_pose,
        last_update_pose=hs.last_update_pose,
        graph=posegraph.PoseGraph(*(put(t) for t in dense.graph)),
        kf_points=put(dense.kf_points[lo:hi]),
        kf_valid=put(dense.kf_valid[lo:hi]),
        last_kf_pose=put(dense.last_kf_pose),
        loop_count=put(dense.loop_count), nodes=dense.nodes)


def init(mesh: Mesh, hcfg: HectorConfig, gcfg: PoseGraphConfig, start_pose,
         num_beams: int, tile_axis: str = "tile",
         search_axis: str = "search") -> ShardedGraphSlamState:
    """A fresh ``graph_slam.init`` state, sharded over the mesh."""
    hector_sharded._check_cfg(hcfg)
    return shard_dense(mesh, graph_slam.init(hcfg, gcfg, start_pose,
                                             num_beams, mesh.device),
                       hcfg, tile_axis, search_axis)


def gather_clouds(mesh: Mesh, state: ShardedGraphSlamState,
                  search_axis: str = "search"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every keyframe cloud (f32[K, N, 2], bool[K, N]) on every rank of this
    rank's search line: ONE all_gather of the points and the valid mask
    side by side (a collective every rank of the mesh calls)."""
    both = mesh.all_gather(torch.cat([state.kf_points, state.kf_valid.to(
        torch.float32)[..., None]], dim=-1), search_axis, tiled=True)
    return both[..., :2].contiguous(), both[..., 2] > 0


def to_dense(mesh: Mesh, state: ShardedGraphSlamState, hcfg: HectorConfig,
             tile_axis: str = "tile", search_axis: str = "search"
             ) -> graph_slam.GraphSlamState:
    """The dense ``GraphSlamState`` (the tiles and the cloud shards
    gathered: two collectives every rank of the mesh calls; the graph
    copied, since the step writes it in place)."""
    hs = hector_sharded.ShardedHectorState(
        state.local_maps, state.match_pose, state.last_update_pose)
    pts, val = gather_clouds(mesh, state, search_axis)
    return graph_slam.GraphSlamState(
        hector=hector_sharded.to_dense(mesh, hs, hcfg, tile_axis),
        graph=posegraph.PoseGraph(*(t.clone() for t in state.graph)),
        kf_points=pts, kf_valid=val,
        last_kf_pose=state.last_kf_pose, loop_count=state.loop_count,
        nodes=state.nodes)


class Step:
    """The distributed graph-SLAM step over ``mesh`` (``make_step``).

    ``step(state, points f32[N, 2], valid bool[N], force)`` takes the whole
    scan (the Hector step keeps this rank's beam chunk; the keyframe cloud
    and the frontend take every beam) and returns (state,
    ShardedGraphSlamInfo): ``models.graph_slam.update``'s contract with the
    hint the state's match pose, ``force`` mapping at it unmatched.
    ``syncs`` counts the host's flag reads, ``searches`` the frontend's
    matches, ``flags`` holds each call's (due, has_cand, looped)."""

    def __init__(self, mesh: Mesh, hcfg: HectorConfig, gcfg: PoseGraphConfig,
                 num_beams: int, mcfg: frontend.ScanMatchConfig | None = None,
                 opt_iterations: int = 3, sep_capacity: int = 16,
                 tile_axis: str = "tile", search_axis: str = "search"):
        self.hstep = hector_sharded.Step(mesh, hcfg, num_beams, tile_axis,
                                         search_axis)
        self.mesh, self.hcfg, self.gcfg = mesh, hcfg, gcfg
        self.mcfg = mcfg if mcfg is not None else frontend.ScanMatchConfig()
        self.opt_iterations, self.sep_capacity = opt_iterations, sep_capacity
        self.tile_axis, self.search_axis = tile_axis, search_axis
        self.per = _per(mesh, gcfg.max_keyframes, search_axis)
        self.syncs = 0
        self.searches = 0
        self.flags: List[Tuple[bool, bool, bool]] = []

    def optimize(self, g: posegraph.PoseGraph
                 ) -> Tuple[posegraph.PoseGraph, torch.Tensor]:
        """``opt_iterations`` Schur steps over the search axis; the worst
        overflow of them."""
        worst = torch.zeros((), dtype=torch.int32, device=g.poses.device)
        for _ in range(self.opt_iterations):
            poses, of = schur.schur_local_step(
                self.mesh, g.poses, g.node_valid, g.edge_i, g.edge_j,
                g.edge_meas, g.edge_w, g.edge_valid,
                sep_capacity=self.sep_capacity, anchor_weight=ANCHOR_WEIGHT,
                damping=DAMPING, axis=self.search_axis,
                huber_delta=self.gcfg.huber_delta)
            g = g._replace(poses=poses)
            worst = torch.maximum(worst, of)
        return g, worst

    def _fetch(self, kf_pts: torch.Tensor, kf_val: torch.Tensor,
               cand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cloud of slot ``cand`` (a device index [1]) on every rank:
        ONE psum over search of the owner's points and valid mask."""
        srank = self.mesh.axis_index(self.search_axis)
        mine = (cand // self.per) == srank
        loc = torch.where(mine, cand - srank * self.per, 0)
        pts = torch.where(mine, kf_pts.index_select(0, loc)[0], 0.0)
        val = torch.where(mine, kf_val.index_select(0, loc)[0], False)
        n = pts.shape[0]
        red = self.mesh.psum(torch.cat([pts.reshape(-1),
                                        val.to(torch.float32)]),
                             self.search_axis)
        return red[:2 * n].reshape(n, 2), red[2 * n:] > 0

    def _spawn(self, state: ShardedGraphSlamState, points: torch.Tensor,
               valid: torch.Tensor, pose: torch.Tensor):
        """The keyframe event (``graph_slam_sharded.py:156-214``): the node,
        its odometry edge and its cloud on the owner, a loop closure
        against the nearest old keyframe, the Schur steps.  Returns (graph,
        clouds, nodes, has_cand, looped, overflow)."""
        gcfg, g, n = self.gcfg, state.graph, state.nodes
        k = gcfg.max_keyframes
        dev = pose.device
        odom_w, loop_w = graph_slam._weights(gcfg, dev)
        kf_pts, kf_val = state.kf_points, state.kf_valid
        has_cand = looped = False
        # capacity guard: with the node table full, nothing below may write
        if n < k:
            rel = pose_between(g.poses[n - 1], pose)
            g, _ = posegraph.add_node(g, pose)
            g = posegraph.add_edge(g, n - 1, n, rel, odom_w)
            owner = n // self.per
            if owner == self.mesh.axis_index(self.search_axis):
                kf_pts[n - owner * self.per] = points
                kf_val[n - owner * self.per] = valid

            # loop closure: the nearest valid candidate by proximity
            cand_mask = frontend.loop_candidates(
                g.poses, g.node_valid, n, gcfg.loop_closure_radius,
                graph_slam.MIN_INDEX_GAP)
            d = torch.linalg.vector_norm(g.poses[:, :2] - pose[None, :2],
                                         dim=1)
            d = torch.where(cand_mask, d, torch.inf)
            cand = torch.argmin(d).reshape(1)
            cpts, cval = self._fetch(kf_pts, kf_val, cand)
            self.syncs += 1
            has_cand = bool(torch.isfinite(d.min()))
            if has_cand:
                self.searches += 1
                zero = torch.zeros(3, dtype=torch.float32, device=dev)
                init_rel = pose_between(g.poses.index_select(0, cand)[0],
                                        pose)
                rel, q = frontend.match_scans(Scan(cpts, cval, zero),
                                              Scan(points, valid, zero),
                                              init_rel, self.mcfg)
                ok = (torch.linalg.vector_norm(rel[:2] - init_rel[:2])
                      < gcfg.loop_max_translation) \
                    & (q.inlier_frac > gcfg.loop_min_inlier_frac)
                self.syncs += 1
                looped = bool(ok)
                if looped:
                    g = posegraph.add_edge(g, cand[0], n, rel, loop_w)
            n += 1
        g, overflow = self.optimize(g)
        return g, kf_pts, kf_val, n, has_cand, looped, overflow

    def __call__(self, state: ShardedGraphSlamState, points: torch.Tensor,
                 valid: torch.Tensor, force
                 ) -> Tuple[ShardedGraphSlamState, ShardedGraphSlamInfo]:
        hs, hinfo = self.hstep(hector_sharded.ShardedHectorState(
            state.local_maps, state.match_pose, state.last_update_pose),
            points, valid, force)
        pose = hs.match_pose
        due = frontend.keyframe_due(state.last_kf_pose, pose,
                                    self.gcfg.keyframe_dist,
                                    self.gcfg.keyframe_angle)
        st = state._replace(local_maps=hs.local_maps, match_pose=pose,
                            last_update_pose=hs.last_update_pose)
        self.syncs += 1
        if not bool(due):             # the scan's read of the device
            self.flags.append((False, False, False))
            return st, ShardedGraphSlamInfo(
                due, torch.zeros_like(due), hinfo.map_updated,
                torch.zeros((), dtype=torch.int32, device=pose.device))
        g, kf_pts, kf_val, n, has_cand, looped, overflow = self._spawn(
            st, points, valid, pose)
        self.flags.append((True, has_cand, looped))
        # re-anchor the live matcher to the optimized current keyframe
        opt = g.poses[n - 1]
        st = st._replace(
            match_pose=torch.stack([opt[0], opt[1], normalize_angle(opt[2])]),
            graph=g, kf_points=kf_pts, kf_valid=kf_val, last_kf_pose=pose,
            loop_count=state.loop_count + int(looped), nodes=n)
        return st, ShardedGraphSlamInfo(due, torch.full_like(due, looped),
                                        hinfo.map_updated, overflow)


def make_step(mesh: Mesh, hcfg: HectorConfig, gcfg: PoseGraphConfig,
              num_beams: int, mcfg: frontend.ScanMatchConfig | None = None,
              opt_iterations: int = 3, sep_capacity: int = 16,
              tile_axis: str = "tile", search_axis: str = "search") -> Step:
    """The distributed graph-SLAM step for scans of ``num_beams`` beams
    (see ``Step``)."""
    return Step(mesh, hcfg, gcfg, num_beams, mcfg, opt_iterations,
                sep_capacity, tile_axis, search_axis)
