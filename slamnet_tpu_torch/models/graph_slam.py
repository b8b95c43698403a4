"""Graph-SLAM: Hector odometry + a keyframe pose graph with loop closures.

Port of ``slamnet_tpu/models/graph_slam.py`` (``init``, ``update``,
``_spawn_keyframe``, ``rebuild_maps``, ``rebuild_maps_sharded``):

  scan -> hector.update (K1/K3 match, K2/K4 map update)
       -> keyframe gate (frontend.keyframe_due)
       -> odometry edge between consecutive keyframes
       -> loop-closure search (frontend.loop_candidates + match_scans:
          K3/K1 and K4/K2 at the local grid's shape)
       -> pose-graph GN optimization on the active node prefix
       -> the live matcher pose re-anchored to the optimized keyframe

The keyframe branch.  JAX branches with ``lax.cond`` on ``due``
(``graph_slam.py:165``), on ``has_cand`` (``:113``) and on ``looped`` for 1 or
3 optimizer iterations (``:118-127``).  Here each is a Python branch on a
1-byte copy of the flag to the host (counted in ``update.syncs``):

* ``due``, once a scan.  The state keeps the host's count of nodes
  (``GraphSlamState.nodes``): a node is added on every keyframe until the
  graph is full, so the host knows it without a read, and it picks the
  solve's bucket and every node index;
* ``has_cand``, once a keyframe event: the frontend's fill and match run
  only when an old keyframe is near (counted in ``update.searches``);
* ``looped``, once a search: the loop edge is written and the optimizer's
  extra steps run only when the match was accepted.

Everything is fixed-shape: K keyframe slots with stored clouds.  ``update``
changes the Hector maps and the graph's tensors in place.  The entry points
(``init``) put the state on the card unless the caller names another device.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from ..core.config import HectorConfig, PoseGraphConfig
from ..core.geometry import normalize_angle, pose_between
from ..core.scan import Scan
from ..graph import frontend, posegraph
from . import hector

ANCHOR_WEIGHT = 1e6    # the node-0 prior of every optimize (graph_slam.py:123)
MIN_INDEX_GAP = 5      # loop candidates at least this many keyframes older


class GraphSlamState(NamedTuple):
    hector: hector.HectorState
    graph: posegraph.PoseGraph
    kf_points: torch.Tensor     # f32[K, N, 2] stored keyframe clouds
    kf_valid: torch.Tensor      # bool[K, N]
    last_kf_pose: torch.Tensor  # f32[3]
    loop_count: torch.Tensor    # i32[] accepted loop closures
    nodes: int                  # the host's count of graph.num_nodes


class GraphSlamInfo(NamedTuple):
    keyframe_added: torch.Tensor   # bool
    loop_closed: torch.Tensor      # bool
    map_updated: torch.Tensor      # bool


def init(hcfg: HectorConfig, gcfg: PoseGraphConfig, start_pose,
         num_beams: int, device: torch.device | str = "cuda"
         ) -> GraphSlamState:
    """Hector at ``start_pose``, a graph whose node 0 is ``start_pose``, and
    empty keyframe clouds of ``num_beams`` beams."""
    pose = torch.as_tensor(start_pose, dtype=torch.float32, device=device)
    g = posegraph.init(gcfg.max_keyframes, gcfg.max_edges, device)
    g, _ = posegraph.add_node(g, pose)
    k = gcfg.max_keyframes
    return GraphSlamState(
        hector=hector.init(hcfg, pose, device), graph=g,
        kf_points=torch.zeros((k, num_beams, 2), dtype=torch.float32,
                              device=device),
        kf_valid=torch.zeros((k, num_beams), dtype=torch.bool, device=device),
        last_kf_pose=pose.clone(),
        loop_count=torch.zeros((), dtype=torch.int32, device=device),
        nodes=min(1, k))


@functools.cache
def _weights(gcfg: PoseGraphConfig, device: torch.device):
    """The edge weights as device tensors, made once a config and device."""
    return (torch.tensor(gcfg.odom_edge_weights, dtype=torch.float32,
                         device=device),
            torch.tensor(gcfg.loop_edge_weights, dtype=torch.float32,
                         device=device))


def _spawn_keyframe(state: GraphSlamState, scan: Scan, pose: torch.Tensor,
                    gcfg: PoseGraphConfig, mcfg: frontend.ScanMatchConfig,
                    plain: bool = False) -> Tuple[GraphSlamState,
                                                  torch.Tensor]:
    """Add the keyframe node, its odometry edge and its cloud, try a loop
    closure against the nearest old keyframe, and optimize.  Returns the
    state and ``looped``, read to the host."""
    g = state.graph
    dev = pose.device
    k = gcfg.max_keyframes
    n = state.nodes
    prev_idx = n - 1
    odom_w, loop_w = _weights(gcfg, dev)
    looped = False
    kf_points, kf_valid = state.kf_points, state.kf_valid
    # capacity guard: with the node table full, nothing below may write (an
    # edge to a clamped index would constrain the wrong node)
    if n < k:
        rel = pose_between(g.poses[prev_idx], pose)
        g, _ = posegraph.add_node(g, pose)
        g = posegraph.add_edge(g, prev_idx, n, rel, odom_w)
        kf_points[n] = scan.points
        kf_valid[n] = scan.valid

        # loop closure: the nearest valid candidate by proximity
        cand_mask = frontend.loop_candidates(g.poses, g.node_valid, n,
                                             gcfg.loop_closure_radius,
                                             MIN_INDEX_GAP)
        d = torch.linalg.vector_norm(g.poses[:, :2] - pose[None, :2], dim=1)
        d = torch.where(cand_mask, d, torch.inf)
        update.syncs += 1
        if bool(torch.isfinite(d.min())):          # has_cand
            update.searches += 1
            cand = torch.argmin(d).reshape(1)
            cand_scan = Scan(kf_points.index_select(0, cand)[0],
                             kf_valid.index_select(0, cand)[0],
                             torch.zeros(3, dtype=torch.float32, device=dev))
            init_rel = pose_between(g.poses.index_select(0, cand)[0], pose)
            rel, q = frontend.match_scans(cand_scan, scan, init_rel, mcfg,
                                          plain)
            # accept when the matcher stayed near its start (no divergence)
            # AND the query points land on the candidate's occupied cells
            ok = (torch.linalg.vector_norm(rel[:2] - init_rel[:2])
                  < gcfg.loop_max_translation) \
                & (q.inlier_frac > gcfg.loop_min_inlier_frac)
            update.syncs += 1
            looped = bool(ok)
            if looped:
                g = posegraph.add_edge(g, cand[0], n, rel, loop_w)
        n += 1

    # optimize after every keyframe: 1 step, or 3 after a closure
    iters = (gcfg.optimize_iterations_loop if looped
             else gcfg.optimize_iterations)
    g = posegraph.optimize(g, iters, ANCHOR_WEIGHT,
                           huber_delta=gcfg.huber_delta, num_nodes=n)

    return state._replace(graph=g, kf_points=kf_points, kf_valid=kf_valid,
                          last_kf_pose=pose,
                          loop_count=state.loop_count + int(looped),
                          nodes=n), looped


def update(state: GraphSlamState, scan: Scan, hcfg: HectorConfig,
           gcfg: PoseGraphConfig,
           mcfg: frontend.ScanMatchConfig | None = None,
           map_without_matching: bool | torch.Tensor = False,
           plain: bool = False) -> Tuple[GraphSlamState, GraphSlamInfo]:
    """One scan: Hector tracking from the live match pose, then, when the
    robot moved a keyframe's distance or angle, a keyframe event.  Reads
    ``due`` a scan, and ``has_cand`` and ``looped`` in a keyframe event (see
    the module's note).  ``plain=True`` runs the kernels' plain versions
    whatever the device."""
    if mcfg is None:
        mcfg = frontend.ScanMatchConfig()
    hstate, hinfo = hector.update(state.hector, scan, state.hector.match_pose,
                                  hcfg, map_without_matching, plain)
    pose = hstate.match_pose
    due = frontend.keyframe_due(state.last_kf_pose, pose, gcfg.keyframe_dist,
                                gcfg.keyframe_angle)
    update.syncs += 1
    if not bool(due):                 # the scan's read of the device
        return state._replace(hector=hstate), GraphSlamInfo(
            due, torch.zeros_like(due), hinfo.map_updated)
    st2, looped = _spawn_keyframe(state._replace(hector=hstate), scan, pose,
                                  gcfg, mcfg, plain)
    # re-anchor the live matcher to the optimized current keyframe
    opt = st2.graph.poses[st2.nodes - 1]
    h = st2.hector._replace(match_pose=torch.stack(
        [opt[0], opt[1], normalize_angle(opt[2])]))
    return st2._replace(hector=h), GraphSlamInfo(
        due, torch.full_like(due, looped), hinfo.map_updated)


update.syncs = 0      # host reads of a device flag
update.searches = 0   # keyframe events that ran the frontend


def rebuild_maps(state: GraphSlamState, hcfg: HectorConfig,
                 plain: bool = False) -> torch.Tensor:
    """Offline map finalization: every stored keyframe scan rasterized at its
    OPTIMIZED pose into a fresh pyramid, slot by slot in order (the occupied
    cap makes the order matter).  One K4 (or K2) call a slot, gated on the
    device by ``node_valid[k]``."""
    dev = state.kf_points.device
    maps = torch.zeros(hcfg.total_cells, dtype=torch.float32, device=dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    st = hector.HectorState(maps, zero, zero)
    g = state.graph
    for k in range(state.kf_points.shape[0]):
        is_kf = g.node_valid[k]
        cloud = Scan(state.kf_points[k], state.kf_valid[k] & is_kf, zero)
        hector.update_maps(st, cloud, g.poses[k], is_kf, hcfg, plain)
    return maps


def rebuild_maps_sharded(mesh, state, hcfg: HectorConfig,
                         tile_axis: str = "tile",
                         search_axis: str = "search") -> torch.Tensor:
    """``rebuild_maps`` over a ('tile' x 'search') mesh: the keyframe clouds
    sharded over ``search_axis`` (slot ``k`` on search index ``k // (K /
    S)``), the pyramid's rows over ``tile_axis``.  Every rank of the mesh
    calls it with its ``graph_slam_sharded.ShardedGraphSlamState`` (its K /
    S clouds; ``graph_slam_sharded.shard_dense`` makes one of a dense
    state).  The graph's node slots are walked in order; at each, the
    owner broadcasts its cloud by ONE psum over ``search_axis`` (the others
    add zeros) and every tile applies the line update to its rows
    (``parallel/tiles.line_marks`` + ``apply_marks``, the sharded Hector's
    update); one ppermute over ``tile_axis`` refreshes every level's halo
    row at the end.  Equal to ``rebuild_maps`` bit for bit under the line
    update (JAX's ``rebuild_maps_sharded`` runs the line update whatever
    ``dense_free_fill`` says).

    Returns this rank's tile table f32[local_cells] (halos refreshed), a
    ``ShardedHectorState``'s ``local_maps``."""
    from ..parallel import tiles
    from . import hector_sharded as hs

    g = state.graph
    k = g.poses.shape[0]
    kf_pts, kf_val = state.kf_points, state.kf_valid
    per = kf_pts.shape[0]
    if per * mesh.axis_size(search_axis) != k:
        raise ValueError(f"{per} clouds a rank over a search axis of "
                         f"{mesh.axis_size(search_axis)} for {k} slots")
    n_tiles = mesh.axis_size(tile_axis)
    loffs = hs.local_level_offsets(hcfg, n_tiles)
    lrows = hs.level_rows(hcfg, n_tiles)
    tile = mesh.axis_index(tile_axis)
    srank = mesh.axis_index(search_axis)
    dev = kf_pts.device
    n = kf_pts.shape[1]
    local = torch.zeros(hs.local_cells(hcfg, n_tiles), dtype=torch.float32,
                        device=dev)
    # slots past the host's node count hold no node: they change nothing
    for slot in range(state.nodes):
        if slot // per == srank:
            mine = torch.cat([kf_pts[slot - srank * per].reshape(-1),
                              kf_val[slot - srank * per].to(torch.float32)])
        else:
            mine = torch.zeros(3 * n, dtype=torch.float32, device=dev)
        red = mesh.psum(mine, search_axis)
        pts = red[:2 * n].reshape(n, 2)
        v = (red[2 * n:] > 0) & g.node_valid[slot]
        for level in range(hcfg.num_levels):
            size, rows = hcfg.level_sizes[level], lrows[level]
            marks = tiles.line_marks(pts[:, 0], pts[:, 1], v, g.poses[slot],
                                     1.0 / hcfg.level_resolutions[level],
                                     size, tile * rows, rows)
            o = loffs[level]
            local[o:o + rows * size] = tiles.apply_marks(
                local[o:o + rows * size], marks, hcfg.log_odds_free,
                hcfg.log_odds_occupied, hcfg.occupied_cap)
    # one halo refresh: every level's first owned row to the north tile
    halos = mesh.ppermute(
        torch.cat([local[o:o + size] for o, size in zip(loffs,
                                                         hcfg.level_sizes)]),
        tile_axis, [(i, i - 1) for i in range(1, n_tiles)])
    h0 = 0
    for o, size, rows in zip(loffs, hcfg.level_sizes, lrows):
        local[o + rows * size:o + (rows + 1) * size] = halos[h0:h0 + size]
        h0 += size
    return local
