"""Carry Hector state between this package and the JAX package, as numpy.

``hector_state_from_numpy`` takes the arrays of a ``slamnet_tpu``
``HectorState`` (``maps``, ``match_pose``, ``last_update_pose``, e.g.
``np.asarray(jax_state.maps)``) and builds this package's state on
``device`` (the card unless the caller names another); ``hector_state_to_numpy`` gives back a dict with the same three
names, so ``slamnet_tpu.models.hector.HectorState(**d)`` rebuilds the JAX
state.

``fleet_state_from_numpy`` / ``fleet_state_to_numpy`` do the same for a
fleet's state (``slamnet_tpu.models.fleet``): flat maps f32[B*C] and poses
f32[B, 3].

``graph_state_from_numpy`` / ``graph_state_to_numpy`` carry a graph-SLAM
state (``slamnet_tpu.models.graph_slam.GraphSlamState``) as a dict of the
same names: ``hector`` (the three Hector arrays), ``graph`` (the
``PoseGraph`` arrays), ``kf_points``, ``kf_valid``, ``last_kf_pose`` and
``loop_count``.

``coreslam_state_from_numpy`` / ``coreslam_state_to_numpy`` carry a CoreSLAM
state (``slamnet_tpu.models.coreslam.CoreSlamState``) as its arrays
``hole_map`` (i32), ``obstacle_map`` (i8), ``pose``, ``last_odometry`` and
``scan_count``.  JAX's PRNG key is not carried: the port's state draws from
a ``torch.Generator`` seeded with ``seed``, so
``CoreSlamState(**d, key=...)`` rebuilds a JAX state with a key of the
caller's choice.

``particle_state_from_numpy`` / ``particle_state_to_numpy`` do the same for
a particle state (``slamnet_tpu.models.particle.ParticleState``): the
CoreSLAM arrays plus ``particles`` f32[P, 3] and ``scores`` i32[P]; the
port's draws come from a generator seeded with ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from .graph.posegraph import PoseGraph
from .models import coreslam, particle
from .models.graph_slam import GraphSlamState
from .models.hector import HectorState

FIELDS = ("maps", "match_pose", "last_update_pose")
GRAPH_FIELDS = PoseGraph._fields
GRAPH_STATE_FIELDS = ("hector", "graph", "kf_points", "kf_valid",
                      "last_kf_pose", "loop_count")
CORESLAM_FIELDS = ("hole_map", "obstacle_map", "pose", "last_odometry",
                   "scan_count")
PARTICLE_FIELDS = ("particles", "scores") + CORESLAM_FIELDS
_INT_FIELDS = ("num_nodes", "edge_i", "edge_j", "num_edges")
_BOOL_FIELDS = ("node_valid", "edge_valid")


def hector_state_from_numpy(maps, match_pose, last_update_pose,
                            device: torch.device | str = "cuda") -> HectorState:
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    maps_t = t(maps)
    if maps_t.dim() != 1:
        raise ValueError(f"maps must be flat f32[total_cells], got {maps_t.shape}")
    return HectorState(maps_t, t(match_pose), t(last_update_pose))


def hector_state_to_numpy(state: HectorState) -> dict[str, np.ndarray]:
    return {name: getattr(state, name).detach().cpu().numpy().copy()
            for name in FIELDS}


def fleet_state_from_numpy(maps, match_pose, last_update_pose,
                           device: torch.device | str = "cuda") -> HectorState:
    """A fleet state from flat ``maps`` f32[B*C] and poses f32[B, 3]."""
    st = hector_state_from_numpy(maps, match_pose, last_update_pose, device)
    for name in ("match_pose", "last_update_pose"):
        pose = getattr(st, name)
        if pose.dim() != 2 or pose.shape[1] != 3 \
                or st.maps.numel() % pose.shape[0]:
            raise ValueError(f"{name} must be [B, 3] with B dividing the "
                             f"{st.maps.numel()} map cells, got "
                             f"{tuple(pose.shape)}")
    return st


fleet_state_to_numpy = hector_state_to_numpy


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def graph_state_from_numpy(arrays: dict,
                           device: torch.device | str = "cuda"
                           ) -> GraphSlamState:
    """A graph-SLAM state from ``arrays`` (the dict ``graph_state_to_numpy``
    gives, e.g. made from a JAX state's arrays), on the card unless
    ``device`` names another."""
    missing = set(GRAPH_STATE_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"graph state arrays lack {sorted(missing)}")

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    g = arrays["graph"]
    graph = PoseGraph(**{
        k: t(g[k], torch.int32 if k in _INT_FIELDS else
             torch.bool if k in _BOOL_FIELDS else torch.float32)
        for k in GRAPH_FIELDS})
    kf_points = t(arrays["kf_points"], torch.float32)
    if kf_points.shape[0] != graph.poses.shape[0]:
        raise ValueError(f"kf_points has {kf_points.shape[0]} slots, the "
                         f"graph {graph.poses.shape[0]}")
    return GraphSlamState(
        hector=hector_state_from_numpy(**arrays["hector"], device=device),
        graph=graph, kf_points=kf_points,
        kf_valid=t(arrays["kf_valid"], torch.bool),
        last_kf_pose=t(arrays["last_kf_pose"], torch.float32),
        loop_count=t(arrays["loop_count"], torch.int32),
        nodes=int(np.asarray(g["num_nodes"])))


def graph_state_to_numpy(state: GraphSlamState) -> dict:
    """``state`` as ``graph_state_from_numpy`` takes it."""
    return {"hector": hector_state_to_numpy(state.hector),
            "graph": {k: _np(getattr(state.graph, k)) for k in GRAPH_FIELDS},
            "kf_points": _np(state.kf_points),
            "kf_valid": _np(state.kf_valid),
            "last_kf_pose": _np(state.last_kf_pose),
            "loop_count": _np(state.loop_count)}


def coreslam_state_from_numpy(hole_map, obstacle_map, pose, last_odometry,
                              scan_count, seed: int = 0,
                              device: torch.device | str = "cuda"
                              ) -> coreslam.CoreSlamState:
    """A CoreSLAM state from its arrays (e.g. a JAX state's), on the card
    unless ``device`` names another, drawing from a generator seeded with
    ``seed``."""
    count = int(np.asarray(scan_count))

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return coreslam.CoreSlamState(
        hole_map=t(hole_map, torch.int32).reshape(-1),
        obstacle_map=t(obstacle_map, torch.int8),
        pose=t(pose, torch.float32), last_odometry=t(last_odometry,
                                                     torch.float32),
        scan_count=t(count, torch.int32),
        generator=torch.Generator(device=device).manual_seed(seed),
        scans=count)


def coreslam_state_to_numpy(state: coreslam.CoreSlamState) -> dict:
    """``state``'s arrays as ``coreslam_state_from_numpy`` takes them."""
    return {k: _np(getattr(state, k)) for k in CORESLAM_FIELDS}


def particle_state_from_numpy(particles, scores, hole_map, obstacle_map, pose,
                              last_odometry, scan_count, seed: int = 0,
                              device: torch.device | str = "cuda"
                              ) -> particle.ParticleState:
    """A particle state from its arrays (e.g. a JAX state's), on the card
    unless ``device`` names another, drawing from a generator seeded with
    ``seed``."""
    c = coreslam_state_from_numpy(hole_map, obstacle_map, pose, last_odometry,
                                  scan_count, seed, device)
    parts = torch.tensor(np.asarray(particles), dtype=torch.float32,
                         device=device)
    sc = torch.tensor(np.asarray(scores), dtype=torch.int32, device=device)
    if parts.dim() != 2 or parts.shape[1] != 3 or sc.shape != parts.shape[:1]:
        raise ValueError(f"particles must be [P, 3] and scores [P], got "
                         f"{tuple(parts.shape)} and {tuple(sc.shape)}")
    return particle.ParticleState(
        particles=parts, scores=sc, hole_map=c.hole_map,
        obstacle_map=c.obstacle_map, pose=c.pose,
        last_odometry=c.last_odometry, scan_count=c.scan_count,
        generator=c.generator, scans=c.scans)


def particle_state_to_numpy(state: particle.ParticleState) -> dict:
    """``state``'s arrays as ``particle_state_from_numpy`` takes them."""
    return {k: _np(getattr(state, k)) for k in PARTICLE_FIELDS}
