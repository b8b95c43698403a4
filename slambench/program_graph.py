"""The system under test in graph-SLAM's cells: ``models/graph_slam.update``
as a replay calls it, and a configuration's ``"hector"``, ``"graph"`` and
``"frontend"`` groups turned into the program's configs.

Each scan is the whole revolution's cloud; the hint is the state's own
match pose (Hector's, re-anchored to the optimized keyframe after each
keyframe event).  The bootstrap maps a scan at its true pose, forced, in
the bootstrap's Hector config.  The counters are read with defaults, so a
program without them reads None.
"""
from __future__ import annotations

import contextlib

import torch

from slamnet_tpu_torch.core.config import PoseGraphConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.graph import frontend
from slamnet_tpu_torch.graph.frontend import ScanMatchConfig
from slamnet_tpu_torch.models import graph_slam

from .program import hector_config

COUNTERS = ("syncs", "searches", "keyframes", "closures", "solves",
            "solve_unknowns")


def graph_config(d: dict) -> PoseGraphConfig:
    """A configuration's ``"graph"`` group as the program's config."""
    return PoseGraphConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items()})


class GraphSlam:
    """One graph-SLAM robot: ``init`` a state at a start pose f32[3],
    ``step`` it one scan, tracked or (``boot``) mapped at a given pose."""

    def __init__(self, cfg: dict, num_beams: int, device):
        self.hcfg = hector_config(cfg["hector"])
        self.boot_hcfg = hector_config({**cfg["hector"],
                                        **cfg["bootstrap_overrides"]})
        self.gcfg = graph_config(cfg["graph"])
        self.mcfg = ScanMatchConfig(**cfg["frontend"])
        self.num_beams = num_beams
        self.device = torch.device(device)
        self._zero = torch.zeros(3, dtype=torch.float32, device=self.device)

    def init(self, start_pose: torch.Tensor):
        return graph_slam.init(self.hcfg, self.gcfg, start_pose,
                               self.num_beams, self.device)

    def step(self, state, points, valid, boot_pose=None):
        """One scan (``points`` f32[N, 2], ``valid`` bool[N]): (state, live
        pose f32[3] on the device).  ``boot_pose`` f32[3] maps the scan at
        that pose, forced, in the bootstrap's config."""
        scan = Scan(points, valid, self._zero)
        if boot_pose is None:
            state, _ = graph_slam.update(state, scan, self.hcfg, self.gcfg,
                                         self.mcfg)
        else:
            state = state._replace(hector=state.hector._replace(
                match_pose=boot_pose.clone()))
            state, _ = graph_slam.update(state, scan, self.boot_hcfg,
                                         self.gcfg, self.mcfg, True)
        return state, state.hector.match_pose

    @contextlib.contextmanager
    def recorded_searches(self):
        """The frontend's loop matches while the block runs, as the program
        makes them: a list of (the candidate's points f32[N, 2] and valid
        bool[N], the new scan's points and valid, the start f32[3], the
        answer f32[3]), device tensors, no read."""
        found, real = [], frontend.match_scans

        def match_scans(ref, qry, init_rel, *args, **kwargs):
            rel, q = real(ref, qry, init_rel, *args, **kwargs)
            found.append((ref.points, ref.valid, qry.points, qry.valid,
                          init_rel, rel))
            return rel, q
        frontend.match_scans = match_scans
        try:
            yield found
        finally:
            frontend.match_scans = real


def outcome(state) -> dict:
    """What a job ends with: keyframes and accepted closures (host
    integers), the keyframes' optimized poses f32[K, 3] and the Hector maps
    (the state's own tensor)."""
    k = state.nodes
    return {"keyframes": k, "closures": int(state.loop_count),
            "kf_poses": state.graph.poses[:k].clone(),
            "maps": state.hector.maps}


def counters() -> dict:
    """The program's counts so far (None where the program has no such
    counter)."""
    return {k: getattr(graph_slam.update, k, None) for k in COUNTERS}
