"""The plain reference of graph-SLAM's cells: Hector odometry, a keyframe
pose graph and loop closures, in plain PyTorch and float32.

The Hector step is ``reference.py``'s (imported).  The rest is written here
from the pipeline's description (``models/graph_slam.py``'s docstring, and
slam_toolbox's gates for the settings): on every scan, Hector's step from
the live pose (in the bootstrap, forced at the true pose), then the
keyframe gate (moved more than ``keyframe_dist`` or turned more than
``keyframe_angle`` since the last keyframe).  A keyframe adds a node at the
live pose with an odometry edge from the previous node, and looks for the
nearest older node within ``loop_closure_radius`` whose index is below the
new one's less ``loop_min_index_gap``.  With one, the frontend rasterizes
that node's scan into a ``grid_size``-px local grid centred on its robot
(``reference.update_maps``' line update at one level) and Gauss-Newton
matches the new scan against it (``reference.match`` at that level, the
f32 table), from the graph's relative pose; the match is accepted as a
loop edge when it moved less than ``loop_max_translation`` from its start
and more than ``loop_min_inlier_frac`` of the valid beams land on cells
whose bilinear probability exceeds ``inlier_prob``.  Then GN steps of the
SE(2) pose graph (one, or ``optimize_iterations_loop`` after a closure),
and the live pose is re-anchored to the new node's optimized pose.

Departures from the program, none in the numbers the pipeline defines:
the normal equations are built as J^T W J over the valid edges and solved
over exactly the nodes there are (``torch.linalg.solve``), where the
program solves the bucket of 32, 64, ... nodes that holds them (its
trailing rows an identity), through an incidence product over every edge
slot; so a solve rounds differently in its last bits, and with H's
condition number at ~1e7 and more that moves a re-anchored pose by mm to
cm.  A tracked scan's Hector step is ``reference.step``'s operators on
fixed buffers (``Tracker``), replayed as one CUDA graph on a card: a job
takes ~29 s on an H100 so, ~240 s launched op by op.  Nothing here
imports the program or JAX, and TF32 is off for matmuls and cuDNN.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import reference

ANCHOR_WEIGHT = 1e6   # the node-0 prior of every GN step
# the local grid's Hector settings beyond the frontend group: slam.net's
# occupied cap (OccGridMap.cs:211) and rotation-step clamp
# (ScanMatcher.cs:107-117), as the program's frontend keeps them
GRID_FIXED = {"occupied_cap": 50.0, "deriv_clamp": 0.2,
              "xy_step_clamp_px": 0.0, "gn_damping": 0.0,
              "min_distance_diff_for_map_update": 0.4,
              "min_angle_diff_for_map_update": math.pi / 22.5,
              "angle_gate_compat": False, "early_exit_tol": 0.0,
              "match_subsample": 1, "max_match_jump": 0.0,
              "min_match_in_map_frac": 0.0,
              "fleet_update_capacity": 1 << 30, "offset": [0.0, 0.0]}


class RefGraphConfig:
    """A configuration's groups as the reference reads them: ``hector``
    (``reference.RefConfig``) and the bootstrap's overlay of it, ``graph``
    and ``frontend``; every field it reads must be given."""

    GRAPH = ("keyframe_dist", "keyframe_angle", "loop_closure_radius",
             "loop_min_index_gap", "max_keyframes", "optimize_iterations",
             "optimize_iterations_loop", "damping", "loop_max_translation",
             "loop_min_inlier_frac", "odom_edge_weights",
             "loop_edge_weights", "huber_delta")
    FRONTEND = ("grid_size", "resolution", "gn_iterations", "log_odds_free",
                "log_odds_occupied", "inlier_prob", "matcher_mode",
                "dense_fill", "free_margin_px")

    def __init__(self, cfg: dict):
        self.hector = reference.RefConfig(cfg["hector"])
        self.boot = self.hector.overlay(cfg["bootstrap_overrides"])
        g, f = cfg["graph"], cfg["frontend"]
        for k in self.GRAPH:
            setattr(self, k, g[k])
        self.front = {k: f[k] for k in self.FRONTEND}
        if self.huber_delta != 0.0:
            raise ValueError("the reference weights every edge as it is")
        if f["matcher_mode"] not in reference.F32_MODES or f["dense_fill"]:
            raise ValueError("the reference's frontend is the f32 match on "
                             "a line-updated grid")
        self.grid = reference.RefConfig({
            **GRID_FIXED, "map_resolution": f["resolution"],
            "map_size": f["grid_size"], "num_levels": 1,
            "estimate_iterations": [f["gn_iterations"]],
            "update_factor_free": _odds(f["log_odds_free"]),
            "update_factor_occupied": _odds(f["log_odds_occupied"]),
            "dense_free_fill": False,
            "dense_free_margin_px": f["free_margin_px"],
            "matcher_mode": f["matcher_mode"]})


def _odds(log_odds: float) -> float:
    """The update factor p whose log(p / (1 - p)) is ``log_odds``."""
    return 1.0 / (1.0 + math.exp(-log_odds))


# ------------------------------------------------------------------- SE(2)
def _rotate(th, x, y):
    c, s = torch.cos(th), torch.sin(th)
    return c * x - s * y, s * x + c * y


def pose_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b in a's frame: inverse(a) composed with b."""
    ix, iy = _rotate(-a[2], a[0], a[1])
    inv = torch.stack([-ix, -iy, -a[2]])
    x, y = _rotate(inv[2], b[0], b[1])
    return torch.stack([inv[0] + x, inv[1] + y, inv[2] + b[2]])


def wrap(a: torch.Tensor) -> torch.Tensor:
    return reference.normalize_angle(a)


# ---------------------------------------------------------------- frontend
def rasterize(points, valid, cfg: RefGraphConfig, grid_dtype) -> torch.Tensor:
    """A scan's local log-odds grid f32[grid_size**2], its robot at the
    centre; ``grid_dtype`` rounds the table (the control's bfloat16)."""
    g = cfg.grid
    centre = centre_of(cfg, points.device)
    grid = torch.zeros((1, g.total_cells), dtype=torch.float32,
                       device=points.device)
    grid = reference.update_maps(grid, points[None], valid[None],
                                 centre[None], g)[0]
    return grid.to(grid_dtype).to(torch.float32)


def centre_of(cfg: RefGraphConfig, device) -> torch.Tensor:
    c = cfg.front["grid_size"] // 2 * cfg.front["resolution"]
    return torch.tensor([c, c, 0.0], dtype=torch.float32, device=device)


def inlier_frac(grid, points, valid, pose, cfg: RefGraphConfig):
    """The share of the valid beams at ``pose`` (grid world) whose bilinear
    probability on the grid exceeds ``inlier_prob``, inside the grid's
    [0, size - 2] margin."""
    w = cfg.front["grid_size"]
    scale = 1.0 / cfg.front["resolution"]
    c, s = torch.cos(pose[2]) * scale, torch.sin(pose[2]) * scale
    X, Y = points[:, 0], points[:, 1]
    mx = c * X - s * Y + pose[0] * scale
    my = s * X + c * Y + pose[1] * scale
    inside = valid & (mx >= 0.0) & (mx <= w - 2) & (my >= 0.0) \
        & (my <= w - 2)
    x0 = torch.floor(mx).to(torch.int32).clamp(0, w - 2)
    y0 = torch.floor(my).to(torch.int32).clamp(0, w - 2)
    fx, fy = mx - x0, my - y0
    i = (y0 * w + x0).long()
    p = [torch.sigmoid(grid[i + o]) for o in (0, 1, w, w + 1)]
    val = (p[0] * (1.0 - fx) + p[1] * fx) * (1.0 - fy) \
        + (p[2] * (1.0 - fx) + p[3] * fx) * fy
    hits = ((val > cfg.front["inlier_prob"]) & inside).sum()
    return hits / valid.sum().clamp(min=1)


def match_scans(ref_pts, ref_val, pts, val, init_rel, cfg: RefGraphConfig,
                grid_dtype=torch.float32):
    """(relative pose f32[3] of the new scan's robot in the old scan's
    frame, inlier share): the old scan's grid, then the new scan matched on
    it from ``init_rel``."""
    grid = rasterize(ref_pts, ref_val, cfg, grid_dtype)
    centre = centre_of(cfg, grid.device)
    out, _ = reference.match(grid, pts[None, :, 0], pts[None, :, 1],
                             val[None], (init_rel + centre)[None], cfg.grid,
                             val.any()[None])
    out = out[0]
    rel = torch.stack([out[0] - centre[0], out[1] - centre[1], wrap(out[2])])
    return rel, inlier_frac(grid, pts, val, out, cfg)


# -------------------------------------------------------------- pose graph
def gn_step(poses: torch.Tensor, edges: list, n: int,
            cfg: RefGraphConfig) -> torch.Tensor:
    """One Gauss-Newton step over the first ``n`` nodes: the edges'
    residuals r = (R_i^T (t_j - t_i) - t_m, wrap(th_j - th_i - th_m)) and
    Jacobians, H = J^T W J and b = J^T W r with the damping on the diagonal
    and the anchor on node 0, H dx = -b, headings wrapped."""
    dev = poses.device
    ii = torch.tensor([e[0] for e in edges], device=dev)
    jj = torch.tensor([e[1] for e in edges], device=dev)
    meas = torch.stack([e[2] for e in edges])
    w = torch.stack([e[3] for e in edges])
    pi, pj = poses[ii], poses[jj]
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx, dy = pj[:, 0] - pi[:, 0], pj[:, 1] - pi[:, 1]
    r = torch.stack([c * dx + s * dy - meas[:, 0],
                     -s * dx + c * dy - meas[:, 1],
                     wrap(pj[:, 2] - pi[:, 2] - meas[:, 2])], dim=1)
    z, one = torch.zeros_like(c), torch.ones_like(c)
    ji = torch.stack([torch.stack([-c, -s, -s * dx + c * dy], 1),
                      torch.stack([s, -c, -c * dx - s * dy], 1),
                      torch.stack([z, z, -one], 1)], 1)
    jj_ = torch.stack([torch.stack([c, s, z], 1),
                       torch.stack([-s, c, z], 1),
                       torch.stack([z, z, one], 1)], 1)
    e = len(edges)
    J = torch.zeros((e, 3, n, 3), dtype=torch.float32, device=dev)
    rows = torch.arange(e, device=dev)
    J[rows, :, ii, :] = ji
    J[rows, :, jj, :] += jj_
    J = J.reshape(3 * e, 3 * n)
    wr = w.reshape(-1)
    H = J.T @ (wr[:, None] * J)
    b = J.T @ (wr * r.reshape(-1))
    prior = torch.full((3 * n,), cfg.damping, dtype=torch.float32,
                       device=dev)
    prior[:3] += ANCHOR_WEIGHT
    step = torch.linalg.solve(H + torch.diag(prior), -b).reshape(n, 3)
    out = poses.clone()
    moved = poses[:n] + step
    out[:n] = torch.cat([moved[:, :2], wrap(moved[:, 2:3])], dim=1)
    return out


# ------------------------------------------------------------ Hector step
class Tracker:
    """``reference.step`` for one robot's tracked (unforced) scans, on
    fixed buffers: the match from the live pose, the motion gate and the
    map update where it fires, the same operators on the same values.  On
    a card the step is captured once as a CUDA graph and replayed, so that
    a job's ~2,000 small operators a scan cost no launch from Python; on
    the CPU it runs as it is."""

    def __init__(self, cfg: reference.RefConfig, state: reference.State,
                 num_beams: int, full_scan: bool):
        self.cfg, self.full_scan = cfg, full_scan
        self.maps = state.maps                 # the job's, updated in place
        dev = self.maps.device
        self.points = torch.zeros((1, num_beams, 2), dtype=torch.float32,
                                  device=dev)
        self.valid = torch.zeros((1, num_beams), dtype=torch.bool,
                                 device=dev)
        self.hint = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        self.last = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        self.pose = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        self.graph = None

    def _body(self) -> None:
        cfg = self.cfg
        sub = cfg.match_subsample
        X, Y = self.points[:, ::sub, 0], self.points[:, ::sub, 1]
        V = self.valid[:, ::sub]
        hint = self.hint
        matched, n_in = reference.match(
            self.maps, X, Y, V, hint, cfg,
            (self.valid if self.full_scan else V).any(dim=1))
        if cfg.min_match_in_map_frac > 0.0:
            frac = n_in / V.sum(dim=1, dtype=torch.float32).clamp(min=1.0)
            matched = torch.where(
                (frac >= cfg.min_match_in_map_frac)[:, None], matched, hint)
        if cfg.max_match_jump > 0.0:
            jump2 = ((matched[:, :2] - hint[:, :2]) ** 2).sum(dim=1)
            matched = torch.where((jump2 <= cfg.max_match_jump ** 2)[:, None],
                                  matched, hint)
        dist2 = ((matched[:, :2] - self.last[:, :2]) ** 2).sum(dim=1)
        ang = reference.rad_diff(matched[:, 2], self.last[:, 2]).abs() \
            > cfg.min_angle_diff_for_map_update
        fire = (dist2 > cfg.min_distance_diff_for_map_update ** 2) | ang
        grids = self.maps.view(1, cfg.total_cells)
        grids.copy_(torch.where(fire[:, None], reference.update_maps(
            grids, self.points, self.valid, matched, cfg), grids))
        self.last.copy_(torch.where(fire[:, None], matched, self.last))
        self.pose.copy_(matched)

    def step(self, state: reference.State, points, valid) -> reference.State:
        """One tracked scan from ``state`` (its maps are ``self.maps``)."""
        self.points[0].copy_(points)
        self.valid[0].copy_(valid)
        self.hint.copy_(state.match_pose)
        self.last.copy_(state.last_pose)
        if self.graph is not None:
            self.graph.replay()
        else:
            self._body()
            if self.maps.is_cuda:     # captured after its first eager run
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self._body()
        return reference.State(self.maps, self.pose.clone(),
                               self.last.clone())


# ------------------------------------------------------------------ replay
class Snapshot(NamedTuple):
    maps: torch.Tensor       # f32[total_cells] Hector's pyramid
    kf_poses: torch.Tensor   # f32[nodes, 3] the optimized keyframe poses
    keyframes: int
    closures: int


class Job:
    """One job of the reference from a fresh state at ``start`` f32[3]:
    ``step`` it a scan at a time; ``nodes`` and ``loop_count`` are its
    keyframe nodes (the start's included) and accepted closures so far."""

    def __init__(self, cfg: dict, start: torch.Tensor,
                 grid_dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.rc = rc = RefGraphConfig(cfg)
        self.grid_dtype = grid_dtype
        dev = start.device
        self.odom_w = torch.tensor(rc.odom_edge_weights, dtype=torch.float32,
                                   device=dev)
        self.loop_w = torch.tensor(rc.loop_edge_weights, dtype=torch.float32,
                                   device=dev)
        self.full_scan = rc.hector.matcher_mode != "pallas"
        start = start.clone().float()
        self.hector = reference.init(rc.hector, start[None])
        self.tracker = None
        self.poses = torch.zeros((rc.max_keyframes, 3), dtype=torch.float32,
                                 device=dev)
        self.poses[0] = start
        # node k's scan; node 0 (the start) has none, an empty cloud
        self.clouds = [(None, None)]
        self.edges, self.nodes, self.loop_count = [], 1, 0
        self.last_kf = start

    def step(self, points, valid, boot_pose=None) -> tuple:
        """One scan (``points`` f32[N, 2], ``valid`` bool[N]); ``boot_pose``
        maps it at that pose, forced, in the bootstrap's config.  Returns
        (live pose f32[3], keyframe event, closure accepted)."""
        rc, st = self.rc, self.hector
        if boot_pose is not None:
            st = st._replace(match_pose=boot_pose[None].clone().float())
            st, _ = reference.step(st, points[None], valid[None], rc.boot,
                                   True, self.full_scan)
        else:
            if self.tracker is None:
                self.tracker = Tracker(rc.hector, st, points.shape[0],
                                       self.full_scan)
            st = self.tracker.step(st, points, valid)
        pose = st.match_pose[0]
        moved = torch.linalg.vector_norm(pose[:2] - self.last_kf[:2])
        turned = wrap(pose[2] - self.last_kf[2]).abs()
        due = bool((moved > rc.keyframe_dist) | (turned > rc.keyframe_angle))
        looped = False
        if due:
            if self.nodes < rc.max_keyframes:
                looped = self._add_node(pose, points, valid)
            for _ in range(rc.optimize_iterations_loop if looped
                           else rc.optimize_iterations):
                self.poses = gn_step(self.poses, self.edges, self.nodes, rc)
            self.last_kf = pose
            opt = self.poses[self.nodes - 1]
            st = st._replace(match_pose=torch.stack(
                [opt[0], opt[1], wrap(opt[2])])[None])
        self.hector = st
        return st.match_pose[0], due, looped

    def _add_node(self, pose, points, valid) -> bool:
        """The node, its odometry edge and its cloud, and a loop closure
        against the nearest old keyframe: whether one was accepted."""
        rc, m = self.rc, self.nodes
        self.edges.append((m - 1, m, pose_between(self.poses[m - 1], pose),
                           self.odom_w))
        self.poses[m] = pose
        self.clouds.append((points, valid))
        self.nodes += 1
        d = torch.linalg.vector_norm(self.poses[:m + 1, :2] - pose[:2], dim=1)
        old = torch.arange(m + 1, device=d.device) < m - rc.loop_min_index_gap
        d = torch.where(old & (d < rc.loop_closure_radius), d, torch.inf)
        if not bool(torch.isfinite(d.min())):
            return False
        c = int(torch.argmin(d))
        ref_pts, ref_val = self.clouds[c]
        if ref_pts is None:
            ref_pts, ref_val = torch.zeros_like(points), \
                torch.zeros_like(valid)
        init_rel = pose_between(self.poses[c], pose)
        rel, frac = match_scans(ref_pts, ref_val, points, valid, init_rel,
                                rc, self.grid_dtype)
        ok = bool((torch.linalg.vector_norm(rel[:2] - init_rel[:2])
                   < rc.loop_max_translation)
                  & (frac > rc.loop_min_inlier_frac))
        if ok:
            self.edges.append((c, m, rel, self.loop_w))
            self.loop_count += 1
        return ok

    def snapshot(self) -> Snapshot:
        return Snapshot(self.hector.maps.clone(),
                        self.poses[:self.nodes].clone(), self.nodes,
                        self.loop_count)


def replay(cfg: dict, traj: torch.Tensor, points: torch.Tensor,
           valid: torch.Tensor, boot: int, n: int, snapshots,
           grid_dtype=torch.float32):
    """One job: scans 0..n-1 from a fresh state at ``traj[0]``, the first
    ``boot`` mapped at their true poses.  Returns (live poses f32[n, 3],
    keyframe scans bool[n], closure scans bool[n], {k: Snapshot after k
    scans} for each k in ``snapshots``)."""
    job = Job(cfg, traj[0], grid_dtype)
    live, kf_at, loop_at, snaps = [], [], [], {}
    for t in range(n):
        pose, due, looped = job.step(points[t], valid[t],
                                     traj[t] if t < boot else None)
        live.append(pose)
        kf_at.append(due)
        loop_at.append(looped)
        if t + 1 in snapshots:
            snaps[t + 1] = job.snapshot()
    return (torch.stack(live), torch.tensor(kf_at), torch.tensor(loop_at),
            snaps)
