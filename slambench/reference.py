"""The plain reference: Hector SLAM in plain PyTorch, for one robot or a fleet.

A frozen copy of the port's plain Hector step (``models/hector.update`` and
``models/fleet.update_fleet`` over ``ops/match.match_batch_plain``,
``ops/gn.py``, ``ops/logodds.py``, ``ops/rasterize.hector_line_cells`` and
``core/geometry.py``), which ports HectorSLAMProcessor.Update
(HectorSLAMProcessor.cs:86-126), ScanMatcher (ScanMatcher.cs:41-204) and
the occupancy updates (OccGridMap.cs:114-239).  It imports nothing of the
program and takes nothing the program made: it bootstraps its own maps from
the log and replays the same scans.

Every function has a robot axis B (one robot is B = 1).  ``cdt`` is the
floating type of the per-beam arithmetic: float32 as the configurations
state it, or bfloat16 for the control (``control.py``), which has to come
out as not correct.  Poses and map tables stay float32 either way.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

TWO_PI = 2.0 * math.pi
FLOAT_MIN = torch.finfo(torch.float32).min
BF16_MODES = ("pallas", "onehot_bf16")     # the table read through bf16
F32_MODES = ("gather", "onehot_highest")   # the table read as it is


class RefConfig:
    """The fields of a configuration's ``"hector"`` group the reference
    reads; every one must be given (no default is assumed)."""

    FIELDS = ("map_resolution", "map_size", "num_levels",
              "estimate_iterations", "update_factor_free",
              "update_factor_occupied", "min_distance_diff_for_map_update",
              "min_angle_diff_for_map_update", "angle_gate_compat",
              "dense_free_fill", "dense_free_margin_px", "early_exit_tol",
              "occupied_cap", "deriv_clamp", "match_subsample",
              "xy_step_clamp_px", "matcher_mode", "max_match_jump",
              "min_match_in_map_frac", "gn_damping", "fleet_update_capacity",
              "offset")
    ANGLE_BINS = 256     # the dense fill's polar bins (ops/fill.py)

    def __init__(self, d: dict):
        for k in self.FIELDS:
            setattr(self, k, d[k])
        if self.matcher_mode not in BF16_MODES + F32_MODES:
            raise ValueError(f"matcher_mode {self.matcher_mode!r}")
        if self.early_exit_tol != 0.0 or self.angle_gate_compat \
                or list(self.offset) != [0.0, 0.0]:
            raise ValueError("the reference runs fixed iterations, the "
                             "radian gate and a zero offset")
        n, s, r = self.num_levels, self.map_size, self.map_resolution
        self.level_sizes = [s >> i for i in range(n)]
        self.level_resolutions = [r * 2.0 ** i for i in range(n)]
        self.level_offsets = [sum(w * w for w in self.level_sizes[:i])
                              for i in range(n)]
        self.total_cells = sum(w * w for w in self.level_sizes)
        pf, po = self.update_factor_free, self.update_factor_occupied
        self.log_odds_free = math.log(pf / (1.0 - pf))
        self.log_odds_occupied = math.log(po / (1.0 - po))

    def overlay(self, d: dict) -> "RefConfig":
        return RefConfig({**{k: getattr(self, k) for k in self.FIELDS}, **d})


class State(NamedTuple):
    maps: torch.Tensor         # f32[B * total_cells], each robot's pyramid
    match_pose: torch.Tensor   # f32[B, 3]
    last_pose: torch.Tensor    # f32[B, 3] pose of the last map update


# ------------------------------------------------------------------ angles
def _floor_mod(x, y: float):
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def normalize_angle(a):
    """Wrap to (-pi, pi] (MathEx.NormalizeAngle)."""
    a = _floor_mod(_floor_mod(a, TWO_PI) + TWO_PI, TWO_PI)
    return torch.where(a > math.pi, a - TWO_PI, a)


def rad_diff(a, b):
    """Signed smallest difference a - b (MathEx.RadDiff)."""
    d = ((a - b) + math.pi) / TWO_PI
    return (d - torch.floor(d)) * TWO_PI - math.pi


# ------------------------------------------------------------------ match
def _solve(H00, H01, H02, H11, H12, H22, d0, d1, d2, cfg: RefConfig):
    """The guarded adjugate solve of the 3x3 system, rotation clamped."""
    if cfg.gn_damping > 0.0:
        H00 = H00 * (1.0 + cfg.gn_damping)
        H11 = H11 * (1.0 + cfg.gn_damping)
        H22 = H22 * (1.0 + cfg.gn_damping)
    a0 = H11 * H22 - H12 * H12
    a1 = H02 * H12 - H01 * H22
    a2 = H01 * H12 - H02 * H11
    det = H00 * a0 + H01 * a1 + H02 * a2
    b1 = H00 * H22 - H02 * H02
    b2 = H01 * H02 - H00 * H12
    c2 = H00 * H11 - H01 * H01
    ok = (H00 != 0.0) & (H11 != 0.0) & (det != 0.0) & torch.isfinite(det)
    safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv = torch.where(ok, 1.0 / safe, torch.zeros_like(det))
    s0 = (a0 * d0 + a1 * d1 + a2 * d2) * inv
    s1 = (a1 * d0 + b1 * d1 + b2 * d2) * inv
    if cfg.xy_step_clamp_px > 0.0:
        s0 = s0.clamp(-cfg.xy_step_clamp_px, cfg.xy_step_clamp_px)
        s1 = s1.clamp(-cfg.xy_step_clamp_px, cfg.xy_step_clamp_px)
    s2 = ((a2 * d0 + b2 * d1 + c2 * d2) * inv).clamp(-cfg.deriv_clamp,
                                                     cfg.deriv_clamp)
    return s0, s1, s2, ok


def match(maps: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
          V: torch.Tensor, hints: torch.Tensor, cfg: RefConfig,
          any_valid: torch.Tensor, cdt=torch.float32):
    """Coarse-to-fine Gauss-Newton match of each robot's matcher beams
    (X, Y f32[B, n], V bool[B, n]) in its pyramid, from ``hints`` f32[B, 3]:
    (pose f32[B, 3], in-map beams of the finest level's last iteration
    f32[B]).  A robot with no valid beam (``any_valid`` false) keeps its
    hint."""
    b = X.shape[0]
    dev = maps.device
    table = maps if cfg.matcher_mode in F32_MODES else \
        maps.to(torch.bfloat16).to(torch.float32)
    inst = torch.arange(b, device=dev)[:, None] * cfg.total_cells
    Xc, Yc = X.to(cdt), Y.to(cdt)
    n_in = torch.zeros(b, dtype=torch.float32, device=dev)
    pose = hints
    for level in range(cfg.num_levels - 1, -1, -1):
        w = cfg.level_sizes[level]
        scale = 1.0 / cfg.level_resolutions[level]
        row0 = inst + cfg.level_offsets[level]
        est = torch.stack([pose[:, 0] * scale, pose[:, 1] * scale,
                           pose[:, 2]], dim=1)
        for _ in range(cfg.estimate_iterations[level]):
            e = est.to(cdt)
            sr = torch.sin(e[:, 2:3]) * scale
            cr = torch.cos(e[:, 2:3]) * scale
            mx = cr * Xc - sr * Yc + e[:, 0:1]
            my = sr * Xc + cr * Yc + e[:, 1:2]
            ok = V & (mx >= 0.0) & (mx <= w - 2) & (my >= 0.0) & (my <= w - 2)
            xi = mx.to(torch.int32).clamp(0, w - 2)
            yi = my.to(torch.int32).clamp(0, w - 2)
            base = row0 + (yi * w + xi).long()
            v = torch.sigmoid(table[torch.stack(
                [base, base + 1, base + w, base + w + 1])].to(cdt))
            fx, fy = mx - xi, my - yi
            xf, yf = 1.0 - fx, 1.0 - fy
            val = (v[0] * xf + v[1] * fx) * yf + (v[2] * xf + v[3] * fx) * fy
            gx = -((v[0] - v[1]) * xf + (v[2] - v[3]) * fx)
            gy = -((v[0] - v[2]) * yf + (v[1] - v[3]) * fy)
            z = torch.zeros_like(gx)
            gx, gy = torch.where(ok, gx, z), torch.where(ok, gy, z)
            fun = torch.where(ok, 1.0 - val, z)
            rot = (-sr * Xc - cr * Yc) * gx + (cr * Xc - sr * Yc) * gy
            red = torch.stack([gx * fun, gy * fun, rot * fun,
                               gx * gx, gx * gy, gx * rot,
                               gy * gy, gy * rot, rot * rot,
                               fun * fun, ok.to(cdt)], dim=-2).sum(dim=-1).float()
            d0, d1, d2, H00, H01, H02, H11, H12, H22, _, n_new = red.unbind(-1)
            s0, s1, s2, _ = _solve(H00, H01, H02, H11, H12, H22, d0, d1, d2,
                                   cfg)
            est = torch.stack([est[:, 0] + s0, est[:, 1] + s1,
                               est[:, 2] + s2], dim=1)
            n_in = n_new
        pose = torch.stack([est[:, 0] / scale, est[:, 1] / scale,
                            normalize_angle(est[:, 2])], dim=1)
    return torch.where(any_valid[:, None], pose, hints), n_in


# ------------------------------------------------------------ map updates
def _endpoints(points, poses, scale, cdt):
    """Beam ends and the robot's cell in map pixels, rounded half to even
    (VectorEx.ToRoundPoint): (bx, by i32[B, 1], ex, ey i32[B, N])."""
    th = poses[:, 2:3].to(cdt)
    c, s = torch.cos(th), torch.sin(th)
    tx, ty = poses[:, 0:1].to(cdt), poses[:, 1:2].to(cdt)
    px, py = points[..., 0].to(cdt), points[..., 1].to(cdt)
    bx, by = tx * scale, ty * scale
    ex = (c * px - s * py + tx) * scale
    ey = (s * px + c * py + ty) * scale
    return (torch.round(bx).to(torch.int32), torch.round(by).to(torch.int32),
            torch.round(ex).to(torch.int32), torch.round(ey).to(torch.int32))


def _apply(grid, free, occ, cfg: RefConfig):
    """Log-odds: occupied overrides free; occupied cells under the cap."""
    zero = torch.zeros_like(grid)
    is_free = free & ~occ
    return (grid + torch.where(is_free, cfg.log_odds_free, zero)
            + torch.where(occ & (grid < cfg.occupied_cap),
                          cfg.log_odds_occupied, zero))


def _occupied(w, bxi, byi, exi, eyi, valid):
    """The beams that count, and their endpoint cells as a mask."""
    def inside(x, y):
        return (x >= 0) & (x < w) & (y >= 0) & (y < w)
    beam_ok = valid & ~((exi == bxi) & (eyi == byi)) & inside(bxi, byi) \
        & inside(exi, eyi)
    b = exi.shape[0]
    occ = torch.zeros((b, w * w), dtype=torch.int32, device=exi.device)
    occ = occ.scatter_reduce(1, torch.where(beam_ok, eyi * w + exi, 0).long(),
                             beam_ok.to(torch.int32), "amax")
    return beam_ok, occ > 0


def line_free(w, bxi, byi, exi, eyi, beam_ok):
    """Hector's Bresenham2D free cells (OccGridMap.cs:155-239) of every
    counted beam, endpoint excluded, as a mask bool[B, w*w]."""
    bx, by = bxi.expand_as(exi), byi.expand_as(eyi)
    dx, dy = exi - bx, eyi - by
    adx, ady = dx.abs(), dy.abs()
    sx, sy = dx.sign(), dy.sign()
    x_major = adx >= ady
    maj = torch.where(x_major, adx, ady)
    mino = torch.where(x_major, ady, adx)
    off_major = torch.where(x_major, sx, sy * w)
    off_minor = torch.where(x_major, sy * w, sx)
    k = torch.arange(w, dtype=torch.int32, device=exi.device)
    m = ((maj // 2)[..., None] + k * mino[..., None]) \
        // maj.clamp(min=1)[..., None]
    flat = (by * w + bx)[..., None] + k * off_major[..., None] \
        + m * off_minor[..., None]
    mask = (k < maj[..., None]) & (maj[..., None] > 0) & beam_ok[..., None]
    b = exi.shape[0]
    free = torch.zeros((b, w * w), dtype=torch.int32, device=exi.device)
    free = free.scatter_reduce(
        1, torch.where(mask, flat, 0).reshape(b, -1).long(),
        mask.reshape(b, -1).to(torch.int32), "amax")
    return free > 0


def dense_free(w, bxi, byi, exi, eyi, beam_ok, cfg: RefConfig, cdt):
    """The dense polar fill's free cells: every cell nearer the robot than
    its angular bin's shortest beam less the margin, as a mask."""
    b, dev, bins_n = exi.shape[0], exi.device, RefConfig.ANGLE_BINS
    dxe, dye = (exi - bxi).to(cdt), (eyi - byi).to(cdt)
    r_beam = torch.sqrt(dxe * dxe + dye * dye)
    bin_scale = bins_n / TWO_PI
    bins = ((torch.atan2(dye, dxe) + math.pi) * bin_scale).to(
        torch.int32).clamp(0, bins_n - 1)
    big = 1e9
    table = torch.full((b, bins_n), big, dtype=torch.float32, device=dev)
    table = table.scatter_reduce(
        1, torch.where(beam_ok, bins, 0).long(),
        torch.where(beam_ok, r_beam.float(),
                    torch.full_like(r_beam, big, dtype=torch.float32)), "amin")
    table = torch.where(table >= big, torch.zeros_like(table), table)
    idx = torch.arange(w, dtype=torch.int32, device=dev)
    dx = (idx[None, None, :] - bxi[:, :, None]).to(cdt)
    dy = (idx[None, :, None] - byi[:, :, None]).to(cdt)
    r_cell = torch.sqrt(dx * dx + dy * dy).reshape(b, -1).float()
    shape = (b, w, w)
    cbin = ((torch.atan2(dy.expand(shape), dx.expand(shape)) + math.pi)
            * bin_scale).to(torch.int32).clamp(0, bins_n - 1)
    r_lim = table.gather(1, cbin.reshape(b, -1).long())
    free = (r_cell < r_lim - cfg.dense_free_margin_px) & (r_cell > 0.0)
    return free & beam_ok.any(dim=1, keepdim=True)


def update_maps(grids: torch.Tensor, points, valid, poses, cfg: RefConfig,
                cdt=torch.float32) -> torch.Tensor:
    """Every level of each robot's pyramid ``grids`` f32[B, total_cells]
    updated by its scan at ``poses`` f32[B, 3] (MapRepMultiMap.UpdateByScan):
    the dense fill or the line update, by ``cfg.dense_free_fill``."""
    out = []
    for level in range(cfg.num_levels):
        w, off = cfg.level_sizes[level], cfg.level_offsets[level]
        scale = 1.0 / cfg.level_resolutions[level]
        bxi, byi, exi, eyi = _endpoints(points, poses, scale, cdt)
        beam_ok, occ = _occupied(w, bxi, byi, exi, eyi, valid)
        free = dense_free(w, bxi, byi, exi, eyi, beam_ok, cfg, cdt) \
            if cfg.dense_free_fill else line_free(w, bxi, byi, exi, eyi,
                                                  beam_ok)
        out.append(_apply(grids[:, off:off + w * w], free, occ, cfg))
    return torch.cat(out, dim=1)


def changed_cells(points, valid, poses, cfg: RefConfig) -> torch.Tensor:
    """Cells each robot's map update marks, over every level: i64[B] (the
    map update's work for the roofline counts)."""
    n = torch.zeros(points.shape[0], dtype=torch.int64, device=points.device)
    for level in range(cfg.num_levels):
        w = cfg.level_sizes[level]
        bxi, byi, exi, eyi = _endpoints(points, poses,
                                        1.0 / cfg.level_resolutions[level],
                                        torch.float32)
        beam_ok, occ = _occupied(w, bxi, byi, exi, eyi, valid)
        free = dense_free(w, bxi, byi, exi, eyi, beam_ok, cfg, torch.float32) \
            if cfg.dense_free_fill else line_free(w, bxi, byi, exi, eyi,
                                                  beam_ok)
        n += (free | occ).sum(dim=1)
    return n


# ------------------------------------------------------------------ steps
def init(cfg: RefConfig, start_poses: torch.Tensor) -> State:
    b = start_poses.shape[0]
    return State(torch.zeros(b * cfg.total_cells, dtype=torch.float32,
                             device=start_poses.device),
                 start_poses.clone().float(),
                 torch.full_like(start_poses, FLOAT_MIN, dtype=torch.float32))


def step(state: State, points, valid, cfg: RefConfig, force: bool,
         full_scan: bool, cdt=torch.float32):
    """One scan for every robot, each hinted with its match pose: match,
    the guards, the motion gate, then the map update of the robots whose
    gate fired.  ``force`` maps at the hint (the bootstrap).  A robot with
    no valid beam keeps its hint, judged over its whole scan with
    ``full_scan`` (the single robot's rule) and over the matcher's beams
    otherwise.  Returns (state, fired bool[B])."""
    hint = state.match_pose
    b = hint.shape[0]
    if force:
        match_pose = hint
        fire = torch.ones(b, dtype=torch.bool, device=hint.device)
    else:
        sub = cfg.match_subsample
        X, Y, V = points[:, ::sub, 0], points[:, ::sub, 1], valid[:, ::sub]
        matched, n_in = match(state.maps, X, Y, V, hint, cfg,
                              (valid if full_scan else V).any(dim=1), cdt)
        if cfg.min_match_in_map_frac > 0.0:
            frac = n_in / V.sum(dim=1, dtype=torch.float32).clamp(min=1.0)
            matched = torch.where((frac >= cfg.min_match_in_map_frac)[:, None],
                                  matched, hint)
        if cfg.max_match_jump > 0.0:
            jump2 = ((matched[:, :2] - hint[:, :2]) ** 2).sum(dim=1)
            matched = torch.where((jump2 <= cfg.max_match_jump ** 2)[:, None],
                                  matched, hint)
        match_pose = matched
        last = state.last_pose
        dist2 = ((match_pose[:, :2] - last[:, :2]) ** 2).sum(dim=1)
        ang = rad_diff(match_pose[:, 2], last[:, 2]).abs() \
            > cfg.min_angle_diff_for_map_update
        fire = (dist2 > cfg.min_distance_diff_for_map_update ** 2) | ang
        if int(fire.sum()) > cfg.fleet_update_capacity:
            raise ValueError("the reference runs uncapped map updates")
    grids = state.maps.view(b, cfg.total_cells)
    idx = fire.nonzero().flatten()
    if idx.numel():
        grids.index_copy_(0, idx, update_maps(
            grids[idx], points[idx], valid[idx], match_pose[idx], cfg, cdt))
    last = torch.where(fire[:, None], match_pose, state.last_pose)
    return State(state.maps, match_pose, last), fire


def bootstrap(traj, points, valid, n: int, cfg: RefConfig) -> State:
    """Scans 0..n-1 (``traj`` f32[T, B, 3], ``points`` f32[T, B, N, 2])
    mapped at their true poses: a fresh state with its maps built."""
    state = init(cfg, traj[0])
    for t in range(n):
        state = state._replace(match_pose=traj[t].clone().float())
        state, _ = step(state, points[t], valid[t], cfg, True, False)
    return state


def replay(state: State, points, valid, cfg: RefConfig, full_scan: bool,
           snapshots=(), cdt=torch.float32):
    """Track the scans ``points`` f32[T, B, N, 2] from a copy of ``state``:
    (poses f32[T, B, 3], fired bool[T, B], {k: maps f32[B*C] after k
    scans} for each k in ``snapshots``)."""
    state = state._replace(maps=state.maps.clone())
    poses, fired, snaps = [], [], {}
    if 0 in snapshots:
        snaps[0] = state.maps.clone()
    for t in range(points.shape[0]):
        state, f = step(state, points[t], valid[t], cfg, False, full_scan, cdt)
        poses.append(state.match_pose)
        fired.append(f)
        if t + 1 in snapshots:
            snaps[t + 1] = state.maps.clone()
    return torch.stack(poses), torch.stack(fired), snaps
