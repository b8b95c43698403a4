"""The plain reference of CoreSLAM: slam.net's step in plain PyTorch.

Computes ``CoreSLAMProcessor.Update`` (CoreSLAMProcessor.cs:717-752) from
its published description, scan by scan:

- the segments' de-skew (ScanSegmentsToCloud, :187-207): each ray at
  ``(p.x + r cos(angle + p.z), p.y + r sin(angle + p.z))`` with ``p`` its
  segment's pose less the newest odometry pose, component by component;
- the search prior ``pose + (odometry - last odometry)`` (:728), and the
  odometry pose taken as it is for the first ``position_search_beginning``
  scans (:739-743), the heading normalised to (-pi, pi] (:746);
- MonteCarloSearch (:624-653): the search pose and ``num_candidates - 1``
  perturbations of it, N(0, sigma_xy) in x and y and N(0, sigma_theta) in
  the heading, drawn from this module's own ``torch.Generator``: the xy
  normals f32[num_candidates, 2] first, then the heading normals
  f32[num_candidates, 1], row 0 standing for the search pose itself;
- CalculateDistanceSISD (:215-259): each candidate's cloud snapped with
  the +0.5 centre bias and C#'s truncation, the in-bounds pixels summed,
  the score ``sum * 1024 / count`` (int-max with no point in the map), and
  the first minimum kept (the strict-improvement update);
- UpdateHoleMap (:496-534): each hit extended by ``hole_width / 2`` and
  walked by DrawLaserRayOnHoleMap (:359-443) step by step (ClipRay,
  :320-345; the V-shaped value profile), all beams at once;
- UpdateObstacleMap (:536-593): DrawLaserRayOnObstacleMap's walk
  (:456-490) step by step, a hit counted at each endpoint up to
  ``max_obstacle_hits``, then every traversed cell stepped toward 0.

One departure, kept as the port keeps it: a hole-map pixel that one scan
visits k times takes the composed blend ``floor(beta^k (p - v_bar) +
v_bar)`` (beta = (256 - quality) / 256, v_bar the visits' mean value),
where slam.net blends the visits one by one in beam order.
``sequential_blend`` is slam.net's order, for showing the gap only.

Transcendentals and roots are computed in float64 and rounded once to
float32, divisions by a configuration's number are true divisions, and
TF32 is off.  The two walks are integer arithmetic, the same on any
device: they step on the CPU, where a step of 400 beams costs no launch,
and everything else runs on the inputs' device (the card).  ``cdt`` is
the floating type of the candidate transform: float32 as the
configuration states it, or bfloat16 for the control, which has to come
out as not correct.  This module imports nothing of the program and takes
nothing the program made.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
TS_OBSTACLE = 0            # the hole's value at the hit (CoreSLAMProcessor.cs)
TS_NO_OBSTACLE = 65500     # free space
HOLE_INIT = (TS_OBSTACLE + TS_NO_OBSTACLE) // 2   # Reset (:167-175)
INT32_MAX = 2 ** 31 - 1


class RefConfig:
    """The fields of a configuration's ``"coreslam"`` group the reference
    reads; every one must be given.  Only slam.net's own mode is known:
    the Monte-Carlo search and the line updates."""

    FIELDS = ("physical_map_size", "hole_map_size", "obstacle_map_size",
              "sigma_xy", "sigma_theta", "num_candidates", "quality",
              "hole_width", "position_search_beginning",
              "unmapped_obstacle_hits", "max_obstacle_hits", "search_mode",
              "dense_hole_fill", "dense_obstacle_fill")

    def __init__(self, d: dict):
        for k in self.FIELDS:
            setattr(self, k, d[k])
        if self.search_mode != "mc" or self.dense_hole_fill \
                or self.dense_obstacle_fill:
            raise ValueError("the reference runs slam.net's Monte-Carlo "
                             "search and line updates only")
        self.hole_scale = self.hole_map_size / self.physical_map_size
        self.obstacle_scale = self.obstacle_map_size / self.physical_map_size


class State(NamedTuple):
    hole: torch.Tensor         # i32[S*S]
    obstacle: torch.Tensor     # i8[OS, OS]
    pose: torch.Tensor         # f32[3]
    last_odo: torch.Tensor     # f32[3]
    scans: int                 # warm-up scans taken so far
    gen: torch.Generator       # the search's draws
    seq_hole: np.ndarray | None     # i64[S*S]: the map in slam.net's blend


# ---------------------------------------------------------------- numbers
def cos_rn(x):
    return torch.cos(x.double()).float()


def sin_rn(x):
    return torch.sin(x.double()).float()


def sqrt_rn(x):
    return torch.sqrt(x.double()).float()


def trunc(x):
    """C#'s (int) cast."""
    return torch.trunc(x).to(torch.int32)


def cdiv(a, b):
    """C#'s integer division, toward zero."""
    return torch.div(a, b, rounding_mode="trunc")


def _floor_mod(x, y: float):
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def normalize_angle(a):
    """MathEx.NormalizeAngle (MathEx.cs:128-138): to (-pi, pi]."""
    a = _floor_mod(_floor_mod(a, TWO_PI) + TWO_PI, TWO_PI)
    return torch.where(a > math.pi, a - TWO_PI, a)


# ----------------------------------------------------------------- state
def init(cfg: RefConfig, start_pose: torch.Tensor, seed: int, device,
         sequential: bool = False) -> State:
    """Reset (:167-175): the hole map at HOLE_INIT, the obstacle map at
    ``unmapped_obstacle_hits``, the pose at ``start_pose``; a generator on
    ``device`` seeded with ``seed``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s, os_ = cfg.hole_map_size, cfg.obstacle_map_size
    return State(
        torch.full((s * s,), HOLE_INIT, dtype=torch.int32, device=device),
        torch.full((os_, os_), cfg.unmapped_obstacle_hits, dtype=torch.int8,
                   device=device),
        start_pose.to(device=device, dtype=torch.float32).clone(),
        torch.zeros(3, dtype=torch.float32, device=device), 0,
        torch.Generator(device=device).manual_seed(int(seed)),
        np.full(s * s, HOLE_INIT, np.int64) if sequential else None)


def deskew(angles, radii, valid, poses):
    """ScanSegmentsToCloud (:187-207) of segments f32[S, N] tagged with
    poses f32[S, 3], the last the newest odometry pose: (points f32[S*N,
    2], valid bool[S*N])."""
    p = poses - poses[-1]
    a = angles + p[:, None, 2]
    x = p[:, None, 0] + radii * cos_rn(a)
    y = p[:, None, 1] + radii * sin_rn(a)
    return torch.stack([x, y], dim=-1).reshape(-1, 2), valid.reshape(-1)


# ---------------------------------------------------------------- search
def candidates(search_pose, cfg: RefConfig, gen) -> torch.Tensor:
    """f32[num_candidates, 3]: row 0 the search pose, the rest its
    perturbations."""
    n, dev = cfg.num_candidates, search_pose.device
    dxy = torch.randn((n, 2), generator=gen, device=dev) * cfg.sigma_xy
    dth = torch.randn((n, 1), generator=gen, device=dev) * cfg.sigma_theta
    d = torch.cat([dxy, dth], dim=1)
    d[0] = 0.0
    return search_pose[None, :] + d


def scores(hole, cfg: RefConfig, points, valid, cands, cdt=torch.float32):
    """CalculateDistanceSISD for every candidate: (score i64[B], in-map
    pixel sum i64[B]).  The score is int-max where no point is in the
    map."""
    size, scale = cfg.hole_map_size, cfg.hole_scale
    px = cands[:, 0] * scale + 0.5
    py = cands[:, 1] * scale + 0.5
    c = cos_rn(cands[:, 2]) * scale
    s = sin_rn(cands[:, 2]) * scale
    X, Y = points[:, 0][None, :], points[:, 1][None, :]
    px, py, c, s, X, Y = (t.to(cdt) for t in (px, py, c, s, X, Y))
    x = trunc((px[:, None] + c[:, None] * X - s[:, None] * Y).float())
    y = trunc((py[:, None] + s[:, None] * X + c[:, None] * Y).float())
    inb = (x >= 0) & (x < size) & (y >= 0) & (y < size) & valid[None, :]
    pix = hole[(y.clamp(0, size - 1) * size + x.clamp(0, size - 1)).long()]
    total = torch.where(inb, pix, torch.zeros_like(pix)).sum(
        dim=1, dtype=torch.int64)
    count = valid.sum().clamp(min=1).to(torch.int64)
    score = torch.div(total * 1024, count, rounding_mode="floor")
    hit = inb.any(dim=1)
    return torch.where(hit, score, torch.full_like(score, INT32_MAX)), \
        torch.where(hit, total, torch.full_like(total, INT32_MAX))


def search(hole, cfg: RefConfig, points, valid, search_pose, gen,
           cdt=torch.float32):
    """MonteCarloSearch: (best pose f32[3], its in-map sum i64[])."""
    cands = candidates(search_pose, cfg, gen)
    score, total = scores(hole, cfg, points, valid, cands, cdt)
    i = torch.argmin(score).reshape(1)        # the first minimum
    return cands.index_select(0, i)[0], total.index_select(0, i)[0]


# -------------------------------------------------------------- hole map
def clip_ray(size: int, xyc, yxc, xy, yx):
    """ClipRay (:320-345) on one axis, every beam: (ok, xyc, yxc)."""
    lo = xyc < 0
    bad = lo & (xyc == xy)
    safe = torch.where(xyc == xy, torch.ones_like(xyc), xyc - xy)
    yxc = torch.where(lo, yxc + cdiv((yxc - yx) * (-xyc), safe), yxc)
    xyc = torch.where(lo, torch.zeros_like(xyc), xyc)
    hi = xyc >= size
    bad = bad | (hi & (xyc == xy))
    safe = torch.where(xyc == xy, torch.ones_like(xyc), xyc - xy)
    yxc = torch.where(hi, yxc + cdiv((yxc - yx) * (size - 1 - xyc), safe),
                      yxc)
    xyc = torch.where(hi, torch.full_like(xyc, size - 1), xyc)
    return ~bad, xyc, yxc


def hole_walk(size: int, x1, y1, x2, y2, xp, yp):
    """DrawLaserRayOnHoleMap (:359-443) of every beam from the robot pixel
    (x1, y1) to the extended end (x2, y2), the hit at (xp, yp): (pixel
    i64[B, K], value i32[B, K], drawn bool[B, K]) in draw order along K."""
    b, dev = x2.shape[0], x2.device
    x1 = torch.zeros(b, dtype=torch.int32, device=dev) + x1
    y1 = torch.zeros(b, dtype=torch.int32, device=dev) + y1
    ok1, x2c, y2c = clip_ray(size, x2, y2, x1, y1)
    ok2, y2c, x2c = clip_ray(size, y2c, x2c, y1, x1)

    dx, dy = (x2 - x1).abs(), (y2 - y1).abs()
    dxc, dyc = (x2c - x1).abs(), (y2c - y1).abs()
    incx, incy = (x2 - x1).sign(), (y2 - y1).sign() * size
    sincv = (TS_OBSTACLE > TS_NO_OBSTACLE) - (TS_OBSTACLE < TS_NO_OBSTACLE)
    xmaj = dx > dy
    derrorv = torch.where(xmaj, (xp - x2).abs(), (yp - y2).abs())
    dx, dxc, dyc = (torch.where(xmaj, dx, dy), torch.where(xmaj, dxc, dyc),
                    torch.where(xmaj, dyc, dxc))
    incx, incy = torch.where(xmaj, incx, incy), torch.where(xmaj, incy, incx)
    drawn = ok1 & ok2 & (derrorv != 0)
    derrorv = derrorv.clamp(min=1)

    steps = int(torch.where(drawn, dxc, -1).max()) + 1
    k = torch.arange(max(steps, 1), device=dev)
    # the walk: the pixel drawn at step k
    ptr = (y1 * size + x1).long()
    error, horiz, diago = 2 * dyc - dxc, 2 * dyc, 2 * (dyc - dxc)
    cols = []
    for _ in range(steps):
        cols.append(ptr)
        up = error > 0
        ptr = ptr + torch.where(up, incy, 0) + incx
        error = error + torch.where(up, diago, horiz)
    pixel = torch.stack(cols, 1) if cols else \
        torch.zeros((b, 1), dtype=torch.long, device=dev)

    # the V profile, from the first step past dx - 2 derrorv
    vn = TS_OBSTACLE - TS_NO_OBSTACLE
    incv = cdiv(torch.full_like(derrorv, vn), derrorv)
    incerrorv = vn - derrorv * incv
    errorv = derrorv // 2
    first = (dx - 2 * derrorv + 1).clamp(min=0)
    ramp = int(torch.where(drawn, dxc - first + 1, 0).max().clamp(min=0))
    pixval = torch.full((b,), TS_NO_OBSTACLE, dtype=torch.int32, device=dev)
    vals = []
    for j in range(ramp):
        x = first + j
        down = x <= dx - derrorv
        sg = down.to(torch.int32) * 2 - 1
        pixval = pixval + sg * incv
        errorv = errorv + sg * incerrorv
        fix = ((down & (errorv > derrorv)).to(torch.int32)
               - (~down & (errorv < 0)).to(torch.int32))
        pixval = pixval + fix * sincv
        errorv = errorv - fix * derrorv
        vals.append(pixval)
    value = torch.full((b, k.numel()), TS_NO_OBSTACLE, dtype=torch.int32,
                       device=dev)
    if vals:
        v = torch.stack(vals, 1)
        j = (k[None, :] - first[:, None]).clamp(0, ramp - 1)
        value = torch.where(k[None, :] >= first[:, None], v.gather(1, j),
                            value)
    return pixel, value, drawn[:, None] & (k[None, :] <= dxc[:, None])


def pose_pixels(pose, size: int, scale: float):
    """The pose in map pixels: (px, py, c, s, x1, y1, robot in the map)."""
    px = pose[0] * scale + 0.5
    py = pose[1] * scale + 0.5
    x1, y1 = trunc(px), trunc(py)
    inside = bool((x1 >= 0) & (x1 < size) & (y1 >= 0) & (y1 < size))
    return (px, py, cos_rn(pose[2]) * scale, sin_rn(pose[2]) * scale, x1, y1,
            inside)


def _cpu(*ts):
    return [t.cpu() for t in ts]


def hole_rays(cfg: RefConfig, points, valid, pose):
    """UpdateHoleMap's rays (:496-534) walked, on the CPU: (pixel, value,
    drawn), or None where the robot is outside the map."""
    size, scale = cfg.hole_map_size, cfg.hole_scale
    px, py, c, s, x1, y1, inside = pose_pixels(pose, size, scale)
    if not inside:
        return None
    x2p = c * points[:, 0] - s * points[:, 1]
    y2p = s * points[:, 0] + c * points[:, 1]
    xp, yp = trunc(px + x2p), trunc(py + y2p)
    dist = sqrt_rn(x2p * x2p + y2p * y2p)
    half = torch.full((), cfg.hole_width * scale / 2.0, dtype=torch.float32,
                      device=dist.device)
    add = half / dist.clamp(min=1e-6)
    x2 = trunc(px + x2p * (1.0 + add))
    y2 = trunc(py + y2p * (1.0 + add))
    pixel, value, drawn = hole_walk(size, *_cpu(x1, y1, x2, y2, xp, yp))
    return pixel, value, drawn & (valid & (dist > 1e-6)).cpu()[:, None]


def composed_blend(hole, rays, quality: int):
    """Every visit of the scan blended at once: ``floor(beta^k (p - v_bar)
    + v_bar)`` for a pixel visited k times (the departure above)."""
    pixel, value, drawn = (t.to(hole.device) for t in rays)
    idx = torch.where(drawn, pixel, 0).reshape(-1)
    k = torch.zeros_like(hole).index_add_(0, idx,
                                          drawn.reshape(-1).to(torch.int32))
    vsum = torch.zeros_like(hole).index_add_(
        0, idx, torch.where(drawn, value, 0).reshape(-1))
    vbar = vsum.to(torch.float32) / k.clamp(min=1).to(torch.float32)
    beta = torch.full((), (256.0 - quality) / 256.0, dtype=torch.float64,
                      device=hole.device)
    decay = torch.pow(beta, k.to(torch.float64)).to(torch.float32)
    new = torch.floor(decay * (hole.to(torch.float32) - vbar) + vbar)
    return torch.where(k > 0, new.to(torch.int32), hole)


def sequential_blend(hole: np.ndarray, rays, quality: int) -> np.ndarray:
    """slam.net's blend (:431): ``p = ((256 - q) p + q v) >> 8`` for each
    visit, beam by beam in order (int64; a beam visits distinct pixels)."""
    pixel, value, drawn = (t.numpy() for t in rays)
    out = hole.copy()
    for b in range(pixel.shape[0]):
        idx = pixel[b][drawn[b]]
        out[idx] = ((256 - quality) * out[idx]
                    + quality * value[b][drawn[b]].astype(np.int64)) >> 8
    return out


# ---------------------------------------------------------- obstacle map
def obstacle_walk(size: int, x1, y1, x2, y2, valid):
    """DrawLaserRayOnObstacleMap (:456-490) of every beam: (cells passed
    i64[B, K] with their mask, the endpoint i64[B], reached bool[B])."""
    dx, sx = (x2 - x1).abs(), (x2 - x1).sign()
    dy, sy = (y2 - y1).abs(), (y2 - y1).sign()
    err = cdiv(torch.where(dx > dy, dx, -dy), 2)
    x = torch.zeros_like(x2) + x1
    y = torch.zeros_like(y2) + y1
    alive, reached = valid.clone(), torch.zeros_like(valid)
    cells, marks = [], []
    for _ in range(int(torch.maximum(dx, dy).max()) + 1):
        alive = alive & (x >= 0) & (x < size) & (y >= 0) & (y < size)
        end = alive & (x == x2) & (y == y2)
        reached = reached | end
        alive = alive & ~end
        cells.append((y * size + x).long())
        marks.append(alive)
        e2 = err
        mx, my = e2 > -dx, e2 < dy
        err = err - torch.where(mx, dy, 0) + torch.where(my, dx, 0)
        x = x + torch.where(mx, sx, 0)
        y = y + torch.where(my, sy, 0)
    return (torch.stack(cells, 1), torch.stack(marks, 1),
            (y2 * size + x2).long(), reached)


def obstacle_update(obstacle, cfg: RefConfig, points, valid, pose):
    """UpdateObstacleMap (:536-593): the hits, each capped at
    ``max_obstacle_hits``, then the traversed cells stepped toward 0."""
    size = cfg.obstacle_map_size
    px, py, c, s, x1, y1, inside = pose_pixels(pose, size,
                                               cfg.obstacle_scale)
    if not inside:
        return obstacle
    x2 = trunc(px + c * points[:, 0] - s * points[:, 1])
    y2 = trunc(py + s * points[:, 0] + c * points[:, 1])
    cells, marks, end, reached = (t.to(obstacle.device) for t in obstacle_walk(
        size, *_cpu(x1, y1, x2, y2, valid)))
    flat = obstacle.reshape(-1).to(torch.int32)
    hits = torch.zeros_like(flat).index_add_(
        0, torch.where(reached, end, 0), reached.to(torch.int32))
    cap = cfg.max_obstacle_hits
    v = torch.where(flat < cap, torch.minimum(flat + hits,
                                              torch.full_like(flat, cap)),
                    flat)
    passed = torch.zeros_like(flat).index_add_(
        0, torch.where(marks, cells, 0).reshape(-1),
        marks.reshape(-1).to(torch.int32)) > 0
    v = v - (passed & (v > 0)).to(torch.int32) \
        + (passed & (v < 0)).to(torch.int32)
    return v.to(torch.int8).view(obstacle.shape)


# ------------------------------------------------------------------ step
def step(st: State, angles, radii, valid, cfg: RefConfig,
         cdt=torch.float32):
    """One scan of one segment (the revolution's rays f32[N] tagged with
    the reference's own pose, as the simulator tags them): (state, best
    in-map sum i64[], 0 where the scan is not searched)."""
    points, valid = deskew(angles[None], radii[None], valid[None],
                           st.pose[None])
    odo = st.pose
    if st.scans >= cfg.position_search_beginning:
        best, total = search(st.hole, cfg, points, valid,
                             st.pose + (odo - st.last_odo), st.gen, cdt)
        scans = st.scans
    else:
        best = odo
        total = torch.zeros((), dtype=torch.int64, device=odo.device)
        scans = st.scans + 1
    pose = torch.stack([best[0], best[1], normalize_angle(best[2])])
    rays = hole_rays(cfg, points, valid, pose)
    hole, seq = st.hole, st.seq_hole
    if rays is not None:
        hole = composed_blend(hole, rays, cfg.quality)
        if seq is not None:
            seq = sequential_blend(seq, rays, cfg.quality)
    obstacle = obstacle_update(st.obstacle, cfg, points, valid, pose)
    return State(hole, obstacle, pose, odo, scans, st.gen, seq), total


def replay(cfg: RefConfig, angles, radii, valid, start_pose, seed: int,
           n: int, snapshots=(), cdt=torch.float32, sequential=False):
    """One job of ``n`` scans from a fresh state at ``start_pose``:
    (poses f32[n, 3], best sums i64[n], {t: (hole, obstacle) after t
    scans} for t in ``snapshots``, the final state)."""
    st = init(cfg, start_pose, seed, radii.device, sequential)
    poses, sums, snaps = [], [], {}
    for t in range(n):
        st, total = step(st, angles, radii[t], valid[t], cfg, cdt)
        poses.append(st.pose)
        sums.append(total)
        if t + 1 in snapshots:
            snaps[t + 1] = (st.hole, st.obstacle)
    return torch.stack(poses), torch.stack(sums), snaps, st
