"""The plain reference of the particle layer: BASELINE.json's config 4
(8k particles scored on CoreSLAM's hole map, a top-k refine) in plain
PyTorch.

Follows the semantics that ``slamnet_tpu/models/particle.py:123-244``
documents (read, not imported), scan by scan, with the odometry pose
``odo`` the layer's own estimate as the simulator feeds it:

1. propagate: every particle moves by ``odo - last odometry`` plus
   N(0, sigma_xy) in x and y and N(0, sigma_theta) in the heading;
   particle 0 carries the unperturbed prior ``pose + delta``;
2. score: each pose's in-map pixel sum over the scan's valid points
   (``reference_coreslam.scores``: CalculateDistanceSISD's snap, int-max
   where no point is in the map);
3. rank: the ``top_k`` lowest sums, lowest first, the lower index first
   among equal sums (a stable sort);
4. refine: each survivor and ``refine_candidates - 1`` perturbations of
   it, N(0, 0.3 sigma), scored again; each survivor keeps its first
   minimum, and the estimate is the first minimum over the survivors, its
   heading normalised; the refined survivors and their sums go back into
   the population;
5. resample: weights softmax(-sum / T), T = 2000 x the valid beams, and
   the effective sample size 1 / sum(w^2); below ``resample_ess_frac`` x
   P, systematic resampling with offsets (u + i) / P, each taking the
   first particle whose CDF reaches it;
6. during the first ``position_search_beginning`` scans the estimate is
   the odometry pose and the population collapses onto it; both maps
   update at the estimate (``reference_coreslam``'s hole walk, composed
   blend and obstacle update).

The draws come from this module's own ``torch.Generator``, seeded as the
program's, in one order a scan: the propagation's xy normals f32[P, 2],
its heading normals f32[P, 1], the refine's xy normals f32[k, r, 2], its
heading normals f32[k, r, 1], one uniform f32[].

Departures from a straightforward float32 sum, each written where the
JAX package's result is not unique: the CDF is exact, each weight in
units of 2^-52 (the weight times 2^52 rounded to an integer, exact for
every weight above 2^-29) summed in int64, where XLA's float32
cumulative sum rounds in its own order; a uniform compared with it in
the same units (rounded up).  The softmax's sum and the ESS's are
``torch.sum``'s float32 reductions.  Divisions by a configuration's
number are true divisions of two tensors, and TF32 is off.  ``cdt`` is
the floating type of the candidate transform: float32 as the
configuration states it, or bfloat16 for the control, which has to come
out as not correct.  This module imports nothing of the program and takes
nothing the program made.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import reference_coreslam as C

UNIT = 2.0 ** 52        # the CDF's fixed-point unit


class PConfig:
    """The fields of a configuration's ``"particle"`` group the reference
    reads; every one must be given.  Only the ``exact`` scorer on every
    beam is known."""

    FIELDS = ("num_particles", "top_k", "refine_candidates",
              "resample_ess_frac", "scorer", "score_subsample",
              "refine_subsample")

    def __init__(self, d: dict):
        for k in self.FIELDS:
            setattr(self, k, d[k])
        if self.scorer != "exact" or self.score_subsample != 1 \
                or self.refine_subsample != 1:
            raise ValueError("the reference scores every pose exactly on "
                             "every beam only")


class State(NamedTuple):
    particles: torch.Tensor    # f32[P, 3]
    sums: torch.Tensor         # i64[P] the last scan's sums
    hole: torch.Tensor         # i32[S*S]
    obstacle: torch.Tensor     # i8[OS, OS]
    pose: torch.Tensor         # f32[3] the estimate
    last_odo: torch.Tensor     # f32[3]
    scans: int                 # warm-up scans taken so far
    gen: torch.Generator       # the draws


class Info(NamedTuple):
    best_sum: torch.Tensor     # i64[] the estimate's sum
    ess: torch.Tensor          # f32[] the effective sample size
    resampled: torch.Tensor    # bool[]


def init(cfg: C.RefConfig, pcfg: PConfig, start_pose: torch.Tensor,
         seed: int, device) -> State:
    """Every particle at ``start_pose``, sums 0, the maps as CoreSLAM's
    Reset leaves them; a generator on ``device`` seeded with ``seed``."""
    c = C.init(cfg, start_pose, seed, device)      # sets TF32 off
    p = pcfg.num_particles
    return State(c.pose[None].repeat(p, 1),
                 torch.zeros(p, dtype=torch.int64, device=device), c.hole,
                 c.obstacle, c.pose, c.last_odo, 0, c.gen)


def first_min(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The index of the first minimum along ``dim``."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device).reshape(
        [-1 if d == dim % x.dim() else 1 for d in range(x.dim())])
    low = x == x.amin(dim=dim, keepdim=True)
    return torch.where(low, idx, n).amin(dim=dim)


def sums_of(hole, cfg: C.RefConfig, points, valid, poses, cdt):
    """In-map pixel sums i64[B] of poses f32[B, 3], int-max off the map."""
    return C.scores(hole, cfg, points, valid, poses, cdt)[1]


def resample(particles, sums, valid, u0, frac: float):
    """(particles, sums, ess, resampled): systematic resampling from
    softmax(-sum / T) when the ESS falls below ``frac`` x P."""
    p, dev = sums.shape[0], sums.device
    t = 2000.0 * valid.sum().clamp(min=1).to(torch.float32)
    logw = torch.div(-sums.to(torch.float32), t)
    e = torch.exp(logw - logw.max())
    w = torch.div(e, e.sum())
    ess = torch.div(torch.ones((), device=dev), (w * w).sum())
    resampled = ess < frac * p
    u = torch.div(u0 + torch.arange(p, device=dev, dtype=torch.float32),
                  torch.full((), float(p), device=dev))
    cdf = torch.cumsum(torch.round(w.double() * UNIT).long(), dim=0)
    uq = torch.ceil(u.double() * UNIT).long()
    idx = (cdf[None, :] < uq[:, None]).sum(dim=1).clamp(max=p - 1)
    return (torch.where(resampled, particles[idx], particles),
            torch.where(resampled, sums[idx], sums), ess, resampled)


def step(st: State, points, valid, cfg: C.RefConfig, pcfg: PConfig,
         cdt=torch.float32):
    """One scan of the log's points f32[N, 2] and flags bool[N], the
    estimate fed back as the odometry: (state, Info)."""
    dev, g = st.pose.device, st.gen
    p, k, r = pcfg.num_particles, pcfg.top_k, pcfg.refine_candidates
    prop_xy = torch.randn((p, 2), generator=g, device=dev)
    prop_th = torch.randn((p, 1), generator=g, device=dev)
    ref_xy = torch.randn((k, r, 2), generator=g, device=dev)
    ref_th = torch.randn((k, r, 1), generator=g, device=dev)
    u0 = torch.rand((), generator=g, device=dev)
    odo = st.pose

    # 1. propagate
    delta = odo - st.last_odo
    prop = st.particles + delta[None, :] + torch.cat(
        [prop_xy * cfg.sigma_xy, prop_th * cfg.sigma_theta], dim=1)
    prop[0] = st.pose + delta

    # 2. score, 3. rank
    sums = sums_of(st.hole, cfg, points, valid, prop, cdt)
    top = torch.sort(sums, stable=True).indices[:k]

    # 4. refine and estimate
    local = torch.cat([ref_xy * (cfg.sigma_xy * 0.3),
                       ref_th * (cfg.sigma_theta * 0.3)], dim=-1)
    local[:, 0] = 0.0
    cands = prop[top][:, None, :] + local                     # [k, r, 3]
    rsums = sums_of(st.hole, cfg, points, valid, cands.reshape(k * r, 3),
                    cdt).reshape(k, r)
    each = first_min(rsums, dim=1)
    refined = cands[torch.arange(k, device=dev), each]
    refined_sums = rsums[torch.arange(k, device=dev), each]
    b = first_min(refined_sums)
    best = refined[b]
    best_pose = torch.stack([best[0], best[1], C.normalize_angle(best[2])])
    particles = prop.clone()
    particles[top] = refined
    sums = sums.clone()
    sums[top] = refined_sums

    # 5. resample
    particles, sums, ess, resampled = resample(
        particles, sums, valid, u0, pcfg.resample_ess_frac)

    # 6. the warm-up, then both maps at the estimate
    warm = st.scans >= cfg.position_search_beginning
    est = best_pose if warm else odo
    if not warm:
        particles = est[None].repeat(p, 1)
    rays = C.hole_rays(cfg, points, valid, est)
    hole = st.hole if rays is None else \
        C.composed_blend(st.hole, rays, cfg.quality)
    obstacle = C.obstacle_update(st.obstacle, cfg, points, valid, est)
    return (State(particles, sums, hole, obstacle, est, odo,
                  st.scans if warm else st.scans + 1, st.gen),
            Info(refined_sums[b], ess, resampled))


def replay(cfg: C.RefConfig, pcfg: PConfig, points, valid, start_pose,
           seed: int, n: int, snapshots=(), cdt=torch.float32):
    """One job of ``n`` scans of points f32[T, N, 2] and flags bool[T, N]
    from a fresh state at ``start_pose``: (estimates f32[n, 3], best sums
    i64[n], ESS f32[n], resampled bool[n], {t: (population, hole,
    obstacle) after t scans} for t in ``snapshots``, the final state)."""
    st = init(cfg, pcfg, start_pose, seed, points.device)
    poses, best, ess, flags, snaps = [], [], [], [], {}
    for t in range(n):
        st, info = step(st, points[t], valid[t], cfg, pcfg, cdt)
        poses.append(st.pose)
        best.append(info.best_sum)
        ess.append(info.ess)
        flags.append(info.resampled)
        if t + 1 in snapshots:
            snaps[t + 1] = (st.particles, st.hole, st.obstacle)
    return (torch.stack(poses), torch.stack(best), torch.stack(ess),
            torch.stack(flags), snaps, st)
