"""The particle layer: a population of P pose hypotheses scored against
CoreSLAM's hole map every scan.

Port of ``slamnet_tpu/models/particle.py`` (BASELINE config 4: 8192
particles, one fused score of the population, a top-k refine).  A step:

  1. propagate: every particle moves by the odometry delta plus motion
     noise; particle 0 carries the unperturbed prior;
  2. score: the population in one batch, ``exact`` (the [P, N] gather of
     ``ops/score.py``, optionally on every ``score_subsample``-th beam) or
     ``grid`` (one correlative grid around the prior, ``ops/correlate.py``,
     and a [P] cell lookup; the grid's sub-pixel argmin joins the refine);
  3. refine: the top-k particles each spawn R local perturbations, scored
     in a second batch; each survivor keeps its best;
  4. estimate: the best refined survivor;
  5. resample: systematic resampling from softmax(-score / T) when the
     effective sample size falls below ``resample_ess_frac`` x P;
  6. map: both CoreSLAM maps updated at the estimate (during the warm-up,
     at the odometry pose, and the population collapses onto it).

Three of JAX's constructs change form:

- JAX splits a PRNG key each step (``particle.py:123``).  Here a step is
  ``draw`` (the raw standard normals and uniform of a ``ParticleNoise``,
  from the state's seeded ``torch.Generator``) and the deterministic
  ``step``, which scales them in JAX's order; ``update = step . draw``.
  The tests feed ``step`` JAX's own draws.
- JAX's warm-up reads ``scan_count`` (``:214``); here it is the host's count
  ``ParticleState.scans``, as in the port's CoreSLAM, so no step reads the
  device.  ``do_resample`` stays a device bool inside ``torch.where``, and a
  pick by a device index is a 1-element ``index_select`` (``x[argmin]``
  with a 0-dim CUDA index reads it to the host).
- ``jax.lax.top_k`` returns the lower index first among equal scores; here
  the rank is a top-k of the unique int64 keys ``score << 32 | index``, so
  ties (off-map int-max, equal integer sums) break the same way on any
  device.

Divisions by a Python number go through ``geometry.true_div`` (CUDA's
``tensor / number`` multiplies by the reciprocal).  The softmax is JAX's
expression, ``exp(x - max) / sum``, its sum in another order than XLA's;
the CDF is exact (fixed point, ``resample``) where JAX's cumulative sum
rounds in f32, so a resampled index can differ where the uniform lies
within an ulp of a CDF step.

No hand kernel runs here: the JAX package computes the particle layer in
XLA, and no function it calls reaches ``pl.pallas_call``.  The entry point
(``init``) puts the state on the card unless the caller names another
device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.config import CoreSlamConfig, ParticleConfig
from ..core.geometry import normalize_angle, true_div
from ..core.scan import Scan
from ..ops import correlate, score
from . import coreslam

INT32_MAX = score.INT32_MAX
_UNIT = 2.0 ** 52          # the resampling CDF's fixed-point unit, 2^-52


class ParticleState(NamedTuple):
    particles: torch.Tensor        # f32[P, 3]
    scores: torch.Tensor           # i32[P] last scan's sums (lower = better)
    hole_map: torch.Tensor         # i32[S*S]
    obstacle_map: torch.Tensor     # i8[OS, OS]
    pose: torch.Tensor             # f32[3] current best estimate
    last_odometry: torch.Tensor    # f32[3]
    scan_count: torch.Tensor       # i32[] warm-up scans counted so far
    generator: torch.Generator     # the step's draws
    scans: int                     # the host's copy of scan_count


class ParticleInfo(NamedTuple):
    best_sum: torch.Tensor         # i32
    ess: torch.Tensor              # f32 effective sample size
    resampled: torch.Tensor        # bool


class ParticleNoise(NamedTuple):
    """A step's raw draws, unscaled (``particle.py:128-129, 157-159, 205``)."""
    prop_xy: torch.Tensor          # f32[P, 2] standard normals
    prop_th: torch.Tensor          # f32[P, 1] standard normals
    refine_xy: torch.Tensor        # f32[k, r, 2] standard normals
    refine_th: torch.Tensor        # f32[k, r, 1] standard normals
    resample_u: torch.Tensor       # f32[] uniform in [0, 1)


def init(ccfg: CoreSlamConfig, pcfg: ParticleConfig, start_pose,
         seed: int = 0, device: torch.device | str = "cuda",
         generator: torch.Generator | None = None) -> ParticleState:
    """Every particle at ``start_pose``, scores 0, the hole map at
    HOLE_INIT and the obstacle map at ``unmapped_obstacle_hits``
    (``particle.py:66-81``); a generator on ``device`` seeded with ``seed``
    unless one is given."""
    c = coreslam.init(ccfg, start_pose, seed, device, generator)
    p = pcfg.num_particles
    return ParticleState(
        particles=c.pose[None].repeat(p, 1),
        scores=torch.zeros(p, dtype=torch.int32, device=device),
        hole_map=c.hole_map, obstacle_map=c.obstacle_map, pose=c.pose,
        last_odometry=c.last_odometry, scan_count=c.scan_count,
        generator=c.generator, scans=0)


def draw(state: ParticleState, ccfg: CoreSlamConfig,
         pcfg: ParticleConfig) -> ParticleNoise:
    """A step's draws from ``state.generator``, on the state's device."""
    dev = state.pose.device
    g = state.generator
    p, k, r = pcfg.num_particles, pcfg.top_k, pcfg.refine_candidates
    return ParticleNoise(
        prop_xy=torch.randn((p, 2), generator=g, device=dev),
        prop_th=torch.randn((p, 1), generator=g, device=dev),
        refine_xy=torch.randn((k, r, 2), generator=g, device=dev),
        refine_th=torch.randn((k, r, 1), generator=g, device=dev),
        resample_u=torch.rand((), generator=g, device=dev))


def _score(state: ParticleState, cfg: CoreSlamConfig, points: torch.Tensor,
           valid: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Effective sums i32[B]: int-max where no point is in bounds."""
    sums, nb = score.score_candidates(state.hole_map, cfg.hole_map_size,
                                      cfg.hole_scale, points, valid, poses)
    return torch.where(nb > 0, sums, torch.full_like(sums, INT32_MAX))


def _grid_score(state: ParticleState, ccfg: CoreSlamConfig, cloud: Scan,
                search: torch.Tensor, poses: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The population scored off one correlative grid around ``search``
    (``particle.py:88-120``): each particle reads its nearest (heading bin,
    pixel shift) cell, int-max outside the grid.  Returns (eff i32[P], the
    grid's sub-pixel argmin pose f32[3], its sum i32[])."""
    span = ccfg.corr_theta_span or 3.0 * ccfg.sigma_theta
    K, W = ccfg.corr_num_theta, ccfg.corr_window
    R = W // 2
    scale = ccfg.hole_scale
    thetas = correlate.theta_grid(search[2], K, span)
    sums, nb = correlate.correlative_scores(
        state.hole_map, ccfg.hole_map_size, scale, cloud.points, cloud.valid,
        search, thetas, W)
    grid = torch.where(nb > 0, sums, torch.full_like(sums, INT32_MAX))
    grid_pose, grid_sum = correlate.refine_from_scores(grid, search, scale, W,
                                                       K, span)
    dth = 2.0 * span / max(K - 1, 1)
    k = torch.round(true_div(normalize_angle(poses[:, 2] - search[2]), dth)
                    + (K - 1) / 2.0).to(torch.int32)
    ix = torch.round((poses[:, 0] - search[0]) * scale).to(torch.int32) + R
    iy = torch.round((poses[:, 1] - search[1]) * scale).to(torch.int32) + R
    inside = (k >= 0) & (k < K) & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < W)
    flat = (k.clamp(0, K - 1) * W + iy.clamp(0, W - 1)) * W \
        + ix.clamp(0, W - 1)
    eff = grid.reshape(-1).index_select(0, flat.long())
    return (torch.where(inside, eff, torch.full_like(eff, INT32_MAX)),
            grid_pose, grid_sum)


def top_k_indices(eff: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k(-eff, k)``'s indices i64[k]: the k lowest scores in
    ascending order, the lower index first among equal scores."""
    idx = torch.arange(eff.shape[0], device=eff.device)
    key = eff.to(torch.int64) * (1 << 32) + idx
    return torch.topk(key, k, largest=False, sorted=True).values & 0xFFFFFFFF


def resample(particles: torch.Tensor, eff: torch.Tensor, valid: torch.Tensor,
             u0: torch.Tensor, ess_frac: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Systematic resampling from softmax(-eff / T), T = 2000 x the valid
    beams, when the effective sample size falls below ``ess_frac`` x P
    (``particle.py:196-211``); ``u0`` is the raw uniform.  Returns
    (particles, eff, ess, do_resample), all on the device."""
    p = eff.shape[0]
    valid_n = valid.sum(dtype=torch.int32).clamp(min=1)
    t = 2000.0 * valid_n.to(torch.float32)
    logw = -eff.to(torch.float32) / t
    e = torch.exp(logw - logw.max())
    w = e / e.sum()
    ess = true_div(1.0, (w * w).sum())
    do_resample = ess < ess_frac * p
    u = true_div(u0 + torch.arange(p, device=eff.device), p)
    # the CDF in units of 2^-52 as int64: each f32 weight times 2^52 is
    # exact (rounded only below 2^-52), the integer sums are exact in any
    # order, and ceil(u 2^52) is the least unit count >= u, so
    # searchsorted's "first cdf >= u" is JAX's without the f32 sum's
    # roundings.  An f32 cumsum on CUDA (a decoupled look-back scan) rounds
    # differently from run to run and moved resampled indices.
    cdf = torch.cumsum(torch.round(w.double() * _UNIT).long(), dim=0)
    uq = torch.ceil(u.double() * _UNIT).long()
    idx = torch.searchsorted(cdf, uq).clamp(0, p - 1)
    return (torch.where(do_resample, particles.index_select(0, idx),
                        particles),
            torch.where(do_resample, eff.index_select(0, idx), eff), ess,
            do_resample)


def step(state: ParticleState, cloud: Scan, odometry_pose,
         noise: ParticleNoise, ccfg: CoreSlamConfig, pcfg: ParticleConfig
         ) -> Tuple[ParticleState, ParticleInfo]:
    """One scan with the given draws (``particle.update``'s semantics,
    ``slamnet_tpu/models/particle.py:123-244``).  Reads nothing from the
    device; the outputs stay on it."""
    dev = state.pose.device
    odo = torch.as_tensor(odometry_pose, dtype=torch.float32, device=dev)
    p, k, r = pcfg.num_particles, pcfg.top_k, pcfg.refine_candidates
    if pcfg.scorer not in ("exact", "grid"):
        raise ValueError(f"unknown particle scorer {pcfg.scorer!r}")

    # 1. propagate with the odometry delta prior (CoreSLAMProcessor.cs:728)
    delta = odo - state.last_odometry
    jitter = torch.cat([noise.prop_xy * ccfg.sigma_xy,
                        noise.prop_th * ccfg.sigma_theta], dim=1)
    prop = state.particles + delta[None, :] + jitter
    prop[0] = state.pose + delta

    # 2. score the whole population in one batch
    ss = max(1, pcfg.score_subsample)
    if pcfg.scorer == "grid":
        eff, grid_pose, _ = _grid_score(state, ccfg, cloud, state.pose + delta,
                                        prop)
    else:
        eff = _score(state, ccfg, cloud.points[::ss], cloud.valid[::ss], prop)

    # 3. top-k refine: k survivors x r local perturbations
    top_idx = top_k_indices(eff, k)
    survivors = prop.index_select(0, top_idx)
    if pcfg.scorer == "grid":
        survivors[k - 1] = grid_pose
    local = torch.cat([noise.refine_xy * (ccfg.sigma_xy * 0.3),
                       noise.refine_th * (ccfg.sigma_theta * 0.3)], dim=-1)
    local[:, 0] = 0.0
    refine_poses = (survivors[:, None, :] + local).reshape(k * r, 3)
    rs = max(1, pcfg.refine_subsample)
    ref_eff = _score(state, ccfg, cloud.points[::rs], cloud.valid[::rs],
                     refine_poses).reshape(k, r)
    best_r = torch.argmin(ref_eff, dim=1)
    pick = torch.arange(k, device=dev) * r + best_r
    refined = refine_poses.index_select(0, pick)                 # [k, 3]
    refined_eff = ref_eff.reshape(-1).index_select(0, pick)

    # 4. estimate = the best refined survivor (the first minimum)
    b = torch.argmin(refined_eff).reshape(1)
    best = refined.index_select(0, b)[0]
    best_pose = torch.cat([best[:2], normalize_angle(best[2:])])
    best_sum = refined_eff.index_select(0, b)[0]

    # refined survivors back into the population; sums scored on another
    # beam subset than the population's are rescaled by the valid-beam ratio
    particles = prop.index_copy(0, top_idx, refined)
    pop_full_beams = pcfg.scorer != "exact"
    if (rs != 1) if pop_full_beams else (ss != rs):
        nb_pop = (cloud.valid if pop_full_beams else cloud.valid[::ss]).sum(
            dtype=torch.int32).clamp(min=1)
        nb_ref = cloud.valid[::rs].sum(dtype=torch.int32).clamp(min=1)
        ratio = nb_pop.to(torch.float32) / nb_ref.to(torch.float32)
        # a finite sum is at most nb_ref x 65535, so scaled stays at most
        # nb_pop x 65535 < 2^31: JAX's clamp to int-max (:189) never binds
        scaled = torch.round(refined_eff.to(torch.float32) * ratio).to(
            torch.int32)
        eff = eff.index_copy(0, top_idx, torch.where(
            refined_eff == INT32_MAX, refined_eff, scaled))
    else:
        eff = eff.index_copy(0, top_idx, refined_eff)

    # 5. resample when the effective sample size collapses
    particles, eff, ess, do_resample = resample(
        particles, eff, cloud.valid, noise.resample_u, pcfg.resample_ess_frac)

    # 6. map updates at the estimate; during the warm-up trust the odometry
    #    (the coreslam PositionSearchBeginning contract) and collapse the
    #    population onto it
    warm = state.scans >= ccfg.position_search_beginning
    est = best_pose if warm else odo
    if not warm:
        particles = est[None].expand(p, 3).clone()
    hole, obst = coreslam.update_maps(state, cloud, est, ccfg)
    new_state = state._replace(
        particles=particles, scores=eff, hole_map=hole, obstacle_map=obst,
        pose=est, last_odometry=odo,
        scan_count=state.scan_count if warm else state.scan_count + 1,
        scans=state.scans if warm else state.scans + 1)
    return new_state, ParticleInfo(best_sum=best_sum, ess=ess,
                                   resampled=do_resample)


def update(state: ParticleState, cloud: Scan, odometry_pose,
           ccfg: CoreSlamConfig, pcfg: ParticleConfig
           ) -> Tuple[ParticleState, ParticleInfo]:
    """One scan: ``step`` with the draws of ``draw``."""
    return step(state, cloud, odometry_pose, draw(state, ccfg, pcfg), ccfg,
                pcfg)
