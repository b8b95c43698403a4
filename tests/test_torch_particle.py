"""The particle layer: slamnet_tpu_torch.models.particle against the JAX
package.

A short loop log (the port's noise-free ray cast plus uniform noise drawn
with numpy from a seed) at JAX's own test size (``tests/test_particle.py``:
512 particles, top 16, 16 refine candidates).  JAX's ``particle.update``
runs outside jit (inside it XLA fuses FMAs and divides by constants through
reciprocals) from ``PRNGKey(3)``; before each of its steps the JAX state is
carried into the port (``convert.particle_state_from_numpy``) and the port's
``step`` is fed JAX's own draws, made here with the same key splits as
``particle.py:123, 128-129, 157-159, 205``.  Then, each step:

* scores, both maps, ``best_sum`` and ``resampled`` equal JAX's exactly, and
  the particles and the pose to f32 rounding (2e-6 m at these 20 m
  coordinates: one ulp), except where a resampled index differs: the
  softmax's sum and the CDF's cumulative sum run in another order than
  XLA's, so a uniform within an ulp of a CDF step may pick the neighbouring
  particle; at most 2 particles (and their scores) a step may differ so;
* the effective sample size to rtol 1e-5 (the same sum-order difference).

The five bench modes (``bench.py:772-788``) at the test size, during the
warm-up (steps 0-4) and after it, and one with a low ESS threshold so that
steps after the warm-up do not resample.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import CoreSlamConfig as JCoreSlamConfig
from slamnet_tpu.core import ParticleConfig as JParticleConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.models import particle as jparticle
from slamnet_tpu_torch import convert, replay
from slamnet_tpu_torch.core.config import CoreSlamConfig, ParticleConfig
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import particle
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim.field import ray_cast
from slamnet_tpu_torch.sim.trajectory import loop_trajectory

T, N = 8, 400
SIZE = dict(num_particles=512, top_k=16, refine_candidates=16)
POSE_ATOL = 2e-6
MAX_FLIPS = 2


def _modes():
    """bench.py's particle modes at the test size, and exact with a low
    resampling threshold."""
    base = ParticleConfig(**SIZE)
    modes = {}
    for name, (ccfg, pcfg) in replay.PARTICLE_MODES.items():
        over = {k: getattr(pcfg, k) for k in ("scorer", "score_subsample",
                                               "refine_subsample")}
        if name == "grid_small":      # bench's smaller refine pool, scaled
            over.update(top_k=8, refine_candidates=8)
        modes[name] = (ccfg, base.overlay(over))
    modes["exact_no_resample"] = (CoreSlamConfig(),
                                  base.overlay({"resample_ess_frac": 0.02}))
    return modes


@pytest.fixture(scope="module")
def plog():
    """T scans along the loop: true poses f32[T, 3], clouds f32[T, N, 2] and
    valid bool[T, N] (numpy seed 0)."""
    traj = loop_trajectory(speed=0.3)[:T].astype(np.float32)
    angles = revolution_angles(N)
    hit, dist = ray_cast(default_field(), torch.from_numpy(traj[:, :2]),
                         torch.from_numpy(angles[None] + traj[:, 2:3]), 40.0)
    rng = np.random.default_rng(0)
    hit = hit.numpy()
    r = np.where(hit, dist.numpy()
                 + rng.integers(-100, 100, hit.shape) / 100.0 * 0.02, 0.0)
    pts = np.stack([r * np.cos(angles), r * np.sin(angles)], -1)
    return traj, pts.astype(np.float32), hit


def jax_draws(key, pcfg) -> particle.ParticleNoise:
    """JAX's draws of the step that holds ``key`` (particle.py:123-205)."""
    _, k_prop, k_ref, k_res = jax.random.split(key, 4)
    p, k, r = pcfg.num_particles, pcfg.top_k, pcfg.refine_candidates

    def t(a):
        return torch.from_numpy(np.array(a))
    return particle.ParticleNoise(
        prop_xy=t(jax.random.normal(k_prop, (p, 2))),
        prop_th=t(jax.random.normal(jax.random.fold_in(k_prop, 1), (p, 1))),
        refine_xy=t(jax.random.normal(k_ref, (k, r, 2))),
        refine_th=t(jax.random.normal(jax.random.fold_in(k_ref, 1),
                                      (k, r, 1))),
        resample_u=t(jax.random.uniform(k_res)))


def _jax_cfgs(ccfg, pcfg):
    return (JCoreSlamConfig(**dataclasses.asdict(ccfg)),
            JParticleConfig(**dataclasses.asdict(pcfg)))


@pytest.mark.parametrize("mode", sorted(_modes()))
def test_step_matches_jax_update(plog, mode):
    traj, pts, v = plog
    ccfg, pcfg = _modes()[mode]
    jc, jp = _jax_cfgs(ccfg, pcfg)
    jst = jparticle.init(jc, jp, traj[0], key=jax.random.PRNGKey(3))
    resampled = []
    for t in range(T):
        arrays = {k: np.asarray(getattr(jst, k))
                  for k in convert.PARTICLE_FIELDS}
        st = convert.particle_state_from_numpy(**arrays, device="cpu")
        noise = jax_draws(jst.key, pcfg)
        jst, jinfo = jparticle.update(
            jst, JScan(jnp.asarray(pts[t]), jnp.asarray(v[t]),
                       jnp.zeros(3, jnp.float32)), jst.pose, jc, jp)
        st, info = particle.step(st, Scan.from_points(pts[t], v[t]), st.pose,
                                 noise, ccfg, pcfg)
        assert st.scans == int(jst.scan_count), t
        got = convert.particle_state_to_numpy(st)
        for k in ("hole_map", "obstacle_map", "scan_count"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(jst, k)),
                                          err_msg=f"{k}, step {t}")
        for k in ("pose", "last_odometry"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)),
                                       atol=POSE_ATOL, rtol=0,
                                       err_msg=f"{k}, step {t}")
        assert int(info.best_sum) == int(jinfo.best_sum), t
        assert bool(info.resampled) == bool(jinfo.resampled), t
        np.testing.assert_allclose(float(info.ess), float(jinfo.ess),
                                   rtol=1e-5, err_msg=f"step {t}")
        # particles and scores: exact but for resampled-index flips
        jparts = np.asarray(jst.particles)
        flip = np.abs(got["particles"] - jparts).max(axis=1) > POSE_ATOL
        assert flip.sum() <= (MAX_FLIPS if bool(jinfo.resampled) else 0), \
            (t, np.where(flip)[0])
        np.testing.assert_array_equal(got["scores"][~flip],
                                      np.asarray(jst.scores)[~flip],
                                      err_msg=f"scores, step {t}")
        resampled.append(bool(jinfo.resampled))
    warm = ccfg.position_search_beginning
    if mode == "exact_no_resample":
        assert not any(resampled[warm:])
    else:
        assert any(resampled[warm:])
    assert not resampled[0]


def test_top_k_is_jax_top_k_with_ties():
    # lax.top_k returns the lower index first among equal values; equal
    # integer sums and off-map int-max scores tie often
    rng = np.random.default_rng(1)
    eff = rng.integers(0, 6, 512).astype(np.int32) * 1000
    eff[rng.random(512) < 0.3] = particle.INT32_MAX
    for k in (1, 16, 64, 400):
        want = np.asarray(jax.lax.top_k(-jnp.asarray(eff), k)[1])
        got = particle.top_k_indices(torch.from_numpy(eff), k).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")
    # all off the map: the first k indices, in order
    allmax = np.full(64, particle.INT32_MAX, np.int32)
    np.testing.assert_array_equal(
        particle.top_k_indices(torch.from_numpy(allmax), 16).numpy(),
        np.arange(16))


def test_update_is_step_of_draw(plog):
    # update = step . draw: the same seed gives the same draws and states;
    # the draws are standard (unscaled) and on the state's device
    traj, pts, v = plog
    ccfg, pcfg = _modes()["grid"]
    a = particle.init(ccfg, pcfg, traj[0], seed=5, device="cpu")
    b = particle.init(ccfg, pcfg, traj[0], seed=5, device="cpu")
    noise = particle.draw(b, ccfg, pcfg)
    assert noise.prop_xy.shape == (pcfg.num_particles, 2)
    assert noise.refine_th.shape == (pcfg.top_k, pcfg.refine_candidates, 1)
    assert 0.0 <= float(noise.resample_u) < 1.0
    assert abs(float(noise.prop_xy.std()) - 1.0) < 0.1
    scan = Scan.from_points(pts[0], v[0])
    a1, ia = particle.update(a, scan, a.pose, ccfg, pcfg)
    b1, ib = particle.step(b, scan, b.pose, noise, ccfg, pcfg)
    for k in convert.PARTICLE_FIELDS:
        assert torch.equal(getattr(a1, k), getattr(b1, k)), k
    assert a1.scans == b1.scans == 1
    assert torch.equal(ia.ess, ib.ess)


def test_particle_convert_round_trip(plog):
    traj = plog[0]
    ccfg, pcfg = _modes()["exact"]
    jst = jparticle.init(*_jax_cfgs(ccfg, pcfg), traj[2],
                         key=jax.random.PRNGKey(0))
    arrays = {k: np.asarray(getattr(jst, k)) for k in convert.PARTICLE_FIELDS}
    st = convert.particle_state_from_numpy(**arrays, seed=4, device="cpu")
    back = convert.particle_state_to_numpy(st)
    for k in convert.PARTICLE_FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
        assert back[k].dtype == arrays[k].dtype, k
    assert st.scans == 0 and st.hole_map.dim() == 1
    with pytest.raises(ValueError, match="particles must be"):
        convert.particle_state_from_numpy(**{**arrays,
                                             "scores": arrays["scores"][1:]},
                                          device="cpu")


def test_particle_replay_flow(plog):
    # the bench's flow on the short log: the state's own pose as the
    # odometry, every output on the device, the gate over the replays
    traj, pts, v = plog
    dlog = replay.DeviceLog(torch.from_numpy(pts), torch.from_numpy(v),
                            torch.from_numpy(traj))
    ccfg, pcfg = _modes()["grid_dense"]
    st, out = replay.particle_replay(dlog, ccfg, pcfg, seed=2)
    assert out.poses.shape == (T, 3) and out.resampled.shape == (T,)
    m = replay.particle_metrics(out, traj)
    assert m["ate_m"] < 0.3 and m["max_err_m"] < 0.5
    assert m["resamples"] == int(out.resampled.sum()) >= 1
    assert st.scans == ccfg.position_search_beginning
    _, again = replay.particle_replay(dlog, ccfg, pcfg, seed=2)
    assert torch.equal(again.poses, out.poses)
    # the gate: JAX's own nine pass it; a median above JAX's worst fails,
    # and so does grid_dense above exact + 0.02 (bench.py:810)
    ref_e = replay.PARTICLE_JAX_REF_ATES_M
    ref_g = replay.PARTICLE_GRID_DENSE_JAX_REF_ATES_M
    assert replay.particle_gate(ref_e, ref_g) == []
    assert len(replay.particle_gate([max(ref_e) + 0.1] * 9, ref_g)) == 1
    assert len(replay.particle_gate([0.05] * 9, [0.1] * 9)) == 1
