"""CoreSLAM's model: slamnet_tpu_torch's ``models/coreslam.py`` against the
JAX package's on the same scans (the port's loop log, numpy in between).

* The production mode (correlative search, dense fills), step by step at the
  bench's shapes (256-px hole map, 64-px obstacle map, 32 x 8 x 8 grid,
  400 beams): each of 20 steps from JAX's state (``convert`` both ways),
  JAX op by op, so both sides round each f32 operation once; the maps
  equal up to flipped snaps (at most 1 cell in 10^4; ``test_torch_coreslam_
  ops.py`` explains them) and the pose within 1e-5.  ``update`` (segments)
  likewise on de-skewed two-segment scans.
* The odometry warm-up (the first ``position_search_beginning`` scans adopt
  the odometry) in the parity mode: poses exact, both line updates as JAX's.
* The state through ``convert`` both ways, and the entry point's defaults.
* The Monte-Carlo parity mode, as ``tests/test_coreslam_e2e.py`` holds JAX:
  a stationary robot stays locked, and the loop stays inside the
  simulator's divergence band under three generator seeds.  The port's
  draws come from a ``torch.Generator``, so only the band can match.
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import CoreSlamConfig as JCoreSlamConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.core.scan import SegmentScan as JSegmentScan
from slamnet_tpu.core.scan import segments_to_cloud as jsegments_to_cloud
from slamnet_tpu.models import coreslam as jcs
from slamnet_tpu_torch import convert, replay
from slamnet_tpu_torch.core.scan import Scan, SegmentScan, segments_to_cloud
from slamnet_tpu_torch.models import coreslam
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim import scan_revolution
from slamnet_tpu_torch.sim.trajectory import (loop_trajectory,
                                              stationary_trajectory)

STEPS = 20
FLIPS = 1e-4


def _jcfg(cfg):
    return JCoreSlamConfig(**{f: getattr(cfg, f) for f in (
        "num_candidates", "search_mode", "dense_hole_fill",
        "dense_obstacle_fill")})


@pytest.fixture(scope="module")
def log():
    lg = replay.make_log(0)
    return lg, replay.to_device(lg, "cpu").points.numpy()


def _to_port(js):
    return convert.coreslam_state_from_numpy(
        np.asarray(js.hole_map), np.asarray(js.obstacle_map),
        np.asarray(js.pose), np.asarray(js.last_odometry),
        np.asarray(js.scan_count), device="cpu")


def _maps_close(ts, js, what):
    for name in ("hole_map", "obstacle_map"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        n = int((a != b).sum())
        assert n <= FLIPS * a.size, f"{what}: {name} {n} cells differ"


def test_production_steps_match_jax(log):
    lg, pts = log
    cfg = replay.coreslam_production_config()
    jcfg = _jcfg(cfg)
    js = jcs.init(jcfg, lg.traj[0], key=jax.random.PRNGKey(1))
    searched = 0
    for t in range(STEPS):
        ts = _to_port(js)
        with jax.disable_jit():
            js, ji = jcs.update_cloud(
                js, JScan(jnp.asarray(pts[t]), jnp.asarray(lg.valid[t]),
                          jnp.zeros(3, jnp.float32)), js.pose, jcfg)
        ts, ti = coreslam.update_cloud(
            ts, Scan(torch.from_numpy(pts[t]), torch.from_numpy(lg.valid[t]),
                     torch.zeros(3)), ts.pose, cfg)
        assert bool(ti.searched) == bool(ji.searched)
        searched += int(ti.searched)
        np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose),
                                   atol=1e-5, rtol=0)
        _maps_close(ts, js, f"scan {t}")
        if not ti.searched:
            np.testing.assert_array_equal(ts.pose.numpy(),
                                          np.asarray(js.pose))
        else:
            assert int(ti.best_sum) == int(ji.best_sum)
        assert ts.scans == int(ts.scan_count) == int(js.scan_count)
    assert searched == STEPS - cfg.position_search_beginning
    # the search tracked: within 5 cm of the truth
    assert np.linalg.norm(ts.pose.numpy()[:2] - lg.traj[STEPS - 1, :2]) < 0.05


def test_update_segments_matches_jax(log):
    """Two segments a revolution (the second half captured 2 cm and 0.01 rad
    later): the de-skewed cloud as JAX's, and ``update`` step by step."""
    lg, _ = log
    cfg = replay.coreslam_production_config()
    jcfg = _jcfg(cfg)
    js = jcs.init(jcfg, lg.traj[0], key=jax.random.PRNGKey(0))
    half = lg.angles.shape[0] // 2
    for t in range(8):
        a = lg.angles.reshape(2, half)
        r = lg.radii[t].reshape(2, half)
        v = lg.valid[t].reshape(2, half)
        odo = np.asarray(js.pose)
        poses = np.stack([odo - np.float32([0.02, 0.0, 0.01]), odo]).astype(
            np.float32)
        jseg = JSegmentScan(jnp.asarray(a), jnp.asarray(r), jnp.asarray(v),
                            jnp.asarray(poses))
        tseg = SegmentScan(*(torch.from_numpy(np.ascontiguousarray(x))
                             for x in (a, r, v, poses)))
        jc, tc = jsegments_to_cloud(jseg), segments_to_cloud(tseg)
        np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points),
                                   atol=2e-6, rtol=0)
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
        ts = _to_port(js)
        with jax.disable_jit():
            js, _ = jcs.update(js, jseg, jcfg)
        ts, _ = coreslam.update(ts, tseg, cfg)
        np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose),
                                   atol=1e-5, rtol=0)
        _maps_close(ts, js, f"segments scan {t}")


def test_warmup_scans_exact(log):
    """The first position_search_beginning scans adopt the odometry (the
    truth here): poses bit for bit, the line updates as JAX's, nothing
    searched and no draw taken."""
    lg, pts = log
    cfg = replay.coreslam_parity_config()
    jcfg = _jcfg(cfg)
    js = jcs.init(jcfg, lg.traj[0], key=jax.random.PRNGKey(1))
    ts = coreslam.init(cfg, lg.traj[0], seed=1, device="cpu")
    g0 = ts.generator.get_state().clone()
    for t in range(cfg.position_search_beginning):
        odo = lg.traj[t]
        with jax.disable_jit():
            js, ji = jcs.update_cloud(
                js, JScan(jnp.asarray(pts[t]), jnp.asarray(lg.valid[t]),
                          jnp.zeros(3, jnp.float32)), jnp.asarray(odo), jcfg)
        ts, ti = coreslam.update_cloud(
            ts, Scan(torch.from_numpy(pts[t]), torch.from_numpy(lg.valid[t]),
                     torch.zeros(3)), torch.from_numpy(odo), cfg)
        assert not bool(ti.searched) and not bool(ji.searched)
        np.testing.assert_array_equal(ts.pose.numpy(), np.asarray(js.pose))
        np.testing.assert_array_equal(ts.last_odometry.numpy(), odo)
        _maps_close(ts, js, f"warm-up scan {t}")
        assert int(ti.best_sum) == 0
    assert ts.scans == 5 and int(ts.scan_count) == 5
    assert torch.equal(ts.generator.get_state(), g0)
    np.testing.assert_array_equal(ts.obstacle_map.numpy(),
                                  np.asarray(js.obstacle_map))
    assert (ts.hole_map.numpy() != coreslam.HOLE_INIT).sum() > 5000


def test_state_through_convert():
    cfg = replay.coreslam_production_config(hole_map_size=64,
                                            obstacle_map_size=16)
    js = jcs.init(JCoreSlamConfig(hole_map_size=64, obstacle_map_size=16),
                  (20.0, 21.0, 0.5))
    rng = np.random.default_rng(0)
    js = js._replace(hole_map=jnp.asarray(rng.integers(0, 65500, 64 * 64),
                                          jnp.int32),
                     obstacle_map=jnp.asarray(rng.integers(-5, 10, (16, 16)),
                                              jnp.int8),
                     scan_count=jnp.int32(3),
                     last_odometry=jnp.asarray([1.0, 2.0, 3.0], jnp.float32))
    ts = _to_port(js)
    assert ts.hole_map.dtype == torch.int32 and ts.obstacle_map.dtype == \
        torch.int8 and ts.scans == 3
    back = convert.coreslam_state_to_numpy(ts)
    assert set(back) == set(convert.CORESLAM_FIELDS)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)))
        assert v.dtype == np.asarray(getattr(js, k)).dtype, k
    rebuilt = jcs.CoreSlamState(**{k: jnp.asarray(v) for k, v in
                                   back.items()}, key=js.key)
    assert int(rebuilt.scan_count) == 3
    # the same seed gives the same draws
    a = convert.coreslam_state_from_numpy(**back, seed=4, device="cpu")
    b = convert.coreslam_state_from_numpy(**back, seed=4, device="cpu")
    assert torch.equal(torch.randn(8, generator=a.generator),
                       torch.randn(8, generator=b.generator))
    # a fresh state, and reset keeps the generator
    st = coreslam.init(cfg, (20.0, 20.0, 0.0), device="cpu")
    assert int((st.hole_map == coreslam.HOLE_INIT).sum()) == 64 * 64
    assert int((st.obstacle_map == cfg.unmapped_obstacle_hits).sum()) == 256
    assert coreslam.reset(st, cfg, (1.0, 2.0, 0.0)).generator is st.generator


def test_entry_points_default_to_the_card():
    for fn in (coreslam.init, convert.coreslam_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            coreslam.init(replay.coreslam_parity_config(), (20.0, 20.0, 0.0))


def _mc_run(traj, seed, n_candidates=1024):
    """tests/test_coreslam_e2e.py's harness: the default field, 400 beams,
    the estimate fed back as odometry; the scans from ``seed`` too."""
    cfg = replay.coreslam_parity_config(num_candidates=n_candidates)
    angles = torch.from_numpy(revolution_angles(400))
    r, v = scan_revolution(default_field(device="cpu"),
                           torch.from_numpy(traj), angles,
                           40.0, 0.02, torch.Generator().manual_seed(seed))
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], -1)
    st = coreslam.init(cfg, traj[0], seed=seed, device="cpu")
    errs = []
    for t in range(traj.shape[0]):
        st, _ = coreslam.update_cloud(st, Scan(pts[t], v[t], torch.zeros(3)),
                                      st.pose, cfg)
        errs.append(st.pose.numpy() - traj[t])
    return st, np.asarray(errs)


def test_mc_stationary_localization_stays_locked():
    st, errs = _mc_run(stationary_trajectory(num_scans=40), 0)
    assert np.linalg.norm(errs[:, :2], axis=1).max() < 0.3
    assert np.abs(errs[:, 2]).max() < math.radians(5.0)
    hm, om = st.hole_map.numpy(), st.obstacle_map.numpy()
    assert (hm > 60000).sum() > 1000 and (hm < 5000).sum() > 50
    assert (om > 0).sum() > 30 and (om == 0).sum() > 200


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mc_loop_within_reference_envelope(seed):
    """The simulator's divergence band (1 m / 10 deg,
    MainWindow.xaml.cs:187) and JAX's e2e ATE bound (0.5 m) over the loop's
    first 500 scans, as tests/test_coreslam_e2e.py:54-64 holds JAX."""
    traj = loop_trajectory(speed=0.3)[:500]
    _, errs = _mc_run(traj, seed)
    pe = np.linalg.norm(errs[:, :2], axis=1)
    assert np.sqrt((pe ** 2).mean()) < 0.5
    assert pe.max() < 1.0
    assert np.abs(errs[:, 2]).max() < math.radians(10.0)
