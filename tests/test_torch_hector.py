"""The slices as a whole: slamnet_tpu_torch's Hector pipeline against JAX.

Both packages bootstrap from the same scans at the true poses in the
``fixed`` config (as ``bench.py:147-172`` bootstraps every mode) and then
track the same scans, each hinted with its own previous match pose.

* ``pallas_dense``: JAX runs ``matcher_mode="onehot_bf16"`` + dense fill (the
  bf16 selection K1 makes, in XLA); the port runs ``pallas_dense`` through
  its plain versions on CPU.  Per-scan poses agree to 2e-3 m and the
  motion-gated map updates fire on the same scans.
* ``fixed`` (the defaults: gather matcher + line updates, K3 + K4's plain
  versions): the f32 table on both sides and bit-exact integer line updates,
  so per-scan poses agree to 1e-4 m, the gates fire on the same scans, and
  the maps agree cell for cell but for a beam whose rounded endpoint a 1-ulp
  cos/sin difference moves (at most 1e-3 of the cells).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.models import hector as jhector
from slamnet_tpu_torch import convert, replay
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.entry import entry
from slamnet_tpu_torch.models import hector
from slamnet_tpu_torch.sim import default_field, revolution_angles
from slamnet_tpu_torch.sim import scan_revolution
from slamnet_tpu_torch.sim.trajectory import loop_trajectory

SMALL = dict(map_size=160, map_resolution=0.25, num_levels=3,
             estimate_iterations=(7, 4, 4))
BOOT, TRACK = 6, 16


@pytest.fixture(scope="module")
def log():
    """22 poses of the loop, 0.14 m apart (so the motion gate fires), and
    their scans as numpy clouds: the same inputs for both packages."""
    traj = loop_trajectory(0.3)[::8][:BOOT + TRACK]
    angles = torch.from_numpy(revolution_angles(400))
    r, v = scan_revolution(default_field(device="cpu"),
                           torch.from_numpy(traj), angles,
                           40.0, 0.02, torch.Generator().manual_seed(3))
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], -1)
    return traj, pts.numpy(), v.numpy()


def _jax_run(log, cfg):
    """JAX's bench flow: BOOT forced scans in the fixed config, then TRACK
    tracked ones in ``cfg``; (boot state, poses, map_updated, final maps)."""
    traj, pts, v = log
    boot_cfg = JHectorConfig(**SMALL)

    def step(st, p, valid, hint, force, cfg):
        return jhector.update(st, JScan(p, valid, jnp.zeros(3, jnp.float32)),
                              hint, cfg, map_without_matching=force)

    boot = jax.jit(functools.partial(step, cfg=boot_cfg))
    track = jax.jit(functools.partial(step, cfg=cfg))
    st = jhector.init(cfg, traj[0])
    for t in range(BOOT):
        st, _ = boot(st, pts[t], v[t], traj[t], jnp.asarray(True))
    boot_state = st
    poses, upd = [], []
    for t in range(BOOT, BOOT + TRACK):
        st, info = track(st, pts[t], v[t], st.match_pose, jnp.asarray(False))
        poses.append(np.asarray(st.match_pose))
        upd.append(bool(info.map_updated))
    return boot_state, np.stack(poses), np.asarray(upd), np.asarray(st.maps)


@pytest.fixture(scope="module")
def jax_run(log):
    return _jax_run(log, JHectorConfig(matcher_mode="onehot_bf16",
                                       dense_free_fill=True, **SMALL))[:3]


def test_convert_round_trip(jax_run):
    boot_state = jax_run[0]
    arrays = {k: np.asarray(getattr(boot_state, k)) for k in convert.FIELDS}
    st = convert.hector_state_from_numpy(**arrays, device="cpu")
    assert st.maps.dtype == torch.float32
    assert st._fields == convert.FIELDS          # no update scratch
    back = convert.hector_state_to_numpy(st)
    for k in convert.FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
    rebuilt = jhector.HectorState(**{k: jnp.asarray(a) for k, a in back.items()})
    np.testing.assert_array_equal(np.asarray(rebuilt.maps), arrays["maps"])
    # the state is a copy: writing the port's maps leaves the numpy alone
    st.maps.add_(1.0)
    np.testing.assert_array_equal(convert.hector_state_to_numpy(st)["maps"],
                                  arrays["maps"] + 1.0)


def test_bootstrap_then_tracking_matches_jax(log, jax_run):
    traj, pts, v = log
    _, jposes, jupd = jax_run
    cfg = replay.pallas_dense_config(**SMALL)
    dlog = replay.DeviceLog(torch.from_numpy(pts), torch.from_numpy(v),
                            torch.from_numpy(traj))
    st = replay.bootstrap(hector.init(cfg, traj[0], device="cpu"), dlog, BOOT, cfg)
    np.testing.assert_array_equal(st.last_update_pose.numpy(), traj[BOOT - 1])
    _, out = replay.replay(st, dlog, BOOT, cfg)
    poses = out.poses.numpy()
    np.testing.assert_allclose(poses, jposes, atol=2e-3)
    np.testing.assert_array_equal(out.map_updated.numpy(), jupd)
    assert 2 <= jupd.sum() < TRACK                   # the gate fired, not always
    assert int(out.solve_failures.sum()) == 0
    ate, mx = replay.ate_of(poses, traj[BOOT:])
    ate_j, _ = replay.ate_of(jposes, traj[BOOT:])
    assert mx < 0.1 and abs(ate - ate_j) < 1e-3


def test_same_state_same_scan_matches_jax(log, jax_run):
    # one matched update from the JAX bootstrap state, carried across by
    # convert: pose, gate and maps agree
    traj, pts, v = log
    boot_state = jax_run[0]
    cfg = replay.pallas_dense_config(**SMALL)
    jcfg = JHectorConfig(matcher_mode="onehot_bf16", dense_free_fill=True,
                         **SMALL)
    t = BOOT + 3
    hint = traj[t] + np.array([0.1, -0.1, 0.02], np.float32)
    jst, jinfo = jhector.update(
        boot_state, JScan(jnp.asarray(pts[t]), jnp.asarray(v[t]),
                          jnp.zeros(3, jnp.float32)), hint, jcfg)
    st = convert.hector_state_from_numpy(
        **{k: np.asarray(getattr(boot_state, k)) for k in convert.FIELDS},
        device="cpu")
    st, info = hector.update(st, Scan.from_points(pts[t], v[t]),
                             torch.from_numpy(hint), cfg)
    np.testing.assert_allclose(st.match_pose.numpy(), np.asarray(jst.match_pose),
                               atol=2e-3)
    assert bool(info.map_updated) == bool(jinfo.map_updated) is True
    np.testing.assert_array_equal(st.last_update_pose.numpy(),
                                  st.match_pose.numpy())
    diff = st.maps.numpy() != np.asarray(jst.maps)
    assert diff.mean() <= 1e-3


def test_public_match_matches_jax(log, jax_run):
    # hector.match: the matched pose alone, as JAX's public match gives it
    traj, pts, v = log
    maps = np.asarray(jax_run[0].maps)
    cfg, jcfg = replay.fixed_config(**SMALL), JHectorConfig(**SMALL)
    t = BOOT + 2
    hint = traj[t] + np.array([0.08, -0.05, 0.02], np.float32)
    got = hector.match(torch.from_numpy(maps.copy()),
                       Scan.from_points(pts[t], v[t]), torch.from_numpy(hint),
                       cfg)
    want = jhector.match(jnp.asarray(maps), JScan(
        jnp.asarray(pts[t]), jnp.asarray(v[t]), jnp.zeros(3, jnp.float32)),
        jnp.asarray(hint), jcfg)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_map_queries_match_jax(jax_run):
    boot_state = jax_run[0]
    cfg = replay.pallas_dense_config(**SMALL)
    jcfg = JHectorConfig(**SMALL)
    maps = np.asarray(boot_state.maps)
    tm = torch.from_numpy(maps.copy())
    for level in range(cfg.num_levels):
        np.testing.assert_array_equal(
            hector.level_view(tm, cfg, level).numpy(),
            np.asarray(jhector.level_view(jnp.asarray(maps), jcfg, level)))
        got = [int(x) for x in hector.map_extents(tm, cfg, level)]
        want = [int(x) for x in jhector.map_extents(jnp.asarray(maps), jcfg,
                                                   level)]
        assert got == want and got[0] == 1
    p = np.array([12.3, 20.7, 0.4], np.float32)
    m = hector.world_to_map(torch.from_numpy(p), 4.0, (0.0, 0.0))
    np.testing.assert_allclose(
        m.numpy(), np.asarray(jhector.world_to_map(jnp.asarray(p), 4.0,
                                                   (0.0, 0.0))), rtol=1e-7)
    np.testing.assert_allclose(hector.map_to_world(m, 4.0, (0.0, 0.0)).numpy(),
                               p, rtol=1e-6)


def test_module_and_entry_step(log):
    traj, pts, v = log
    cfg = replay.pallas_dense_config(**SMALL)
    slam = hector.HectorSLAM(cfg, traj[0], device="cpu")
    assert {"maps", "match_pose", "last_update_pose"} <= set(slam.state_dict())
    st = hector.init(cfg, traj[0], device="cpu")
    for t in range(3):
        scan = Scan.from_points(pts[t], v[t])
        info = slam(scan, torch.from_numpy(traj[t]), True)
        st, ref = hector.update(st, scan, torch.from_numpy(traj[t]), cfg, True)
        assert bool(info.map_updated) and bool(ref.map_updated)
    assert torch.equal(slam.maps, st.maps)
    assert torch.equal(slam.match_pose, st.match_pose)
    for bad in ({"matcher_mode": "onehot"}, {"offset": (1.0, 0.0)}):
        with pytest.raises(NotImplementedError, match="matcher_mode"):
            hector.HectorSLAM(cfg.overlay(bad))
    # the early exit: refused under "pallas" (as JAX refuses it), taken by
    # the f32 matchers and by K1's onehot_bf16 table
    with pytest.raises(ValueError, match="early_exit_tol"):
        hector.HectorSLAM(cfg.overlay({"early_exit_tol": 1e-3}))
    for mode in ("gather", "onehot_highest", "onehot_bf16"):
        hector.HectorSLAM(cfg.overlay({"early_exit_tol": 1e-3,
                                       "matcher_mode": mode}), device="cpu")
    hector.HectorSLAM(cfg.overlay({"matcher_mode": "gather"}), device="cpu")

    # the entry runs the JAX entry's own config: the fixed mode (K3 + K4)
    step, (state, points, valid) = entry("cpu")
    first = hector.HectorState(*(t.clone() for t in state))
    new = step(state, points, valid)
    assert new.maps.shape == (replay.fixed_config().total_cells,)
    assert torch.isfinite(new.maps).all() and bool(new.maps.ne(0).any())
    assert torch.isfinite(new.match_pose).all()
    ref, _ = hector.update(first, Scan(points, valid, torch.zeros(3)),
                           first.match_pose, replay.fixed_config())
    assert torch.equal(new.maps, ref.maps)
    assert torch.equal(new.match_pose, ref.match_pose)


def test_fixed_bootstrap_then_tracking_matches_jax(log):
    # the reference-exact mode end to end: K3's and K4's plain versions
    traj, pts, v = log
    _, jposes, jupd, jmaps = _jax_run(log, JHectorConfig(**SMALL))
    cfg = replay.fixed_config(**SMALL)
    dlog = replay.DeviceLog(torch.from_numpy(pts), torch.from_numpy(v),
                            torch.from_numpy(traj))
    st = replay.bootstrap(hector.init(cfg, traj[0], device="cpu"), dlog, BOOT, cfg)
    np.testing.assert_array_equal(st.last_update_pose.numpy(), traj[BOOT - 1])
    stf, out = replay.replay(st, dlog, BOOT, cfg)
    poses = out.poses.numpy()
    np.testing.assert_allclose(poses, jposes, atol=1e-4)
    np.testing.assert_array_equal(out.map_updated.numpy(), jupd)
    assert 2 <= jupd.sum() < TRACK                   # the gate fired, not always
    assert int(out.solve_failures.sum()) == 0
    diff = stf.maps.numpy() != jmaps
    assert diff.mean() <= 1e-3, diff.mean()
    ate, mx = replay.ate_of(poses, traj[BOOT:])
    ate_j, _ = replay.ate_of(jposes, traj[BOOT:])
    assert mx < 0.1 and abs(ate - ate_j) < 1e-4


def test_onehot_bf16_dense_early_exit_tracks_jax(log):
    # bench.py's default candidate (early_exit_tol=1e-3, K1's table, dense
    # fill): JAX's onehot_bf16 table is K1's to 2e-3, so the poses are held
    # there; the gates fire on the same scans and the exit cuts iterations
    traj, pts, v = log
    jcfg = JHectorConfig(matcher_mode="onehot_bf16", dense_free_fill=True,
                         early_exit_tol=1e-3, **SMALL)
    _, jposes, jupd, _ = _jax_run(log, jcfg)
    cfg = replay.onehot_bf16_dense_config(**SMALL)
    dlog = replay.DeviceLog(torch.from_numpy(pts), torch.from_numpy(v),
                            torch.from_numpy(traj))
    st = replay.bootstrap(hector.init(cfg, traj[0], device="cpu"), dlog, BOOT,
                          cfg)
    _, out = replay.replay(st, dlog, BOOT, cfg)
    np.testing.assert_allclose(out.poses.numpy(), jposes, atol=2e-3)
    np.testing.assert_array_equal(out.map_updated.numpy(), jupd)
    iters = out.gn_iterations.numpy()
    assert iters.dtype == np.int32 and (iters >= 3).all()
    assert iters.sum() < 15 * TRACK                  # the exit fired
