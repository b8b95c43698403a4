"""CARMEN logs and the dataset replay: slamnet_tpu_torch against JAX.

* ``io.datasets``: both checked-in logs read as JAX's reader reads them, bit
  for bit; ``write_carmen`` -> ``read_carmen`` round trips (truth included,
  and JAX's reader reads the port's file the same); ``log_points`` equal;
  the simulated logs' odometry equal to JAX's (numpy, same seed) and their
  ranges from the port's lidar (dropouts, the noise grid).
* ``sim.lidar.scan_revolution(dropout_prob=...)`` and the trajectories JAX
  has beside the loop (numpy, bit for bit).
* ``replay.carmen_replay``: the first 30 scans of each checked-in log through
  Hector (gather + line updates, a 4-level 160-px pyramid at 0.25 m) and the
  JAX package's ``hector.update`` in the same flow
  (``examples/replay_dataset.py``): the pose within 1e-5 m at every scan;
  CoreSLAM's correlative search with the dense fills step by step from JAX's
  state, as ``tests/test_torch_coreslam.py`` holds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import CoreSlamConfig as JCoreSlamConfig
from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.io import datasets as jds
from slamnet_tpu.models import coreslam as jcs
from slamnet_tpu.models import hector as jhector
from slamnet_tpu.sim import lidar as jlidar
from slamnet_tpu.sim import trajectory as jtraj
from slamnet_tpu_torch import convert, replay
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.io import datasets
from slamnet_tpu_torch.models import coreslam
from slamnet_tpu_torch.sim import field, lidar, trajectory

LOGS = {"sim_loop": replay.SIM_LOOP_LOG, "adversarial": replay.ADVERSARIAL_LOG}
SMALL = dict(map_size=160, map_resolution=0.25, num_levels=4,
             estimate_iterations=(7, 4, 4, 4))
SCANS = 30
CORESLAM_STEPS = 8
FLIPS = 1e-4


def _same_log(a, b):
    for name in ("ranges", "valid", "odometry", "angles", "timestamps"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.max_range == b.max_range
    assert (a.truth is None) == (b.truth is None)
    if a.truth is not None:
        np.testing.assert_array_equal(a.truth, b.truth)


@pytest.mark.parametrize("name", sorted(LOGS))
def test_read_carmen_equals_jax(name):
    got = datasets.read_carmen(str(LOGS[name]))
    _same_log(got, jds.read_carmen(str(LOGS[name])))
    assert got.ranges.shape == ((120, 180) if name == "sim_loop"
                                else (360, 181))
    assert (got.truth is None) == (name == "sim_loop")
    np.testing.assert_array_equal(datasets.log_points(got),
                                  jds.log_points(got))
    few = datasets.read_carmen(str(LOGS[name]), max_scans=7)
    _same_log(few, jds.read_carmen(str(LOGS[name]), max_scans=7))


def test_write_read_round_trip(tmp_path):
    log = datasets.read_carmen(str(replay.ADVERSARIAL_LOG), max_scans=12)
    path = str(tmp_path / "round.clf")
    datasets.write_carmen(path, log)
    back = datasets.read_carmen(path)
    _same_log(back, jds.read_carmen(path))
    np.testing.assert_allclose(back.ranges[log.valid], log.ranges[log.valid],
                               atol=5e-4)
    np.testing.assert_array_equal(back.valid, log.valid)
    np.testing.assert_allclose(back.truth, log.truth, atol=1e-6)
    np.testing.assert_allclose(back.odometry, log.odometry, atol=1e-6)
    assert back.max_range == pytest.approx(log.max_range)


def test_robotlaser1_and_mixed_beams(tmp_path):
    p = tmp_path / "rl.clf"
    p.write_text("ROBOTLASER1 0 -1.5 3.0 1.0 30.0 0.1 0 4 1.0 2.0 40.0 3.0 "
                 "0 0.5 0.6 0.1 0 0 0 0 0 0 0 0 7.5 h 7.5\n")
    for reader in (datasets.read_carmen, jds.read_carmen):
        log = reader(str(p))
        np.testing.assert_allclose(log.angles, [-1.5, -0.5, 0.5, 1.5])
        assert log.max_range == 30.0
        np.testing.assert_array_equal(log.valid, [[True, True, False, True]])
        np.testing.assert_allclose(log.odometry, [[0.5, 0.6, 0.1]])
        assert log.timestamps[0] == 7.5
    _same_log(datasets.read_carmen(str(p)), jds.read_carmen(str(p)))
    q = tmp_path / "mixed.clf"
    q.write_text("FLASER 2 1.0 2.0 0 0 0 0 0 0 1 h 1\n"
                 "FLASER 3 1.0 2.0 3.0 0 0 0 0 0 0 2 h 2\n")
    with pytest.raises(ValueError):
        datasets.read_carmen(str(q))


def test_simulated_logs_on_the_cpu():
    # the odometry is numpy from the same seed: JAX's bit for bit
    adv = datasets.simulate_adversarial_log(n_scans=40, num_beams=45, seed=5,
                                            device="cpu")
    jadv = jds.simulate_adversarial_log(n_scans=40, num_beams=45, seed=5)
    np.testing.assert_array_equal(adv.odometry, jadv.odometry)
    np.testing.assert_array_equal(adv.truth, jadv.truth)
    np.testing.assert_array_equal(adv.angles, jadv.angles)
    np.testing.assert_array_equal(adv.timestamps, jadv.timestamps)
    assert adv.ranges.shape == (40, 45) and adv.max_range == jadv.max_range
    assert 0.1 < 1.0 - adv.valid.mean() < 0.3       # 20% dropouts
    assert (adv.ranges[~adv.valid] == 0).all()
    loop = datasets.simulate_carmen_log(n_scans=20, num_beams=30, seed=2,
                                        device="cpu")
    jloop = jds.simulate_carmen_log(n_scans=20, num_beams=30, seed=2)
    np.testing.assert_array_equal(loop.odometry, jloop.odometry)
    assert loop.truth is None and loop.ranges.dtype == np.float32
    np.testing.assert_array_equal(loop.valid, jloop.valid)   # no dropouts
    # the ranges are the port's lidar: the truth's ray distances plus the
    # grid noise
    truth = jtraj.loop_trajectory(0.25)[:20]
    _, dist = field.ray_cast(field.default_field(device="cpu"),
                             torch.from_numpy(truth[:, :2]),
                             torch.from_numpy(loop.angles[None, :]
                                              + truth[:, 2:3]), 40.0)
    k = (loop.ranges - dist.numpy()) / 0.02 * 100.0
    assert np.abs(k).max() <= 100.05
    np.testing.assert_allclose(k, np.round(k), atol=2e-2)


def test_dropout_draws_after_the_steps():
    fld = field.default_field(device="cpu")
    pose = torch.tensor([20.0, 20.0, 0.1])
    ang = torch.from_numpy(jlidar.revolution_angles(400))
    r0, v0 = lidar.scan_revolution(fld, pose, ang, 40.0, 0.02,
                                   torch.Generator().manual_seed(4))
    r1, v1 = lidar.scan_revolution(fld, pose, ang, 40.0, 0.02,
                                   torch.Generator().manual_seed(4),
                                   dropout_prob=0.3)
    # the uniform steps come first: kept beams are the dropout-free ranges
    assert torch.equal(r1[v1], r0[v1]) and bool((v1 <= v0).all())
    assert 0.2 < 1.0 - v1.float().mean() < 0.4
    assert bool((r1[~v1] == 0).all())
    # a draw not asked for takes nothing: no dropout leaves the normals as
    # they were
    r2, _ = lidar.scan_revolution(fld, pose, ang, 40.0, 0.02,
                                  torch.Generator().manual_seed(4),
                                  range_error_std=0.03, dropout_prob=0.0)
    r3, _ = lidar.scan_revolution(fld, pose, ang, 40.0, 0.02,
                                  torch.Generator().manual_seed(4), 0.03)
    assert torch.equal(r2, r3)


@pytest.mark.parametrize("fn,kw", [
    ("straight_trajectory", {"start": (3.0, 4.0, 0.7), "num_scans": 50}),
    ("rect_drive_trajectory", {}),
    ("rect_drive_trajectory", {"num_loops": 2, "closing_leg": 3,
                               "step": 0.2}),
    ("spin_trajectory", {"num_scans": 60}),
])
def test_trajectories_equal(fn, kw):
    got = getattr(trajectory, fn)(**kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, getattr(jtraj, fn)(**kw))


def _jax_flow(data, hcfg, scans):
    """examples/replay_dataset.py's Hector loop in JAX over ``scans``."""
    jc = JHectorConfig(**{k: getattr(hcfg, k) for k in (
        "map_size", "map_resolution", "num_levels", "estimate_iterations",
        "xy_step_clamp_px", "max_match_jump", "gn_damping")})
    step = jax.jit(lambda st, p, v, hint, force: jhector.update(
        st, JScan(p, v, jnp.zeros(3, jnp.float32)), hint, jc,
        map_without_matching=force))
    st = jhector.init(jc, data.odo[0])
    pts, val = data.points.numpy(), data.valid.numpy()
    poses = []
    for t in range(scans):
        st, _ = step(st, pts[t], val[t], st.match_pose + data.deltas[t],
                     jnp.asarray(t < replay.DATASET_FORCED))
        if t < replay.DATASET_FORCED:
            st = st._replace(match_pose=jnp.asarray(data.odo[t]))
        poses.append(np.asarray(st.match_pose))
    return np.stack(poses)


@pytest.mark.parametrize("name", sorted(LOGS))
def test_hector_dataset_replay_matches_jax(name):
    data = replay.load_carmen(LOGS[name], "cpu", max_scans=SCANS,
                              truth=replay.sim_loop_truth(120))
    assert data.truth is not None and data.truth.shape == (SCANS, 3)
    np.testing.assert_array_equal(data.odo[0, :2], [20.0, 20.0])
    hcfg = replay.dataset_config(robust=name == "adversarial")[0].overlay(
        SMALL)
    hst, cst, out = replay.carmen_replay(data, hcfg, None)
    assert cst is None and out.coreslam is None
    got = out.hector.numpy()
    np.testing.assert_array_equal(got[:replay.DATASET_FORCED],
                                  data.odo[:replay.DATASET_FORCED])
    np.testing.assert_allclose(got, _jax_flow(data, hcfg, SCANS), atol=1e-5,
                               rtol=0)
    m = replay.dataset_metrics(data, out)
    assert m["hector_ate_m"] < 0.05 and "coreslam_ate_m" not in m


def test_coreslam_dataset_steps_match_jax():
    data = replay.load_carmen(replay.ADVERSARIAL_LOG, "cpu",
                              max_scans=CORESLAM_STEPS)
    ccfg = replay.dataset_config(robust=True)[1]
    jcfg = JCoreSlamConfig(physical_map_size=ccfg.physical_map_size,
                           search_mode="correlative", dense_hole_fill=True,
                           dense_obstacle_fill=True)
    js = jcs.init(jcfg, data.odo[0], key=jax.random.PRNGKey(0))
    pts, val = data.points.numpy(), data.valid.numpy()
    for t in range(CORESLAM_STEPS):
        ts = convert.coreslam_state_from_numpy(
            np.asarray(js.hole_map), np.asarray(js.obstacle_map),
            np.asarray(js.pose), np.asarray(js.last_odometry),
            np.asarray(js.scan_count), device="cpu")
        with jax.disable_jit():
            js, ji = jcs.update_cloud(
                js, JScan(jnp.asarray(pts[t]), jnp.asarray(val[t]),
                          jnp.zeros(3, jnp.float32)),
                jnp.asarray(data.odo[t]), jcfg)
        ts, ti = coreslam.update_cloud(
            ts, Scan(data.points[t], data.valid[t], torch.zeros(3)),
            data.odo_t[t], ccfg)
        assert bool(ti.searched) == bool(ji.searched)
        np.testing.assert_allclose(ts.pose.numpy(), np.asarray(js.pose),
                                   atol=1e-5, rtol=0)
        for m in ("hole_map", "obstacle_map"):
            a, b = getattr(ts, m).numpy(), np.asarray(getattr(js, m))
            assert int((a != b).sum()) <= FLIPS * a.size, (t, m)
    # the whole flow: both pipelines, no step reading the device
    _, cst, out = replay.carmen_replay(data, None, ccfg)
    assert out.hector is None and out.coreslam.shape == (CORESLAM_STEPS, 3)
    assert cst.scans == ccfg.position_search_beginning


def test_dataset_entry_points_default_to_the_card():
    import inspect
    for fn in (replay.load_carmen, datasets.simulate_carmen_log,
               datasets.simulate_adversarial_log, field.make_field,
               field.default_field, field.office_field):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        for fn in (field.default_field, field.office_field,
                   lambda: replay.load_carmen(replay.SIM_LOOP_LOG)):
            with pytest.raises((RuntimeError, AssertionError)):
                fn()
