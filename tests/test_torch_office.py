"""The office loop: slamnet_tpu_torch's generators and flow against the JAX
package's (the port's log, numpy in between).

* ``office_field``, ``office_tour_trajectory`` (679 poses at two laps) and
  ``drifting_odometry``: equal to JAX's bit for bit (numpy both sides).
* ``scan_revolution``'s ``range_error_std``: the noise's mean, spread and
  tails against the model's (the port draws from a ``torch.Generator``, so
  only the distribution can match JAX's).
* The office flow's first 40 scans (10 forced, then the drive out of room
  A with drifting odometry hints) on a 2-level 100-px pyramid at 0.2 m
  (20 m, as the office's 200-px map at 0.1 m), Hector alone and graph-SLAM,
  against ``scripts/torch_port_ref_ate.py``'s JAX flow on the same log: the
  same keyframes and closures, poses within 1e-4 m.
"""
import math

import numpy as np
import pytest
import torch

from slamnet_tpu.io import datasets as jdata
from slamnet_tpu.sim import field as jfield
from slamnet_tpu.sim import trajectory as jtraj
from slamnet_tpu_torch import replay
from slamnet_tpu_torch.io import datasets as tdata
from slamnet_tpu_torch.sim import field as tfield
from slamnet_tpu_torch.sim import lidar as tlidar
from slamnet_tpu_torch.sim import trajectory as ttraj

PREFIX = 40
LEVELS = dict(num_levels=2, map_size=100, map_resolution=0.2,
              estimate_iterations=(7, 4))


def test_office_field_equal():
    jf, tf = jfield.office_field(), tfield.office_field(device="cpu")
    assert tf.num_edges == jf.num_edges == 28
    np.testing.assert_array_equal(tf.a.numpy(), np.asarray(jf.a))
    np.testing.assert_array_equal(tf.b.numpy(), np.asarray(jf.b))
    assert (tfield.OFFICE_OUTER, tfield.OFFICE_CROSS, tfield.OFFICE_DOORS) \
        == (jfield.OFFICE_OUTER, jfield.OFFICE_CROSS, jfield.OFFICE_DOORS)


@pytest.mark.parametrize("loops,step", [(2, 0.25), (1, 0.5)])
def test_office_tour_equal(loops, step):
    got = ttraj.office_tour_trajectory(loops, step)
    np.testing.assert_array_equal(got, jtraj.office_tour_trajectory(loops,
                                                                    step))
    if (loops, step) == (2, 0.25):
        assert got.shape == (679, 3)
    wps = [(20.0, 20.0), (24.0, 20.0), (24.0, 25.0), (20.0, 20.0)]
    np.testing.assert_array_equal(
        ttraj.waypoint_drive_trajectory(wps, 0.3, math.radians(15.0)),
        jtraj.waypoint_drive_trajectory(wps, 0.3, math.radians(15.0)))


def test_drifting_odometry_equal_and_office_log():
    log = replay.make_office_log()
    assert log.radii.shape == (689, 400) and log.bootstrap == 10
    np.testing.assert_array_equal(log.traj[:10], np.tile(log.traj[0], (10, 1)))
    want = jdata.drifting_odometry(log.traj.astype(np.float64), 1.02,
                                   0.0002, 0.003, heading_noise=0.001, seed=7)
    odo, deltas = replay.office_odometry(log.traj)
    np.testing.assert_array_equal(odo, want)
    np.testing.assert_array_equal(
        tdata.drifting_odometry(log.traj, 1.05, 0.001, 0.01, 0.002, 0.003, 5),
        jdata.drifting_odometry(log.traj, 1.05, 0.001, 0.01, 0.002, 0.003, 5))
    assert np.abs(deltas[:, 2]).max() <= math.pi
    # the odometry drifts: a few metres off by the end of two laps
    assert 0.5 < np.linalg.norm(odo[-1, :2] - log.traj[-1, :2]) < 20.0


def test_range_error_std_moments():
    """200 revolutions of 400 beams from the middle of room A (the walls
    within 10 m of half the beams): the noise is the uniform grid (mean
    -0.01 x err, variance ~err^2 / 3) plus N(0, std^2)."""
    fld = tfield.office_field(device="cpu")
    angles = torch.from_numpy(tlidar.revolution_angles(400))
    pose = torch.tensor([[9.5, 9.5, 0.0]]).repeat(200, 1)
    gen = torch.Generator().manual_seed(0)
    clean, hit = tlidar.scan_revolution(fld, pose, angles, 10.0, 0.0, gen)
    r, v = tlidar.scan_revolution(fld, pose, angles, 10.0, 0.02, gen,
                                  range_error_std=0.03)
    assert torch.equal(v, hit)
    e = (r - clean)[hit].double()
    grid = np.arange(-100, 100) / 100.0 * 0.02
    mean, var = grid.mean(), grid.var() + 0.03 ** 2
    n = e.numel()
    assert n > 30_000
    assert abs(float(e.mean()) - mean) < 4 * math.sqrt(var / n)
    assert abs(float(e.var()) / var - 1.0) < 0.03
    # Gaussian tails: beyond 3 sigma of the sum, about 0.3% of the rays
    tail = float((e.abs() > 3 * math.sqrt(var)).double().mean())
    assert 0.0015 < tail < 0.0045
    # without it the draws are the grid's alone
    r0, _ = tlidar.scan_revolution(fld, pose[:1], angles, 10.0, 0.02,
                                   torch.Generator().manual_seed(1))
    steps = ((r0 - clean[:1])[hit[:1]] / 0.02 * 100).round()
    assert float((steps - (r0 - clean[:1])[hit[:1]] / 0.02 * 100).abs().max()
                 ) < 1e-2


@pytest.fixture(scope="module")
def prefix():
    """The office flow's first PREFIX scans, the port's and JAX's."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_port_ref_ate.py")
    spec = importlib.util.spec_from_file_location("torch_port_ref_ate", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    full = replay.make_office_log()
    log = replay.ScanLog(full.traj[:PREFIX], full.angles,
                         full.radii[:PREFIX], full.valid[:PREFIX],
                         full.bootstrap)
    jax_out = ref.run_office(log, num_levels=2, map_size=100,
                             map_resolution=0.2)
    hcfg, gcfg, mcfg = replay.office_config(**LEVELS)
    odo, deltas = replay.office_odometry(log.traj)
    dlog = replay.to_device(log, "cpu")
    odo_t, deltas_t = torch.from_numpy(odo), torch.from_numpy(deltas)
    _, h = replay.office_replay(dlog, odo_t, deltas_t, hcfg)
    g_state, g = replay.office_replay(dlog, odo_t, deltas_t, hcfg, gcfg, mcfg)
    port = replay.office_metrics(log.traj, h.poses.numpy(), g_state,
                                 g.poses.numpy(), g.keyframe_added.numpy())
    return log, jax_out, port, h, g


def test_office_prefix_hector_only_matches_jax(prefix):
    log, (_, jh, _, _), _, h, _ = prefix
    np.testing.assert_allclose(h.poses.numpy(), jh, atol=1e-4, rtol=0)
    # the forced scans end on the odometry
    odo, _ = replay.office_odometry(log.traj)
    np.testing.assert_array_equal(h.poses.numpy()[:10], odo[:10])


def test_office_prefix_graph_matches_jax(prefix):
    _, (jm, _, jg, jkf), port, _, g = prefix
    np.testing.assert_array_equal(g.keyframe_added.numpy(), jkf)
    assert port["keyframes"] == jm["keyframes"] >= 5
    assert port["loop_closures"] == jm["loop_closures"]
    np.testing.assert_allclose(g.poses.numpy(), jg, atol=1e-4, rtol=0)
    for k in ("hector_only_ate_m", "graph_online_ate_m", "kf_hector_ate_m",
              "kf_optimized_ate_m"):
        assert abs(port[k] - jm[k]) < 1e-4, k
    assert replay.office_gate(port, jm) == []
