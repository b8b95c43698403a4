"""slamnet_tpu_torch.sim against slamnet_tpu.sim."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.sim import field as jfield
from slamnet_tpu.sim import lidar as jlidar
from slamnet_tpu.sim import trajectory as jtraj
from slamnet_tpu_torch.sim import field as tfield
from slamnet_tpu_torch.sim import lidar as tlidar
from slamnet_tpu_torch.sim import trajectory as ttraj


@pytest.mark.parametrize("n", [400, 360, 7])
def test_revolution_angles_equal(n):
    want = jlidar.revolution_angles(n)
    got = tlidar.revolution_angles(n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("speed", [0.3, 1.0])
def test_loop_trajectory_equal(speed):
    np.testing.assert_array_equal(ttraj.loop_trajectory(speed),
                                  jtraj.loop_trajectory(speed))
    np.testing.assert_array_equal(ttraj.LOOP_WAYPOINTS, jtraj.LOOP_WAYPOINTS)


def test_default_field_edges_equal():
    jf, tf = jfield.default_field(), tfield.default_field(device="cpu")
    assert tf.num_edges == jf.num_edges == 16
    np.testing.assert_array_equal(tf.a.numpy(), np.asarray(jf.a))
    np.testing.assert_array_equal(tf.b.numpy(), np.asarray(jf.b))


def test_ray_cast_noise_free_matches_jax():
    poses = jtraj.loop_trajectory(0.3)[::60]                 # ~50 poses
    poses = np.concatenate([poses, [[2.0, 2.0, 0.0]]]).astype(np.float32)
    # the last pose is outside the field
    angles = jlidar.revolution_angles(400)
    la = angles[None, :] + poses[:, 2:3]
    jhit, jdist = jfield.ray_cast_batch(jfield.default_field(),
                                        jnp.asarray(poses[:, :2]),
                                        jnp.asarray(la), 40.0)
    thit, tdist = tfield.ray_cast(tfield.default_field(device="cpu"),
                                  torch.from_numpy(poses[:, :2]),
                                  torch.from_numpy(la), 40.0)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), atol=1e-4,
                               rtol=0)
    assert thit.float().mean() > 0.95 and not thit[-1].all()


def test_scan_revolution_noise_grid():
    # noise is k/100 * err for integer k in [-100, 99], drawn from the
    # caller's generator: same seed, same scan
    pose = torch.tensor([20.0, 20.0, 0.3])
    angles = torch.from_numpy(tlidar.revolution_angles(400))
    fld = tfield.default_field(device="cpu")
    r1, v1 = tlidar.scan_revolution(fld, pose, angles, 40.0, 0.02,
                                    torch.Generator().manual_seed(5))
    r2, _ = tlidar.scan_revolution(fld, pose, angles, 40.0, 0.02,
                                   torch.Generator().manual_seed(5))
    assert torch.equal(r1, r2) and bool(v1.all())
    _, dist = tfield.ray_cast(fld, pose[:2], angles + pose[2], 40.0)
    k = ((r1 - dist) / 0.02 * 100.0).numpy()
    np.testing.assert_allclose(k, np.round(k), atol=2e-2)
    assert k.min() >= -100.02 and k.max() <= 99.02
    assert len(np.unique(np.round(k))) > 100
    cloud = tlidar.make_cloud(angles, r1, v1)
    np.testing.assert_allclose(cloud.points.norm(dim=1).numpy(), r1.numpy(),
                               rtol=1e-5)


def test_make_log_is_the_bench_log():
    # bench.py:109-135: 10 + 512 poses of the 0.3 m/s loop, 400 beams,
    # 40 m range, +/-0.02 m grid noise; the same seed gives the same log
    from slamnet_tpu_torch import replay
    log = replay.make_log(seed=0)
    assert log.bootstrap == 10
    assert log.radii.shape == log.valid.shape == (522, 400)
    assert log.radii.dtype == np.float32 and log.valid.dtype == bool
    np.testing.assert_array_equal(log.traj, jtraj.loop_trajectory(0.3)[:522])
    np.testing.assert_array_equal(log.angles, jlidar.revolution_angles(400))
    assert log.valid.mean() > 0.99
    assert (log.radii[~log.valid] == 0).all()
    again = replay.make_log(seed=0)
    np.testing.assert_array_equal(again.radii, log.radii)
    assert not np.array_equal(replay.make_log(seed=1).radii, log.radii)
    # noise-free ranges of the first scans, from the JAX package
    la = log.angles[None, :] + log.traj[:4, 2:3]
    _, dist = jfield.ray_cast_batch(jfield.default_field(),
                                    jnp.asarray(log.traj[:4, :2]),
                                    jnp.asarray(la), 40.0)
    k = (log.radii[:4] - np.asarray(dist)) / 0.02 * 100.0
    assert np.abs(k).max() <= 100.05
    np.testing.assert_allclose(k, np.round(k), atol=2e-2)


# sha256 of (traj, angles, radii, valid) of each log as the parent tree of
# the sim's change of default device (to the card) made them: the logs the
# JAX references in replay.py were computed over
LOG_SHA256 = {
    "make_log": "6c8ccda3d011bafd207b3f9c4b1d71321e7d7a44664bfd24ece190bd1cb6f66e",
    "make_graph_log":
        "32b28dfa3e2d6376756ceca640cb36f23faa37b088bf03b70234bb7ea2b2b17b",
    "make_office_log":
        "3315444a3eac8a6e332547c97bf924f114c4e91dbc2bb65181a82f5c78cb1304",
}


@pytest.mark.parametrize("name", sorted(LOG_SHA256))
def test_replay_logs_unchanged(name):
    import hashlib

    from slamnet_tpu_torch import replay
    log = getattr(replay, name)()
    h = hashlib.sha256()
    for a in (log.traj, log.angles, log.radii, log.valid):
        h.update(a.tobytes())
    assert h.hexdigest() == LOG_SHA256[name]


def test_sim_defaults_to_the_card():
    import inspect
    for fn in (tfield.make_field, tfield.default_field, tfield.office_field):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tfield.default_field()

