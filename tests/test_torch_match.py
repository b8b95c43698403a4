"""K1's plain version (slamnet_tpu_torch.ops.match) against the JAX matcher.

The JAX side runs ``hector.match_with_stats`` in ``"pallas"`` mode (the TPU
kernel K1 in interpret mode, as tests/test_pallas_onehot.py runs it) and in
``"onehot_bf16"`` mode (XLA); the port runs the same map, scan and hint
through its ``match_with_stats``, which on CPU tensors takes K1's plain
version.  All three read the map through bf16 rounding, so only the order of
the beam sums differs: poses agree to 2e-3 (3e-3 with subsampled beams),
solve failures exactly, residuals to rtol 0.05 — that file's tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import HectorConfig as JHectorConfig
from slamnet_tpu.core.scan import Scan as JScan
from slamnet_tpu.models import hector as jhector
from slamnet_tpu.sim import default_field, lidar
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import hector
from slamnet_tpu_torch.ops import _build, match
from slamnet_tpu_torch.replay import pallas_dense_config

SMALL = dict(map_size=160, map_resolution=0.25, num_levels=3,
             estimate_iterations=(7, 4, 4))
TRUTH = np.array([20.0, 20.0, 0.0], np.float32)


def _scan(rng, pose, angles):
    """Noise-free JAX ray cast + the simulator's uniform noise grid from numpy."""
    hit, dist = jax.jit(lidar.field_mod.ray_cast, static_argnums=3)(
        default_field(), jnp.asarray(pose[:2]),
        jnp.asarray(angles + pose[2]), 40.0)
    hit = np.array(hit)
    r = np.where(hit, np.asarray(dist)
                 + rng.integers(-100, 100, angles.shape) / 100.0 * 0.02, 0.0)
    pts = np.stack([r * np.cos(angles), r * np.sin(angles)], -1)
    return pts.astype(np.float32), hit


@pytest.fixture(scope="module")
def boot():
    """A map bootstrapped by the JAX package from 6 scans at the truth, and a
    7th scan to match (all from numpy seed 0)."""
    cfg = JHectorConfig(**SMALL)
    angles = lidar.revolution_angles(400)
    rng = np.random.default_rng(0)
    step = jax.jit(lambda st, pts, v: jhector.update(
        st, JScan(pts, v, jnp.zeros(3, jnp.float32)), TRUTH, cfg,
        map_without_matching=True)[0])
    state = jhector.init(cfg, TRUTH)
    for _ in range(6):
        pts, v = _scan(rng, TRUTH, angles)
        state = step(state, jnp.asarray(pts), jnp.asarray(v))
    pts, v = _scan(rng, TRUTH, angles)
    return np.array(state.maps), pts, v


def _jax_match(maps, pts, v, hint, mode, **over):
    cfg = dataclasses.replace(JHectorConfig(**SMALL), matcher_mode=mode, **over)
    pose, st = jhector.match_with_stats(
        jnp.asarray(maps), JScan(jnp.asarray(pts), jnp.asarray(v),
                                 jnp.zeros(3, jnp.float32)),
        jnp.asarray(hint), cfg)
    return np.asarray(pose), int(st.solve_failures), float(st.residual)


def _port_match(maps, pts, v, hint, **over):
    cfg = pallas_dense_config(**SMALL, **over)
    pose, st = hector.match_with_stats(
        torch.from_numpy(maps), Scan.from_points(pts, v), torch.from_numpy(hint),
        cfg)
    return pose.numpy(), int(st.solve_failures), float(st.residual)


@pytest.mark.parametrize("offset", [(0.2, -0.15, 0.04), (-0.1, 0.12, -0.03),
                                    (0.05, 0.25, 0.06)])
def test_match_plain_matches_jax_pallas_and_onehot_bf16(boot, offset):
    maps, pts, v = boot
    hint = TRUTH + np.asarray(offset, np.float32)
    pose_t, fails_t, res_t = _port_match(maps, pts, v, hint)
    assert np.linalg.norm(pose_t[:2] - TRUTH[:2]) < 0.05
    for mode in ("pallas", "onehot_bf16"):
        pose_j, fails_j, res_j = _jax_match(maps, pts, v, hint, mode)
        np.testing.assert_allclose(pose_t, pose_j, atol=2e-3, err_msg=mode)
        assert fails_t == fails_j == 0, mode
        np.testing.assert_allclose(res_t, res_j, rtol=0.05, err_msg=mode)


def test_match_plain_guards_and_subsample_match_jax(boot):
    maps, pts, v = boot
    over = dict(xy_step_clamp_px=10.0, gn_damping=0.1, match_subsample=4)
    hint = TRUTH + np.asarray([0.15, 0.1, -0.03], np.float32)
    pose_t, fails_t, res_t = _port_match(maps, pts, v, hint, **over)
    assert np.linalg.norm(pose_t[:2] - TRUTH[:2]) < 0.08
    for mode in ("pallas", "onehot_bf16"):
        pose_j, fails_j, res_j = _jax_match(maps, pts, v, hint, mode, **over)
        np.testing.assert_allclose(pose_t, pose_j, atol=3e-3, err_msg=mode)
        assert fails_t == fails_j, mode
        np.testing.assert_allclose(res_t, res_j, rtol=0.05, err_msg=mode)


def test_match_empty_scan_returns_hint(boot):
    maps = boot[0]
    pts = np.zeros((400, 2), np.float32)
    v = np.zeros(400, bool)
    hint = np.asarray([20.0, 20.0, 0.5], np.float32)
    pose_t, fails_t, _ = _port_match(maps, pts, v, hint)
    pose_j, fails_j, _ = _jax_match(maps, pts, v, hint, "pallas")
    np.testing.assert_array_equal(pose_t, hint)
    np.testing.assert_allclose(pose_j, hint, atol=1e-6)
    assert fails_t == fails_j == 15      # every solve fails on an empty H


def test_match_wrapper_takes_plain_version_on_cpu(boot):
    maps, pts, v = boot
    cfg = pallas_dense_config(**SMALL)
    hint = torch.from_numpy(TRUTH + np.float32(0.1))
    args = (torch.from_numpy(maps), torch.from_numpy(pts), torch.from_numpy(v),
            hint, cfg)
    before = match.match.launches
    out = match.match(*args)
    assert match.match.launches == before      # no kernel launched on CPU
    assert out.shape == (6,) and out.dtype == torch.float32
    assert torch.equal(out, match.match_plain(*args))
    with pytest.raises(ValueError, match="early_exit_tol"):
        match.match(*args[:-1], cfg.overlay({"early_exit_tol": 1e-3}))


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device"])
def test_kernel_input_check_refuses(bad):
    # the wrappers check every tensor before a launch (here on CPU tensors,
    # against the CPU device, since the check needs no card)
    maps = torch.zeros(10)
    good = ("maps", maps, torch.float32, (10,))
    _build.check_tensors("K1", maps.device, [good])
    t = {"dtype": maps.double(), "shape": torch.zeros(11),
         "strided": torch.zeros(20)[::2], "device": maps.to("meta")}[bad]
    with pytest.raises(ValueError, match="K1 maps"):
        _build.check_tensors("K1", maps.device, [("maps", t, torch.float32,
                                                  (10,))])


def test_kernel_build_refuses_without_cuda():
    # the CPU test machine has no card: building the kernels must say so
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.build()
