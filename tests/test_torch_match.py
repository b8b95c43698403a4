"""K1's and K3's plain version (slamnet_tpu_torch.ops.match) against the JAX
matcher.

K1: the JAX side runs ``hector.match_with_stats`` in ``"pallas"`` mode (the
TPU kernel K1 in interpret mode, as tests/test_pallas_onehot.py runs it) and
in ``"onehot_bf16"`` mode (XLA); the port runs the same map, scan and hint
through its ``match_with_stats``, which on CPU tensors takes K1's plain
version.  All three read the map through bf16 rounding, so only the order of
the beam sums differs: poses agree to 2e-3 (3e-3 with subsampled beams),
solve failures exactly, residuals to rtol 0.05 — that file's tolerances.

K3: the port's ``"gather"`` mode reads the f32 table, as JAX's ``"gather"``
(XLA) does; the same 11 sums in another order, so poses agree to 1e-4 and
the in-map fraction exactly.  Against the TPU kernel K3 itself
(``pallas_gn.match_pallas`` in interpret mode, a per-beam sequential sum,
and no clamps, heading wrap or fallback) at a pose where those do nothing:
2e-3, as tests/test_pallas_gn.py:49 holds it to the XLA matcher.
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
from slamnet_tpu.ops import pallas_gn
from slamnet_tpu.sim import default_field, lidar
from slamnet_tpu_torch.core.scan import Scan
from slamnet_tpu_torch.models import fleet, hector
from slamnet_tpu_torch.ops import _build, match
from slamnet_tpu_torch.replay import fixed_config, pallas_dense_config

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


def _jax_match(maps, pts, v, hint, mode, stats=False, **over):
    cfg = dataclasses.replace(JHectorConfig(**SMALL), matcher_mode=mode, **over)
    pose, st = jhector.match_with_stats(
        jnp.asarray(maps), JScan(jnp.asarray(pts), jnp.asarray(v),
                                 jnp.zeros(3, jnp.float32)),
        jnp.asarray(hint), cfg)
    if stats:
        return np.asarray(pose), st
    return np.asarray(pose), int(st.solve_failures), float(st.residual)


def _port_match(maps, pts, v, hint, stats=False, **over):
    cfg = pallas_dense_config(**SMALL, **over)
    pose, st = hector.match_with_stats(
        torch.from_numpy(maps), Scan.from_points(pts, v), torch.from_numpy(hint),
        cfg)
    if stats:
        return pose.numpy(), st
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
    assert out.shape == (match.OUT,) and out.dtype == torch.float32
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


@pytest.mark.parametrize("offset", [(0.2, -0.15, 0.04), (-0.1, 0.12, -0.03),
                                    (0.05, 0.25, 0.06)])
def test_k3_plain_matches_jax_gather(boot, offset):
    maps, pts, v = boot
    hint = TRUTH + np.asarray(offset, np.float32)
    pose_t, st_t = _port_match(maps, pts, v, hint, True, matcher_mode="gather")
    pose_j, st_j = _jax_match(maps, pts, v, hint, "gather", True)
    assert np.linalg.norm(pose_t[:2] - TRUTH[:2]) < 0.05
    np.testing.assert_allclose(pose_t, pose_j, atol=1e-4)
    assert int(st_t.solve_failures) == int(st_j.solve_failures) == 0
    assert st_t.iterations == int(st_j.iterations) == 15
    np.testing.assert_allclose(float(st_t.residual), float(st_j.residual),
                               rtol=1e-3)
    assert float(st_t.in_map_frac) == float(st_j.in_map_frac)


def test_k3_plain_guards_and_subsample_match_jax(boot):
    maps, pts, v = boot
    over = dict(xy_step_clamp_px=10.0, gn_damping=0.1, match_subsample=4)
    hint = TRUTH + np.asarray([0.15, 0.1, -0.03], np.float32)
    pose_t, fails_t, res_t = _port_match(maps, pts, v, hint,
                                         matcher_mode="gather", **over)
    pose_j, fails_j, res_j = _jax_match(maps, pts, v, hint, "gather", **over)
    assert np.linalg.norm(pose_t[:2] - TRUTH[:2]) < 0.08
    np.testing.assert_allclose(pose_t, pose_j, atol=1e-4)
    assert fails_t == fails_j
    np.testing.assert_allclose(res_t, res_j, rtol=1e-3)


def test_k3_plain_matches_tpu_kernel_k3(boot):
    # pallas_gn.match_pallas (K3's TPU kernel, interpret mode) on 128 of the
    # beams, lane-padded as its caller must: a pose where the heading wrap,
    # the empty-scan fallback and the (absent) clamps do nothing
    maps, pts, v = boot
    sub_pts = np.ascontiguousarray(pts[:384:3])
    sub_v = np.ascontiguousarray(v[:384:3])
    hint = TRUTH + np.asarray([0.12, -0.1, 0.03], np.float32)
    cfg = JHectorConfig(**SMALL)
    want = np.asarray(pallas_gn.match_pallas(
        jnp.asarray(maps), cfg, jnp.asarray(hint), jnp.asarray(sub_pts[:, 0]),
        jnp.asarray(sub_pts[:, 1]), jnp.asarray(sub_v), interpret=True))
    got, fails, _ = _port_match(maps, sub_pts, sub_v, hint,
                                matcher_mode="gather")
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert fails == 0 and abs(got[2]) < 0.5


def test_onehot_highest_is_gather(boot):
    # JAX documents onehot_highest as bit-identical to gather
    # (core/config.py:153): the port runs K3 for both
    maps, pts, v = boot
    hint = TRUTH + np.asarray([0.1, 0.1, -0.02], np.float32)
    pose_g, st_g = _port_match(maps, pts, v, hint, True, matcher_mode="gather")
    pose_o, st_o = _port_match(maps, pts, v, hint, True,
                               matcher_mode="onehot_highest")
    np.testing.assert_array_equal(pose_g, pose_o)
    assert float(st_g.residual) == float(st_o.residual)
    pose_j, _, _ = _jax_match(maps, pts, v, hint, "onehot_highest")
    np.testing.assert_allclose(pose_o, pose_j, atol=1e-4)


@pytest.mark.parametrize("mode", ["gather", "onehot_bf16", "pallas"])
def test_empty_scan_rule_follows_the_jax_mode(boot, mode):
    # valid beams only at indices the subsample skips: the XLA modes fall
    # back to the hint only when the FULL scan is empty (hector.py:195,254),
    # so they return the GN estimate, the hint with its heading wrapped;
    # K1 ("pallas") tests the subsampled beams and returns the hint itself
    maps, pts, _ = boot
    v = np.arange(len(pts)) % 4 != 0
    hint = np.asarray([20.0, 20.0, 4.0], np.float32)
    got, fails, _ = _port_match(maps, pts, v, hint, matcher_mode=mode,
                                match_subsample=4)
    want, fails_j, _ = _jax_match(maps, pts, v, hint, mode, match_subsample=4)
    assert fails == fails_j == 15             # every solve fails on an empty H
    np.testing.assert_allclose(got, want, atol=1e-6)
    heading = hint[2] if mode == "pallas" else hint[2] - 2 * np.pi
    np.testing.assert_allclose(got, [20.0, 20.0, heading], atol=1e-5)


def _k3_refusals():
    cfg = fixed_config(**SMALL)
    c = cfg.total_cells
    maps, pts = torch.zeros(c), torch.zeros(400, 2)
    v, h = torch.ones(400, dtype=torch.bool), torch.zeros(3)
    return {
        # K3 takes the early exit; K1 under "pallas" refuses it, as JAX does
        "early_exit": (ValueError, "K1 under matcher_mode='pallas'",
                       lambda: match.match(maps, pts, v, h, cfg.overlay(
                           {"early_exit_tol": 1e-3,
                            "matcher_mode": "pallas"}))),
        "offset": (ValueError, "K3 needs cfg.offset", lambda: match.match(
            maps, pts, v, h, cfg.overlay({"offset": (1.0, 0.0)}))),
        "mode": (ValueError, "no match kernel", lambda: match.match(
            maps, pts, v, h, cfg.overlay({"matcher_mode": "onehot"}))),
        "points_dtype": (ValueError, "K3 points", lambda: match.match(
            maps, pts.double(), v, h, cfg)),
        "valid_shape": (ValueError, "K3 valid", lambda: match.match(
            maps, pts, v[:-1], h, cfg)),
        "hint_strided": (ValueError, "K3 hint", lambda: match.match(
            maps, pts, v, torch.zeros(6)[::2], cfg)),
        "maps_size": (ValueError, "K3 maps", lambda: match.match(
            maps[:-1], pts, v, h, cfg)),
        "batch_hints": (ValueError, "K3 batch hints", lambda:
                        match.match_batch(torch.zeros(2 * c),
                                          torch.zeros(2, 400, 2),
                                          torch.ones(2, 400, dtype=torch.bool),
                                          h, cfg)),
        # the fleet takes the batch-wide exit under K3's and K1's
        # onehot_bf16 tables; the model refuses it under "pallas" (as JAX's
        # fleet does, fleet.py:89-92), and K6 refuses it at g_pack > 1
        "model_mode": (ValueError, "early_exit_tol", lambda:
                       fleet.init_fleet(cfg.overlay({"early_exit_tol": 1e-3,
                                                     "matcher_mode": "pallas"}),
                                        torch.zeros(2, 3), device="cpu")),
        "batch_early_exit": (ValueError, "batch-wide early exit", lambda:
                             match.match_packed(
                                 torch.zeros(2 * c), torch.zeros(2, 400, 2),
                                 torch.ones(2, 400, dtype=torch.bool),
                                 torch.zeros(2, 3),
                                 cfg.overlay({"early_exit_tol": 1e-3}), 2)),
    }


@pytest.mark.parametrize("case", sorted(_k3_refusals()))
def test_k3_wrappers_refuse(case):
    # the K3 wrappers check every input on any device before choosing a path
    exc, msg, call = _k3_refusals()[case]
    with pytest.raises(exc, match=msg):
        call()


EXIT = dict(early_exit_tol=1e-3)


@pytest.mark.parametrize("offset", [(0.2, -0.15, 0.04), (-0.1, 0.12, -0.03),
                                    (0.05, 0.25, 0.06)])
@pytest.mark.parametrize("mode", ["gather", "onehot_highest"])
def test_k3_plain_early_exit_matches_jax(boot, offset, mode):
    # JAX's per-level while loop (hector.py:227-244) against the port's K3
    # plain version with the exit: the same pose to 1e-5, the same count of
    # iterations run, fewer than the fixed 15
    maps, pts, v = boot
    hint = TRUTH + np.asarray(offset, np.float32)
    pose_t, st_t = _port_match(maps, pts, v, hint, True, matcher_mode=mode,
                               **EXIT)
    pose_j, st_j = _jax_match(maps, pts, v, hint, mode, True, **EXIT)
    np.testing.assert_allclose(pose_t, pose_j, atol=1e-5)
    assert st_t.iterations.dtype == torch.int32
    assert int(st_t.iterations) == int(st_j.iterations) < 15
    assert int(st_t.solve_failures) == int(st_j.solve_failures) == 0
    np.testing.assert_allclose(float(st_t.residual), float(st_j.residual),
                               rtol=1e-3)


def _while_loop_iterations(maps, pts, v, hint, cfg):
    """The iterations JAX's while loop runs, counted by a Python loop of
    single plain GN iterations on the bf16-rounded table."""
    from slamnet_tpu_torch.core.geometry import normalize_angle
    from slamnet_tpu_torch.ops.gn import _gn_coords, _gn_tail
    table = torch.from_numpy(maps).to(torch.bfloat16).to(torch.float32)
    X, Y = torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1])
    V = torch.from_numpy(v)
    pose = torch.from_numpy(hint)
    total = 0
    for level in range(cfg.num_levels - 1, -1, -1):
        w, off = cfg.level_sizes[level], cfg.level_offsets[level]
        scale = 1.0 / cfg.level_resolutions[level]
        est = torch.stack([pose[0] * scale, pose[1] * scale, pose[2]])
        i, moved2 = 0, float("inf")
        while i < cfg.estimate_iterations[level] and moved2 > 1e-6:
            sr, cr, mx, my, ok, xi, yi = _gn_coords(w, scale, est, X, Y, V)
            base = off + (yi * w + xi).long()
            vals = torch.sigmoid(table[torch.stack([base, base + 1, base + w,
                                                    base + w + 1])])
            new = _gn_tail(vals, mx, my, xi, yi, ok, X, Y, sr, cr, est,
                           cfg.deriv_clamp, cfg.xy_step_clamp_px,
                           cfg.gn_damping)[0]
            d = new - est
            moved2 = float(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            est, i = new, i + 1
        total += i
        pose = torch.stack([est[0] / scale, est[1] / scale,
                            normalize_angle(est[2])])
    return total, pose.numpy()


@pytest.mark.parametrize("offset", [(0.2, -0.15, 0.04), (-0.1, 0.12, -0.03),
                                    (0.05, 0.25, 0.06)])
def test_k1_table_plain_early_exit_matches_jax_onehot_bf16(boot, offset):
    # K1's table (the port's onehot_bf16) with the exit: JAX's onehot_bf16
    # rounds its table another way (up to 2e-3 apart, test_torch_fleet.py),
    # so the pose is held to 2e-3; the iteration count to a while loop of
    # single plain iterations on the same bf16-rounded table
    maps, pts, v = boot
    hint = TRUTH + np.asarray(offset, np.float32)
    pose_t, st_t = _port_match(maps, pts, v, hint, True,
                               matcher_mode="onehot_bf16", **EXIT)
    pose_j, st_j = _jax_match(maps, pts, v, hint, "onehot_bf16", True, **EXIT)
    np.testing.assert_allclose(pose_t, pose_j, atol=2e-3)
    n, pose_w = _while_loop_iterations(maps, pts, v, hint,
                                       pallas_dense_config(**SMALL))
    assert int(st_t.iterations) == n < 15
    np.testing.assert_array_equal(pose_t, pose_w)
