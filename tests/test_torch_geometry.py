"""slamnet_tpu_torch.core.geometry against slamnet_tpu.core.geometry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamnet_tpu.core import geometry as jg
from slamnet_tpu_torch.core import geometry as tg

HALFWAY = np.array([-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 0.49999997,
                    -0.49999997, 0.50000006, 2.5000002, 1e6 + 0.5, -7.5,
                    0.0, -0.0], np.float32)


def test_dotnet_round_half_to_even_bit_exact():
    want = np.asarray(jg.dotnet_round(jnp.asarray(HALFWAY)))
    got = tg.dotnet_round(torch.from_numpy(HALFWAY)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # banker's rounding, not floor(x + 0.5)
    np.testing.assert_array_equal(got[:8], [-4, -2, -2, 0, 0, 2, 2, 4])


def test_csharp_trunc_toward_zero_bit_exact():
    x = np.concatenate([HALFWAY, np.array([-1.7, -0.3, 0.3, 1.9], np.float32)])
    want = np.asarray(jg.csharp_trunc(jnp.asarray(x)))
    got = tg.csharp_trunc(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["normalize_angle_pos", "normalize_angle"])
def test_angle_wrap_matches_jax(fn):
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(-40.0, 40.0, 2000),
                        np.pi * np.arange(-8, 9)]).astype(np.float32)
    want = np.asarray(getattr(jg, fn)(jnp.asarray(a)))
    got = getattr(tg, fn)(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn,span", [("rad_diff", 20.0), ("deg_diff", 720.0)])
def test_angle_difference_matches_jax(fn, span):
    rng = np.random.default_rng(2)
    a = rng.uniform(-span, span, 2000).astype(np.float32)
    b = rng.uniform(-span, span, 2000).astype(np.float32)
    want = np.asarray(getattr(jg, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tg, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _poses(seed, n=500):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-30.0, 30.0, n), rng.uniform(-30.0, 30.0, n),
                     rng.uniform(-7.0, 7.0, n)], -1).astype(np.float32)


POSE_FNS = {
    "rot2": lambda m, a, b, p: m.rot2(a[:, 2]),
    "transform_points": lambda m, a, b, p: m.transform_points(p, a),
    "pose_compose": lambda m, a, b, p: m.pose_compose(a, b),
    "pose_inverse": lambda m, a, b, p: m.pose_inverse(a),
    "pose_between": lambda m, a, b, p: m.pose_between(a, b),
}


@pytest.mark.parametrize("fn", sorted(POSE_FNS))
def test_pose_functions_match_jax(fn):
    # the SE(2) helpers of the pose graph, on 500 random poses (and 7
    # points each for transform_points), against the JAX package's
    a, b = _poses(3), _poses(4)
    p = np.random.default_rng(5).uniform(-20.0, 20.0, (500, 7, 2)).astype(
        np.float32)
    want = np.asarray(POSE_FNS[fn](jg, jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(p)))
    got = POSE_FNS[fn](tg, torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(p)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-6)
    if fn == "pose_between":
        # b expressed in a's frame, composed back onto a, is b
        back = tg.pose_compose(torch.from_numpy(a), torch.from_numpy(got))
        np.testing.assert_allclose(back[:, :2].numpy(), b[:, :2], atol=1e-4)


def test_line_and_angle_helpers_match_jax():
    rng = np.random.default_rng(4)
    p, a, b = (rng.normal(0, 5, (50, 2)).astype(np.float32) for _ in range(3))
    b[0] = a[0]                               # a degenerate line
    for fn in ("find_position_on_line", "point_to_line_distance"):
        want = np.asarray(getattr(jg, fn)(p, a, b))
        got = getattr(tg, fn)(*(torch.from_numpy(x) for x in (p, a, b)))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    x = rng.uniform(-400.0, 400.0, 100).astype(np.float32)
    for fn in ("deg_to_rad", "rad_to_deg"):
        np.testing.assert_allclose(getattr(tg, fn)(torch.from_numpy(x)).numpy(),
                                   np.asarray(getattr(jg, fn)(x)), rtol=1e-6)
    np.testing.assert_array_equal(tg.limit(torch.from_numpy(x), -10.0,
                                           25.0).numpy(),
                                  np.asarray(jg.limit(x, -10.0, 25.0)))
    r, th = np.abs(x[:20]), x[20:40] / 50.0
    np.testing.assert_allclose(
        tg.polar_to_cartesian(torch.from_numpy(r), torch.from_numpy(th)).numpy(),
        np.asarray(jg.polar_to_cartesian(r, th)), atol=1e-4, rtol=1e-6)

