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
