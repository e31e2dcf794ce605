"""The port's noise estimation (`ops/noise_estimation.py`) against the JAX
package's, on the CPU.

Tolerances: the window statistics within rtol 5e-4 (PARITY.md:152; box
sums in another order, with an absolute floor of 1e-6 for the std, a
difference of squares that is ~0 in flat windows); the regressions, which
read those statistics, within 1e-4 of the JAX fit; the KL divergence
within rtol 5e-4; the value-based estimates (numpy and scipy on the same
arrays on both sides) equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.ops import noise_estimation as J
from noisediff_tpu_torch.ops import noise_estimation as N

RTOL = 5e-4


def _field(shape, seed=0):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0.05, 0.8, shape).astype(np.float32)
    return (mu + rng.normal(0, 1, shape) * (0.3 * mu + 0.01)).astype(np.float32)


@pytest.mark.parametrize("shape,k", [((1, 6, 7, 2), 3), ((2, 17, 13, 4), 3), ((1, 12, 9, 1), 5)])
def test_sliding_window_stats_match_jax(shape, k):
    x = _field(shape, seed=k)
    js, jm = J.sliding_window_stats(jnp.asarray(x), k)
    ps, pm = N.sliding_window_stats(torch.from_numpy(x), k)
    assert ps.shape == pm.shape == (shape[0], shape[1] * shape[2], shape[3])
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL, atol=1e-6)


def test_poisson_lambda_by_patch_matches_jax():
    x = _field((2, 32, 40, 3), seed=1)
    (js, ji), (ps, pi) = (J.compute_poisson_lambda_by_patch(jnp.asarray(x)),
                          N.compute_poisson_lambda_by_patch(torch.from_numpy(x)))
    assert ps.shape == pi.shape == (2, 3)
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pi, ji, rtol=0, atol=1e-4)


def test_theil_sen_equals_jax():
    x = np.linspace(0, 1, 50)
    y = 2.0 * x + 0.1
    y[::10] += 5.0
    assert N.theil_sen(x, y) == J.theil_sen(x, y)


@pytest.mark.parametrize("shape", [(40, 30, 4), (160, 130, 1)])
def test_poisson_lambda_single_image_matches_jax(shape):
    """(160, 130, 1) has 20800 windows: both sides subsample 20000 of them
    with np.random.default_rng(0)."""
    x = _field(shape, seed=2)
    want = J.compute_poisson_lambda_single_image(jnp.asarray(x))
    got = N.compute_poisson_lambda_single_image(torch.from_numpy(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(64,), (3, 5, 7)])
def test_kl_divergence_matches_jax(shape):
    rng = np.random.default_rng(3)
    a, b = rng.normal(0, 1, shape).astype(np.float32), rng.normal(0, 2, shape).astype(np.float32)
    want = float(J.kl_divergence(jnp.asarray(a), jnp.asarray(b)))
    got = N.kl_divergence(torch.from_numpy(a), torch.from_numpy(b))
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    assert float(N.kl_divergence(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(
        0.0, abs=1e-7)


def _value_pairs(seed):
    rng = np.random.default_rng(seed)
    clean = rng.choice(np.linspace(0.01, 0.5, 12), size=(40, 40)).astype(np.float64)
    noisy = clean + rng.normal(0, 1, clean.shape) * np.sqrt(0.02 * clean)
    return clean, noisy


def test_value_based_lambda_equals_jax():
    clean, noisy = _value_pairs(4)
    assert N.get_poisson_lambda(clean, noisy) == J.get_poisson_lambda(clean, noisy)
    # every value seen once: no std to fit, (0, 0) on both sides
    once = np.arange(16, dtype=np.float64).reshape(4, 4) * 0.01
    assert N.get_poisson_lambda(once, once) == J.get_poisson_lambda(once, once) == (0.0, 0.0)


def test_accumulate_and_regress_equal_jax():
    acc_p, acc_j = {}, {}
    for seed in (5, 6):
        clean, noisy = _value_pairs(seed)
        N.accumulate_value_stats(clean, noisy, acc_p)
        J.accumulate_value_stats(clean, noisy, acc_j)
    assert acc_p == acc_j
    assert N.regress_value_stats(acc_p) == J.regress_value_stats(acc_j)
