"""The port's quality metrics (`ops/metrics.py`) against the JAX package's,
on the CPU.

Tolerances: PSNR, SSIM (both protocols), quality_assess and the
illuminance correction within rtol 5e-4 in fp32 (PARITY.md:152; the
filters and sums run in another order), PSNR and skimage SSIM within
1e-5; the numpy image converters equal; the KLD histograms and
divergences within 1e-12 (float64 numpy on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.ops import metrics as J
from noisediff_tpu_torch.ops import metrics as M

RTOL = 5e-4


def _pair(shape, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(37, 41, 4), (16, 16, 1), (64, 48, 3)])
@pytest.mark.parametrize("data_range", [1.0, 0.5])
def test_psnr_and_ssim_match_jax(shape, data_range):
    a, b = _pair(shape, seed=shape[0])
    for name in ("psnr", "ssim"):
        want = float(getattr(J, name)(jnp.asarray(a), jnp.asarray(b), data_range))
        got = getattr(M, name)(torch.from_numpy(a), torch.from_numpy(b), data_range)
        assert got.dtype == torch.float32 and got.ndim == 0
        # tighter than PARITY.md's 5e-4: these sums agree to a few fp32 ulps
        np.testing.assert_allclose(float(got), want, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("win_size", [7, 11])
def test_ssim_window_and_identity(win_size):
    a, b = _pair((40, 40, 2), seed=3)
    want = float(J.ssim(jnp.asarray(a), jnp.asarray(b), win_size=win_size))
    got = float(M.ssim(torch.from_numpy(a), torch.from_numpy(b), win_size=win_size))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert float(M.ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("shape", [(32, 32), (30, 35, 3)])
def test_ssim_matlab_matches_jax(shape):
    a, b = _pair(shape, seed=7, noise=0.1)
    want = float(J.ssim_matlab(jnp.asarray(a * 255), jnp.asarray(b * 255)))
    got = float(M.ssim_matlab(torch.from_numpy(a * 255), torch.from_numpy(b * 255)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_gaussian_kernel_matches_jax():
    np.testing.assert_allclose(M._gaussian_kernel(11, 1.5).numpy(),
                               np.asarray(J._gaussian_kernel(11, 1.5)), rtol=1e-6, atol=1e-9)


def test_quality_assess_matches_jax():
    a, b = _pair((24, 20, 4), seed=9)
    want, got = J.quality_assess(a, b), M.quality_assess(a, b)
    assert set(got) == set(want) == {"PSNR", "SSIM"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    with pytest.raises(NotImplementedError):
        M.quality_assess(a[..., 0], b[..., 0])


@pytest.mark.parametrize("pred_shape,src_shape", [
    ((12, 10, 4), (12, 10, 4)),      # (H, W, C)
    ((3, 12, 10, 4), (3, 12, 10, 4)),  # batched, one source a sample
    ((3, 12, 10, 4), (1, 12, 10, 4)),  # batched against one broadcast source
])
def test_illuminance_correct_matches_jax(pred_shape, src_shape):
    rng = np.random.default_rng(11)
    pred = rng.uniform(-0.1, 1.2, pred_shape).astype(np.float32)  # the clamp shows
    src = rng.uniform(0, 1, src_shape).astype(np.float32)
    src.reshape(-1)[::7] = 1.0  # saturated pixels leave the fit
    want = np.asarray(J.illuminance_correct(jnp.asarray(pred), jnp.asarray(src)))
    got = M.illuminance_correct(torch.from_numpy(pred), torch.from_numpy(src)).numpy()
    assert got.shape == want.shape == pred_shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_psnr_matlab_equals_jax():
    a, b = _pair((10, 10, 3), seed=2)
    assert M.psnr_matlab(a * 255, b * 255) == J.psnr_matlab(a * 255, b * 255)
    assert M.psnr_matlab(a, a) == float("inf")


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("only_y", [True, False])
def test_bgr2ycbcr_equals_jax(dtype, only_y):
    rng = np.random.default_rng(4)
    img = (rng.integers(0, 256, (9, 7, 3)).astype(np.uint8) if dtype == "uint8"
           else rng.uniform(0, 1, (9, 7, 3)).astype(np.float32))
    want, got = J.bgr2ycbcr(img, only_y), M.bgr2ycbcr(img, only_y)
    assert got.dtype == want.dtype == img.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(9, 7), (3, 9, 7), (5, 3, 6, 4), (4, 3, 6, 4), (1, 3, 6, 4)])
@pytest.mark.parametrize("out_type", [np.uint8, np.float32])
def test_tensor2img_equals_jax(shape, out_type):
    """2-D, 3-D, and 4-D grids with n = 5 (not a square: 2 images a row,
    3 rows), n = 4 and a batch of one (squeezed to 3-D)."""
    x = np.random.default_rng(5).uniform(-0.2, 1.2, shape).astype(np.float32)
    want = J.tensor2img(x, out_type=out_type)
    got = M.tensor2img(torch.from_numpy(x), out_type=out_type)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("visualize", [False, True])
@pytest.mark.parametrize("video", [False, True])
def test_tensor2im_equals_jax(visualize, video):
    x = np.random.default_rng(6).uniform(-0.1, 1.3, (2, 4, 5, 6)).astype(np.float32)
    want = J.tensor2im(x, visualize=visualize, video=video)
    got = M.tensor2im(torch.from_numpy(x), visualize=visualize, video=video)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_histogram_and_kl_divergences_equal_jax():
    rng = np.random.default_rng(8)
    real, synth = rng.normal(0, 0.03, 20000), rng.normal(0.002, 0.035, 15000)
    for kw in ({}, {"left_edge": -0.1, "right_edge": 0.1, "n_bins": 50}):
        (hp, cp), (hj, cj) = M.get_histogram(real, **kw), J.get_histogram(real, **kw)
        np.testing.assert_allclose(hp, hj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(cp, cj, rtol=0, atol=1e-12)
    edges = np.concatenate([[-1000.0], np.linspace(-0.1, 0.1, 201), [1000.0]])
    p, _ = M.get_histogram(real, bin_edges=edges)
    q, _ = M.get_histogram(synth, bin_edges=edges)
    q[3] = np.nan  # dropped by both
    for name in ("kl_div_forward", "kl_div_inverse", "kl_div_3"):
        np.testing.assert_allclose(getattr(M, name)(p, q), getattr(J, name)(p, q), rtol=0,
                                   atol=1e-12, err_msg=name)
    got, want = M.noise_kld(real, synth), J.noise_kld(real, synth)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert all(v >= 0 for v in got)
    assert M.noise_kld(real, real) == (0.0, 0.0, 0.0)
