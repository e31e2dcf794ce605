"""The port's denoiser math against the JAX package's, on the CPU in fp32:
LSID (forward on carried-over weights, its 42 reference keys, the weight
bridge's ConvTranspose rule), the pixel losses, the LR staircase, the
SonyA7S2 Kmax lookup and Shot-Noise Augmentation.

Tolerance: rtol 5e-4 / atol 5e-5 (PARITY.md:152) for the network; the
losses, the staircase, Kmax and the deterministic parts of SNA hold to
float32 rounding. The Poisson draw of SNA cannot match jax.random.poisson
draw for draw, so it is held by its lattice and its moments."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.models import losses as jlosses
from noisediff_tpu.models.lsid import LSID as JaxLSID
from noisediff_tpu.ops import sna as jsna
from noisediff_tpu.train.schedules import denoising_staircase_lr as jax_staircase
from noisediff_tpu.train.torch_import import import_torch_params
from noisediff_tpu_torch.models import LSID, define_network
from noisediff_tpu_torch.models import losses
from noisediff_tpu_torch.ops import sna
from noisediff_tpu_torch.train.schedules import denoising_staircase_lr
from noisediff_tpu_torch.weights import jax_params_to_state_dict, load_into
from torch_port_util import ATOL, RTOL, load_port, random_params

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "lsid_torch_keys.json")


def _jax_lsid(width, h, w, seed=0):
    model = JaxLSID(lane_fold=False, base_width=width)
    return model, random_params(model, jnp.zeros((1, h, w, 4)), seed=seed)


@pytest.mark.parametrize("width,h,w", [(8, 32, 32), (8, 33, 35), (32, 32, 32), (32, 33, 35)])
def test_lsid_forward_matches_jax(width, h, w):
    """Carried-over weights, odd sizes included: the ceil-mode pool, the
    crop of each upsampled map, the [upsampled, skip] concat order and the
    up6..up9 flip of the weight bridge all show in the output."""
    model, params = _jax_lsid(width, h, w)
    x = np.random.default_rng(1).standard_normal((2, h, w, 4)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, x))
    got = load_port(LSID(base_width=width), params)(torch.from_numpy(x))
    assert got.shape == (2, h, w, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_lsid_keys_shapes_and_param_count():
    with open(FIXTURE) as f:
        ref = json.load(f)
    model = LSID()
    assert {k: list(v.shape) for k, v in model.state_dict().items()} == ref
    assert len(ref) == 42
    assert sum(p.numel() for p in model.parameters()) == 7_760_004


def test_lsid_init_is_he_fanout():
    """Zero biases; weights N(0, 2 / (k * k * out_channels)), the
    ConvTranspose's out_channels being its weight's dim 1 (checked on the
    tensors with more than 4096 entries)."""
    torch.manual_seed(0)
    model = LSID()
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
        elif p.numel() > 4096:
            k, out = p.shape[-1], p.shape[1] if name.startswith("up") else p.shape[0]
            assert abs(float(p.detach().std()) / np.sqrt(2.0 / (k * k * out)) - 1) < 0.1, name


def test_bridge_round_trip_and_reference_pth(tmp_path):
    """JAX tree -> state_dict -> strict load; the port's .pth (reference
    layout) goes back through the JAX package's importer to the same tree,
    so both directions agree on the ConvTranspose layout."""
    _, params = _jax_lsid(8, 32, 32, seed=3)
    sd = jax_params_to_state_dict(params)
    assert len(sd) == 42
    # torch ConvTranspose2d: W[c, o, di, dj] = K_flax[1 - di, 1 - dj, c, o]
    k = np.asarray(params["up6"]["kernel"])
    np.testing.assert_array_equal(sd["up6.weight"].numpy()[:, :, 0, 1], k[1, 0])
    model = LSID(base_width=8)
    model.load_state_dict(sd, strict=True)
    path = str(tmp_path / "net_final.pth")
    torch.save({"module." + k: v for k, v in model.state_dict().items()}, path)
    again = LSID(base_width=8)
    load_into(again, path)
    like = jax.tree.map(np.zeros_like, params)
    back = import_torch_params(like, {k: v.numpy() for k, v in again.state_dict().items()},
                               strict=True)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_define_network_lsid():
    class Cfg:
        lsid_width = 8

    model = define_network("LSID", Cfg(), dtype=torch.bfloat16)
    assert isinstance(model, LSID) and model.dtype == torch.bfloat16
    assert model.conv1_1.out_channels == 8
    x = torch.rand(1, 16, 16, 4)
    assert model(x).dtype == torch.bfloat16
    assert model.conv1_1.weight.dtype == torch.float32


@pytest.mark.parametrize("name", ["l1_loss", "mse_loss", "charbonnier_loss"])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("weighted", [False, True])
def test_pixel_losses_match_jax(name, reduction, weighted):
    rng = np.random.default_rng(4)
    pred, target, weight = (rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
                            for _ in range(3))
    w = weight if weighted else None
    want = np.asarray(getattr(jlosses, name)(pred, target, weight=w, reduction=reduction,
                                             loss_weight=0.7))
    got = getattr(losses, name)(torch.from_numpy(pred), torch.from_numpy(target),
                                weight=None if w is None else torch.from_numpy(w),
                                reduction=reduction, loss_weight=0.7)
    # float32, summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_tv_loss_matches_jax(weighted):
    rng = np.random.default_rng(5)
    pred, weight = (rng.standard_normal((2, 7, 6, 4)).astype(np.float32) for _ in range(2))
    w = weight if weighted else None
    want = float(jlosses.weighted_tv_loss(pred, weight=w, loss_weight=1.5))
    got = float(losses.weighted_tv_loss(torch.from_numpy(pred),
                                        weight=None if w is None else torch.from_numpy(w),
                                        loss_weight=1.5))
    assert got == pytest.approx(want, rel=1e-5)


def test_losses_reject_unknown_reduction():
    with pytest.raises(ValueError, match="reduction"):
        losses.l1_loss(torch.zeros(1), torch.zeros(1), reduction="avg")


@pytest.mark.parametrize("max_iter", [13, 10, 500])
def test_staircase_lr_at_its_boundaries(max_iter):
    """/2 strictly after max_iter // 2, 1e-5 strictly after int(0.8 max_iter)."""
    half, late = max_iter // 2, int(max_iter * 0.8)
    for epoch in sorted({0, half - 1, half, half + 1, late - 1, late, late + 1, max_iter - 1}):
        assert denoising_staircase_lr(2e-4, max_iter, epoch) == jax_staircase(2e-4, max_iter,
                                                                              epoch)
    assert denoising_staircase_lr(2e-4, max_iter, half) == 2e-4
    assert denoising_staircase_lr(2e-4, max_iter, half + 1) == 1e-4
    assert denoising_staircase_lr(2e-4, max_iter, late) == (1e-4 if late > half else 2e-4)
    assert denoising_staircase_lr(2e-4, max_iter, late + 1) == 1e-5


def test_kmax_for_iso_matches_jax():
    """Table ISOs (first, middle, last) and off-table ones (between rows,
    below and above the table), with a jitter."""
    iso = np.array([50, 800, 25600, 3000, 30, 30000, 1601], np.int32)
    jitter = np.linspace(-0.01, 0.01, len(iso)).astype(np.float32)
    want = np.asarray(jsna.kmax_for_iso(jnp.asarray(iso), jnp.asarray(jitter)))
    got = sna.kmax_for_iso(torch.from_numpy(iso), torch.from_numpy(jitter)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[3], (0.0009546 * 3000 - 0.00193) * (1 + jitter[3]),
                               rtol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_aug_wb_post_processing_matches_jax(seed):
    """Given JAX's own draws (r, the gate, three normals), the port's gains
    equal those of jax sample_aug_wb."""
    key = jax.random.PRNGKey(seed)
    b = 16
    k_r, k_gate, k_g, k_rr, k_bb = jax.random.split(key, 5)
    draws = [jax.random.randint(k_r, (), 0, 2).astype(jnp.float32) * 0.25 + 0.25,
             jax.random.randint(k_gate, (), 0, 4) != 0,
             jax.random.normal(k_g, (b,)), jax.random.normal(k_rr, (b,)),
             jax.random.normal(k_bb, (b,))]
    want = np.asarray(jsna.sample_aug_wb(key, b))
    got = sna.aug_wb_from_draws(*(torch.from_numpy(np.array(d)) for d in draws))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_sample_aug_wb_distribution():
    """One gate and one r per batch: 1/4 of the batches pass through with
    all-zero gains; among the others r = 0.25 and 0.5 each half the time
    (read from the batch's mean positive green gain, r * 0.798); the
    greens are equal, no gain is negative, each stays under 4 r."""
    g = torch.Generator().manual_seed(0)
    n, b = 400, 256
    zero, half = 0, 0
    for _ in range(n):
        wb = sna.sample_aug_wb(g, b)
        assert wb.shape == (b, 4)
        assert torch.equal(wb[:, 1], wb[:, 3]) and bool((wb >= 0).all())
        if not wb.any():
            zero += 1
            continue
        green = wb[:, 1][wb[:, 1] > 0]
        r = 0.5 if float(green.mean()) > 0.3 else 0.25
        assert float(wb.max()) <= 4 * r + 1e-6
        half += r == 0.5
    aug = n - zero
    # 4 standard errors of each binomial frequency
    assert abs(zero / n - 0.25) < 4 * np.sqrt(0.25 * 0.75 / n)
    assert abs(half / aug - 0.5) < 4 * np.sqrt(0.25 / aug)


def _sna_inputs(b=3, s=24, seed=0):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.0, 0.3, (b, s, s, 4)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.02, clean.shape), 0, 1).astype(np.float32)
    iso = np.array([800, 3200, 100][:b], np.int32)
    ratio = np.array([250.0, 100.0, 300.0][:b], np.float32)
    aug_wb = np.array([[0.5, 0.25, 0.4, 0.25], [0.0, 0.0, 0.0, 0.0],
                       [1.2, 0.1, 0.0, 0.1]][:b], np.float32)
    return noisy, clean, iso, ratio, aug_wb


def test_apply_sna_clean_output_equals_jax():
    noisy, clean, iso, ratio, aug_wb = _sna_inputs()
    _, want = jsna.apply_sna(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in
                                                      (noisy, clean, iso, ratio, aug_wb)))
    g = torch.Generator().manual_seed(1)
    _, got = sna.apply_sna(g, *(torch.from_numpy(a) for a in (noisy, clean, iso, ratio, aug_wb)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_sna_noisy_increment_is_on_the_shot_noise_lattice():
    """noisy gains an integer multiple of K * ratio / (WP - BL) per pixel,
    K from the jitter the call draws first; all-zero gains pass through
    bit for bit."""
    noisy, clean, iso, ratio, aug_wb = _sna_inputs()
    g = torch.Generator().manual_seed(7)
    out, _ = sna.apply_sna(g, *(torch.from_numpy(a) for a in (noisy, clean, iso, ratio, aug_wb)))
    jitter = sna.draw_jitter(torch.Generator().manual_seed(7), 3)
    k = sna.kmax_for_iso(torch.from_numpy(iso), jitter).numpy()
    out = out.numpy()
    np.testing.assert_array_equal(out[1], noisy[1])
    for i in (0, 2):
        unit = k[i] * ratio[i] / (sna.WP - sna.BL)
        steps = (out[i].astype(np.float64) - noisy[i]) / unit
        assert np.abs(steps - np.round(steps)).max() < 1e-2
        assert steps.min() > -1e-2 and steps.max() > 1


def test_apply_sna_poisson_moments():
    """At a fixed lam field the increment's mean is dy and its variance
    unit * dy, within 5 standard errors per channel."""
    b, s = 1, 96
    clean = np.full((b, s, s, 4), 0.2, np.float32)
    noisy = np.zeros_like(clean)
    iso, ratio = np.array([800], np.int32), np.array([100.0], np.float32)
    aug_wb = np.array([[0.5, 0.25, 0.05, 0.25]], np.float32)
    g = torch.Generator().manual_seed(3)
    out, clean2 = sna.apply_sna(g, *(torch.from_numpy(a) for a in
                                     (noisy, clean, iso, ratio, aug_wb)))
    k = sna.kmax_for_iso(torch.from_numpy(iso), sna.draw_jitter(
        torch.Generator().manual_seed(3), 1)).numpy()[0]
    unit = k * ratio[0] / (sna.WP - sna.BL)
    dn = out.numpy()[0].reshape(-1, 4).astype(np.float64)
    dy = (clean2.numpy() - clean)[0, 0, 0].astype(np.float64)
    n = dn.shape[0]
    var = unit * dy
    assert np.all(np.abs(dn.mean(0) - dy) < 5 * np.sqrt(var / n))
    # the sample variance's standard error: var * sqrt(2 / n) (+ the Poisson excess)
    assert np.all(np.abs(dn.var(0) - var) < 5 * var * np.sqrt((2 + unit / dy) / n))
