"""The port's training GroupNorm route against the JAX GroupNorm under
gn_train_trace, on the CPU.

The JAX side runs with NOISEDIFF_GN_STATS=pallas-interpret, so its
coefficients come from the gn_stats Pallas kernel and its affine backward
from gn_grad_stats, both in interpret mode; the port's module in training
mode runs the same two autograd Functions over the kernels' plain
versions. The forward, the input gradient, both parameter gradients and
the FiLM gradients agree at the port's fp32 bound (rtol 5e-4, PARITY.md:152).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.models import blocks as jb
from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter
from noisediff_tpu_torch.models import blocks as pb

from torch_port_util import ATOL, RTOL, cl_to_nhwc, nhwc_to_cl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several test workers on one CPU; torch's own
    thread pool in each of them oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("film", ["none", "per_sample", "per_pixel"])
@pytest.mark.parametrize("c,groups", [(16, 4), (32, 8)])
def test_train_groupnorm_matches_jax_vjp(monkeypatch, film, c, groups):
    monkeypatch.setenv("NOISEDIFF_GN_STATS", "pallas-interpret")
    rng = np.random.default_rng(c + groups)
    x = (2 * rng.standard_normal((2, 8, 8, c)) + 0.5).astype(np.float32)
    ss = None
    if film == "per_sample":
        ss = tuple((0.3 * rng.standard_normal((2, 1, 1, c))).astype(np.float32) for _ in range(2))
    elif film == "per_pixel":
        ss = tuple((0.3 * rng.standard_normal((2, 8, 8, c))).astype(np.float32) for _ in range(2))
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    gy = rng.standard_normal((2, 8, 8, c)).astype(np.float32)

    module = jb.GroupNorm(groups=groups)
    params = {"params": {"norm": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}}
    jss = None if ss is None else tuple(jnp.asarray(a) for a in ss)

    def f(pp, xx, sss):
        with jb.gn_train_trace():
            return module.apply(pp, xx, sss)

    y, vjp = jax.vjp(f, params, jnp.asarray(x), jss)
    gp, gx, gss = vjp(jnp.asarray(gy))

    pm = pb.GroupNorm(c, groups).train()
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(scale))
        pm.bias.copy_(torch.from_numpy(bias))
    xt = nhwc_to_cl(x).requires_grad_(True)
    tss = None if ss is None else tuple(nhwc_to_cl(a).requires_grad_(True) for a in ss)
    yt = pm(xt, tss)
    yt.backward(nhwc_to_cl(gy))

    np.testing.assert_allclose(cl_to_nhwc(yt), np.asarray(y), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cl_to_nhwc(xt.grad), np.asarray(gx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pm.weight.grad.numpy(), np.asarray(gp["params"]["norm"]["scale"]),
                               rtol=RTOL, atol=ATOL * 10)
    np.testing.assert_allclose(pm.bias.grad.numpy(), np.asarray(gp["params"]["norm"]["bias"]),
                               rtol=RTOL, atol=ATOL * 10)
    if ss is not None:
        for got, want in zip(tss, gss):
            np.testing.assert_allclose(cl_to_nhwc(got.grad), np.asarray(want).reshape(
                cl_to_nhwc(got.grad).shape), rtol=RTOL, atol=ATOL * 10)


def test_eval_keeps_the_groupnorm_silu_route():
    """eval() routes a per-sample FiLM through the groupnorm_silu wrapper;
    train() through gn_stats; both compute the same forward."""
    rng = np.random.default_rng(0)
    x = nhwc_to_cl((rng.standard_normal((2, 8, 8, 16))).astype(np.float32))
    ss = tuple(torch.from_numpy((0.3 * rng.standard_normal((2, 16, 1, 1))).astype(np.float32))
               for _ in range(2))
    m = pb.GroupNorm(16, 4)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5)
        y_eval = m.eval()(x, ss)
        y_train = m.train()(x, ss)
    torch.testing.assert_close(y_train, y_eval, rtol=1e-5, atol=1e-6)


def test_training_step_calls_per_model(monkeypatch):
    """One training forward and backward of NoiseDiffNet calls gn_stats and
    gn_grad_stats 44 times each (every GroupNorm, the two per-pixel-FiLM
    ones included), the attn_tail forward and backward 9 times each, the
    dual head once and the groupnorm_silu kernel never: the per-step counts
    chip_smoke.py checks on the card."""
    from noisediff_tpu_torch.models import noisediff_net

    calls = {}

    def counting(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    for name in ("gn_stats", "gn_grad_stats", "fused_attn_tail", "fused_groupnorm_film_silu"):
        counting(pb, name)
    counting(noisediff_net, "fused_dual_head")

    torch.manual_seed(0)
    model = NoiseDiffNet(dim=8).train()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(np.float32))
    cond = {"clean_img": torch.rand(2, 16, 16, 4), "position": torch.rand(2, 16, 16, 2),
            "iso_ratio_idx": torch.tensor([3, 24])}
    model(x, torch.tensor([5, 900]), cond).square().mean().backward()
    assert calls == {"gn_stats": 44, "gn_grad_stats": 44, "fused_attn_tail": 9,
                     "fused_dual_head": 1}
    # every parameter the forward reads gets a finite gradient; the
    # attention's query and key weights exist for the checkpoint and the
    # one-token path never reads them (their JAX gradient is zero)
    unread = [n for n, _ in model.named_parameters() if is_unread_parameter(n)]
    assert len(unread) == 9 * 4  # norm1 weight and bias, to_q, to_k per AttnBlock
    for name, p in model.named_parameters():
        if is_unread_parameter(name):
            assert p.grad is None, name
        else:
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
