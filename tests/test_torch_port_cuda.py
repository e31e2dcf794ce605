"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: they skip on a machine without an NVIDIA GPU (a CUDA kernel
has no CPU mode). On the card:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which the GPU machine need
not have; this file imports no JAX.)

Tolerances: the kernels and the plain versions take the same bf16 inputs
and store intermediates in bf16 at the same points; fp32 sums run in
another order, so an output may differ by a rounding flip at each stored
intermediate (chip_smoke.py states the same bounds at full size). The
gradients are held by relative L2: the plain backward rounds the weight
gradients to bf16 (autograd through the weights' cast) where the kernel
keeps fp32, and every sum over pixels runs in another order. TF32 is off
for matmuls and cuDNN convolutions (set_precision_flags), which the fp32
check below relies on.
"""
import numpy as np
import pytest
import torch

from noisediff_tpu_torch.cli.common import set_precision_flags
from noisediff_tpu_torch.ops.kernels import (
    fused_attn_tail, fused_attn_tail_bwd, fused_dual_head, fused_groupnorm_film_silu,
    gn_grad_stats, gn_stats, reference_attn_tail, reference_attn_tail_bwd, reference_dual_head,
    reference_gn_grad_stats, reference_gn_stats, reference_groupnorm_film_silu)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_precision_flags()
    return torch.device("cuda")


def _randn(dev, *shape, scale=1.0, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("hw,c", [(32, 48), (16, 96), (8, 192), (8, 384)])
def test_attn_tail_kernel(dev, hw, c):
    x = _randn(dev, 2, hw, hw, c, dtype=torch.bfloat16)
    tok = _randn(dev, 2, c, scale=0.3, dtype=torch.bfloat16)
    p = (1 + 0.1 * _randn(dev, c), 0.1 * _randn(dev, c, seed=1),
         _randn(dev, 2 * c, c, scale=c ** -0.5), 0.1 * _randn(dev, 2 * c),
         _randn(dev, c, 2 * c, scale=(2 * c) ** -0.5, seed=2), 0.1 * _randn(dev, c, seed=3),
         _randn(dev, c, c, scale=c ** -0.5, seed=4), 0.1 * _randn(dev, c, seed=5))
    before = fused_attn_tail.launches
    got = fused_attn_tail(x, tok, *p)
    assert fused_attn_tail.launches == before + 1
    _close(got, reference_attn_tail(x, tok, *p), 3e-2)


@pytest.mark.parametrize("hw,c,groups", [(32, 48, 2), (32, 48, 8), (16, 96, 8), (8, 384, 8)])
@pytest.mark.parametrize("film", [True, False])
def test_groupnorm_silu_kernel(dev, hw, c, groups, film):
    x = _randn(dev, 2, hw * hw, c, scale=1.5, dtype=torch.bfloat16)
    gamma, beta = 1 + 0.1 * _randn(dev, c), 0.1 * _randn(dev, c, seed=1)
    fs = fsh = None
    if film:
        fs, fsh = 0.2 * _randn(dev, 2, c, seed=2), 0.2 * _randn(dev, 2, c, seed=3)
    got = fused_groupnorm_film_silu(x, gamma, beta, fs, fsh, groups)
    _close(got, reference_groupnorm_film_silu(x, gamma, beta, fs, fsh, groups), 2e-2)


@pytest.mark.parametrize("c", [16, 48, 64])
def test_dual_head_kernel(dev, c):
    x, sa, sb = (_randn(dev, 2, 16, 16, c, dtype=torch.bfloat16, seed=s) for s in range(3))
    p = (_randn(dev, c, c, scale=c ** -0.5), 0.1 * _randn(dev, c),
         _randn(dev, 4, c, scale=c ** -0.5, seed=1), 0.1 * _randn(dev, 4),
         _randn(dev, 4, c, scale=c ** -0.5, seed=2), 0.1 * _randn(dev, 4, seed=3))
    got = fused_dual_head(x, sa, sb, *p)
    assert got.dtype == torch.float32
    _close(got, reference_dual_head(x, sa, sb, *p), 1e-2)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-12))


@pytest.mark.parametrize("b,hw,c", [(2, 32, 48), (4, 16, 96), (1, 8, 384), (3, 5, 8)])
def test_gn_stats_kernels(dev, b, hw, c):
    x = _randn(dev, b, hw, hw, c, scale=1.5, dtype=torch.bfloat16)
    g = _randn(dev, b, hw, hw, c, dtype=torch.bfloat16, seed=1)
    n0, n1 = gn_stats.launches, gn_grad_stats.launches
    for got, want in ((gn_stats(x), reference_gn_stats(x)),
                      (gn_grad_stats(g, x), reference_gn_grad_stats(g, x))):
        for gt, wt in zip(got, want):
            assert gt.dtype == torch.float32 and gt.shape == (b, c)
            torch.testing.assert_close(gt, wt, rtol=1e-4, atol=1e-3)
    assert (gn_stats.launches, gn_grad_stats.launches) == (n0 + 1, n1 + 1)
    assert all(torch.equal(a, b) for a, b in zip(gn_stats(x), gn_stats(x)))
    assert all(torch.equal(a, b) for a, b in zip(gn_grad_stats(g, x), gn_grad_stats(g, x)))


def _attn_args(dev, b, hw, c):
    x = _randn(dev, b, hw, hw, c, dtype=torch.bfloat16)
    tok = _randn(dev, b, c, scale=0.3, dtype=torch.bfloat16)
    p = (1 + 0.1 * _randn(dev, c), 0.1 * _randn(dev, c, seed=1),
         _randn(dev, 2 * c, c, scale=c ** -0.5), 0.1 * _randn(dev, 2 * c),
         _randn(dev, c, 2 * c, scale=(2 * c) ** -0.5, seed=2), 0.1 * _randn(dev, c, seed=3),
         _randn(dev, c, c, scale=c ** -0.5, seed=4), 0.1 * _randn(dev, c, seed=5))
    return x, tok, p


@pytest.mark.parametrize("b,hw,c", [(2, 32, 48), (2, 16, 96), (2, 8, 192), (2, 8, 384),
                                    (3, 4, 16)])
def test_attn_tail_bwd_kernel(dev, b, hw, c):
    x, tok, p = _attn_args(dev, b, hw, c)
    g = _randn(dev, b, hw, hw, c, dtype=torch.bfloat16, seed=9)
    before = fused_attn_tail_bwd.launches
    got = fused_attn_tail_bwd(x, tok, *p, g)
    assert fused_attn_tail_bwd.launches == before + 1
    want = reference_attn_tail_bwd(x, tok, *p, g)
    names = ("x", "tok", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "wp", "bp")
    for name, gt, wt in zip(names, got, want):
        assert gt.shape == wt.shape and gt.dtype == wt.dtype, name
        assert bool(torch.isfinite(gt).all()), name
        assert _rel(gt, wt) < 2e-2, (name, _rel(gt, wt))
    # dx elementwise: dx = g + dtok2 with dtok2 stored in bf16, so a rounding
    # flip is relative to |dtok2| <= |dx| + |g|
    err = (got[0].float() - want[0].float()).abs()
    assert bool((err <= 3e-2 + 3e-2 * (want[0].float().abs() + g.float().abs())).all()), \
        float(err.max())
    # every sum runs in a fixed order: a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, fused_attn_tail_bwd(x, tok, *p, g)))


def test_attn_tail_autograd_function(dev):
    """loss.backward() through fused_attn_tail on the card reaches x, tok
    and all eight parameters, as autograd of the plain version does."""
    x, tok, p = _attn_args(dev, 2, 16, 48)
    g = _randn(dev, 2, 16, 16, 48, dtype=torch.bfloat16, seed=7)
    leaves = [t.clone().requires_grad_(True) for t in (x, tok) + p]
    fused_attn_tail(*leaves).backward(g)
    want = reference_attn_tail_bwd(x, tok, *p, g)
    for leaf, w in zip(leaves, want):
        assert leaf.grad is not None and _rel(leaf.grad, w) < 2e-2


def test_dual_head_and_groupnorm_silu_are_differentiable(dev):
    """The generation kernels' wrappers carry gradients on the card: the
    recompute backward of the plain version, as the JAX custom_vjps."""
    c = 48
    x, sa, sb = (_randn(dev, 2, 16, 16, c, dtype=torch.bfloat16, seed=s) for s in range(3))
    p = (_randn(dev, c, c, scale=c ** -0.5), 0.1 * _randn(dev, c),
         _randn(dev, 4, c, scale=c ** -0.5, seed=1), 0.1 * _randn(dev, 4),
         _randn(dev, 4, c, scale=c ** -0.5, seed=2), 0.1 * _randn(dev, 4, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (x, sa, sb) + p]
    fused_dual_head(*leaves).square().sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (x, sa, sb) + p]
    reference_dual_head(*ref).square().sum().backward()
    for a, r in zip(leaves, ref):
        assert a.grad is not None and _rel(a.grad, r.grad) < 2e-2

    xg = _randn(dev, 2, 256, c, scale=1.5, dtype=torch.bfloat16)
    gamma, beta = 1 + 0.1 * _randn(dev, c), 0.1 * _randn(dev, c, seed=1)
    fs, fsh = 0.2 * _randn(dev, 2, c, seed=2), 0.2 * _randn(dev, 2, c, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (xg, gamma, beta, fs, fsh)]
    fused_groupnorm_film_silu(*leaves, 8).float().square().sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (xg, gamma, beta, fs, fsh)]
    reference_groupnorm_film_silu(*ref, 8).float().square().sum().backward()
    for a, r in zip(leaves, ref):
        assert a.grad is not None and _rel(a.grad, r.grad) < 2e-2


def test_model_backward_card_vs_cpu(dev):
    """The detach fault's test: loss.backward() through a small NoiseDiffNet
    on the card (bf16, every kernel) gives every parameter the forward
    reads a finite gradient that agrees with the CPU bf16 gradient.

    bf16 rounds through ~60 layers forward and back on both sides, so a
    small parameter's gradient can differ by 10% between two bf16 runs. The
    bound is relative to that noise: each card gradient lies as close to
    the CPU's fp32 gradient as the CPU's bf16 gradient does, within 2x +
    0.02, and all gradients together within 5e-2 of the CPU bf16 ones."""
    from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter

    torch.manual_seed(0)
    f32 = NoiseDiffNet(dim=16).train()
    cpu = NoiseDiffNet(dim=16, dtype=torch.bfloat16).train()
    cpu.load_state_dict(f32.state_dict())
    card = NoiseDiffNet(dim=16, dtype=torch.bfloat16)
    card.load_state_dict(f32.state_dict())
    card = card.to(dev, memory_format=torch.channels_last).train()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    cond = {"clean_img": torch.from_numpy(rng.uniform(0, .3, (2, 32, 32, 4)).astype(np.float32)),
            "position": torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 2)).astype(np.float32)),
            "iso_ratio_idx": torch.tensor([24, 3])}
    t = torch.tensor([700, 5])
    target = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    for m in (f32, cpu):
        (m(x, t, cond).float() - target).square().mean().backward()
    out = card(x.to(dev), t.to(dev), {k: v.to(dev) for k, v in cond.items()})
    (out.float() - target.to(dev)).square().mean().backward()
    ref32, ref16 = dict(f32.named_parameters()), dict(cpu.named_parameters())
    bad, got_all, want_all = {}, [], []
    for name, p in card.named_parameters():
        if is_unread_parameter(name):
            assert p.grad is None, name
            continue
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        g = p.grad.cpu()
        limit = 2 * _rel(ref16[name].grad, ref32[name].grad) + 0.02
        if _rel(g, ref32[name].grad) > limit:
            bad[name] = (_rel(g, ref32[name].grad), limit)
        got_all.append(g.flatten())
        want_all.append(ref16[name].grad.flatten())
    assert not bad, bad
    assert _rel(torch.cat(got_all), torch.cat(want_all)) < 5e-2


def test_kernels_refuse_fp32(dev):
    x = torch.zeros(2, 8, 8, 48, device=dev)
    with pytest.raises(TypeError):
        fused_groupnorm_film_silu(x.view(2, 64, 48), torch.ones(48, device=dev),
                                  torch.zeros(48, device=dev))


def test_fp32_conv_without_tf32_matches_cpu(dev):
    """With TF32 off, an fp32 convolution on the card agrees with the CPU to
    fp32 rounding (with cuDNN's default TF32 it would not at 1e-5)."""
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 48, 32, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 48, 3, 3)).astype(np.float32) / 20)
    want = torch.nn.functional.conv2d(x, w, padding=1)
    got = torch.nn.functional.conv2d(x.to(dev), w.to(dev), padding=1).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_model_forward_card_vs_cpu(dev):
    """A small NoiseDiffNet in bf16 through the kernels on the card against
    the same model through the plain versions on the CPU."""
    from noisediff_tpu_torch.models import NoiseDiffNet

    torch.manual_seed(0)
    cpu = NoiseDiffNet(dim=16, dtype=torch.bfloat16).eval()
    card = NoiseDiffNet(dim=16, dtype=torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev, memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    cond = {"clean_img": torch.from_numpy(rng.uniform(0, .3, (2, 32, 32, 4)).astype(np.float32)),
            "position": torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 2)).astype(np.float32)),
            "iso_ratio_idx": torch.tensor([24, 3])}
    t = torch.tensor([700, 5])
    with torch.inference_mode():
        want = cpu(x, t, cond).float()
        got = card(x.to(dev), t.to(dev), {k: v.to(dev) for k, v in cond.items()}).float().cpu()
    assert float((got - want).norm() / want.norm()) < 5e-2
