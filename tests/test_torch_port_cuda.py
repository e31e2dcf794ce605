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
import os

import numpy as np
import pytest
import torch

from noisediff_tpu_torch.cli.common import set_precision_flags
from noisediff_tpu_torch.ops.kernels import (
    conv_wgrad, ddim_step_scalars, flash_attention, fused_attn_tail, fused_attn_tail_bwd,
    fused_ddim_head_update, fused_dual_head, fused_groupnorm_film_silu, gn_grad_stats, gn_stats,
    reference_attn_tail, reference_attn_tail_bwd, reference_conv_wgrad,
    reference_ddim_head_update, reference_dual_head, reference_flash_attention,
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


def _attn_params(dev, c):
    return (1 + 0.1 * _randn(dev, c), 0.1 * _randn(dev, c, seed=1),
            _randn(dev, 2 * c, c, scale=c ** -0.5), 0.1 * _randn(dev, 2 * c),
            _randn(dev, c, 2 * c, scale=(2 * c) ** -0.5, seed=2), 0.1 * _randn(dev, c, seed=3),
            _randn(dev, c, c, scale=c ** -0.5, seed=4), 0.1 * _randn(dev, c, seed=5))


# every route that takes each stage's width: the fused kernel is built for
# FWD_FUSED_WIDTHS, the streamed one for FWD_STREAMED_WIDTHS, the tiled
# route takes every C % 16 up to 768
FWD_ROUTES = [(4, 512, 48, "fused"), (4, 512, 48, "tiled"), (4, 256, 96, "fused"),
              (4, 256, 96, "tiled"), (4, 128, 192, "streamed"), (4, 128, 192, "tiled"),
              (4, 64, 384, "tiled"), (2, 32, 16, "fused"), (2, 32, 32, "tiled"),
              (1, 16, 768, "tiled")]


def _fwd_routes(c):
    from noisediff_tpu_torch.ops.kernels import attn_tail as at

    return [r for r, widths in (("fused", at.FWD_FUSED_WIDTHS),
                                ("streamed", at.FWD_STREAMED_WIDTHS)) if c in widths] + ["tiled"]


@pytest.mark.parametrize("b,hw,c,route", FWD_ROUTES)
def test_attn_tail_forward_routes(dev, b, hw, c, route):
    """The forward on each route at the canonical stages (B 4, crop 512)
    against the plain version, two calls bit-equal; the default route
    through the wrapper counts one launch."""
    from noisediff_tpu_torch.ops.kernels import attn_tail as at

    x = _randn(dev, b, hw, hw, c, dtype=torch.bfloat16)
    tok = _randn(dev, b, c, scale=0.3, dtype=torch.bfloat16)
    p = _attn_params(dev, c)
    got = at._launch(x, tok, *p, 1e-5, route=route)
    _close(got, reference_attn_tail(x, tok, *p), 3e-2)
    assert torch.equal(got, at._launch(x, tok, *p, 1e-5, route=route))
    if route == at.fwd_route(c):
        before = fused_attn_tail.launches
        assert torch.equal(fused_attn_tail(x, tok, *p), got)
        assert fused_attn_tail.launches == before + 1


def test_attn_tail_forward_converts_operands(dev):
    """bf16 weights and an fp32 token (the wrapper converts them, and keeps
    the copies alive until the launch) give the bits of the same values as
    fp32 weights and a bf16 token, on every route."""
    for b, hw, c in [(4, 128, 48), (4, 64, 96), (4, 32, 192), (4, 16, 384)]:
        x = _randn(dev, b, hw, hw, c, dtype=torch.bfloat16)
        tok = _randn(dev, b, c, scale=0.3, dtype=torch.bfloat16)
        p = [t.to(torch.bfloat16).float() if t.dim() == 2 else t for t in _attn_params(dev, c)]
        want = fused_attn_tail(x, tok, *p)
        got = fused_attn_tail(x, tok.float(), *[t.to(torch.bfloat16) if t.dim() == 2 else t
                                                for t in p])
        assert torch.equal(got, want), c


def test_attn_tail_forward_plan_matches_kernel(dev):
    """The fused and streamed kernels' shared memory is the plan's; each
    fits an SM."""
    from noisediff_tpu_torch.ops.kernels import _build
    from noisediff_tpu_torch.ops.kernels import attn_tail as at

    lib = _build.library("attn_tail", at._SIGNATURES)
    for c in at.FWD_FUSED_WIDTHS + at.FWD_STREAMED_WIDTHS:
        assert lib.nd_attn_tail_smem(c) == at.fwd_smem_bytes(c)
        assert lib.nd_attn_tail_occupancy(c) >= 1


def test_fp32_training_step_under_pallas_wgrad(dev, monkeypatch):
    """An fp32 NoiseDiffNet training step with NOISEDIFF_WGRAD=pallas on the
    card: no conv takes the bf16-only conv_wgrad kernel, nothing launches,
    the loss and every gradient are finite."""
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    monkeypatch.setenv("NOISEDIFF_WGRAD", "pallas")
    torch.manual_seed(0)
    net = NoiseDiffNet(dim=48).to(dev).train()
    pd = GaussianDiffusion.create(net, image_size=64, timesteps=1000, beta_schedule="sigmoid2",
                                  device=dev)
    rng = np.random.default_rng(0)
    img = torch.from_numpy((0.05 * rng.standard_normal((2, 64, 64, 4))).astype(np.float32))
    cond = {"clean_img": torch.from_numpy(rng.uniform(0, 0.3, (2, 64, 64, 4)).astype(np.float32)),
            "position": torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 2)).astype(np.float32)),
            "iso_ratio_idx": torch.tensor([24, 3])}
    reset_launch_counts()
    loss = pd.loss(img.to(dev), {k: v.to(dev) for k, v in cond.items()})
    loss.backward()
    torch.cuda.synchronize()
    assert all(n == 0 for n in launch_counts().values()), launch_counts()
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(q.grad).all()) for q in net.parameters() if q.grad is not None)


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


# groupnorm_silu: the evaluation's stages (B 4), the full frame's /8 stage
# (B 1: a sample over the blocks' shared memory, rows read twice), crop
# 504's /4 stage and the narrowest width, as (B, N, C, groups)
GN_SHAPES = [(4, 512 * 512, 48, 2), (4, 512 * 512, 48, 8), (4, 256 * 256, 96, 8),
             (4, 128 * 128, 192, 8), (4, 64 * 64, 384, 8), (1, 178 * 266, 384, 8),
             (4, 126 * 126, 96, 8), (2, 16 * 16, 8, 2)]


@pytest.mark.parametrize("b,n,c,groups", GN_SHAPES)
@pytest.mark.parametrize("bias,film", [(True, True), (False, False), (True, False),
                                       (False, True)])
def test_groupnorm_silu_one_launch(dev, b, n, c, groups, bias, film):
    """The one-launch kernel with the folded conv bias and the bf16 FiLM
    halves of the time-MLP's output: within 2e-2 of the plain version (as
    chip_smoke.TOLS), one launch per call, two calls bit-equal."""
    x = _randn(dev, b, n, c, scale=1.5, dtype=torch.bfloat16) + 0.3
    gamma, beta = 1 + 0.1 * _randn(dev, c), 0.1 * _randn(dev, c, seed=1)
    cb = 0.3 * _randn(dev, c, seed=2) if bias else None
    fs = fsh = None
    if film:
        t = (0.2 * _randn(dev, b, 2 * c, seed=3)).to(torch.bfloat16)
        fs, fsh = t[:, :c], t[:, c:]
    args = (x, gamma, beta, fs, fsh, groups, 1e-5, cb)
    n0 = fused_groupnorm_film_silu.launches
    got = fused_groupnorm_film_silu(*args)
    assert fused_groupnorm_film_silu.launches == n0 + 1
    _close(got, reference_groupnorm_film_silu(*args), 2e-2)
    assert torch.equal(got, fused_groupnorm_film_silu(*args))


def test_groupnorm_silu_conv_bias_gradient(dev):
    """With autograd on, the conv bias gets the plain version's gradient."""
    c = 48
    x = _randn(dev, 2, 256, c, scale=1.5, dtype=torch.bfloat16)
    gamma, beta, cb = 1 + 0.1 * _randn(dev, c), 0.1 * _randn(dev, c, seed=1), _randn(dev, c)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta, cb)]
    fused_groupnorm_film_silu(*leaves[:3], None, None, 8, 1e-5,
                              leaves[3]).float().square().sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (x, gamma, beta, cb)]
    reference_groupnorm_film_silu(*ref[:3], None, None, 8, 1e-5,
                                  ref[3]).float().square().sum().backward()
    for a, r in zip(leaves, ref):
        assert a.grad is not None and _rel(a.grad, r.grad) < 2e-2


@pytest.mark.parametrize("c", [16, 32, 48, 64])
@pytest.mark.parametrize("sigma", [None, 0.0, 0.1])
def test_head_kernels_ragged(dev, c, sigma):
    """dual_head (sigma None) and ddim_head (sigma 0: no noise read; 0.1)
    at every width the kernels take and a pixel count that is not a
    multiple of 16 (2 x 13 x 11 = 286), at chip_smoke.TOLS; two calls
    bit-equal; the parameters as fp32 leaves of the model's own layout."""
    x, sa, sb = (_randn(dev, 2, 13, 11, c, dtype=torch.bfloat16, seed=s) for s in range(3))
    p = (_randn(dev, c, c, scale=c ** -0.5), 0.1 * _randn(dev, c),
         _randn(dev, 4, c, scale=c ** -0.5, seed=1), 0.1 * _randn(dev, 4),
         _randn(dev, 4, c, scale=c ** -0.5, seed=2), 0.1 * _randn(dev, 4, seed=3))
    if sigma is None:
        args, fn, ref, tol = (x, sa, sb) + p, fused_dual_head, reference_dual_head, 1e-2
    else:
        xt = _randn(dev, 2, 13, 11, 4, seed=4)
        noise = _randn(dev, 2, 13, 11, 4, seed=5) if sigma else None
        scal = ddim_step_scalars(0.3, 0.45, sigma, (1 - 0.45 - sigma ** 2) ** 0.5)
        args = (x, sa, sb, xt, noise) + p + (scal,)
        fn, ref, tol = fused_ddim_head_update, reference_ddim_head_update, 2e-2
    n0 = fn.launches
    got = fn(*args)
    assert fn.launches == n0 + 1 and got.shape == (2, 13, 11, 4) and got.dtype == torch.float32
    _close(got, ref(*args), tol)
    assert torch.equal(got, fn(*args))


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


def _gn_inputs(dev, b, h, w, c):
    x = _randn(dev, b, h, w, c, scale=1.5, dtype=torch.bfloat16)
    g = _randn(dev, b, h, w, c, dtype=torch.bfloat16, seed=1)
    return x, g


def _gn_check(x, g):
    """Both kernels against their plain versions; returns their outputs."""
    b, c = x.shape[0], x.shape[-1]
    outs = (gn_stats(x), gn_grad_stats(g, x))
    for got, want in zip(outs, (reference_gn_stats(x), reference_gn_grad_stats(g, x))):
        for gt, wt in zip(got, want):
            assert gt.dtype == torch.float32 and gt.shape == (b, c)
            torch.testing.assert_close(gt, wt, rtol=1e-4, atol=1e-3)
    return outs


# hw: a square side or (H, W). The one-launch design's edges: a map smaller
# than one block's slab (2x2x384), a pixel count no slab size divides (5x7),
# B 1 and B 16, C 8 and C 2048 (the wrapper's limit)
@pytest.mark.parametrize("b,hw,c", [(2, 32, 48), (4, 16, 96), (1, 8, 384), (3, 5, 8),
                                    (4, 2, 384), (3, (5, 7), 48), (1, (48, 40), 192),
                                    (16, 12, 96), (4, (33, 31), 8), (2, (9, 7), 2048)])
def test_gn_stats_kernels(dev, b, hw, c):
    h, w = hw if isinstance(hw, tuple) else (hw, hw)
    x, g = _gn_inputs(dev, b, h, w, c)
    n0, n1 = gn_stats.launches, gn_grad_stats.launches
    _gn_check(x, g)
    assert (gn_stats.launches, gn_grad_stats.launches) == (n0 + 1, n1 + 1)
    assert all(torch.equal(a, b) for a, b in zip(gn_stats(x), gn_stats(x)))
    assert all(torch.equal(a, b) for a, b in zip(gn_grad_stats(g, x), gn_grad_stats(g, x)))


# calls one after another with nothing reset between them: shapes of other
# batch sizes and splits in turn (an arrival counter left non-zero by one
# call would end another's sum early or never), and a call on a side stream
# (its own scratch) beside the current stream's
@pytest.mark.parametrize("case", ["alternating", "side_stream"])
def test_gn_stats_kernel_call_sequences(dev, case):
    shapes = [(4, 32, 32, 48), (2, 3, 5, 384), (16, 8, 8, 96), (1, 64, 64, 8), (3, 2, 2, 2048)]
    inputs = [_gn_inputs(dev, *s) for s in shapes]
    first = [_gn_check(x, g) for x, g in inputs]
    if case == "alternating":
        for _ in range(3):
            for (x, g), want in zip(inputs, first):
                got = (gn_stats(x), gn_grad_stats(g, x))
                assert all(torch.equal(a, b) for gw, ww in zip(got, want)
                           for a, b in zip(gw, ww))
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [(gn_stats(x), gn_grad_stats(g, x)) for x, g in inputs]
        got += [_gn_check(x, g) for x, g in inputs]
    torch.cuda.current_stream().wait_stream(side)
    again = [_gn_check(x, g) for x, g in inputs]
    for outs in (got[:len(inputs)], got[len(inputs):], again):
        for o, want in zip(outs, first):
            assert all(torch.equal(a, b) for gw, ww in zip(o, want) for a, b in zip(gw, ww))


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


@pytest.mark.parametrize("c", [16, 48])
@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_ddim_head_kernel(dev, c, sigma):
    """The DDIM tail: the dual head (the kernel's products, 1e-2 as
    dual_head) and an fp32 update whose coefficients are at most ~10, so the
    carry agrees within 1e-1 of the head's tolerance."""
    x, sa, sb = (_randn(dev, 2, 16, 16, c, dtype=torch.bfloat16, seed=s) for s in range(3))
    p = (_randn(dev, c, c, scale=c ** -0.5), 0.1 * _randn(dev, c),
         _randn(dev, 4, c, scale=c ** -0.5, seed=1), 0.1 * _randn(dev, 4),
         _randn(dev, 4, c, scale=c ** -0.5, seed=2), 0.1 * _randn(dev, 4, seed=3))
    xt = _randn(dev, 2, 16, 16, 4, seed=4)
    noise = _randn(dev, 2, 16, 16, 4, seed=5) if sigma else None
    scal = ddim_step_scalars(0.3, 0.45, sigma, (1 - 0.45 - sigma ** 2) ** 0.5)
    before = fused_ddim_head_update.launches
    got = fused_ddim_head_update(x, sa, sb, xt, noise, *p, scal)
    assert fused_ddim_head_update.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == xt.shape
    _close(got, reference_ddim_head_update(x, sa, sb, xt, noise, *p, scal), 2e-2)


@pytest.mark.parametrize("b,h,w,ci,co,k", [
    (2, 32, 32, 48, 48, 3), (2, 16, 16, 96, 48, 3), (1, 9, 13, 48, 96, 1), (2, 8, 8, 32, 64, 3),
    (1, 5, 70, 16, 32, 3), (2, 16, 16, 144, 96, 1)])
def test_conv_wgrad_kernel(dev, b, h, w, ci, co, k):
    """fp32 sums over B*H*W bf16 products in another order: within 1e-4 of
    the largest sum, and the same bits from two calls."""
    x = _randn(dev, b, h, w, ci, dtype=torch.bfloat16)
    g = _randn(dev, b, h, w, co, dtype=torch.bfloat16, seed=1)
    before = conv_wgrad.launches
    got = conv_wgrad(g, x, k, k)
    assert conv_wgrad.launches == before + 1
    want = reference_conv_wgrad(g, x, k, k)
    assert got.shape == (k, k, ci, co) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, conv_wgrad(g, x, k, k))


@pytest.mark.parametrize("b,h,w,ci,co,k", [
    (1, 9, 40, 48, 48, 3), (2, 13, 70, 48, 96, 3), (1, 3, 48, 576, 384, 1),
    (1, 64, 512, 48, 48, 3), (4, 64, 64, 576, 384, 1), (1, 17, 33, 96, 48, 1)])
def test_conv_wgrad_kernel_edges(dev, b, h, w, ci, co, k):
    """The tiled design's edges: W not a multiple of a pixel tile's columns
    and odd H (the TMA boxes' zero fill past the image), B 1, 48 channels
    (the 56-channel box's zero fill past the last channel), 576 -> 384 1x1,
    pairs that each fit one block and one pair spread over every SM. Within
    1e-4 of the largest sum, and the same bits from two calls."""
    from noisediff_tpu_torch.ops.kernels.conv_wgrad import plan, reduce_slots

    p = plan(b, h, w, ci, co, k, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    splits = {len(reduce_slots(p, pair)) for pair in range(p["pairs"])}
    x = _randn(dev, b, h, w, ci, dtype=torch.bfloat16)
    g = _randn(dev, b, h, w, co, dtype=torch.bfloat16, seed=1)
    got = conv_wgrad(g, x, k, k)
    want = reference_conv_wgrad(g, x, k, k)
    assert got.shape == (k, k, ci, co) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), splits
    assert torch.equal(got, conv_wgrad(g, x, k, k))


@pytest.mark.parametrize("kh,kw", [(1, 3), (3, 1)])
def test_conv_wgrad_kernel_rectangular(dev, kh, kw):
    x = _randn(dev, 2, 12, 20, 48, dtype=torch.bfloat16)
    g = _randn(dev, 2, 12, 20, 48, dtype=torch.bfloat16, seed=1)
    got, want = conv_wgrad(g, x, kh, kw), reference_conv_wgrad(g, x, kh, kw)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_conv_wgrad_route_on_card(dev, monkeypatch):
    """A 3x3 conv under NOISEDIFF_WGRAD=pallas on the card: the same output
    and dx as cuDNN's backward, and dW within bf16 rounding of it (cuDNN
    rounds its weight gradient to bf16; the kernel keeps fp32)."""
    from noisediff_tpu_torch.models.blocks import Conv2d

    torch.manual_seed(0)
    conv = Conv2d(48, 96, 3).to(dev)
    x0 = _randn(dev, 2, 48, 32, 32, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    grads = {}
    for flag in ("xla", "pallas"):
        monkeypatch.setenv("NOISEDIFF_WGRAD", flag)
        conv.zero_grad()
        x = x0.clone().requires_grad_(True)
        n = conv_wgrad.launches
        y = conv(x)
        y.float().square().sum().backward()
        assert conv_wgrad.launches == n + (flag == "pallas")
        grads[flag] = (y.detach(), x.grad, conv.weight.grad.clone(), conv.bias.grad.clone())
    assert torch.equal(grads["xla"][0], grads["pallas"][0])
    assert torch.equal(grads["xla"][1], grads["pallas"][1])
    for a, b in zip(grads["xla"][2:], grads["pallas"][2:]):
        assert _rel(b, a) < 1e-2


@pytest.mark.parametrize("n,d", [(4096, 32), (1000, 32), (256, 64), (1, 32), (77, 64)])
def test_flash_attention_kernel(dev, n, d):
    """bf16 output against the plain version, within the bound of their bf16
    roundings: each rounds the probabilities (error <= u P|v|) and its
    output (<= u |o| <= u P|v|) once, u = 2^-9, so |k - p| <= 2^-7 P|v|
    elementwise with P the fp32 softmax; the rel L2 within 2^-7 too."""
    q, k, v = (_randn(dev, 2, 2, n, d, dtype=torch.bfloat16, seed=s) for s in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v).float()
    assert flash_attention.launches == before + 1
    want = reference_flash_attention(q, k, v).float()
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * d ** -0.5, dim=-1)
    err = (got - want).abs()
    assert bool((err <= 2.0 ** -7 * (p @ v.float().abs())).all()), float(err.max())
    assert _rel(got, want) <= 2.0 ** -7


@pytest.mark.parametrize("b,h,nq,nk,d", [(1, 1, 40, 200, 32), (1, 1, 1, 4096, 32),
                                         (2, 1, 130, 130, 64), (1, 1, 4096, 4100, 32),
                                         (1, 3, 63, 65, 64)])
def test_flash_attention_kernel_edges(dev, b, h, nq, nk, d):
    """The redesign's edges, held to the same rounding bound: Nk not a
    multiple of the 64-key tile (the masked last tile), Nq under a block's
    query rows, D 64, BH 1."""
    q = _randn(dev, b, h, nq, d, dtype=torch.bfloat16)
    k, v = (_randn(dev, b, h, nk, d, dtype=torch.bfloat16, seed=s) for s in (1, 2))
    got = flash_attention(q, k, v).float()
    want = reference_flash_attention(q, k, v).float()
    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * d ** -0.5, dim=-1)
    err = (got - want).abs()
    assert bool((err <= 2.0 ** -7 * (p @ v.float().abs())).all()), float(err.max())
    assert _rel(got, want) <= 2.0 ** -7
    with pytest.raises(ValueError):  # the kernel takes the max before the scale
        flash_attention(q, k, v, scale=-0.5)


def test_flash_attention_autograd_and_module(dev):
    """The backward (autograd of the plain version) reaches q, k and v; the
    Attention module on the card agrees with the CPU's."""
    from noisediff_tpu_torch.models.blocks import Attention

    q, k, v = (_randn(dev, 1, 2, 300, 32, dtype=torch.bfloat16, seed=s) for s in range(3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves).float().square().sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reference_flash_attention(*ref).float().square().sum().backward()
    for a, r in zip(leaves, ref):
        assert a.grad is not None and _rel(a.grad, r.grad) < 2e-2

    torch.manual_seed(0)
    cpu = Attention(96)
    card = Attention(96, dtype=torch.bfloat16)  # the bf16 route runs the kernel
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev)
    x = torch.randn(2, 96, 32, 32).contiguous(memory_format=torch.channels_last)
    n = flash_attention.launches
    got = card(x.to(dev, torch.bfloat16)).float().cpu()
    assert flash_attention.launches == n + 1
    want = cpu(x.bfloat16()).float()
    assert _rel(got, want) < 2e-2


def test_fused_ddim_matches_unfused_on_card(dev):
    """A small bf16 NoiseDiffNet: the fused DDIM tail (the kernel) against
    the unfused sampler (dual_head kernel, then PyTorch's update) from the
    same noise. The unfused path rounds the model output to bf16; the fused
    one keeps it fp32, so they agree to bf16 rounding through the steps."""
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet

    torch.manual_seed(0)
    model = NoiseDiffNet(dim=16, dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last)
    model.eval()
    gd = GaussianDiffusion.create(model, image_size=32, timesteps=1000, beta_schedule="sigmoid2",
                                  device=dev)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32)).to(dev)
    cond = {"clean_img": torch.from_numpy(rng.uniform(0, .3, (2, 32, 32, 4)).astype(np.float32)),
            "position": torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 2)).astype(np.float32)),
            "iso_ratio_idx": torch.tensor([24, 3])}
    cond = {k: v.to(dev) for k, v in cond.items()}

    def trunk_fn(xx, t, c):
        return (*model.trunk(xx, t, c), model.head_weights())

    n = fused_ddim_head_update.launches
    fused = gd.ddim_sample(x.shape, cond, sampling_timesteps=4, init_noise=x, trunk_fn=trunk_fn)
    assert fused_ddim_head_update.launches == n + 4
    unfused = gd.ddim_sample(x.shape, cond, sampling_timesteps=4, init_noise=x)
    assert bool(torch.isfinite(fused).all()) and _rel(fused, unfused) < 5e-2


# Pixel counts that are not multiples of 16: the full frame's /8 stage,
# crop 504's /4 stage, the tiny scale's /8 stage, and odd small maps.
RAGGED = [(1, 178, 266, 384), (4, 126, 126, 96), (4, 2, 2, 384), (1, 7, 9, 48),
          (4, 3, 5, 48), (4, 126, 126, 48), (1, 33, 65, 384), (7, 3, 3, 48),
          (2, 37, 29, 192), (3, 5, 7, 192)]


@pytest.mark.parametrize("b,h,w,c", RAGGED)
def test_attn_tail_forward_routes_ragged(dev, b, h, w, c):
    """The forward on every route that takes C at ragged pixel counts, at
    test_attn_tail_ragged_shapes' tolerance, two calls bit-equal."""
    from noisediff_tpu_torch.ops.kernels import attn_tail as at

    x = _randn(dev, b, h, w, c, scale=1.5, dtype=torch.bfloat16) + 0.5
    tok = _randn(dev, b, c, scale=0.3, dtype=torch.bfloat16)
    p = _attn_params(dev, c)
    want = reference_attn_tail(x, tok, *p).float()
    for route in _fwd_routes(c):
        out = at._launch(x, tok, *p, 1e-5, route=route)
        err = (out.float() - want).abs()
        assert bool((err <= 3e-2 + 3e-2 * (want.abs() + x.float().abs())).all()), route
        assert torch.equal(out, at._launch(x, tok, *p, 1e-5, route=route)), route


@pytest.mark.parametrize("b,h,w,c", RAGGED)
def test_attn_tail_ragged_shapes(dev, b, h, w, c):
    """Forward and backward at ragged pixel counts (a last tile partly
    filled, tiles across samples); two backward calls give the same bits.
    The backward at the square shapes' tolerances. The forward's output is
    the bf16 sum of the proj output and x: a rounding flip of the proj
    output is relative to |out| + |x|, which this input (x shifted and
    scaled as a training step's) makes larger than |out| where they cancel."""
    x = _randn(dev, b, h, w, c, scale=1.5, dtype=torch.bfloat16) + 0.5
    tok = _randn(dev, b, c, scale=0.3, dtype=torch.bfloat16)
    p = (1 + 0.1 * _randn(dev, c), 0.1 * _randn(dev, c, seed=1),
         _randn(dev, 2 * c, c, scale=c ** -0.5), 0.1 * _randn(dev, 2 * c),
         _randn(dev, c, 2 * c, scale=(2 * c) ** -0.5, seed=2), 0.1 * _randn(dev, c, seed=3),
         _randn(dev, c, c, scale=c ** -0.5, seed=4), 0.1 * _randn(dev, c, seed=5))
    g = _randn(dev, b, h, w, c, dtype=torch.bfloat16, seed=9)
    out, want_out = fused_attn_tail(x, tok, *p).float(), reference_attn_tail(x, tok, *p).float()
    assert bool(((out - want_out).abs() <= 3e-2 + 3e-2 * (want_out.abs() + x.float().abs())).all())
    got = fused_attn_tail_bwd(x, tok, *p, g)
    want = reference_attn_tail_bwd(x, tok, *p, g)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape and bool(torch.isfinite(gt).all())
        assert _rel(gt, wt) < 2e-2
    err = (got[0].float() - want[0].float()).abs()
    assert bool((err <= 3e-2 + 3e-2 * (want[0].float().abs() + g.float().abs())).all())
    assert all(torch.equal(a, b_) for a, b_ in zip(got, fused_attn_tail_bwd(x, tok, *p, g)))


def _sid_tree(root, h_bayer, w_bayer, frames=2):
    """A miniature SID tree: 2 ISO800 training pairs and `frames` clean frames."""
    sid = root / "SID"
    (sid / "Sony" / "short").mkdir(parents=True)
    (sid / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in (1, 2):
        in_fn, gt_fn = f"{i:05d}_00_0.04s.ARW", f"{i:05d}_00_10s.ARW"
        for sub, fn in (("short", in_fn), ("long", gt_fn)):
            arr = rng.integers(512, 4096, size=(h_bayer, w_bayer)).astype(np.uint16)
            np.save(sid / "Sony" / sub / (fn + ".npy"), arr)
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO800 F1.8")
    for i in range(3, 3 + max(0, frames - 2)):
        arr = rng.integers(512, 4096, size=(h_bayer, w_bayer)).astype(np.uint16)
        np.save(sid / "Sony" / "long" / f"{i:05d}_00_10s.ARW.npy", arr)
    (sid / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")
    return sid


def _train_argv(sid, out, *extra):
    return ["--name", "train_diffusion", "--net_name", "NoiseDiffNet", "--dim", "16",
            "--crop_size", "64", "--batch_size", "50", "--max_iter", "1",
            "--save_epoch_freq", "1", "--beta_schedule", "sigmoid2", "--positional_encoding",
            "--with_camera_settings", "--generation_result", "noise",
            "--trainset", "SonyTrainDataset", "--sid_folder", str(sid), "--num_workers", "2",
            "--device", "cuda", "--log_freq", "1", "--save_folder", str(out), *extra]


def _gen_argv(sid, ckpt, out, dim, *extra):
    return ["--name", "ISO800_Ratio250", "--testset", "NoiseImageGenerationDataset",
            "--net_name", "NoiseDiffNet", "--beta_schedule", "sigmoid2", "--positional_encoding",
            "--with_camera_settings", "--save_npy", "--dim", str(dim), "--crop_size", "32",
            "--batch_size", "64", "--sampler", "dpm", "--sampling_timesteps", "3",
            "--iso", "800", "--ratio", "250", "--sid_folder", str(sid),
            "--pretrained_dir", str(sid.parent), "--num_workers", "1", "--device", "cuda",
            "--resume", str(ckpt), "--save_folder", str(out), *extra]


def test_fp32_clis_launch_no_kernel(dev, tmp_path):
    """--no_mixed_precision (fp32 compute, the reference-faithful mode)
    trains 2 steps and generates a batch through both CLIs on the card, on
    the plain route: no kernel launches."""
    from noisediff_tpu_torch.cli import test_diffusion, train_diffusion
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    sid = _sid_tree(tmp_path, 160, 192)
    reset_launch_counts()
    summary = train_diffusion.main(_train_argv(sid, tmp_path / "train", "--no_mixed_precision"))
    assert summary["steps"] == 2 and all(np.isfinite(summary["losses"]))
    ckpt = tmp_path / "train" / "train_diffusion" / "snapshot" / "net_final.pth"
    gen = test_diffusion.main(_gen_argv(sid, ckpt, tmp_path / "gen", 16, "--no_mixed_precision"))
    assert gen["batches"] == 1 and gen["generated"] > 0
    for f in os.listdir(gen["out_dir"]):
        assert np.isfinite(np.load(os.path.join(gen["out_dir"], f))).all()
    assert all(n == 0 for n in launch_counts().values()), launch_counts()


def test_dim96_generation_on_card(dev, tmp_path):
    """--dim 96: the heads are built for C <= 64, so they take their plain
    version; the attn_tail and GroupNorm kernels run at 96..768 channels."""
    from noisediff_tpu_torch.cli import test_diffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    sid = _sid_tree(tmp_path, 128, 128)
    torch.manual_seed(0)
    ckpt = tmp_path / "net96.pth"
    torch.save(NoiseDiffNet(dim=96).state_dict(), ckpt)
    reset_launch_counts()
    gen = test_diffusion.main(_gen_argv(sid, ckpt, tmp_path / "gen", 96))
    counts = launch_counts()
    assert gen["batches"] == 1 and gen["generated"] > 0
    for f in os.listdir(gen["out_dir"]):
        assert np.isfinite(np.load(os.path.join(gen["out_dir"], f))).all()
    assert counts["fused_dual_head"] == 0 and counts["fused_attn_tail"] == 9 * 3
    assert counts["fused_groupnorm_film_silu"] > 0


def test_tb_logger_writes_scalars_on_card(dev, tmp_path):
    import json

    from noisediff_tpu_torch.cli import train_diffusion

    sid = _sid_tree(tmp_path, 160, 192)
    train_diffusion.main(_train_argv(sid, tmp_path / "weights", "--use_tb_logger",
                                     "--vis_step_freq", "1"))
    path = tmp_path / "tb_logger" / "train_diffusion" / "scalars.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(r["tag"], r["step"]) for r in rows] == [
        (tag, step) for step in (0, 1) for tag in ("diffusion_loss", "lr")]
    assert all(np.isfinite(r["value"]) for r in rows)


def _lsid_step(dtype, dev, sd, batch):
    """One denoising step (flip and SNA off) of a width-32 LSID; returns
    its loss and every parameter's gradient on the CPU."""
    from noisediff_tpu_torch.models import LSID
    from noisediff_tpu_torch.train.state import make_denoising_train_step, make_optimizer

    model = LSID(dtype=dtype)
    model.load_state_dict(sd)
    model = model.to(dev, memory_format=torch.channels_last).train()
    step = make_denoising_train_step(model, make_optimizer(model.parameters(), lr=1e-4),
                                     augment_flip=False, use_sna=False)
    metrics = step({k: v.to(dev) for k, v in batch.items()}, torch.Generator(device=dev))
    return float(metrics["loss_sum"]), {n: p.grad.float().cpu()
                                        for n, p in model.named_parameters()}


def test_lsid_step_card_vs_cpu(dev):
    """The denoiser's training step on the card against the CPU (B 2, 64^2,
    L1): fp32 on both within 1e-5 on the loss and 1e-3 relative L2 on each
    gradient (TF32 off); bf16 on the card with each gradient as close to
    the CPU's fp32 one as the CPU's bf16 gradient is (within 2x + 0.02),
    and the loss within 2e-2. No kernel of the port runs on this path."""
    from noisediff_tpu_torch.models import LSID
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.manual_seed(0)
    sd = LSID().state_dict()
    rng = np.random.default_rng(2)
    clean = rng.uniform(0, 0.4, (2, 64, 64, 4)).astype(np.float32)
    batch = {"noisy_img": torch.from_numpy(np.clip(clean + rng.normal(0, .05, clean.shape), 0, 1)
                                           .astype(np.float32)),
             "clean_img": torch.from_numpy(clean), "iso": torch.tensor([800, 800]),
             "ratio": torch.tensor([250.0, 250.0])}
    cpu = torch.device("cpu")
    loss32, g32 = _lsid_step(None, cpu, sd, batch)
    loss16, g16 = _lsid_step(torch.bfloat16, cpu, sd, batch)
    reset_launch_counts()
    loss_c32, gc32 = _lsid_step(None, dev, sd, batch)
    loss_c16, gc16 = _lsid_step(torch.bfloat16, dev, sd, batch)
    assert not any(launch_counts().values())
    assert abs(loss_c32 - loss32) <= 1e-5 * abs(loss32)
    assert abs(loss_c16 - loss16) <= 2e-2 * abs(loss16)
    for name in g32:
        assert bool(torch.isfinite(gc16[name]).all()), name
        assert _rel(gc32[name], g32[name]) < 1e-3, name
        assert _rel(gc16[name], g32[name]) <= 2 * _rel(g16[name], g32[name]) + 0.02, name


def test_sna_poisson_on_card_has_poisson_moments(dev):
    """torch.poisson on the card at a fixed lam field (SNA's draw): the
    mean and variance of each channel's draws agree with lam within 5
    standard errors."""
    lam = torch.tensor([0.5, 3.0, 40.0, 900.0], device=dev).expand(512, 512, 4).contiguous()
    draws = torch.poisson(lam, generator=torch.Generator(device=dev).manual_seed(0))
    draws = draws.reshape(-1, 4).double().cpu()
    n, lam = draws.shape[0], lam[0, 0].double().cpu()
    assert bool((draws == draws.round()).all())
    assert bool(((draws.mean(0) - lam).abs() < 5 * (lam / n).sqrt()).all())
    assert bool(((draws.var(0) - lam).abs() < 5 * lam * ((2 + 1 / lam) / n).sqrt()).all())


def test_lsid_step_under_pallas_wgrad(dev, monkeypatch):
    """NOISEDIFF_WGRAD=pallas routes LSID's wide convs' weight gradients
    through conv_wgrad, as the JAX model's convs are routed: the bf16 step's
    gradients within 2e-2 relative L2 of cuDNN's wgrad step (which rounds
    each weight gradient to bf16 where the kernel keeps fp32)."""
    from noisediff_tpu_torch.models import LSID
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.manual_seed(1)
    sd = LSID().state_dict()
    rng = np.random.default_rng(3)
    clean = rng.uniform(0, 0.4, (2, 64, 64, 4)).astype(np.float32)
    batch = {"noisy_img": torch.from_numpy(np.clip(clean + rng.normal(0, .05, clean.shape), 0, 1)
                                           .astype(np.float32)),
             "clean_img": torch.from_numpy(clean), "iso": torch.tensor([800, 800]),
             "ratio": torch.tensor([250.0, 250.0])}
    _, want = _lsid_step(torch.bfloat16, dev, sd, batch)
    monkeypatch.setenv("NOISEDIFF_WGRAD", "pallas")
    reset_launch_counts()
    _, got = _lsid_step(torch.bfloat16, dev, sd, batch)
    assert launch_counts()["conv_wgrad"] > 0
    for name in want:
        assert _rel(got[name], want[name]) < 2e-2, name


@pytest.mark.parametrize("shape", [(64, 96, 4), (35, 51, 4)])
def test_metrics_on_card_match_cpu(dev, shape):
    """PSNR, SSIM (both protocols) and the illuminance correction on the
    card against the CPU, fp32 on both (sums in another order)."""
    from noisediff_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn in (M.psnr, M.ssim, M.ssim_matlab):
        got = fn(ta.to(dev), tb.to(dev))
        assert got.device.type == "cuda"
        assert abs(float(got) - float(fn(ta, tb))) <= 1e-5 * max(1.0, abs(float(fn(ta, tb))))
    got = M.illuminance_correct(ta.to(dev), tb.to(dev)).cpu()
    assert _rel(got, M.illuminance_correct(ta, tb)) < 1e-6


def test_evaluate_on_card_matches_cpu(dev, tmp_path):
    """The test_denoising CLI's evaluate on the card against the CPU on a
    small SID tree (dark shading, illuminance correction): each frame's
    PSNR within 1e-3 dB, SSIM within 1e-5, no kernel of the port
    launched."""
    import pickle

    from noisediff_tpu_torch.cli import test_denoising
    from noisediff_tpu_torch.models import LSID
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(1)
    sid = tmp_path / "SID"
    lines = []
    for i in (1, 2):
        for sub, fn, scale in (("short", f"{i:05d}_00_0.04s.ARW", 1 / 250),
                               ("long", f"{i:05d}_00_10s.ARW", 1.0)):
            (sid / "Sony" / sub).mkdir(parents=True, exist_ok=True)
            frame = 512 + rng.uniform(500, 12000, (96, 128)) * scale + rng.normal(0, 2, (96, 128))
            np.save(sid / "Sony" / sub / (fn + ".npy"), np.clip(frame, 0, 16383).astype(np.uint16))
        lines.append(f"./Sony/short/{i:05d}_00_0.04s.ARW ./Sony/long/{i:05d}_00_10s.ARW "
                     "ISO800 F1.8\n")
    (sid / "Sony_test_list.txt").write_text("".join(lines))
    res = tmp_path / "res"
    res.mkdir()
    for band in ("low", "high"):
        np.save(res / f"darkshading_{band}ISO_k.npy", rng.normal(0, 1e-3, (96, 128)))
        np.save(res / f"darkshading_{band}ISO_b.npy", rng.normal(0, 2, (96, 128)))
    with open(res / "darkshading_BLE.pkl", "wb") as f:
        pickle.dump({800: 0.3}, f)
    torch.manual_seed(0)
    torch.save(LSID(base_width=8).state_dict(), tmp_path / "net.pth")
    argv = ["--resume", str(tmp_path / "net.pth"), "--lsid_width", "8", "--ratio", "250",
            "--correct_darkshading", "--correct_illum", "--sid_folder", str(sid),
            "--resources_path", str(res), "--save_folder", str(tmp_path / "out")]
    reset_launch_counts()
    card = test_denoising.evaluate(test_denoising.build_parser().parse_args(
        argv + ["--device", "cuda"]))
    assert not any(launch_counts().values())
    cpu = test_denoising.evaluate(test_denoising.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert card["n"] == cpu["n"] == 2
    for a, b in zip(card["frames"], cpu["frames"]):
        assert abs(a["PSNR"] - b["PSNR"]) <= 1e-3 and abs(a["SSIM"] - b["SSIM"]) <= 1e-5


def test_fullframe_on_card_runs_the_kernels(dev):
    """generate_full_frame on the card (dim 16, bf16, a 64 x 96 frame):
    attn_tail, groupnorm_silu and dual_head launch 9, 42 and 1 times an
    evaluation; the sample is finite and within bf16 rounding of the fp32
    plain route's from the same noise."""
    from noisediff_tpu_torch.diffusion.fullframe import generate_full_frame
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from noisediff_tpu_torch.ops.schedules import make_schedule

    torch.manual_seed(0)
    ref = NoiseDiffNet(dim=16)
    clean = np.random.default_rng(2).uniform(0, 0.3, (64, 96, 4)).astype(np.float32)
    x = torch.randn((1, 64, 96, 4), generator=torch.Generator().manual_seed(3))
    out = {}
    for name, dtype in (("kernels", torch.bfloat16), ("fp32", None)):
        model = NoiseDiffNet(dim=16, dtype=dtype)
        model.load_state_dict(ref.state_dict())
        gd = GaussianDiffusion(model.to(dev, memory_format=torch.channels_last).eval(),
                               make_schedule("sigmoid2", 1000), image_size=64, device=dev)
        reset_launch_counts()
        out[name] = generate_full_frame(gd, clean, 24, sampling_timesteps=3, init_noise=x)
        counts = launch_counts()
    assert not any(counts.values())  # the fp32 run
    assert np.isfinite(out["kernels"]).all() and out["kernels"].shape == (64, 96, 4)
    rel = np.linalg.norm(out["kernels"] - out["fp32"]) / np.linalg.norm(out["fp32"])
    assert rel < 5e-2, rel
    reset_launch_counts()
    model = NoiseDiffNet(dim=16, dtype=torch.bfloat16)
    model.load_state_dict(ref.state_dict())
    gd = GaussianDiffusion(model.to(dev, memory_format=torch.channels_last).eval(),
                           make_schedule("sigmoid2", 1000), image_size=64, device=dev)
    generate_full_frame(gd, clean, 24, sampling_timesteps=2, init_noise=x)
    c = launch_counts()
    assert (c["fused_attn_tail"], c["fused_groupnorm_film_silu"], c["fused_dual_head"]) == (
        18, 84, 2)


def test_kernels_launch_on_the_tensors_card(dev):
    """Every kernel, given tensors on cuda:1 while cuda:0 is the current
    device, launches on cuda:1 (the wrappers make the tensors' card current
    for the launch, and restore the current device): each output lies on
    cuda:1 and agrees with the plain version there (relative L2 within
    2e-2); attn_tail's forward on its fused (48), streamed (192) and tiled
    (384) routes, its backward on the fused (48) and tiled (96) ones."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    one, bf = torch.device("cuda", 1), torch.bfloat16
    torch.cuda.set_device(0)
    reset_launch_counts()
    checks = []
    try:
        for c in (48, 192, 384):
            x, tok, p = _attn_args(one, 2, 8, c)
            checks.append((f"attn_tail {c}", fused_attn_tail(x, tok, *p),
                           reference_attn_tail(x, tok, *p)))
        for c in (48, 96):
            x, tok, p = _attn_args(one, 2, 8, c)
            g = _randn(one, 2, 8, 8, c, dtype=bf, seed=9)
            got, want = fused_attn_tail_bwd(x, tok, *p, g), reference_attn_tail_bwd(x, tok, *p, g)
            checks += [(f"attn_tail_bwd {c} {i}", a, b) for i, (a, b) in enumerate(zip(got, want))]
        x = _randn(one, 2, 256, 48, scale=1.5, dtype=bf)
        gn = (x, 1 + 0.1 * _randn(one, 48), 0.1 * _randn(one, 48, seed=1), None, None, 8, 1e-5,
              0.3 * _randn(one, 48, seed=2))
        checks.append(("groupnorm_silu", fused_groupnorm_film_silu(*gn),
                       reference_groupnorm_film_silu(*gn)))
        h, sa, sb = (_randn(one, 2, 8, 8, 48, dtype=bf, seed=s) for s in range(3))
        hp = (_randn(one, 48, 48, scale=48 ** -0.5), 0.1 * _randn(one, 48),
              _randn(one, 4, 48, scale=48 ** -0.5, seed=1), 0.1 * _randn(one, 4),
              _randn(one, 4, 48, scale=48 ** -0.5, seed=2), 0.1 * _randn(one, 4, seed=3))
        checks.append(("dual_head", fused_dual_head(h, sa, sb, *hp),
                       reference_dual_head(h, sa, sb, *hp)))
        xt, noise = _randn(one, 2, 8, 8, 4, seed=4), _randn(one, 2, 8, 8, 4, seed=5)
        dargs = (h, sa, sb, xt, noise) + hp + (ddim_step_scalars(0.3, 0.45, 0.1, 0.7),)
        checks.append(("ddim_head", fused_ddim_head_update(*dargs),
                       reference_ddim_head_update(*dargs)))
        x, g = _gn_inputs(one, 2, 8, 8, 48)
        checks += [("gn_stats", a, b) for a, b in zip(gn_stats(x), reference_gn_stats(x))]
        checks += [("gn_grad_stats", a, b)
                   for a, b in zip(gn_grad_stats(g, x), reference_gn_grad_stats(g, x))]
        checks.append(("conv_wgrad", conv_wgrad(g, x, 3, 3), reference_conv_wgrad(g, x, 3, 3)))
        q, k, v = (_randn(one, 2, 2, 128, 32, dtype=bf, seed=s) for s in range(3))
        checks.append(("flash_attention", flash_attention(q, k, v),
                       reference_flash_attention(q, k, v)))
        torch.cuda.synchronize(one)
        assert torch.cuda.current_device() == 0
    finally:
        torch.cuda.set_device(0)
    for name, got, want in checks:
        assert got.device == one, name
        assert bool(torch.isfinite(got.float()).all()) and _rel(got, want) < 2e-2, name
    assert all(launch_counts().values()), launch_counts()


DIST_RANK = r'''
import hashlib, json, os
import torch
from noisediff_tpu_torch.cli.common import set_precision_flags
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter
from noisediff_tpu_torch.ops.kernels import launch_counts
from noisediff_tpu_torch.ops.schedules import make_schedule
from noisediff_tpu_torch.parallel import mesh
from noisediff_tpu_torch.train.state import make_diffusion_train_step, make_optimizer

set_precision_flags()
shard, dev = mesh.setup(torch.device("cuda"), "gloo")
torch.manual_seed(0)
model = NoiseDiffNet(dim=16, dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last)
net = mesh.wrap(model.train(), dev, is_unread_parameter)
gd = GaussianDiffusion(net, make_schedule("sigmoid2", 1000), image_size=32, device=dev)
step = make_diffusion_train_step(gd, make_optimizer(model.parameters()), shard=shard)
g = torch.Generator(device=dev).manual_seed(1)
batch = {"noise": 0.02 * torch.randn((4, 32, 32, 4), generator=g, device=dev),
         "clean_img": 0.2 * torch.rand((4, 32, 32, 4), generator=g, device=dev),
         "coord": torch.rand((4, 32, 32, 2), generator=g, device=dev),
         "iso_ratio_idx": torch.tensor([24, 3, 24, 7], device=dev)}
batch = {k: shard.rows(v) for k, v in batch.items()}
metrics = []
for i in range(2):
    g.manual_seed(100 + i)
    metrics.append({k: float(v) for k, v in step(batch, g).items()})
h = hashlib.sha256()
for p in model.parameters():
    h.update(p.detach().float().cpu().numpy().tobytes())
print(json.dumps({"rank": shard.rank, "device": str(dev), "metrics": metrics,
                  "digest": h.hexdigest(), "launches": launch_counts()}))
mesh.teardown()
'''


def test_gloo_two_rank_step_on_one_card(dev, tmp_path):
    """Two ranks of a DDP training step (NoiseDiffNet dim 16, bf16, the
    kernels' route, crop 32, global batch 4) over gloo on CUDA tensors,
    both on cuda:0: both log the same loss and grad norm, end with
    bit-equal parameters, and launch the training path's kernels."""
    import json
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    try:
        for rank in (0, 1):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen([sys.executable, "-c", DIST_RANK], cwd=root, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    r0, r1 = outs
    assert (r0["device"], r1["device"]) == ("cuda:0", "cuda:0")
    assert r0["metrics"] == r1["metrics"] and r0["digest"] == r1["digest"]
    for name in ("fused_attn_tail", "fused_attn_tail_bwd", "gn_stats", "gn_grad_stats",
                 "fused_dual_head"):
        assert r0["launches"][name] > 0 and r0["launches"][name] == r1["launches"][name], name
