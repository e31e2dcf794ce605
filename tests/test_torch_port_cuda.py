"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: they skip on a machine without an NVIDIA GPU (a CUDA kernel
has no CPU mode). On the card:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py sets up JAX, which the GPU machine need
not have; this file imports no JAX.)

Tolerances: the kernels and the plain versions take the same bf16 inputs
and store intermediates in bf16 at the same points; fp32 sums run in
another order, so an output may differ by a rounding flip at each stored
intermediate (chip_smoke.py states the same bounds at full size). TF32 is
off for matmuls and cuDNN convolutions (set_precision_flags), which the fp32
check below relies on.
"""
import numpy as np
import pytest
import torch

from noisediff_tpu_torch.cli.common import set_precision_flags
from noisediff_tpu_torch.ops.kernels import (
    fused_attn_tail, fused_dual_head, fused_groupnorm_film_silu, reference_attn_tail,
    reference_dual_head, reference_groupnorm_film_silu)

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
