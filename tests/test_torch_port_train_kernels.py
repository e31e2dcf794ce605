"""The training-path kernel modules of the port against the JAX package, on
the CPU: gn_stats, gn_grad_stats and the attn_tail backward.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold it against the Pallas kernel in interpret mode (as
tests/test_groupnorm_kernel.py and tests/test_attn_tail.py run them), on the
same numpy inputs, fp32. The sums are fp32 in another order on each side:
rtol 1e-5 with an absolute floor of 1e-4 for the sums, and the port's fp32
bound (rtol 5e-4, PARITY.md:152) for the attn_tail gradients.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.ops.pallas import attn_tail as jax_attn
from noisediff_tpu.ops.pallas import gn_stats as jax_gn
from noisediff_tpu_torch.ops.kernels import (
    KERNELS, fused_attn_tail, fused_attn_tail_bwd, gn_grad_stats, gn_stats,
    reference_attn_tail_bwd)

from torch_port_util import ATOL, RTOL

SHAPES = [(2, 8, 12, 32), (1, 4, 4, 8), (3, 16, 8, 48)]
_PARAMS = ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "wp", "bp")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_gn_stats_plain_matches_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    x = (2 * rng.standard_normal(shape) + 1).astype(np.float32)
    want_s, want_q = jax_gn.gn_stats(jnp.asarray(x), interpret=True)
    got_s, got_q = gn_stats(_t(x))
    assert got_s.dtype == torch.float32 and tuple(got_s.shape) == (shape[0], shape[3])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_gn_grad_stats_plain_matches_pallas(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    g = rng.standard_normal(shape).astype(np.float32)
    x = (2 * rng.standard_normal(shape) + 1).astype(np.float32)
    want_s, want_p = jax_gn.gn_grad_stats(jnp.asarray(g), jnp.asarray(x), interpret=True)
    got_s, got_p = gn_grad_stats(_t(g), _t(x))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-4)


def _attn_inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 8, c)).astype(np.float32)
    tok = (0.3 * rng.standard_normal((2, c))).astype(np.float32)
    g = rng.standard_normal((2, 4, 8, c)).astype(np.float32)
    # JAX layout (in, out) kernels
    p = dict(
        ln_scale=rng.uniform(0.5, 1.5, c), ln_bias=0.1 * rng.standard_normal(c),
        w1=rng.standard_normal((c, 2 * c)) / np.sqrt(c), b1=0.1 * rng.standard_normal(2 * c),
        w2=rng.standard_normal((2 * c, c)) / np.sqrt(2 * c), b2=0.1 * rng.standard_normal(c),
        wp=rng.standard_normal((c, c)) / np.sqrt(c), bp=0.1 * rng.standard_normal(c),
    )
    return x, tok, g, {k: np.asarray(v, np.float32) for k, v in p.items()}


def _port_args(x, tok, p):
    """The port takes (out, in) weights."""
    return (_t(x), _t(tok)) + tuple(_t(p[k].T if k[0] == "w" else p[k]) for k in _PARAMS)


@pytest.mark.parametrize("c", [16, 48])
def test_attn_tail_bwd_plain_matches_pallas(c):
    """All ten gradients of the plain backward against the Pallas backward
    kernel in interpret mode (the TPU's _bwd_kernel, fold 1)."""
    x, tok, g, p = _attn_inputs(c)
    want = jax_attn._pallas_bwd(jnp.asarray(x), jnp.asarray(tok),
                                *(jnp.asarray(p[k]) for k in _PARAMS), jnp.asarray(g),
                                1, 1e-5, True)
    got = fused_attn_tail_bwd(*_port_args(x, tok, p), _t(g))
    assert len(got) == len(want) == 10
    names = ("x", "tok") + _PARAMS
    for name, gt, wt in zip(names, got, want):
        gt = gt.numpy()
        if name in ("w1", "w2", "wp"):
            gt = gt.T
        np.testing.assert_allclose(gt, np.asarray(wt).reshape(gt.shape), rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(wt).max())),
                                   err_msg=name)


def test_attn_tail_wrapper_is_differentiable_on_cpu():
    """Autograd through fused_attn_tail on the CPU gives the plain
    backward's gradients."""
    x, tok, g, p = _attn_inputs(16, seed=3)
    args = [a.requires_grad_(True) for a in _port_args(x, tok, p)]
    fused_attn_tail(*args).backward(_t(g))
    want = reference_attn_tail_bwd(*_port_args(x, tok, p), _t(g))
    for a, w in zip(args, want):
        torch.testing.assert_close(a.grad, w)


def test_cpu_wrappers_do_not_count_launches():
    before = [k.launches for k in KERNELS]
    x = _t(np.ones((2, 4, 4, 16)))
    gn_stats(x)
    gn_grad_stats(x, x)
    xx, tok, g, p = _attn_inputs(16)
    fused_attn_tail_bwd(*_port_args(xx, tok, p), _t(g))
    assert [k.launches for k in KERNELS] == before


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises; it never falls
    back to the plain version."""
    x = torch.empty((2, 4, 8, 48), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gn_stats(x)
    with pytest.raises(ValueError):
        gn_grad_stats(x, x)
    with pytest.raises(ValueError):
        fused_attn_tail_bwd(x, x[:, 0, 0], *(torch.empty(1, device="meta"),) * 8, x)
