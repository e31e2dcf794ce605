"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold it against the JAX module's jnp reference and against the Pallas
kernel in interpret mode (as tests/test_attn_tail.py runs it), on the same
numpy inputs. fp32: rtol 5e-4 (PARITY.md:152). bf16: the two sides round
intermediates at different points, so they agree to a few bf16 ulps
(rtol/atol 3e-2 as in tests/test_attn_tail.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.ops.pallas import attn_tail as jax_attn
from noisediff_tpu.ops.pallas import dual_head as jax_dual
from noisediff_tpu.ops.pallas import groupnorm_silu as jax_gn
from noisediff_tpu_torch.ops.kernels import (
    fused_attn_tail, fused_dual_head, fused_groupnorm_film_silu)

from torch_port_util import ATOL, RTOL

DTYPES = {"fp32": (jnp.float32, torch.float32, RTOL, ATOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-2)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


def _attn_inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 8, c)).astype(np.float32)
    tok = (0.3 * rng.standard_normal((2, c))).astype(np.float32)
    # JAX layout (in, out) kernels
    p = dict(
        ln_scale=rng.uniform(0.5, 1.5, c), ln_bias=0.1 * rng.standard_normal(c),
        w1=rng.standard_normal((c, 2 * c)) / np.sqrt(c), b1=0.1 * rng.standard_normal(2 * c),
        w2=rng.standard_normal((2 * c, c)) / np.sqrt(2 * c), b2=0.1 * rng.standard_normal(c),
        wp=rng.standard_normal((c, c)) / np.sqrt(c), bp=0.1 * rng.standard_normal(c),
    )
    return x, tok, {k: np.asarray(v, np.float32) for k, v in p.items()}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("c", [48, 96])
def test_attn_tail_plain_matches_jax(dt, c):
    jdt, tdt, rtol, atol = DTYPES[dt]
    x, tok, p = _attn_inputs(c)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(tok, jdt)) + tuple(
        jnp.asarray(p[k]) for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "wp", "bp"))
    want_ref = np.asarray(jax_attn.reference_attn_tail(*jargs).astype(jnp.float32))
    want_pallas = np.asarray(jax_attn.fused_attn_tail(*jargs, 1, 1e-5, True).astype(jnp.float32))
    got = fused_attn_tail(
        _t(x, tdt), _t(tok, tdt), _t(p["ln_scale"]), _t(p["ln_bias"]), _t(p["w1"].T), _t(p["b1"]),
        _t(p["w2"].T), _t(p["b2"]), _t(p["wp"].T), _t(p["bp"]))
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(_np(got), want_ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(got), want_pallas, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("c,groups", [(48, 2), (48, 8), (96, 8)])
@pytest.mark.parametrize("film", [True, False])
def test_groupnorm_silu_plain_matches_jax(dt, c, groups, film):
    jdt, tdt, rtol, atol = DTYPES[dt]
    rng = np.random.default_rng(c + groups)
    x = (1.5 * rng.standard_normal((2, 64, c)) + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    fs = fsh = None
    if film:
        fs = (0.2 * rng.standard_normal((2, c))).astype(np.float32)
        fsh = (0.2 * rng.standard_normal((2, c))).astype(np.float32)
    jf = (None, None) if not film else (jnp.asarray(fs), jnp.asarray(fsh))
    jx = jnp.asarray(x, jdt)
    want_ref = np.asarray(jax_gn._reference(jx, jnp.asarray(gamma), jnp.asarray(beta), *jf,
                                            groups, 1e-5).astype(jnp.float32))
    want_pallas = np.asarray(jax_gn.fused_groupnorm_film_silu(
        jx, jnp.asarray(gamma), jnp.asarray(beta), *jf, groups, 1e-5, True).astype(jnp.float32))
    tf = (None, None) if not film else (_t(fs), _t(fsh))
    got = fused_groupnorm_film_silu(_t(x, tdt), _t(gamma), _t(beta), *tf, groups=groups)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(_np(got), want_ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(got), want_pallas, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("c", [48, 96])
def test_dual_head_plain_matches_jax(dt, c):
    jdt, tdt, rtol, atol = DTYPES[dt]
    rng = np.random.default_rng(c)
    x, sa, sb = (rng.standard_normal((2, 4, 8, c)).astype(np.float32) for _ in range(3))
    w1 = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
    w2 = (rng.standard_normal((c, 4)) / np.sqrt(c)).astype(np.float32)
    wr = (rng.standard_normal((c, 4)) / np.sqrt(c)).astype(np.float32)
    b1, b2, br = ((0.1 * rng.standard_normal(n)).astype(np.float32) for n in (c, 4, 4))
    jargs = tuple(jnp.asarray(a, jdt) for a in (x, sa, sb)) + tuple(
        jnp.asarray(a) for a in (w1, b1, w2, b2, wr, br))
    want_ref = np.asarray(jax_dual.reference_dual_head(*jargs))
    want_pallas = np.asarray(jax_dual.fused_dual_head(*jargs, 1, True))
    got = fused_dual_head(_t(x, tdt), _t(sa, tdt), _t(sb, tdt), _t(w1.T), _t(b1), _t(w2.T),
                          _t(b2), _t(wr.T), _t(br))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 8, 4)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=rtol, atol=atol)


def test_cpu_wrappers_do_not_count_launches():
    """The counters count kernel launches only; the plain path is not one."""
    before = (fused_attn_tail.launches, fused_groupnorm_film_silu.launches,
              fused_dual_head.launches)
    x, tok, p = _attn_inputs(48)
    fused_attn_tail(_t(x), _t(tok), _t(p["ln_scale"]), _t(p["ln_bias"]), _t(p["w1"].T),
                    _t(p["b1"]), _t(p["w2"].T), _t(p["b2"]), _t(p["wp"].T), _t(p["bp"]))
    fused_groupnorm_film_silu(_t(x).view(2, 32, 48), torch.ones(48), torch.zeros(48))
    assert (fused_attn_tail.launches, fused_groupnorm_film_silu.launches,
            fused_dual_head.launches) == before


@pytest.mark.parametrize("device", ["meta"])
def test_wrappers_refuse_other_devices(device):
    """Off the CPU a wrapper launches its kernel or raises; it never falls
    back to the plain version."""
    x = torch.empty((2, 4, 8, 48), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fused_attn_tail(x, x[:, 0, 0], *(torch.empty(1, device=device),) * 8)
    with pytest.raises(ValueError):
        fused_groupnorm_film_silu(x.view(2, 32, 48), torch.empty(48, device=device),
                                  torch.empty(48, device=device))
    with pytest.raises(ValueError):
        fused_dual_head(x, x, x, *(torch.empty(1, device=device),) * 6)
