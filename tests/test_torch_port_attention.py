"""The port's flash attention, RMSNorm and Attention against the JAX
package, on the CPU.

`flash_attention` runs its plain version for CPU tensors; it is held
against the JAX `flash_attention` with its Pallas kernel in interpret mode
(a length its tiles divide) and at a ragged length (where the JAX function
runs its jnp reference), values and gradients. `Attention` carries a JAX
`blocks.Attention` param tree across through weights.py. fp32: rtol 5e-4
(PARITY.md:152) with an absolute floor for values near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.models.blocks import Attention as JaxAttention
from noisediff_tpu.models.blocks import RMSNorm as JaxRMSNorm
from noisediff_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from noisediff_tpu_torch.models.blocks import Attention, RMSNorm
from noisediff_tpu_torch.ops.kernels import flash_attention, reference_flash_attention
from noisediff_tpu_torch.weights import jax_params_to_state_dict, torch_key

from torch_port_util import ATOL, RTOL, cl_to_nhwc, load_port, nhwc_to_cl, random_params


def _qkv(n, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [512, 300])
def test_plain_flash_matches_jax(n):
    """512: the Pallas kernel (interpret) over two 256-row tiles; 300:
    ragged, the JAX function's jnp reference."""
    q, k, v = _qkv(n)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), None, True))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_flash_gradient_matches_jax():
    q, k, v = _qkv(300, seed=1)
    w = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def loss(qq, kk, vv):
        return jnp.sum(jax_flash(qq, kk, vv, None, True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (flash_attention(*leaves) * torch.from_numpy(w)).sum().backward()
    for leaf, wg in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wg), rtol=RTOL, atol=ATOL)


def test_reference_scale_and_rounding_points():
    """The plain version's explicit scale, and bf16 inputs give a bf16
    output (the weights cast to v's dtype, as the JAX reference)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(40, d=64, seed=3))
    want = torch.softmax(q @ k.transpose(-1, -2) * 0.3, dim=-1) @ v
    torch.testing.assert_close(reference_flash_attention(q, k, v, 0.3), want, rtol=1e-5,
                               atol=1e-6)
    out = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    assert float((out.float() - flash_attention(q, k, v)).abs().max()) < 3e-2


def _x(b, h, w, c, seed=4):
    return np.random.default_rng(seed).standard_normal((b, h, w, c)).astype(np.float32)


def test_rmsnorm_matches_jax():
    x = _x(2, 4, 6, 32)
    jm = JaxRMSNorm()
    params = random_params(jm, jnp.asarray(x), seed=5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = load_port(RMSNorm(32), params)
    assert port.g.shape == (1, 32, 1, 1)
    got = cl_to_nhwc(port(nhwc_to_cl(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads,dim_head", [(4, 32), (2, 64)])
def test_attention_matches_jax(heads, dim_head):
    """blocks.Attention with the JAX module's weights carried across:
    forward, and the gradient of the input."""
    c = 48
    x = _x(2, 8, 8, c)
    jm = JaxAttention(heads=heads, dim_head=dim_head)
    params = random_params(jm, jnp.asarray(x), seed=6)
    assert set(jax_params_to_state_dict(params)) == {
        "norm.g", "to_qkv.weight", "to_out.weight", "to_out.bias"}
    want, vjp = jax.vjp(lambda xx: jm.apply({"params": params}, xx), jnp.asarray(x))
    gy = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(gy))
    port = load_port(Attention(c, heads, dim_head), params)
    xt = nhwc_to_cl(x).requires_grad_(True)
    y = port(xt)
    (y * nhwc_to_cl(gy)).sum().backward()
    np.testing.assert_allclose(cl_to_nhwc(y), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cl_to_nhwc(xt.grad), np.asarray(want_dx), rtol=RTOL, atol=ATOL)


def test_nested_attention_keys():
    """An Attention inside another module keeps its RMSNorm's g (the bridge
    collapses a trailing 'norm' only for GroupNorm / LayerNorm primitives)
    and its plain conv to_out."""
    assert torch_key(("mid_attn", "norm", "g")) == "mid_attn.norm.g"
    assert torch_key(("mid_attn", "to_out", "conv", "kernel")) == "mid_attn.to_out.weight"
    assert torch_key(("downs_0_attn", "attn", "to_out", "dense", "kernel")) == \
        "downs.0.2.attn.to_out.0.weight"
