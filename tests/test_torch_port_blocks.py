"""The port's NoiseDiffNet blocks against their flax modules, on the CPU.

Each flax module gets seeded numpy weights, which reach the port's module
through the weight bridge (noisediff_tpu_torch.weights); the same numpy
inputs go to both. fp32, rtol 5e-4 (PARITY.md:152). The JAX Upsample runs
as a phase decomposition and the JAX Downsample as a strided conv, so
those two agree up to fp32 reassociation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.models import blocks as jb
from noisediff_tpu_torch.models import blocks as pb

from torch_port_util import ATOL, RTOL, cl_to_nhwc, load_port, nhwc_to_cl, random_params

RNG = np.random.default_rng(11)


def _x(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(np.float32)


def _run_flax(module, params, *args):
    return np.asarray(module.apply({"params": params}, *args))


def test_resnet_block_time_film():
    x, t = _x(2, 8, 8, 16), _x(2, 32)
    fm = jb.ResnetBlock(24, time_emb_dim=32, groups=8)
    params = random_params(fm, jnp.asarray(x), jnp.asarray(t))
    want = _run_flax(fm, params, jnp.asarray(x), jnp.asarray(t))
    pm = load_port(pb.ResnetBlock(16, 24, time_emb_dim=32, groups=8), params)
    with torch.no_grad():
        got = cl_to_nhwc(pm(nhwc_to_cl(x), torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_resnet_block_skip_concat():
    a, b, t = _x(2, 8, 8, 16), _x(2, 8, 8, 8), _x(2, 32)
    fm = jb.ResnetBlock(16, time_emb_dim=32, groups=8)
    params = random_params(fm, (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(t))
    want = _run_flax(fm, params, (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(t))
    pm = load_port(pb.ResnetBlock(24, 16, time_emb_dim=32, groups=8), params)
    with torch.no_grad():
        got = cl_to_nhwc(pm((nhwc_to_cl(a), nhwc_to_cl(b)), torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_resnet_block2_per_pixel_film():
    x, pos = _x(2, 8, 8, 16), _x(2, 8, 8, 8)
    fm = jb.ResnetBlock2(16, pos_emb_dim=8, groups=2)
    params = random_params(fm, jnp.asarray(x), jnp.asarray(pos))
    want = _run_flax(fm, params, jnp.asarray(x), jnp.asarray(pos))
    pm = load_port(pb.ResnetBlock2(16, 16, pos_emb_dim=8, groups=2), params)
    with torch.no_grad():
        got = cl_to_nhwc(pm(nhwc_to_cl(x), nhwc_to_cl(pos)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c", [16, 48])
def test_attn_block_one_token(c):
    x, ctx = _x(2, 4, 8, c), _x(2, 1, 16)
    fm = jb.AttnBlock(heads=4, dim_head=32)
    params = random_params(fm, jnp.asarray(x), jnp.asarray(ctx))
    want = _run_flax(fm, params, jnp.asarray(x), jnp.asarray(ctx))
    pm = load_port(pb.AttnBlock(c, 16, heads=4, dim_head=32), params)
    with torch.no_grad():
        got = cl_to_nhwc(pm(nhwc_to_cl(x), torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _seq_rename(key):  # standalone flax resample module: conv.* -> Sequential slot 1
    return key.replace("conv.", "1.", 1)


def test_downsample_space_to_depth_order():
    x = _x(2, 8, 8, 16)
    fm = jb.Downsample(32)
    params = random_params(fm, jnp.asarray(x))
    want = _run_flax(fm, params, jnp.asarray(x))
    naive = _run_flax(jb.Downsample(32, naive=True), params, jnp.asarray(x))
    np.testing.assert_allclose(naive, want, rtol=RTOL, atol=ATOL)
    pm = load_port(pb.Downsample(16, 32), params, rename=_seq_rename)
    with torch.no_grad():
        got = cl_to_nhwc(pm(nhwc_to_cl(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_upsample():
    x = _x(2, 4, 4, 32)
    fm = jb.Upsample(16)
    params = random_params(fm, jnp.asarray(x))
    want = _run_flax(fm, params, jnp.asarray(x))
    pm = load_port(pb.Upsample(32, 16), params, rename=_seq_rename)
    with torch.no_grad():
        got = cl_to_nhwc(pm(nhwc_to_cl(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_time_mlp():
    t = np.array([0, 17, 999], np.int32)
    fm = jb.TimeMlp(16, 64)
    params = random_params(fm, jnp.asarray(t))
    want = _run_flax(fm, params, jnp.asarray(t))
    pm = load_port(pb.TimeMlp(16, 64), params)
    with torch.no_grad():
        got = pm(torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_learned_sinusoidal_pos_emb():
    coords = RNG.uniform(0, 1, (2, 8, 8, 2)).astype(np.float32)
    fm = jb.LearnedSinusoidalPosEmb(8)
    params = random_params(fm, jnp.asarray(coords))
    want = _run_flax(fm, params, jnp.asarray(coords))
    pm = load_port(pb.LearnedSinusoidalPosEmb(2, 8), params)
    with torch.no_grad():
        got = cl_to_nhwc(pm(nhwc_to_cl(coords)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gelu_forms():
    """tanh form in bf16, erf form in fp32 (blocks._gelu)."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jb._gelu(jnp.asarray(x, jdt)).astype(jnp.float32))
        got = pb.gelu(torch.from_numpy(x).to(tdt)).float().numpy()
        tol = 1e-6 if tdt == torch.float32 else 8e-3
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_nhwc_views_are_free():
    """A channels-last NCHW map is the NHWC layout: the kernels' view of it
    needs no copy."""
    x = torch.randn(2, 3, 4, 5).contiguous(memory_format=torch.channels_last)
    assert pb.to_nhwc(x).data_ptr() == x.data_ptr()
    assert pb.to_nchw(pb.to_nhwc(x)).is_contiguous(memory_format=torch.channels_last)
