"""The Block conv bias folded into groupnorm_silu, and the redesigned
kernels' host side, on the CPU.

In evaluation a bf16 Block runs its conv without the bias and hands the
bias to the groupnorm_silu kernel (`GroupNorm.folds_bias`), which adds it
where it reads x, rounded to x's dtype as the conv's own bias add stores
it. On the CPU the wrapper runs its plain version, which these tests hold
against the JAX package on the same numpy inputs: the plain function
against the JAX kernel (interpret mode) and its jnp reference applied to
round(x + b); Blocks, ResnetBlocks and a small NoiseDiffNet in bf16
against the flax modules on bridged weights. Tolerances: fp32 rtol 5e-4
(PARITY.md:152); bf16 3e-2, a few bf16 ulps, as in
test_torch_port_kernels.py (the two sides round intermediates at
different points); the whole model by relative L2 within 5e-2, the bound
chip_smoke.py holds the card's bf16 forward to.

Also: the groupnorm_silu launch plan (`plan`) covers every row of every
sample once within the card's shared memory, training keeps the bias on
the conv, and the head wrappers pass the fp32 parameters to the kernel
without casting them per call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.models import blocks as jb
from noisediff_tpu.ops.pallas import groupnorm_silu as jax_gn
from noisediff_tpu_torch.models import NoiseDiffNet
from noisediff_tpu_torch.models import blocks as pb
from noisediff_tpu_torch.ops.kernels import _build
from noisediff_tpu_torch.ops.kernels import dual_head as port_dual
from noisediff_tpu_torch.ops.kernels import groupnorm_silu as port_gn
from noisediff_tpu_torch.ops.kernels import reference_groupnorm_film_silu

from torch_port_util import ATOL, RTOL, cl_to_nhwc, load_port, nhwc_to_cl, random_params

DTYPES = {"fp32": (jnp.float32, torch.float32, RTOL, ATOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-2)}
MODEL_REL = 5e-2


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("groups", [2, 8])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", [(2, 64, 48), (1, 63, 16)])  # (B, N, C); 63 = 7 x 9 pixels
def test_plain_with_conv_bias_matches_jax(dt, groups, film, shape):
    jdt, tdt, rtol, atol = DTYPES[dt]
    b, n, c = shape
    rng = np.random.default_rng(n + c + groups)
    x = (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    fs = fsh = None
    if film:
        fs, fsh = ((0.2 * rng.standard_normal((b, c))).astype(np.float32) for _ in range(2))
    # the pre-norm values the conv's own bias add stores: x + b in x's dtype
    xb = (_t(x, tdt) + _t(bias).to(tdt)).float().numpy()
    jf = (None, None) if not film else (jnp.asarray(fs), jnp.asarray(fsh))
    jx = jnp.asarray(xb, jdt)
    want_ref = np.asarray(jax_gn._reference(jx, jnp.asarray(gamma), jnp.asarray(beta), *jf,
                                            groups, 1e-5).astype(jnp.float32))
    want_pallas = np.asarray(jax_gn.fused_groupnorm_film_silu(
        jx, jnp.asarray(gamma), jnp.asarray(beta), *jf, groups, 1e-5, True).astype(jnp.float32))
    tf = (None, None) if not film else (_t(fs), _t(fsh))
    got = reference_groupnorm_film_silu(_t(x, tdt), _t(gamma), _t(beta), *tf, groups=groups,
                                        conv_bias=_t(bias))
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), want_ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.float().numpy(), want_pallas, rtol=rtol, atol=atol)


@pytest.fixture
def fold_spy(monkeypatch):
    """Records, per GroupNorm call on the kernel's route, whether a conv
    bias came with it."""
    seen = []
    real = pb.fused_groupnorm_film_silu

    def spy(*args, **kwargs):
        conv_bias = args[7] if len(args) > 7 else kwargs.get("conv_bias")
        seen.append(conv_bias is not None)
        return real(*args, **kwargs)

    monkeypatch.setattr(pb, "fused_groupnorm_film_silu", spy)
    return seen


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _flax_bf16(module, params, *args):
    return np.asarray(module.apply({"params": params}, *args).astype(jnp.float32))


def _case_block(rng):
    x = _x(rng, 2, 8, 8, 16)
    fm = jb.Block(24, groups=8, dtype=jnp.bfloat16)
    params = random_params(fm, jnp.asarray(x))
    want = _flax_bf16(fm, params, jnp.asarray(x, jnp.bfloat16))
    pm = load_port(pb.Block(16, 24, groups=8, dtype=torch.bfloat16), params)
    return want, lambda: pm(nhwc_to_cl(x).to(torch.bfloat16)), [True]


def _case_block_film(rng):
    x, s, sh = _x(rng, 2, 8, 8, 16), 0.2 * _x(rng, 2, 1, 1, 24), 0.2 * _x(rng, 2, 1, 1, 24)
    fm = jb.Block(24, groups=8, dtype=jnp.bfloat16)
    jss = (jnp.asarray(s, jnp.bfloat16), jnp.asarray(sh, jnp.bfloat16))
    params = random_params(fm, jnp.asarray(x), jss)
    want = _flax_bf16(fm, params, jnp.asarray(x, jnp.bfloat16), jss)
    pm = load_port(pb.Block(16, 24, groups=8, dtype=torch.bfloat16), params)
    tss = tuple(nhwc_to_cl(a).to(torch.bfloat16) for a in (s, sh))
    return want, lambda: pm(nhwc_to_cl(x).to(torch.bfloat16), tss), [True]


def _case_resnet(rng):
    x, t = _x(rng, 2, 8, 8, 16), _x(rng, 2, 32)
    fm = jb.ResnetBlock(24, time_emb_dim=32, groups=8, dtype=jnp.bfloat16)
    params = random_params(fm, jnp.asarray(x), jnp.asarray(t))
    want = _flax_bf16(fm, params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16))
    pm = load_port(pb.ResnetBlock(16, 24, time_emb_dim=32, groups=8, dtype=torch.bfloat16),
                   params)
    return want, lambda: pm(nhwc_to_cl(x).to(torch.bfloat16),
                            torch.from_numpy(t).to(torch.bfloat16)), [True, True]


def _case_resnet2(rng):
    """block1 has the per-pixel FiLM (bias stays on the conv, plain route);
    block2 has none (folded)."""
    x, pos = _x(rng, 2, 8, 8, 16), _x(rng, 2, 8, 8, 8)
    fm = jb.ResnetBlock2(16, pos_emb_dim=8, groups=2, dtype=jnp.bfloat16)
    params = random_params(fm, jnp.asarray(x), jnp.asarray(pos))
    want = _flax_bf16(fm, params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos, jnp.bfloat16))
    pm = load_port(pb.ResnetBlock2(16, 16, pos_emb_dim=8, groups=2, dtype=torch.bfloat16),
                   params)
    return want, lambda: pm(nhwc_to_cl(x).to(torch.bfloat16),
                            nhwc_to_cl(pos).to(torch.bfloat16)), [True]


CASES = {"block": _case_block, "block_film": _case_block_film, "resnet": _case_resnet,
         "resnet2": _case_resnet2}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_eval_blocks_fold_and_match_jax(case, fold_spy):
    rng = np.random.default_rng(len(case))
    want, run, folded = CASES[case](rng)
    with torch.no_grad():
        got = cl_to_nhwc(run())
    assert fold_spy == folded
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def test_bf16_noisediffnet_forward_folds_and_matches_jax(fold_spy):
    b, s, dim = 2, 32, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, s, 4)).astype(np.float32)
    cond = {"clean_img": rng.uniform(0, 0.3, (b, s, s, 4)).astype(np.float32),
            "position": rng.uniform(0, 1, (b, s, s, 2)).astype(np.float32),
            "iso_ratio_idx": np.array([24, 3], np.int32)}
    t = np.array([700, 12], np.int32)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    params = random_params(JaxNet(dim=dim), jnp.asarray(x), jnp.zeros((b,), jnp.int32), jcond)
    jnet = JaxNet(dim=dim, dtype=jnp.bfloat16)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jcond)
                      .astype(jnp.float32))
    port = load_port(NoiseDiffNet(dim=dim, dtype=torch.bfloat16), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t).long(),
                   {k: torch.from_numpy(v) for k, v in cond.items()}).float().numpy()
    # 42 Blocks of the dim-16 trunk and shot branch run the kernel's route,
    # all with their conv bias; the two per-pixel-FiLM ones do not
    assert len(fold_spy) == 42 and all(fold_spy)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert got.shape == (b, s, s, 4) and np.isfinite(got).all()
    assert rel < MODEL_REL, rel


@pytest.mark.parametrize("train", [True, False])
def test_block_bias_gets_its_gradient(train, fold_spy):
    """Training keeps the bias on the conv (the gn_stats route, no fold);
    an evaluation forward with autograd on folds it, and the bias gets the
    same gradient through the plain version's backward."""
    torch.manual_seed(0)
    block = pb.Block(16, 24, groups=8, dtype=torch.bfloat16)
    block.train(train)
    x = torch.randn(2, 16, 8, 8).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    block(x).float().square().sum().backward()
    assert fold_spy == ([] if train else [True])
    g = block.proj.bias.grad
    assert g is not None and bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


@pytest.mark.parametrize("kernels,training,per_pixel,folds", [
    (True, False, False, True), (True, True, False, False), (True, False, True, False),
    (False, False, False, False)])
def test_folds_bias_only_on_the_kernel_route(kernels, training, per_pixel, folds):
    gn = pb.GroupNorm(24, 8, dtype=torch.bfloat16 if kernels else None)
    gn.train(training)
    ss = None
    if per_pixel:
        ss = (torch.zeros(2, 24, 8, 8), torch.zeros(2, 24, 8, 8))
    assert gn.folds_bias(ss) is folds
    assert gn.folds_bias((torch.zeros(2, 24, 1, 1),) * 2) is (kernels and not training)
    if not folds:
        with pytest.raises(ValueError):
            gn(torch.zeros(2, 24, 8, 8), ss, conv_bias=torch.zeros(24))


def _slabs(b, n, p):
    """Every block's (sample, first row, end row) in every round, as the
    kernel's slab_of makes them."""
    for r in range(p["rounds"]):
        s0 = r * p["spr"]
        ns = min(p["spr"], b - s0)
        bps = p["grid"] // ns
        for blk in range(ns * bps):
            part = blk % bps
            yield s0 + blk // bps, part * n // bps, (part + 1) * n // bps


@pytest.mark.parametrize("b,n,c", [
    (4, 512 * 512, 48), (4, 256 * 256, 96), (4, 128 * 128, 192), (4, 64 * 64, 384),
    (1, 178 * 266, 384), (4, 126 * 126, 96), (1, 512 * 512, 96), (2, 64, 48), (2, 16, 8),
    (4, 4, 1024), (3, 1000, 200)])
def test_groupnorm_plan_covers_every_row_once(b, n, c):
    limit, sms = 232448, 132  # the H100's opt-in shared memory per block, its SMs
    p = port_gn.plan(b, n, c, sms, limit)
    lanes = c // 8
    assert p["threads"] % lanes == 0 and p["threads"] <= port_gn.MAX_THREADS
    assert 1 <= p["grid"] <= sms and p["smem"] <= limit
    assert 1 <= p["spr"] <= min(b, p["grid"]) and p["rounds"] * p["spr"] >= b
    covered = np.zeros((b, n), np.int64)
    widest = 0
    for s, r0, r1 in _slabs(b, n, p):
        covered[s, r0:r1] += 1
        widest = max(widest, r1 - r0)
    assert (covered == 1).all() and widest == p["rows"]
    # rows past res_rows are read twice; that happens only where one
    # sample's slab alone is over a block's shared memory
    assert (widest > p["res_rows"]) == p["reread"]
    if p["reread"]:
        assert p["spr"] == 1 and p["smem"] + 2 * c > limit
    else:
        assert p["res_rows"] == widest


def test_groupnorm_plan_main_path_reads_x_once():
    """At the canonical shapes every sample fits on chip: x is read once."""
    for res, c in [(512, 48), (256, 96), (128, 192), (64, 384)]:
        assert not port_gn.plan(4, res * res, c, 132, 232448)["reread"]


def test_wrappers_pass_parameters_without_casting(monkeypatch):
    """The head and groupnorm_silu wrappers hand the fp32 parameters (and
    the time-MLP's bf16 FiLM halves) to the kernels as they are: no cast,
    copy or `Tensor.to` per call."""
    dev = torch.device("cpu")
    c = 48
    head = (torch.randn(c, c), torch.randn(c), torch.randn(4, c), torch.randn(4), torch.randn(4, c),
            torch.randn(4))
    t = torch.randn(2, 2 * c).to(torch.bfloat16)
    calls = []
    real_to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        calls.append(args)
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    got = port_dual.head_params(*head, dev)
    gamma = torch.randn(c)
    fs, fsh = port_gn._film(t[:, :c], t[:, c:], 2, c, dev)
    assert all(a is b for a, b in zip(got, head))
    assert _build.on_device(gamma, dev, torch.float32) is gamma
    assert fs.data_ptr() == t.data_ptr() and fsh.data_ptr() == t[:, c:].data_ptr()
    assert fs.dtype == torch.bfloat16 and fs.stride() == (2 * c, 1)
    assert calls == []
    # a bf16 weight is converted (the kernel reads fp32)
    assert port_dual.head_params(head[0].to(torch.bfloat16), *head[1:], dev)[0].dtype == \
        torch.float32
