"""Which blocks of the port run their kernel, the attn_tail plain versions
against the JAX kernel and its VJP, and the attn_tail backward's work
split, on the CPU.

* `blocks.runs_kernel` decides once, at construction, from the compute
  dtype and the channel width: a bf16 model runs every kernel at dim 48,
  an fp32 model none; the heads take C in {16, 32, 48, 64}, attn_tail
  C % 16 == 0.
* An fp32 model never calls a kernel wrapper: its forward, backward and
  the DDIM fused tail call the plain versions directly, and its forward
  matches the JAX model at the port's fp32 bound (rtol 5e-4, PARITY.md:152).
* `reference_attn_tail` and `reference_attn_tail_bwd` match the JAX
  `fused_attn_tail` and its VJP (the Pallas kernels in interpret mode) at
  ragged pixel counts, fp32, at the same bound.
* `bwd_plan` puts every pixel row in exactly one tile, and every row in
  exactly one of the sums' ranges, in a fixed order; `fwd_plan` puts every
  row in exactly one strip or group of a block's run (fused, streamed) or
  of the row and product kernels' grids (tiled), at every width the kernel
  takes, and its shared memory fits the card's 227 KB.
* The kernel libraries are named by a hash of their source and every
  header under csrc/, so an edited header is rebuilt.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.ops.pallas import attn_tail as jax_attn
from noisediff_tpu_torch.diffusion import gaussian as port_gaussian
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, noisediff_net
from noisediff_tpu_torch.models import blocks as pb
from noisediff_tpu_torch.ops.kernels import reference_attn_tail, reference_attn_tail_bwd
from noisediff_tpu_torch.ops.kernels import _build
from noisediff_tpu_torch.ops.kernels import attn_tail as port_attn

from torch_port_util import ATOL, RTOL, load_port, random_params

_PARAMS = ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "wp", "bp")
_WRAPPERS = {pb: ("fused_attn_tail", "fused_groupnorm_film_silu", "gn_stats", "gn_grad_stats",
                  "flash_attention"),
             noisediff_net: ("fused_dual_head",),
             port_gaussian: ("fused_ddim_head_update",)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _routes(model):
    """{channel width: set of decisions} per kernel family of a model."""
    out = {"attn_tail": {}, "groupnorm": {}}
    for m in model.modules():
        if isinstance(m, pb.AttnBlock):
            out["attn_tail"].setdefault(m.norm2.weight.numel(), set()).add(m.kernel)
        if isinstance(m, pb.GroupNorm):
            out["groupnorm"].setdefault(m.weight.numel(), set()).add(m.kernels)
    return out


@pytest.mark.parametrize("dtype,dim,attn,heads", [
    (torch.bfloat16, 48, {48: True, 96: True, 192: True, 384: True}, True),
    (None, 48, {48: False, 96: False, 192: False, 384: False}, False),
    (torch.float32, 48, {48: False, 96: False, 192: False, 384: False}, False),
    (torch.bfloat16, 96, {96: True, 192: True, 384: True, 768: True}, False),
    (torch.bfloat16, 40, {40: False, 80: True, 160: True, 320: True}, False),
    (torch.bfloat16, 16, {16: True, 32: True, 64: True, 128: True}, True),
])
def test_model_routes(dtype, dim, attn, heads):
    with torch.device("meta"):
        model = NoiseDiffNet(dim=dim, dtype=dtype)
    routes = _routes(model)
    assert {c: d.pop() for c, d in routes["attn_tail"].items() if len(d) == 1} == attn
    assert model.head_kernel is heads
    # the GroupNorm kernels take every width of these models in bf16
    assert all(d == {dtype == torch.bfloat16} for d in routes["groupnorm"].values())


def test_runs_kernel_rule():
    bf = torch.bfloat16
    assert pb.runs_kernel("attn_tail", bf, 48) and not pb.runs_kernel("attn_tail", bf, 40)
    assert pb.runs_kernel("attn_tail", bf, 768) and not pb.runs_kernel("attn_tail", bf, 784)
    assert not pb.runs_kernel("attn_tail", None, 48)
    assert not pb.runs_kernel("attn_tail", torch.float32, 48)
    assert [c for c in (8, 16, 32, 48, 64, 96) if pb.runs_kernel("heads", bf, c)] == \
        [16, 32, 48, 64]
    assert pb.runs_kernel("groupnorm", bf, 1024) and not pb.runs_kernel("groupnorm", bf, 1032)
    assert not pb.runs_kernel("groupnorm", bf, 12)
    assert pb.runs_kernel("flash", bf, 32) and not pb.runs_kernel("flash", bf, 16)
    assert pb.Attention(64, dtype=bf).kernel and not pb.Attention(64).kernel


@pytest.fixture
def no_wrappers(monkeypatch):
    """Every kernel wrapper a model could call raises."""
    def refuse(*_, **__):
        raise AssertionError("a kernel wrapper was called on the plain route")

    for module, names in _WRAPPERS.items():
        for name in names:
            monkeypatch.setattr(module, name, refuse)


B, S, DIM = 2, 16, 16


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, S, 4)).astype(np.float32)
    cond = {
        "clean_img": rng.uniform(0, 0.3, (B, S, S, 4)).astype(np.float32),
        "position": rng.uniform(0, 1, (B, S, S, 2)).astype(np.float32),
        "iso_ratio_idx": np.array([24, 3], np.int32),
    }
    return x, cond


def test_fp32_model_forward_on_the_plain_route_matches_jax(no_wrappers):
    jnet = JaxNet(dim=DIM)
    x, cond = _inputs()
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    params = random_params(jnet, jnp.asarray(x), jnp.zeros((B,), jnp.int32), jcond)
    t = np.array([999, 37], np.int32)
    want = np.asarray(jax.jit(lambda p, xx, tt, cc: jnet.apply({"params": p}, xx, tt, cc))(
        params, jnp.asarray(x), jnp.asarray(t), jcond))
    port = load_port(NoiseDiffNet(dim=DIM), params).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   {k: torch.from_numpy(v) for k, v in cond.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL * 10)


def test_fp32_training_and_fused_ddim_call_no_wrapper(no_wrappers):
    torch.manual_seed(0)
    model = NoiseDiffNet(dim=8).train()
    x, cond = _inputs(2)
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    model(torch.from_numpy(x), torch.tensor([5, 900]), tcond).square().mean().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    model.eval()
    gd = GaussianDiffusion.create(model, image_size=S, timesteps=100, beta_schedule="sigmoid2",
                                  device="cpu")

    def trunk_fn(xx, tt, cc):
        return (*model.trunk(xx, tt, cc), model.head_weights())

    out = gd.ddim_sample(x.shape, tcond, sampling_timesteps=2, trunk_fn=trunk_fn,
                         generator=torch.Generator().manual_seed(0))
    assert out.shape == x.shape and torch.isfinite(out).all()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("shape", [(1, 7, 9, 16), (2, 2, 2, 32), (1, 126, 126, 16)])
def test_attn_tail_plain_matches_jax_vjp(shape):
    """Forward and all ten gradients at pixel counts that are not multiples
    of 16 (63, 8 and 15,876 pixels)."""
    c = shape[-1]
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    tok = (0.3 * rng.standard_normal((shape[0], c))).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    p = {k: np.asarray(v, np.float32) for k, v in dict(  # JAX (in, out) kernels
        ln_scale=rng.uniform(0.5, 1.5, c), ln_bias=0.1 * rng.standard_normal(c),
        w1=rng.standard_normal((c, 2 * c)) / np.sqrt(c), b1=0.1 * rng.standard_normal(2 * c),
        w2=rng.standard_normal((2 * c, c)) / np.sqrt(2 * c), b2=0.1 * rng.standard_normal(c),
        wp=rng.standard_normal((c, c)) / np.sqrt(c), bp=0.1 * rng.standard_normal(c)).items()}
    jargs = (jnp.asarray(x), jnp.asarray(tok)) + tuple(jnp.asarray(p[k]) for k in _PARAMS)
    want_y, vjp = jax.vjp(lambda *a: jax_attn.fused_attn_tail(*a, 1, 1e-5, True), *jargs)
    want = vjp(jnp.asarray(g))
    targs = (_t(x), _t(tok)) + tuple(_t(p[k].T if k[0] == "w" else p[k]) for k in _PARAMS)
    np.testing.assert_allclose(reference_attn_tail(*targs).numpy(), np.asarray(want_y),
                               rtol=RTOL, atol=ATOL * 10)
    got = reference_attn_tail_bwd(*targs, _t(g))
    for name, gt, wt in zip(("x", "tok") + _PARAMS, got, want):
        gt = gt.numpy().T if name in ("w1", "w2", "wp") else gt.numpy()
        np.testing.assert_allclose(gt, np.asarray(wt).reshape(gt.shape), rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(wt).max())), err_msg=name)


PLAN_CASES = [(4, 512 * 512, 48), (1, 178 * 266, 384), (4, 126 * 126, 96), (4, 4, 384),
              (1, 63, 16), (2, 8, 32), (3, 1000, 48), (4, 64 * 64, 384), (2, 17, 768)]


@pytest.mark.parametrize("b,hw,c", PLAN_CASES)
def test_bwd_plan_covers_every_pixel_once(b, hw, c):
    plan = port_attn.bwd_plan(b, hw, c, sms=132, blocks_per_sm=1)
    p = b * hw
    assert plan["P"] == p and plan["route"] == ("fused" if c <= 48 else "tiled")
    if plan["route"] == "fused":
        ranges = port_attn.block_tiles(plan)
        assert len(ranges) == plan["grid"] <= 132
        # the blocks' tile runs tile [0, tiles) in order, none empty
        assert ranges[0][0] == 0 and ranges[-1][1] == plan["tiles"]
        assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
        assert all(t1 > t0 for t0, t1 in ranges)
        rows = [port_attn.tile_rows(plan, t) for t in range(plan["tiles"])]
        assert rows[0][0] == 0 and rows[-1][1] == p
        assert all(a[1] == b_[0] for a, b_ in zip(rows, rows[1:]))
        assert rows[-1][1] - rows[-1][0] == plan["last_rows"] <= plan["M"]
        for t in range(plan["tiles"]):
            s0, s1 = port_attn.tile_samples(plan, t)
            r0, r1 = rows[t]
            assert s0 == r0 // hw and s1 == (r1 - 1) // hw and s0 <= s1 < b
        assert plan["smem"] <= 227 * 1024
        return
    splits = port_attn.split_ranges(plan)
    assert len(splits) == plan["splits"] and plan["rows_per_split"] % 32 == 0
    assert splits[0][0] == 0 and splits[-1][1] == p
    assert all(a[1] == b_[0] and a[1] > a[0] for a, b_ in zip(splits, splits[1:]))
    assert (plan["row_tiles"] - 1) * 128 < p <= plan["row_tiles"] * 128
    ranges = port_attn.ln_ranges(plan)
    assert len(ranges) == b * plan["ln_splits"]
    assert ranges[0][0] == 0 and ranges[-1][1] == p
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    # no range crosses a sample, none is empty
    assert all(r1 > r0 and r0 // hw == (r1 - 1) // hw for r0, r1 in ranges)


def test_bwd_route_widths():
    assert [port_attn.bwd_route(c) for c in (16, 32, 48, 64, 96, 768)] == \
        ["fused"] * 3 + ["tiled"] * 3
    for c in (8, 40, 784):
        with pytest.raises(ValueError):
            port_attn.bwd_route(c)


# ragged pixel counts, tiles across samples, the canonical stages' counts
FWD_HWS = (1, 7, 63, 64, 65, 1000, 178 * 266, 512 * 512)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("c", range(16, port_attn.TILED_MAX_C + 1, 16))
def test_fwd_plan_covers_every_pixel_once(b, c):
    """The forward's plan at every width the kernel takes: the fused route
    at C <= 48 and at 96, streamed at 192, the tiled one at the others;
    every pixel row in exactly one strip (fused) or group (streamed) of one
    block's run, or one LayerNorm block and one row tile of the products
    (tiled); shared memory within the card's 227 KB."""
    for hw in FWD_HWS:
        plan = port_attn.fwd_plan(b, hw, c, sms=132, blocks_per_sm=2)
        p = b * hw
        assert plan["P"] == p and plan["smem"] <= 227 * 1024
        assert plan["route"] == ("fused" if c <= 48 or c == 96 else
                                 "streamed" if c == 192 else "tiled")
        if plan["route"] != "tiled":
            assert plan["smem"] == port_attn.fwd_smem_bytes(c)
            assert plan["launches"] == (1 if plan["route"] == "fused" else 2)
            assert plan["M"] == (16 if plan["route"] == "fused" else 128)
            ranges = port_attn.block_tiles(plan)
            assert len(ranges) == plan["grid"] <= 2 * 132
            assert ranges[0][0] == 0 and ranges[-1][1] == plan["tiles"]
            assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
            assert all(t1 > t0 for t0, t1 in ranges)
            # a block's warps split its strips, each strip to one warp (the
            # streamed route: each warp takes one strip of every group)
            for k in range(0, plan["grid"] if plan["route"] == "fused" else 0,
                           max(1, plan["grid"] // 7)):
                got = sorted(t for w in range(plan["warps"])
                             for t in port_attn.warp_tiles(plan, k, w))
                assert got == list(range(*ranges[k]))
            rows = [port_attn.tile_rows(plan, t) for t in range(plan["tiles"])]
            assert rows[0][0] == 0 and rows[-1][1] == p
            assert all(a[1] == b_[0] for a, b_ in zip(rows, rows[1:]))
            assert rows[-1][1] - rows[-1][0] == plan["last_rows"] <= plan["M"]
            for t in range(0, plan["tiles"], max(1, plan["tiles"] // 97)):
                s0, s1 = port_attn.tile_samples(plan, t)
                r0, r1 = rows[t]
                assert s0 == r0 // hw and s1 == (r1 - 1) // hw and s0 <= s1 < b
            continue
        assert plan["launches"] == 4
        assert (plan["ln_blocks"] - 1) * plan["ln_rows"] < p <= plan["ln_blocks"] * plan["ln_rows"]
        assert (plan["row_tiles"] - 1) * 128 < p <= plan["row_tiles"] * 128
        # the cast blocks round every weight element once, 8 a thread
        assert (plan["cast_blocks"] - 1) * 256 * 8 < 5 * c * c <= plan["cast_blocks"] * 256 * 8
        for (rt, ct), n in zip(plan["gemm_grids"], (2 * c, c, c)):
            assert rt == plan["row_tiles"] and (ct - 1) * 128 < n <= ct * 128
        assert plan["scratch"] == 5 * c * c + 4 * c * p


def test_fwd_routes():
    """The default routes, the widths the fused kernel is built for (where
    the tiled route also runs, to be measured against it), and what neither
    takes."""
    assert [port_attn.fwd_route(c) for c in (16, 32, 48, 64, 96, 192, 384, 768)] == \
        ["fused"] * 3 + ["tiled", "fused", "streamed", "tiled", "tiled"]
    for route, widths in (("fused", port_attn.FWD_FUSED_WIDTHS),
                          ("streamed", port_attn.FWD_STREAMED_WIDTHS)):
        for c in widths:
            assert port_attn.fwd_plan(2, 100, c, 132, route=route)["route"] == route
            assert port_attn.fwd_plan(2, 100, c, 132, route="tiled")["route"] == "tiled"
            assert port_attn.fwd_smem_bytes(c) <= 227 * 1024
    with pytest.raises(ValueError):
        port_attn.fwd_plan(1, 64, 96, 132, route="streamed")
    for c in (8, 40, 784):
        with pytest.raises(ValueError):
            port_attn.fwd_route(c)
    with pytest.raises(ValueError):
        port_attn.fwd_plan(1, 64, 64, 132, route="fused")
    with pytest.raises(ValueError):
        port_attn.fwd_plan(0, 64, 48, 132)


def test_lib_path_hashes_every_header(monkeypatch, tmp_path):
    """A library's name changes with its source, with any header under
    csrc/ (an edit, a new one) and with nothing else."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    names = ("attn_tail", "attn_tail_bwd", "gn_stats")
    before = {n: _build._lib_path(n) for n in names}
    (tmp_path / "notes.txt").write_text("not under csrc/")
    assert {n: _build._lib_path(n) for n in names} == before
    seen = [before]
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    assert "attn_tail_chain.cuh" in headers and "common.cuh" in headers
    for edit in [*headers, "extra.cuh"]:
        with open(csrc / edit, "a") as f:
            f.write("\n// edited\n")
        now = {n: _build._lib_path(n) for n in names}
        assert all(now[n] != old[n] for n in names for old in seen), edit
        seen.append(now)
    with open(csrc / "attn_tail.cu", "a") as f:
        f.write("\n")
    assert _build._lib_path("attn_tail") != seen[-1]["attn_tail"]
    assert _build._lib_path("gn_stats") == seen[-1]["gn_stats"]
