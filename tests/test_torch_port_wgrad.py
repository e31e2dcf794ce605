"""The port's conv weight-gradient route against the JAX package, on the CPU.

`conv_wgrad` runs its plain version (the tap sum) for CPU tensors; it is
held against the JAX Pallas kernel in interpret mode
(ops/pallas/conv_wgrad.conv_wgrad). The route through models/blocks.Conv2d
is held against the default conv backward, and a whole NoiseDiffNet
training step (dim 16, 16^2, batch 2) with NOISEDIFF_WGRAD=pallas against
JAX with NOISEDIFF_WGRAD=pallas-interpret. The kernel is bf16-only, so the
route is taken for a bf16 input at widths it takes (`Conv2d.wgrad_route`);
an fp32 step takes PyTorch's wgrad and still matches JAX, whose kernel runs
in fp32. The gate's decisions are held against the JAX
`_wgrad_pallas_mode`, as tests/test_conv_wgrad.py:174-198 drives it. fp32:
rtol 5e-4 (PARITY.md:152); gradients of the whole step within 2e-3
relative L2, as tests/test_torch_port_train_model.py holds them. bf16, the
route against the default backward: the default rounds dW and db to bf16
(autograd through the parameters' cast) where the route keeps fp32, so
they agree within BF16_REL relative L2 (2^-9 per element, with margin).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.models import blocks as jax_blocks
from noisediff_tpu.ops.pallas.conv_wgrad import conv_wgrad as jax_conv_wgrad
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter
from noisediff_tpu_torch.models import blocks
from noisediff_tpu_torch.ops.kernels import conv_wgrad, reference_conv_wgrad
from noisediff_tpu_torch.ops.kernels.conv_wgrad import plan, reduce_slots, segments
from noisediff_tpu_torch.weights import jax_params_to_state_dict

from torch_port_util import RTOL, load_port, random_params

B, S, DIM = 2, 16, 16
T = 1000
BF16_REL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several test workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("kh,kw", [(1, 1), (3, 3), (1, 3), (3, 1)])
def test_plain_wgrad_matches_jax_kernel(kh, kw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    g = rng.standard_normal((2, 8, 12, 24)).astype(np.float32)
    want = np.asarray(jax_conv_wgrad(jnp.asarray(g), jnp.asarray(x), kh, kw, interpret=True))
    got = conv_wgrad(torch.from_numpy(g), torch.from_numpy(x), kh, kw)
    assert got.dtype == torch.float32 and got.shape == (kh, kw, 16, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("ks,cin,cout,routed", [(3, 32, 48, True), (1, 64, 32, True),
                                                (3, 16, 48, False), (7, 32, 32, False)])
def test_conv2d_route_matches_default(monkeypatch, ks, cin, cout, routed):
    """Conv2d under NOISEDIFF_WGRAD=pallas: the same output and gradients
    as the default backward, and the route only where the gate allows
    (`routed`: for a bf16 input). An fp32 input never takes it: both runs
    are the default backward."""
    torch.manual_seed(0)
    conv = blocks.Conv2d(cin, cout, ks)
    x32 = torch.randn(2, cin, 9, 11).contiguous(memory_format=torch.channels_last)
    calls = []

    def counting(g, x, kh, kw):
        calls.append((kh, kw))
        return conv_wgrad(g, x, kh, kw)

    monkeypatch.setattr(blocks, "conv_wgrad", counting)
    for dtype in (torch.float32, torch.bfloat16):
        x0 = x32.to(dtype)
        outs = {}
        calls.clear()
        for flag in ("xla", "pallas"):
            monkeypatch.setenv("NOISEDIFF_WGRAD", flag)
            conv.zero_grad()
            x = x0.clone().requires_grad_(True)
            y = conv(x)
            (y.float().sin() * y.float()).sum().backward()
            outs[flag] = (y.detach(), x.grad, conv.weight.grad.clone(), conv.bias.grad.clone())
        if dtype == torch.float32:
            assert calls == []
            for a, b in zip(outs["xla"], outs["pallas"]):
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=1e-4)
        else:
            assert calls == ([(ks, ks)] if routed else [])
            for a, b in zip(outs["xla"], outs["pallas"]):
                assert _rel_l2(b.float().numpy(), a.float().numpy()) < BF16_REL


@pytest.mark.parametrize("dtype,ci,co,want", [
    (torch.float32, 48, 48, False), (torch.bfloat16, 48, 48, True),
    (torch.bfloat16, 40, 48, False), (torch.bfloat16, 48, 24, False),
    (torch.bfloat16, 16, 48, False), (torch.bfloat16, 96, 384, True),
    (torch.float16, 48, 48, False)])
def test_wgrad_route_decides_by_dtype_and_width(monkeypatch, dtype, ci, co, want):
    """Under NOISEDIFF_WGRAD=pallas a conv takes the kernel's route for a
    bf16 input with Ci, Co >= 32 and divisible by 16, and nothing else; no
    route where no weight gradient is taken."""
    monkeypatch.setenv("NOISEDIFF_WGRAD", "pallas")
    conv = blocks.Conv2d(ci, co, 3).train()
    x = torch.zeros(1, ci, 8, 8, dtype=dtype)
    assert conv.wgrad_route(x) == want
    with torch.no_grad():
        assert not conv.wgrad_route(x)


def test_gate_decisions_match_jax(monkeypatch):
    """wgrad_kernel_on against _wgrad_pallas_mode on a TPU backend (where the
    JAX gate can turn on), for every flag, area floor and train context."""
    monkeypatch.setattr(jax_blocks.jax, "default_backend", lambda: "tpu")
    shapes = [(2, 128, 64, 32), (2, 16, 16, 32), (1, 64, 64, 48)]
    for flag in (None, "xla", "pallas", "auto"):
        for min_hw in (None, "131072", "256"):
            for key, val in (("NOISEDIFF_WGRAD", flag), ("NOISEDIFF_WGRAD_MIN_HW", min_hw)):
                if val is None:
                    monkeypatch.delenv(key, raising=False)
                else:
                    monkeypatch.setenv(key, val)
            for shape in shapes:
                x = jnp.zeros(shape)
                for training in (False, True):
                    if training:
                        with jax_blocks.gn_train_trace():
                            want = jax_blocks._wgrad_pallas_mode(x) != ""
                    else:
                        want = jax_blocks._wgrad_pallas_mode(x) != ""
                    xt = torch.zeros(shape).permute(0, 3, 1, 2)
                    assert blocks.wgrad_kernel_on(xt, training) == want, (flag, min_hw, shape,
                                                                           training)
    for ci, co in [(32, 32), (16, 48), (48, 8), (384, 576)]:
        assert blocks.wgrad_channels_ok(ci, co) == jax_blocks._wgrad_channels_ok(ci, co)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    img = (0.05 * rng.standard_normal((B, S, S, 4))).astype(np.float32)
    cond = {
        "clean_img": rng.uniform(0, 0.3, (B, S, S, 4)).astype(np.float32),
        "position": rng.uniform(0, 1, (B, S, S, 2)).astype(np.float32),
        "iso_ratio_idx": np.array([24, 3], np.int32),
    }
    return img, cond


def test_training_step_gradients_match_jax(monkeypatch):
    jnet = JaxNet(dim=DIM)
    img, cond = _batch()
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    params = random_params(jnet, jnp.asarray(img), jnp.zeros((B,), jnp.int32), jcond, seed=3)
    jd = JaxDiffusion.create(lambda p, x, t, c: jnet.apply({"params": p}, x, t, c),
                             image_size=S, timesteps=T, beta_schedule="sigmoid2")
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        with jax_blocks.gn_train_trace():
            return jd.loss(p, key, jnp.asarray(img), jcond)

    monkeypatch.setenv("NOISEDIFF_WGRAD", "pallas-interpret")
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    t = np.array(jax.random.randint(jax.random.fold_in(key, 0), (B,), 0, T))
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), img.shape, jnp.float32))

    monkeypatch.setenv("NOISEDIFF_WGRAD", "pallas")
    calls = []

    def counting(g, x, kh, kw):
        calls.append((kh, kw))
        return conv_wgrad(g, x, kh, kw)

    monkeypatch.setattr(blocks, "conv_wgrad", counting)
    port = load_port(NoiseDiffNet(dim=DIM), params).train()
    # the convs whose forward ran with the route on: none, in fp32 (the
    # kernel is bf16-only; JAX's runs in fp32, and the step agrees)
    routed = []
    for m in port.modules():
        if isinstance(m, blocks.Conv2d):
            m.register_forward_pre_hook(
                lambda mod, args: routed.append(mod) if mod.wgrad_route(args[0]) else None)
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  device="cpu")
    loss = pd.loss(torch.from_numpy(img), {k: torch.from_numpy(v) for k, v in cond.items()},
                   t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    assert calls == routed == []

    want = jax_params_to_state_dict(jax.tree.map(np.asarray, want_grads))
    bad = {}
    for name, p in port.named_parameters():
        if is_unread_parameter(name):
            assert p.grad is None, name
            continue
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        r = _rel_l2(p.grad.numpy(), want[name].numpy())
        if r > 2e-3:
            bad[name] = r
    assert not bad, bad


def test_bf16_training_step_on_the_route(monkeypatch):
    """A bf16 training step (dim 16, 16^2, batch 2) under
    NOISEDIFF_WGRAD=pallas takes the route at every stride-1 1x1 / 3x3 conv
    with Ci, Co >= 32 and divisible by 16 (those of the 32-, 64- and
    128-wide stages), and agrees with the default backward: the same loss
    (the route's forward is the default's), every gradient within BF16_REL
    relative L2."""
    img, cond = _batch()
    rng = np.random.default_rng(7)
    t = torch.from_numpy(rng.integers(0, T, B)).long()
    noise = torch.from_numpy(rng.standard_normal(img.shape).astype(np.float32))
    calls = []

    def counting(g, x, kh, kw):
        calls.append((kh, kw))
        return conv_wgrad(g, x, kh, kw)

    monkeypatch.setattr(blocks, "conv_wgrad", counting)
    torch.manual_seed(3)
    net = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16).train()
    routed = []
    for m in net.modules():
        if isinstance(m, blocks.Conv2d):
            m.register_forward_pre_hook(
                lambda mod, args: routed.append(mod) if mod.wgrad_route(args[0]) else None)
    pd = GaussianDiffusion.create(net, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  device="cpu")
    runs = {}
    for flag in ("xla", "pallas"):
        monkeypatch.setenv("NOISEDIFF_WGRAD", flag)
        net.zero_grad(set_to_none=True)
        loss = pd.loss(torch.from_numpy(img), {k: torch.from_numpy(v) for k, v in cond.items()},
                       t=t, noise=noise)
        loss.backward()
        runs[flag] = (float(loss.detach()), {n: p.grad.clone() for n, p in net.named_parameters()
                                             if p.grad is not None})
    assert len(calls) == len(routed) > 10
    assert all(m.in_channels % 16 == 0 and m.out_channels % 16 == 0 and m.in_channels >= 32
               and m.out_channels >= 32 for m in routed)
    assert runs["pallas"][0] == runs["xla"][0]
    want, got = runs["xla"][1], runs["pallas"][1]
    assert got.keys() == want.keys()
    bad = {n: r for n in want
           if (r := _rel_l2(got[n].float().numpy(), want[n].float().numpy())) > BF16_REL}
    assert not bad, bad


def test_reference_matches_direct_sum():
    """The plain version against the definition, summed pixel by pixel."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 3, 4, 2)).astype(np.float32)
    g = rng.standard_normal((1, 3, 4, 3)).astype(np.float32)
    want = np.zeros((3, 3, 2, 3), np.float32)
    for i in range(3):
        for j in range(3):
            for h in range(3):
                for w in range(4):
                    hh, ww = h + i - 1, w + j - 1
                    if 0 <= hh < 3 and 0 <= ww < 4:
                        want[i, j] += np.outer(x[0, hh, ww], g[0, h, w])
    got = reference_conv_wgrad(torch.from_numpy(g), torch.from_numpy(x), 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# the 21 conv shapes of a canonical training step on the route (B 4, dim 48;
# chip_smoke.wgrad_conv_shapes) and the card tests' edges: (B, H, W, Ci, Co, k)
_STEP_SHAPES = [(4, 512, 512, 48, 48, 3), (4, 512, 512, 48, 48, 1), (4, 512, 512, 96, 48, 3),
                (4, 512, 512, 96, 48, 1), (4, 256, 256, 48, 48, 3), (4, 256, 256, 96, 96, 3),
                (4, 256, 256, 144, 96, 3), (4, 256, 256, 144, 96, 1), (4, 256, 256, 192, 96, 3),
                (4, 128, 128, 96, 96, 3), (4, 128, 128, 192, 192, 3), (4, 128, 128, 288, 192, 3),
                (4, 128, 128, 288, 192, 1), (4, 128, 128, 384, 192, 3), (4, 64, 64, 192, 192, 3),
                (4, 64, 64, 192, 384, 3), (4, 64, 64, 384, 384, 3), (4, 64, 64, 576, 384, 3),
                (4, 64, 64, 576, 384, 1)]
_EDGE_SHAPES = [(1, 9, 40, 48, 48, 3), (2, 13, 70, 48, 96, 3), (1, 3, 48, 576, 384, 1),
                (1, 64, 512, 48, 48, 3), (1, 5, 70, 16, 32, 3), (2, 8, 8, 32, 64, 3)]


@pytest.mark.parametrize("sms", [132, 7, 100000])
@pytest.mark.parametrize("shape", _STEP_SHAPES + _EDGE_SHAPES)
def test_wgrad_plan_covers_every_tile_once(shape, sms):
    """The kernel's work split: every (pair, pixel tile) unit falls in
    exactly one block's run, no block is empty, every partial has a slot of
    its own inside the scratch, and the second pass adds, for each pair,
    exactly the slots of that pair's segments in block order."""
    b, h, w, ci, co, k = shape
    p = plan(b, h, w, ci, co, k, k, sms)
    rows, cols = p["rows"], p["cols"]
    assert p["ctiles"] * cols >= w > (p["ctiles"] - 1) * cols
    assert p["bands"] * rows >= h > (p["bands"] - 1) * rows
    assert p["units"] == p["pairs"] * b * p["bands"] * p["ctiles"]
    assert p["grid"] == min(sms, p["units"])
    segs = segments(p)
    covered = [u for _, _, u0, u1, _ in segs for u in range(u0, u1)]
    assert covered == list(range(p["units"]))
    assert sorted({blk for blk, *_ in segs}) == list(range(p["grid"]))
    slots = [slot for *_, slot in segs]
    assert len(set(slots)) == len(slots)
    assert (max(slots) + 1) * k * k * 48 * 48 <= p["part_floats"]
    for pair in range(p["pairs"]):
        mine = [slot for _, pr, _, _, slot in segs if pr == pair]
        assert reduce_slots(p, pair) == mine
    if sms == 132:
        # the partials written and read stay under the operands' bytes at
        # the 48-channel shapes; at most (grid + pairs) tiles anywhere
        operands = 2 * b * h * w * (ci + co)
        if ci <= 96 and h * w >= 256 * 256:
            assert 2 * 4 * len(segs) * k * k * 48 * 48 < operands


def test_wgrad_plan_splits():
    """A pair spread over every SM (one 48 -> 48 pair at 512^2), and pairs
    that each fit one block (576 -> 384 1x1 on 3 x 48 pixels: 96 pairs of one
    tile each)."""
    p = plan(4, 512, 512, 48, 48, 3, 3, 132)
    assert p["pairs"] == 1 and len(reduce_slots(p, 0)) == 132
    p = plan(1, 3, 48, 576, 384, 1, 1, 132)
    assert p["pairs"] == p["units"] == p["grid"] == 96
    assert all(len(reduce_slots(p, pair)) == 1 for pair in range(96))
