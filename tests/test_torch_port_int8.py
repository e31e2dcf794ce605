"""The port's w8a8 int8 inference route (NOISEDIFF_INT8=1) against the JAX
package's, on the CPU.

The JAX package is not modified: where a test counts quantized convs, its
`blocks._quantized_conv` is wrapped by a recorder through pytest's
monkeypatch (at trace time: `jax.eval_shape` sees every call), and the
port's `blocks.int8_conv` the same way.

Tolerances, with the distances measured when they were set:
  * the plain version against `_quantized_conv`: equal int8 values and
    bit-equal outputs, fp32 and bf16 (the integer sums are exact on both
    sides; every other step is the same IEEE operation);
  * which convs are quantized: the same multiset of (input, kernel) shapes
    as the JAX model's corresponding route (NoiseDiffNet dim 48: 77 in
    bf16 against the JAX fused heads and attention tail, 87 in fp32; LSID
    21; CameraCond dim 16);
  * outputs: teacher-forced (see `_Teacher`: the route is chaotic at the
    rounding level, so a free-running comparison bounds nothing), the
    fp32 outputs within `INT8_SHARE` (0.1) of the JAX package's own
    int8-against-float distance on the same weights, bf16 and the split
    frame as stated beside their tests.
"""
import argparse
import contextlib
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.models import blocks as jax_blocks
from noisediff_tpu.models import others as jax_others
from noisediff_tpu.models.lsid import LSID as JaxLSID
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import LSID, NoiseDiffNet, blocks, others
from noisediff_tpu_torch.train.trainer_denoising import Trainer as DenoiseTrainer
from noisediff_tpu_torch.train.trainer_diffusion import Trainer as DiffusionTrainer

from torch_port_util import load_port, random_params, run_ranks

# the kernel module (the package's `int8_conv` name is the wrapper)
port_int8 = importlib.import_module("noisediff_tpu_torch.ops.kernels.int8_conv")

INT8_SHARE = 0.1
BF16_SHARE = 0.5
BF16_GROWTH = 2.0
B, S, DIM, T = 2, 16, 16, 1000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU; one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def _env(**kw):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in kw.items():
            mp.setenv(k, v)
        yield


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_conv_operands(monkeypatch):
    """Record the int8 operands `_quantized_conv` hands to the conv."""
    seen = []
    real = jax.lax.conv_general_dilated

    def rec(lhs, rhs, *a, **k):
        if lhs.dtype == jnp.int8:
            seen.append((np.asarray(lhs), np.asarray(rhs)))
        return real(lhs, rhs, *a, **k)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", rec)
    return seen


# (x NHWC, kernel HWIO): test_int8.py's shape, Ci 48 (a ragged depth step),
# a 1x1, Co 16
CONV_SHAPES = [((2, 16, 16, 24), (3, 3, 24, 32)), ((2, 12, 10, 48), (3, 3, 48, 40)),
               ((2, 8, 9, 32), (1, 1, 32, 64)), ((1, 9, 7, 48), (3, 3, 48, 16))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,ks", CONV_SHAPES)
def test_plain_conv_is_jax_quantized_conv(monkeypatch, xs, ks, dtype):
    rng = np.random.default_rng(sum(xs) + sum(ks))
    x = rng.normal(size=xs).astype(np.float32)
    k = (rng.normal(size=ks) * 0.1).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    seen = _jax_conv_operands(monkeypatch)
    pad = ks[0] // 2
    want = jax_blocks._quantized_conv(jnp.asarray(x).astype(jdt), jnp.asarray(k), (1, 1),
                                      "SAME", jdt)
    (xq_jax, kq_jax), = seen
    xt = torch.from_numpy(x).to(tdt)
    kq, sw = port_int8.quantize_weight(torch.from_numpy(k).permute(3, 2, 0, 1))
    assert kq.dtype == torch.int8 and kq.shape[-1] % port_int8.K_STEP == 0
    np.testing.assert_array_equal(kq[..., :ks[2]].permute(1, 2, 3, 0).numpy(), kq_jax)
    np.testing.assert_array_equal(kq[..., ks[2]:].numpy(), 0)
    amax = port_int8.absmax(xt)
    sx = port_int8.activation_scale(amax)
    xq = torch.clamp(torch.round(xt.float() * (1.0 / sx)), -127, 127).to(torch.int8)
    np.testing.assert_array_equal(xq.numpy(), xq_jax)
    got = port_int8.int8_conv(xt, kq, sw, amax, (pad, pad))
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_plain_conv_parts_sum_then_bias():
    """Two parts of a concat, each with its own scales: the second part's
    output added to the first's in the output dtype, then the bias, as the
    JAX module's loop (blocks.py:518-548)."""
    rng = np.random.default_rng(5)
    xa, xb = (rng.normal(size=(1, 6, 5, c)).astype(np.float32) for c in (16, 24))
    k = (rng.normal(size=(3, 3, 40, 24)) * 0.1).astype(np.float32)
    bias = (0.1 * rng.normal(size=24)).astype(np.float32)
    ya = jax_blocks._quantized_conv(jnp.asarray(xa).astype(jnp.bfloat16), jnp.asarray(k[:, :, :16]),
                                    (1, 1), "SAME", jnp.bfloat16)
    yb = jax_blocks._quantized_conv(jnp.asarray(xb).astype(jnp.bfloat16), jnp.asarray(k[:, :, 16:]),
                                    (1, 1), "SAME", jnp.bfloat16)
    want = np.asarray((ya + yb) + jnp.asarray(bias).astype(jnp.bfloat16), np.float32)
    y = None
    w = torch.from_numpy(k).permute(3, 2, 0, 1)
    for i, (x, (a, b)) in enumerate(zip((xa, xb), ((0, 16), (16, 40)))):
        xt = torch.from_numpy(x).bfloat16()
        kq, sw = port_int8.quantize_weight(w[:, a:b])
        y = port_int8.int8_conv(xt, kq, sw, port_int8.absmax(xt), (1, 1),
                                torch.from_numpy(bias) if i else None, y)
    np.testing.assert_array_equal(y.float().numpy(), want)


# -- which convs are quantized -------------------------------------------------

def _jax_inventory(monkeypatch, fn):
    calls = []
    real = jax_blocks._quantized_conv

    def rec(x, kf, strides, pad, out_dtype):
        calls.append((tuple(x.shape), tuple(kf.shape)))
        return real(x, kf, strides, pad, out_dtype)

    monkeypatch.setattr(jax_blocks, "_quantized_conv", rec)
    fn()
    return sorted(calls)


def _port_inventory(monkeypatch, fn):
    calls = []
    real = blocks.int8_conv

    def rec(x, kq, sw, amax, padding, bias=None, into=None):
        co, kh, kw, _ = kq.shape
        calls.append((tuple(x.shape), (kh, kw, x.shape[-1], co)))
        return real(x, kq, sw, amax, padding, bias, into)

    monkeypatch.setattr(blocks, "int8_conv", rec)
    with torch.no_grad():
        fn()
    return sorted(calls)


def _unet_inputs(b, s, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, s, 4)).astype(np.float32)
    cond = {"clean_img": rng.uniform(0, 0.3, (b, s, s, 4)).astype(np.float32),
            "position": rng.uniform(0, 1, (b, s, s, 2)).astype(np.float32),
            "iso_ratio_idx": np.array([24, 3][:b], np.int32)}
    t = np.array([999, 37][:b], np.int32)
    return x, t, cond


def _jax_args(x, t, cond):
    return jnp.asarray(x), jnp.asarray(t), {k: jnp.asarray(v) for k, v in cond.items()}


def _torch_args(x, t, cond):
    return (torch.from_numpy(x), torch.from_numpy(t).long(),
            {k: torch.from_numpy(v) for k, v in cond.items()})


def _unet_inventories(monkeypatch, jnet, port, b, s):
    args = _unet_inputs(b, s)
    ja = _jax_args(*args)
    p = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *ja)
    want = _jax_inventory(monkeypatch, lambda: jax.eval_shape(
        lambda q: jnet.apply(q, *ja), p))
    got = _port_inventory(monkeypatch, lambda: port(*_torch_args(*args)))
    return got, want


# NoiseDiffNet dim 48: the bf16 model against the JAX fused routes (heads and
# attention tail in their kernels: 77 convs), the fp32 model against the JAX
# unfused route (87: also the 9 attention projections and shot_mlp3.fc1)
@pytest.mark.parametrize("dtype,count,env", [
    ("bfloat16", 77, {"NOISEDIFF_FUSED_HEADS": "interpret", "NOISEDIFF_FUSED_ATTN": "interpret"}),
    ("float32", 87, {})])
def test_noisediff_net_quantizes_the_jax_convs(monkeypatch, dtype, count, env):
    monkeypatch.setenv("NOISEDIFF_INT8", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bf = dtype == "bfloat16"
    jnet = JaxNet(dim=48, dtype=jnp.bfloat16 if bf else None)
    port = NoiseDiffNet(dim=48, dtype=torch.bfloat16 if bf else None).eval()
    got, want = _unet_inventories(monkeypatch, jnet, port, 1, 32)
    assert len(want) == count and got == want


def test_camera_cond_quantizes_the_jax_convs(monkeypatch):
    monkeypatch.setenv("NOISEDIFF_INT8", "1")
    jnet = jax_others.UNet_PosEmbV2_CameraCond(dim=16)
    port = others.UNet_PosEmbV2_CameraCond(dim=16).eval()
    got, want = _unet_inventories(monkeypatch, jnet, port, 2, 32)
    assert len(want) > 50 and got == want
    # cond_concat_conv's two parts reach the conv unjoined
    assert got.count(((2, 32, 32, 16), (3, 3, 16, 16))) > 2


def test_lsid_quantizes_the_jax_convs(monkeypatch):
    monkeypatch.setenv("NOISEDIFF_INT8", "1")
    jnet, x = JaxLSID(lane_fold=False), np.zeros((1, 36, 44, 4), np.float32)
    p = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))
    want = _jax_inventory(monkeypatch, lambda: jax.eval_shape(
        lambda q: jnet.apply(q, jnp.asarray(x)), p))
    got = _port_inventory(monkeypatch, lambda: LSID().eval()(torch.from_numpy(x)))
    assert len(want) == 21 and got == want


def test_flag_off_quantizes_nothing(monkeypatch):
    monkeypatch.delenv("NOISEDIFF_INT8", raising=False)
    port = NoiseDiffNet(dim=16).eval()
    assert not any(getattr(m, "int8", False) for m in port.modules())
    assert _port_inventory(monkeypatch, lambda: port(*_torch_args(*_unet_inputs(2, 16)))) == []


# -- outputs against the JAX package ------------------------------------------
#
# The route is chaotic at the rounding level: a value within an fp32 ulp of
# a quantization boundary rounds either way, and each flip moves the next
# layers' inputs further (measured: the JAX package's own int8 output moves
# by 1.7e-3 to 3.7e-2 under a 1e-6 relative perturbation of its input, as
# far as the int8 route moves it from the float one). So the outputs are
# compared teacher-forced: each quantized conv of the port takes the JAX
# model's activation at that conv (and its max|x|), found by the conv's
# int8 kernel, after its own activation has been held against it; all the
# port's code between the quantized convs, each part's sum, bias and
# weights run as they are.

class _Teacher:
    """The JAX model's activation at each quantized conv, in call order per
    conv part (keyed by its int8 kernel), and what the port's own
    activations were beside them."""

    def __init__(self):
        self.calls = {}
        self.seen = []  # (port x rel. distance, quantized values that differ, values)

    def jax_recorder(self):
        real = jax_blocks._quantized_conv

        def rec(x, kf, strides, pad, out_dtype):
            jax.debug.callback(self._store, x, kf, ordered=True)
            return real(x, kf, strides, pad, out_dtype)
        return rec

    def _store(self, x, kf):
        x = np.asarray(x).astype(np.float32)
        kq, _ = port_int8.quantize_weight(torch.from_numpy(np.asarray(kf)).permute(3, 2, 0, 1))
        self.calls.setdefault(kq.numpy().tobytes(), []).append((x, np.abs(x).max()))

    def port_conv(self, real):
        def conv(x, kq, sw, amax, padding, bias=None, into=None):
            xj, aj = self.calls[kq.numpy().tobytes()].pop(0)
            amax_j = torch.tensor([aj], dtype=torch.float32)
            xt = torch.from_numpy(xj).to(x.dtype)
            own, theirs = (torch.round(v.float() / port_int8.activation_scale(a))
                           for v, a in ((x, amax), (xt, amax_j)))
            self.seen.append((_rel(x.float(), xj), int((own != theirs).sum()), x.numel()))
            return real(xt, kq, sw, amax_j, padding, bias, into)
        return conv

    def check(self, x_rel: float, flip_share: float):
        """Every recorded call consumed; the port's own activations within
        x_rel of JAX's, and at most flip_share of their quantized values
        on the other side of a boundary."""
        assert self.seen and not any(self.calls.values())
        worst = max(r for r, _, _ in self.seen)
        flips = sum(f for _, f, _ in self.seen) / sum(n for _, _, n in self.seen)
        assert worst <= x_rel and flips <= flip_share, (worst, flips)


# fp32: the port's activation at each quantized conv within FP32_X_REL of
# JAX's and at most FP32_FLIPS of the quantized values flipped (measured
# up to 3.7e-5, in LSID, and 2.2e-5); the teacher-forced output within
# INT8_SHARE of the JAX package's own int8-against-float distance
# (measured 1.0e-7 to 2.1e-7 against 3.4e-2 to 1.1e-1)
FP32_X_REL = 1e-4
FP32_FLIPS = 1e-3


def _jax_out(fn, int8: bool, **env):
    with _env(NOISEDIFF_INT8="1" if int8 else "0", **env):
        return np.asarray(fn(), np.float32)


def _port_net(ctor, params, int8: bool):
    with _env(NOISEDIFF_INT8="1" if int8 else "0"):
        return load_port(ctor(), params)


@pytest.fixture(scope="module")
def net16():
    jnet = JaxNet(dim=DIM)
    args = _unet_inputs(B, S)
    params = random_params(jnet, *_jax_args(*args))
    return jnet, params, args


def _forward(jnet, params, args, int8, **env):
    return _jax_out(lambda: jax.jit(lambda p, *a: jnet.apply({"params": p}, *a))(
        params, *_jax_args(*args)), int8, **env)


def _teacher_forced(monkeypatch, jax_run, port_run):
    """(JAX int8 output, JAX float output, the port's teacher-forced int8
    output, the teacher)."""
    teacher = _Teacher()
    base = jax_run(False)
    with monkeypatch.context() as m:
        m.setattr(jax_blocks, "_quantized_conv", teacher.jax_recorder())
        want = jax_run(True)
        jax.effects_barrier()
        m.setattr(blocks, "int8_conv", teacher.port_conv(blocks.int8_conv))
        with torch.no_grad():
            got = port_run()
    return want, base, np.asarray(got.float()), teacher


def _check_fp32(want, base, got, teacher):
    teacher.check(FP32_X_REL, FP32_FLIPS)
    assert _rel(got, want) <= INT8_SHARE * _rel(want, base), (_rel(got, want), _rel(want, base))


def test_noisediff_net_fp32_matches_jax(monkeypatch, net16):
    jnet, params, args = net16
    port = _port_net(lambda: NoiseDiffNet(dim=DIM), params, True)
    _check_fp32(*_teacher_forced(monkeypatch, lambda q: _forward(jnet, params, args, q),
                                 lambda: port(*_torch_args(*args))))


# bf16: the port's kernel routes (their plain versions here) against the
# JAX fused routes in interpret mode, which already differ by bf16
# roundings without the flag (1.6e-2); with it, teacher-forced, the
# distance from JAX at most BF16_GROWTH times that (measured 7.4e-3), the
# port's activations within BF16_X_REL of JAX's (measured 1.3e-2) and at
# most BF16_FLIPS of their quantized values flipped (measured 0.10: a bf16
# ulp of a value near max|x| is a fifth of a quantization step)
BF16_X_REL = 3e-2
BF16_FLIPS = 0.2


def test_noisediff_net_bf16_matches_jax_fused_routes(monkeypatch, net16):
    jnet, params, args = net16
    fused = {"NOISEDIFF_FUSED_HEADS": "interpret", "NOISEDIFF_FUSED_ATTN": "interpret"}
    jbf = jnet.clone(dtype=jnp.bfloat16)
    port = _port_net(lambda: NoiseDiffNet(dim=DIM, dtype=torch.bfloat16), params, True)
    want, base, got, teacher = _teacher_forced(
        monkeypatch, lambda q: _forward(jbf, params, args, q, **fused),
        lambda: port(*_torch_args(*args)))
    plain = _port_net(lambda: NoiseDiffNet(dim=DIM, dtype=torch.bfloat16), params, False)
    with torch.no_grad():
        d_plain = _rel(plain(*_torch_args(*args)).float().numpy(), base)
    teacher.check(BF16_X_REL, BF16_FLIPS)
    assert _rel(got, want) <= BF16_GROWTH * d_plain, (_rel(got, want), d_plain)


def test_lsid_fp32_matches_jax(monkeypatch):
    jnet = JaxLSID(lane_fold=False)
    x = np.random.default_rng(3).uniform(0, 0.2, (1, 36, 44, 4)).astype(np.float32)
    params = random_params(jnet, jnp.asarray(x), seed=2)
    port = _port_net(LSID, params, True)
    _check_fp32(*_teacher_forced(
        monkeypatch, lambda q: _jax_out(lambda: jax.jit(
            lambda p, a: jnet.apply({"params": p}, a))(params, jnp.asarray(x)), q),
        lambda: port(torch.from_numpy(x))))


def test_camera_cond_fp32_matches_jax(monkeypatch):
    jnet = jax_others.UNet_PosEmbV2_CameraCond(dim=DIM)
    args = _unet_inputs(B, 32)
    params = random_params(jnet, *_jax_args(*args), seed=4)
    port = _port_net(lambda: others.UNet_PosEmbV2_CameraCond(dim=DIM), params, True)
    _check_fp32(*_teacher_forced(monkeypatch, lambda q: _forward(jnet, params, args, q),
                                 lambda: port(*_torch_args(*args))))


def _jax_sample(jnet, params, sampler, x, cond, int8):
    apply = jax.jit(lambda p, xx, tt, cc: jnet.apply({"params": p}, xx, tt, cc))
    jd = JaxDiffusion.create(lambda p, xx, tt, cc: apply(p, xx, tt, cc), image_size=S,
                             timesteps=T, beta_schedule="sigmoid2")
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    key, noise = jax.random.PRNGKey(0), jnp.asarray(x)
    if sampler == "dpm":
        run = lambda: jd.dpm_solver_sample(params, key, x.shape, jcond, sampling_timesteps=3,
                                           init_noise=noise, step_spacing="lambda")
    elif sampler == "ddim":
        run = lambda: jd.ddim_sample(params, key, x.shape, jcond, sampling_timesteps=2,
                                     eta=0.0, init_noise=noise)
    else:  # the fused tail: the trunk's convs quantized, the heads in the tail
        trunk = jnet.clone(trunk_only=True)
        run = lambda: jd.ddim_sample(
            params, key, x.shape, jcond, sampling_timesteps=2, eta=0.0, init_noise=noise,
            trunk_apply_fn=lambda p, xx, tt, cc: trunk.apply({"params": p}, xx, tt, cc),
            fused_mode="pallas", fused_interpret=True)
    return _jax_out(run, int8)


@pytest.mark.parametrize("sampler", ["dpm", "ddim", "ddim_fused"])
def test_samplers_fp32_match_jax(monkeypatch, net16, sampler):
    jnet, params, _ = net16
    x, _, cond = _unet_inputs(B, S, seed=2)
    port = _port_net(lambda: NoiseDiffNet(dim=DIM), params, True)
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  device="cpu")
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    noise = torch.from_numpy(x)

    def port_run():
        if sampler == "dpm":
            return pd.dpm_solver_sample(x.shape, tcond, sampling_timesteps=3, init_noise=noise,
                                        step_spacing="lambda")
        trunk = pd.fused_tail_trunk() if sampler == "ddim_fused" else None
        return pd.ddim_sample(x.shape, tcond, sampling_timesteps=2, eta=0.0, init_noise=noise,
                              trunk_fn=trunk)

    _check_fp32(*_teacher_forced(
        monkeypatch, lambda q: _jax_sample(jnet, params, sampler, x, cond, q), port_run))


# -- the split frame -------------------------------------------------------------
#
# The frame split by rows over 2 gloo ranks, teacher-forced by one
# process's int8 run of the same frame (NoiseDiffNet dim 16, 32 x 48,
# DPM-3): at each quantized conv a rank checks its rows (with their halo
# rows for a 3x3) and its activation scale's max|x| against one process's,
# then convolves one process's rows. With the MAX all-reduce every max|x|
# is the whole frame's; with each rank's own (`own_scale`) it is not.

FH, FW = 32, 48
SPLIT = f"FH, FW, DIM = {FH}, {FW}, {DIM}\n" + r"""
import json, os
import numpy as np
import torch
import torch.nn.functional as F
from noisediff_tpu_torch.diffusion import fullframe
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, blocks
from noisediff_tpu_torch.parallel import mesh

d = os.environ["INT8_DIR"]
shard, _ = mesh.setup(torch.device("cpu"))
model = NoiseDiffNet(dim=DIM)
model.load_state_dict(torch.load(os.path.join(d, "net.pt")), strict=True)
gd = GaussianDiffusion.create(model.eval(), image_size=FH, timesteps=8,
                              beta_schedule="sigmoid2", objective="pred_v", device="cpu")
clean = np.load(os.path.join(d, "clean.npy"))
x_t = torch.from_numpy(np.load(os.path.join(d, "x_t.npy")))
with np.load(os.path.join(d, "one.npz")) as f:
    xs = [f[f"x{i}"] for i in range(int(f["n"]))]
    amaxes = f["amax"]
real = blocks.int8_conv
out = {"rank": shard.rank, "world": shard.world}


def teacher(stats):
    calls = iter(range(len(xs)))

    def conv(x, kq, sw, amax, padding, bias=None, into=None):
        i = next(calls)
        one = torch.from_numpy(xs[i])  # the whole frame at this conv's scale
        first = mesh.spatial().at_scale(x.shape[1] - (2 if padding[0] != kq.shape[1] // 2 else 0))[0]
        halo = (kq.shape[1] // 2) if padding[0] != kq.shape[1] // 2 else 0
        rows = F.pad(one, (0, 0, 0, 0, halo, halo))[:, first:first + x.shape[1]].contiguous()
        stats["x"] = max(stats.get("x", 0.0), float((x - rows).norm() / rows.norm()))
        stats["amax"] = max(stats.get("amax", 0.0), abs(float(amax) / float(amaxes[i]) - 1))
        stats["calls"] = i + 1
        return real(rows, kq, sw, torch.tensor([amaxes[i]]), padding, bias, into)
    return conv


blocks.int8_conv = teacher(out.setdefault("shared", {}))
frame = fullframe.generate_full_frame(gd, clean, 24, sampling_timesteps=3, init_noise=x_t)
mesh.all_reduce_max = lambda t, group=None: t  # each rank's own max|x|
blocks.int8_conv = teacher(out.setdefault("own_scale", {}))
fullframe.generate_full_frame(gd, clean, 24, sampling_timesteps=3, init_noise=x_t)
if shard.rank == 0:
    np.save(os.path.join(d, "split.npy"), frame)
mesh.teardown()
print(json.dumps(out))
"""


def test_split_frame_matches_one_process(tmp_path, monkeypatch, net16):
    from noisediff_tpu_torch.diffusion import fullframe

    _, params, _ = net16
    rng = np.random.default_rng(0)
    clean = rng.uniform(0, 0.3, (FH, FW, 4)).astype(np.float32)
    x_t = rng.standard_normal((1, FH, FW, 4)).astype(np.float32)
    np.save(tmp_path / "clean.npy", clean)
    np.save(tmp_path / "x_t.npy", x_t)
    one = {}
    calls = []
    real = blocks.int8_conv

    def rec(x, kq, sw, amax, padding, bias=None, into=None):
        calls.append((x.numpy().copy(), float(amax)))
        return real(x, kq, sw, amax, padding, bias, into)

    monkeypatch.setattr(blocks, "int8_conv", rec)
    for q in (True, False):
        port = _port_net(lambda: NoiseDiffNet(dim=DIM), params, q)
        if not q:
            torch.save(port.state_dict(), tmp_path / "net.pt")
        gd = GaussianDiffusion.create(port, image_size=FH, timesteps=8, beta_schedule="sigmoid2",
                                      objective="pred_v", device="cpu")
        one[q] = fullframe.generate_full_frame(gd, clean, 24, sampling_timesteps=3,
                                               init_noise=torch.from_numpy(x_t))
    np.savez(tmp_path / "one.npz", n=len(calls), amax=np.array([a for _, a in calls], np.float32),
             **{f"x{i}": x for i, (x, _) in enumerate(calls)})
    ranks = run_ranks(SPLIT, 2, env={"INT8_DIR": str(tmp_path), "NOISEDIFF_INT8": "1"})
    split = np.load(tmp_path / "split.npy")
    assert [r["world"] for r in ranks] == [2, 2]
    for r in ranks:
        shared, own = r["shared"], r["own_scale"]
        assert shared["calls"] == own["calls"] == len(calls)
        assert shared["x"] <= FP32_X_REL and shared["amax"] <= FP32_X_REL, shared
        assert own["amax"] > 1e-2, own
    assert split.shape == (FH, FW, 4)
    assert _rel(split, one[True]) <= INT8_SHARE * _rel(one[True], one[False])


# -- the rest ------------------------------------------------------------------------

@pytest.mark.parametrize("trainer", [DiffusionTrainer, DenoiseTrainer])
def test_trainers_refuse_int8(monkeypatch, trainer):
    monkeypatch.setenv("NOISEDIFF_INT8", "1")
    with pytest.raises(RuntimeError, match="inference-only"):
        trainer(argparse.Namespace(phase="train"))


def test_weight_cache_follows_the_weight(monkeypatch):
    """(kq, sw) are made once per weight and remade after load_state_dict
    (an in-place copy) or a new weight tensor."""
    monkeypatch.setenv("NOISEDIFF_INT8", "1")
    torch.manual_seed(0)
    conv = blocks.Conv2d(16, 24, 3).eval()
    assert conv.int8
    x = torch.randn(1, 16, 6, 7).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y0 = conv(x)
        cached = conv.int8_weights([16])
        conv(x)
        assert conv.int8_weights([16]) is cached
        other = blocks.Conv2d(16, 24, 3).eval()
        conv.load_state_dict(other.state_dict())
        np.testing.assert_array_equal(conv(x).numpy(), other(x).numpy())
        assert conv.int8_weights([16]) is not cached
        kq, sw = port_int8.quantize_weight(other.weight)
        np.testing.assert_array_equal(conv.int8_weights([16])[0][0].numpy(), kq.numpy())
        conv.weight = torch.nn.Parameter(conv.weight.detach().clone() * 2)
        assert not torch.equal(conv(x), y0)
        np.testing.assert_array_equal(conv.int8_weights([16])[0][1].numpy(), 2 * sw.numpy())


def test_flag_changes_the_output(net16):
    """The flag changes the model's output, within the JAX test's bound
    (tests/test_int8.py: relative RMS below 0.15), in the model dtype."""
    _, params, args = net16
    out = {}
    for q in (True, False):
        port = _port_net(lambda: NoiseDiffNet(dim=DIM, dtype=torch.bfloat16), params, q)
        with torch.no_grad():
            out[q] = port(*_torch_args(*args))
    assert out[True].dtype == out[False].dtype == torch.bfloat16
    a, b = out[False].float().numpy(), out[True].float().numpy()
    assert not np.allclose(a, b) and _rel(b, a) < 0.15


def test_kernel_wrapper_refuses_what_it_does_not_take():
    x = torch.zeros(1, 4, 4, 16)
    kq, sw = port_int8.quantize_weight(torch.ones(16, 16, 3, 3))
    amax = torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        port_int8._check(x, kq, sw, amax, (1, 1), None, None)
    assert port_int8.absmax_blocks(1) == 1
    assert port_int8.absmax_blocks(10 ** 9) == port_int8.ABSMAX_BLOCKS
    assert port_int8.out_size((1, 5, 7, 16), (16, 3, 3, 32), (0, 1)) == (3, 7)


def test_chip_smoke_int8_helpers(monkeypatch):
    """chip_smoke's int8 phase on the CPU at a small size: the route's
    variable set only inside `int8_route`, the calls of a dim-48 bf16
    evaluation (77) and of LSID (21) counted by call shape, and each shape's
    kernel check (on the CPU, its plain version against itself) and the
    ragged shapes' operands."""
    import chip_smoke

    monkeypatch.delenv("NOISEDIFF_INT8", raising=False)
    with chip_smoke.int8_route():
        net = NoiseDiffNet(dim=48, dtype=torch.bfloat16).eval()
        lsid = LSID().eval()
    assert "NOISEDIFF_INT8" not in os.environ
    gen = chip_smoke.int8_calls(net, *_torch_args(*_unet_inputs(1, 32)))
    ls = chip_smoke.int8_calls(lsid, torch.rand(1, 36, 44, 4) * 0.05)
    assert sum(gen.values()) == 77 and sum(ls.values()) == 21
    assert any(k[3] for k in gen) and any(k[4] for k in gen)  # joins' parts, biases
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    for key in sorted(gen)[:3] + sorted(ls)[-2:]:
        chip_smoke.int8_check(randn, key, torch.bfloat16)
    for b, h, w, ci, co, k, pad in chip_smoke.INT8_RAGGED:
        x, kq, *_ = chip_smoke.int8_operands(
            randn, ((b, h, w, ci), (co, k, k, ci + (-ci % 32)), pad, True, True), torch.float32)
        assert x.shape == (b, h, w, ci) and kq.shape == (co, k, k, ci + (-ci % 32))
