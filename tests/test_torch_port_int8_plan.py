"""The int8 conv's route rule and the tiled kernel's launch plan
(ops/kernels/int8_conv.py `takes_tiled`, `route`, `plan`, `smem_layout`),
held on the CPU: which kernel each call shape takes, that the plan's units
cover every output tile once (the kernel's blocks walk units blockIdx.x,
blockIdx.x + grid, ... below `units`), and that the shared memory fits a
block at every main-path shape.

The main-path call shapes are the int8 convs of one NoiseDiffNet dim-48
evaluation (B 4, 512^2, bf16: 77 calls over 23 shapes) and of LSID's
evaluation of one packed full SID frame (fp32: 21 calls over 17 shapes),
as chip_smoke.py records them on the card; `test_main_path_calls_match_
the_models` holds the lists against the models' own int8 calls on the CPU
at a small frame (the channel widths, kernels and parts do not depend on
the frame).
"""
import importlib
import os

import pytest
import torch

import chip_smoke

m = importlib.import_module("noisediff_tpu_torch.ops.kernels.int8_conv")

# ((B, H, W, Ci), Co, k, padding, into, bias, calls an evaluation)
GEN_CALLS = [
    ((4, 64, 64, 192), 192, 3, (1, 1), False, False, 4),
    ((4, 64, 64, 192), 384, 1, (0, 0), True, True, 2),
    ((4, 64, 64, 192), 384, 3, (1, 1), False, True, 1),
    ((4, 64, 64, 192), 384, 3, (1, 1), True, False, 2),
    ((4, 64, 64, 384), 384, 1, (0, 0), False, False, 2),
    ((4, 64, 64, 384), 384, 3, (1, 1), False, False, 8),
    ((4, 128, 128, 96), 96, 3, (1, 1), False, False, 4),
    ((4, 128, 128, 96), 192, 1, (0, 0), True, True, 2),
    ((4, 128, 128, 96), 192, 3, (1, 1), True, False, 2),
    ((4, 128, 128, 192), 192, 1, (0, 0), False, False, 2),
    ((4, 128, 128, 192), 192, 3, (1, 1), False, False, 4),
    ((4, 256, 256, 48), 48, 3, (1, 1), False, False, 4),
    ((4, 256, 256, 48), 96, 1, (0, 0), True, True, 2),
    ((4, 256, 256, 48), 96, 3, (1, 1), True, False, 2),
    ((4, 256, 256, 96), 96, 1, (0, 0), False, False, 2),
    ((4, 256, 256, 96), 96, 3, (1, 1), False, False, 4),
    ((4, 512, 512, 24), 16, 1, (0, 0), False, True, 1),
    ((4, 512, 512, 48), 48, 1, (0, 0), False, False, 3),
    ((4, 512, 512, 48), 48, 1, (0, 0), False, True, 3),
    ((4, 512, 512, 48), 48, 1, (0, 0), True, True, 3),
    ((4, 512, 512, 48), 48, 3, (1, 1), False, False, 14),
    ((4, 512, 512, 48), 48, 3, (1, 1), False, True, 3),
    ((4, 512, 512, 48), 48, 3, (1, 1), True, False, 3),
]
LSID_CALLS = [
    ((1, 89, 133, 256), 512, 3, (1, 1), False, True, 1),
    ((1, 89, 133, 512), 512, 3, (1, 1), False, True, 1),
    ((1, 178, 266, 128), 256, 3, (1, 1), False, True, 1),
    ((1, 178, 266, 256), 256, 3, (1, 1), False, False, 1),
    ((1, 178, 266, 256), 256, 3, (1, 1), False, True, 2),
    ((1, 178, 266, 256), 256, 3, (1, 1), True, True, 1),
    ((1, 356, 532, 64), 128, 3, (1, 1), False, True, 1),
    ((1, 356, 532, 128), 128, 3, (1, 1), False, False, 1),
    ((1, 356, 532, 128), 128, 3, (1, 1), False, True, 2),
    ((1, 356, 532, 128), 128, 3, (1, 1), True, True, 1),
    ((1, 712, 1064, 32), 64, 3, (1, 1), False, True, 1),
    ((1, 712, 1064, 64), 64, 3, (1, 1), False, False, 1),
    ((1, 712, 1064, 64), 64, 3, (1, 1), False, True, 2),
    ((1, 712, 1064, 64), 64, 3, (1, 1), True, True, 1),
    ((1, 1424, 2128, 32), 32, 3, (1, 1), False, False, 1),
    ((1, 1424, 2128, 32), 32, 3, (1, 1), False, True, 2),
    ((1, 1424, 2128, 32), 32, 3, (1, 1), True, True, 1),
]
# what the plan reads of a call (not `into`, the bias or the count), and
# what the route rule reads: each distinct one in both dtypes (chip_smoke
# checks every call shape in both)
DTYPES = (torch.bfloat16, torch.float32)
PLAN_CLASSES = [(c, dt) for c in dict.fromkeys(c[:4] for c in GEN_CALLS + LSID_CALLS)
                for dt in DTYPES]
ROUTE_CLASSES = [(ci, co, dt) for ci, co in dict.fromkeys(
    (c[0][3], c[1]) for c in GEN_CALLS + LSID_CALLS) for dt in DTYPES]


def _id(case):
    (shape, co, k, pad), dt = case
    return f"{'x'.join(map(str, shape))}-{co}x{k}-p{pad[0]}{pad[1]}-{str(dt)[6:]}"


def test_main_path_counts():
    assert (len(GEN_CALLS), sum(c[-1] for c in GEN_CALLS)) == (23, 77)
    assert (len(LSID_CALLS), sum(c[-1] for c in LSID_CALLS)) == (17, 21)


@pytest.mark.parametrize("ci,co,dt", ROUTE_CLASSES,
                         ids=[f"{ci}-{co}-{str(dt)[6:]}" for ci, co, dt in ROUTE_CLASSES])
def test_main_path_takes_the_tiled_route(ci, co, dt):
    itemsize = torch.empty(0, dtype=dt).element_size()
    assert m.takes_tiled(ci, co, itemsize, aligned=True)
    # a view 2 bytes into its buffer goes to the small kernel
    assert not m.takes_tiled(ci, co, itemsize, aligned=False)


@pytest.mark.parametrize("b,h,w,ci,co,k,pad", chip_smoke.INT8_RAGGED)
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_ragged_shapes_route(b, h, w, ci, co, k, pad, dt):
    """Every INT8_RAGGED shape takes the tiled kernel but a bf16 Ci 20 (a
    40-byte row: TMA strides are multiples of 16 bytes); an fp32 Ci 20 is
    80 bytes and takes it."""
    itemsize = torch.empty(0, dtype=dt).element_size()
    want = not (ci == 20 and dt == torch.bfloat16)
    assert m.takes_tiled(ci, co, itemsize, aligned=True) == want
    if want:
        _check_plan(m.plan(b, h, w, ci, co, k, pad, itemsize), b, ci, co, k)


@pytest.mark.parametrize("ci,co,itemsize,aligned,want", [
    (20, 20, 2, True, False),
    (20, 20, 4, True, True), (12, 16, 4, True, True), (48, 47, 2, True, False),
    (48, 48, 4, False, False), (16, 8, 2, True, True), (40, 40, 2, True, True),
    (36, 16, 2, True, False)])
def test_route_rule(ci, co, itemsize, aligned, want):
    assert m.takes_tiled(ci, co, itemsize, aligned) == want


def test_route_reads_alignment_and_dtype():
    x = torch.zeros(2, 5, 5, 48, dtype=torch.bfloat16)
    kq, _ = m.quantize_weight(torch.zeros(48, 48, 3, 3))
    assert m.route(x, kq) == "tiled"
    assert m.route(x, kq, torch.zeros(2, 5, 5, 48, dtype=torch.bfloat16)) == "tiled"
    off = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    assert m.route(off, kq) == "small"
    into_off = torch.zeros(2 * 5 * 5 * 48 + 1, dtype=torch.bfloat16)[1:].view(2, 5, 5, 48)
    assert m.route(x, kq, into_off) == "small"
    x20 = torch.zeros(1, 4, 4, 20)
    kq20, _ = m.quantize_weight(torch.zeros(20, 20, 3, 3))
    assert m.route(x20, kq20) == "tiled" and m.route(x20.bfloat16(), kq20) == "small"


def _check_plan(p, b, ci, co, k):
    """The plan's numbers against the kernel's limits: the tiles cover the
    output with no whole tile past it, one unit per (sample, pixel tile, N
    tile), and no more blocks than units."""
    tr, tc = m.TILE
    assert p["nt"] in m.N_TILES and p["n_co"] == -(-co // p["nt"])
    assert p["tiles_h"] * tr >= p["ho"] > (p["tiles_h"] - 1) * tr
    assert p["tiles_w"] * tc >= p["wo"] > (p["tiles_w"] - 1) * tc
    # TMA's box: at most 256 along each axis
    assert 16 * p["ckg"] <= 256 and tc + k - 1 <= 256 and p["nt"] <= 256
    groups = -(-ci // 16)
    assert p["chunks"] * p["ckg"] >= groups > (p["chunks"] - 1) * p["ckg"]
    assert p["ckg"] <= (ci + (-ci % m.K_STEP)) // 16  # within kq's groups
    if p["resident"]:
        assert p["chunks"] == 1 and p["n_co"] == 1
    else:
        assert p["ckg"] % 2 == 0  # streamed chunks pair their groups within a tap
    budget = m.SMEM_BLOCK if p["blocks_per_sm"] == 1 else m.SMEM_SM // 2 - m.SMEM_RESERVED
    assert p["smem"] <= budget <= m.SMEM_BLOCK
    assert p["blocks_per_sm"] == 1 or p["nt"] <= m.TWO_BLOCKS_MAX_NT
    assert 2 <= p["stages"] <= 4
    assert p["units"] == p["n_co"] * b * p["tiles_h"] * p["tiles_w"]
    assert 1 <= p["grid"] <= min(p["units"], p["blocks_per_sm"] * m.SMS)


@pytest.mark.parametrize("case", PLAN_CLASSES, ids=[_id(c) for c in PLAN_CLASSES])
def test_main_path_plan(case):
    (shape, co, k, pad), dt = case
    itemsize = torch.empty(0, dtype=dt).element_size()
    p = m.plan(*shape, co, k, pad, itemsize)
    _check_plan(p, shape[0], shape[3], co, k)
    assert p["smem"] == m.smem_layout(k, p["nt"], p["ckg"], p["stages"], p["resident"], itemsize,
                                      p["n_co"])


def test_plan_keeps_narrow_weights_resident():
    """Weights stay resident (loaded once a block) wherever one N tile and
    one chunk of every input channel fit a block; they stream at the split
    N tiles and where they do not fit. Every 512^2 and 256^2 call of
    NoiseDiffNet in bf16, the bulk of an evaluation's bytes, keeps them
    resident."""
    for (shape, co, k, pad), dt in PLAN_CLASSES:
        es = torch.empty(0, dtype=dt).element_size()
        p = m.plan(*shape, co, k, pad, es)
        groups = -(-shape[3] // 16)
        fits = p["n_co"] == 1 and groups <= 16 and \
            m.smem_layout(k, p["nt"], groups, 2, True, es) <= m.SMEM_BLOCK
        assert p["resident"] == fits, (shape, co, k, dt)
        if shape[1] >= 256 and shape[0] == 4 and dt == torch.bfloat16:
            assert p["resident"], (shape, co, k, dt)


def test_smem_layout_by_hand():
    """3x3 48 -> 48, bf16, resident, 3 stages: boxes of 10 x 18 pixels x 48
    channels (17,280 bytes), two quantized buffers of 3 planes (8,768 with
    the partner's 128 bytes, rounded to 128), the weights (9 x 3 pieces of
    48 x 16 bytes) and the zero piece, two warpgroups' staging (64 pixels x
    56 elements), the 48 channels' scales and biases, 7 mbarriers."""
    def up(n):
        return -(-n // 128) * 128

    raw = 10 * 18 * 48 * 2
    q = up(3 * 10 * 18 * 16 + 128)
    w = up(9 * 3 * 48 * 16 + 48 * 16)
    staging = 64 * 56 * 2
    assert m.smem_layout(3, 48, 3, 3, True, 2) == \
        3 * raw + 2 * q + w + 2 * staging + 2 * 48 * 4 + 8 * 7
    # streamed: three quantized buffers, the weights in each stage; fp32
    # staging rounds of 32 channels; two N tiles' scales and biases
    raw = 10 * 18 * 32 * 4
    wchunk = 9 * 2 * 256 * 16
    q = up(2 * 10 * 18 * 16 + 128)
    staging = 64 * 40 * 4
    assert m.smem_layout(3, 256, 2, 2, False, 4, 2) == \
        2 * (raw + wchunk) + 3 * q + 2 * staging + 2 * 2 * 256 * 4 + 8 * 5


def test_plan_spreads_units_over_every_sm():
    p = m.plan(4, 512, 512, 48, 48, 3, (1, 1), 2)
    assert p["grid"] == p["blocks_per_sm"] * m.SMS
    assert p["units"] == 4 * 64 * 512 // m.TILE[1]
    small = m.plan(1, 1, 1, 48, 24, 3, (1, 1), 2)
    assert small["units"] == small["grid"] == 1


def test_main_path_calls_match_the_models(monkeypatch):
    """The lists above are the models' int8 calls: NoiseDiffNet dim 48
    (bf16) and LSID (fp32) under NOISEDIFF_INT8=1, on the CPU at a small
    frame, call the same (Ci, Co, k, padding, into, bias) the same number
    of times."""
    from noisediff_tpu_torch.models import LSID, NoiseDiffNet, blocks

    monkeypatch.setenv("NOISEDIFF_INT8", "1")
    seen = {}
    real = blocks.int8_conv

    def rec(x, kq, sw, amax, padding, bias=None, into=None):
        key = (x.shape[-1], kq.shape[0], kq.shape[1], tuple(padding), into is not None,
               bias is not None)
        seen[key] = seen.get(key, 0) + 1
        return real(x, kq, sw, amax, padding, bias, into)

    monkeypatch.setattr(blocks, "int8_conv", rec)
    torch.manual_seed(0)
    with torch.no_grad():
        net = NoiseDiffNet(dim=48, dtype=torch.bfloat16).eval()
        x = torch.rand(1, 16, 16, 4)
        net(x, torch.tensor([500]), {"clean_img": x * 0.1, "position": x[..., :2],
                                     "iso_ratio_idx": torch.tensor([3])})
        gen, seen = seen, {}
        LSID().eval()(torch.rand(1, 32, 32, 4) * 0.05)
    lsid = seen

    def keyed(calls):
        out = {}
        for s, co, k, pad, into, bias, n in calls:
            key = (s[3], co, k, pad, into, bias)
            out[key] = out.get(key, 0) + n
        return out

    assert gen == keyed(GEN_CALLS)
    assert lsid == keyed(LSID_CALLS)


def test_route_counters_reset_together():
    from noisediff_tpu_torch.ops.kernels import int8_conv_small, launch_counts
    from noisediff_tpu_torch.ops.kernels import reset_launch_counts

    int8_conv_small.launches = 3
    assert launch_counts()["int8_conv_small"] == 3
    reset_launch_counts()
    assert launch_counts()["int8_conv_small"] == 0 == launch_counts()["int8_conv"]


def test_cpu_call_launches_no_kernel():
    from noisediff_tpu_torch.ops.kernels import int8_conv, int8_conv_small, reference_int8_conv

    before = (int8_conv.launches, int8_conv_small.launches)
    x = torch.randn(1, 6, 7, 24)
    kq, sw = m.quantize_weight(torch.randn(16, 24, 3, 3) * 0.1)
    amax = m.reference_absmax(x)
    want = reference_int8_conv(x, kq, sw, amax, (1, 1))
    assert torch.equal(int8_conv(x, kq, sw, amax, (1, 1)), want)
    assert torch.equal(int8_conv_small(x, kq, sw, amax, (1, 1)), want)
    assert (int8_conv.launches, int8_conv_small.launches) == before
    assert os.path.exists(os.path.join(os.path.dirname(m.__file__), "..", "..", "csrc",
                                       "int8_conv.cu"))


@pytest.mark.parametrize("co,ci,k,nt,ckg", [(384, 384, 3, 192, 2), (256, 128, 3, 128, 2),
                                            (72, 48, 3, 96, 2), (200, 96, 1, 128, 4)])
def test_streamed_weights_layout(co, ci, k, nt, ckg):
    """The streamed weights' copy: block (N tile, chunk) holds, tap by tap
    and group by group, the tile's output channels' 16 bytes, zero past Co
    and past kq's groups; made once per (kq, nt, ckg), also for a kq made
    under inference mode (no version counter), as the generation CLI
    makes it."""
    g = torch.Generator().manual_seed(co + ci)
    kq, _ = m.quantize_weight(torch.randn(co, ci, k, k, generator=g))
    ks = m.streamed_weights(kq, nt, ckg)
    cip = kq.shape[-1]
    n_co, chunks = -(-co // nt), -(-cip // (16 * ckg))
    assert ks.shape == (n_co, chunks, k * k, ckg, nt, 16) and ks.is_contiguous()
    flat = kq.reshape(co, k * k, cip)
    for cot in range(n_co):
        for c in range(chunks):
            for tap in (0, k * k - 1):
                for gg in range(ckg):
                    lo = (c * ckg + gg) * 16
                    for r in (0, nt - 1):
                        want = flat[cot * nt + r, tap, lo:lo + 16] if cot * nt + r < co and \
                            lo < cip else torch.zeros(16, dtype=torch.int8)
                        assert torch.equal(ks[cot, c, tap, gg, r], want)
    assert m.streamed_weights(kq, nt, ckg) is ks
    with torch.inference_mode():
        kq_inf, _ = m.quantize_weight(torch.randn(co, ci, k, k, generator=g))
        ks_inf = m.streamed_weights(kq_inf, nt, ckg)
    assert m.streamed_weights(kq_inf, nt, ckg) is ks_inf and ks_inf.shape == ks.shape
