"""The benchmark's yardstick on the CPU: its operation counts against
torch.utils.flop_counter, its roofline formulas against the port's kernel
table, its call list against the calls the port makes, and its plain
references against the port's CPU route at small sizes (the tests may
import both; the references import nothing of the port)."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import flops, port, roofline, weights
from reference import diffusion as ref_diffusion
from reference import lsid as ref_lsid
from reference.noisediff_net import NoiseDiffNet as RefNet

NDN = dict(model="NoiseDiffNet", dim=16, dim_mults=[1, 2, 4, 8], resnet_block_groups=8,
           iso_dim=16, iso_vocab=100, pos_dim=8, attn_heads=4, attn_dim_head=32, channels=4,
           compute_dtype="float32")
LSID = dict(model="LSID", base_width=8, channels=4, compute_dtype="float32", init="he")
CPU = torch.device("cpu")


def _inputs(b, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, h, w, 4, generator=g), torch.randint(0, 1000, (b,), generator=g),
            {"clean_img": 0.3 * torch.rand(b, h, w, 4, generator=g),
             "position": torch.rand(b, h, w, 2, generator=g),
             "iso_ratio_idx": torch.randint(0, 75, (b,), generator=g)})


def _pair(cfg, seed=3):
    prog = port.program_model(cfg, CPU)
    state = port.seeded_weights(cfg, prog, seed, CPU)
    prog.load_state_dict(state)
    ref = port.reference_model(cfg, CPU)
    ref.load_state_dict(state)
    return prog.eval(), ref.eval(), state


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc


def test_forward_count_matches_the_flop_counter_over_the_port():
    from noisediff_tpu_torch.models import NoiseDiffNet

    x, t, c = _inputs(2, 32, 48)
    fc = _counted(lambda: NoiseDiffNet(dim=16)(x, t, c))
    assert fc.get_total_flops() == flops.forward_flops(NDN, 2, 32, 48)


def test_forward_count_is_the_reference_less_the_constant_attention():
    """The reference computes the one-token attention's queries, keys and
    products over one key, whose weights are the constant 1, and projects
    the one value at every pixel; the count leaves the first out and
    projects the value once a sample."""
    x, t, c = _inputs(2, 32, 48)
    ref = RefNet(dim=16)
    fc = _counted(lambda: ref(x, t, c))
    counts = fc.get_flop_counts()
    constant = sum(sum(ops.values()) for k, ops in counts.items()
                   if k.endswith((".attn.to_q", ".attn.to_k", ".attn.to_out")))
    constant += sum(v for k, ops in counts.items() if k.endswith(".attn")
                    for op, v in ops.items() if "bmm" in str(op))
    once = sum(2 * 2 * m.to_out[0].in_features * m.to_out[0].out_features
               for m in ref.modules() if hasattr(m, "to_out"))
    assert fc.get_total_flops() - constant + once == flops.forward_flops(NDN, 2, 32, 48)


@pytest.mark.parametrize("h,w", [(45, 67), (64, 96)])
def test_lsid_count_matches_the_flop_counter(h, w):
    fc = _counted(lambda: ref_lsid.LSID(base_width=8)(torch.rand(1, h, w, 4)))
    assert fc.get_total_flops() == flops.forward_flops(LSID, 1, h, w)


def test_counts_at_the_cells_shapes():
    big = dict(NDN, dim=48)
    assert flops.forward_flops(big, 4, 512, 512) == 2_399_320_793_088
    assert abs(flops.forward_flops(dict(LSID, base_width=32), 1, 1424, 2128) - 1.1186e12) < 1e8


# the kernel table's shapes (PERF.md; chip_smoke's STAGES, ATTN_PER_EVAL,
# GN_PER_EVAL, GN_PER_STEP at B 4, 512^2, dim 48) and its bound ms
STAGES = [(512 >> i, 48 << i) for i in range(4)]
ATTN = {0: 3, 1: 2, 2: 2, 3: 2}
GN_EVAL = [(0, True, 1), (0, False, 3), (0, True, 5), (0, False, 5), (1, True, 4),
           (1, False, 4), (2, True, 4), (2, False, 4), (3, True, 6), (3, False, 6)]
GN_STEP = {0: 16, 1: 8, 2: 8, 3: 12}


@pytest.mark.parametrize("row,want_ms", [
    ("attn_tail", 0.3382), ("attn_tail_bwd", 0.7102), ("groupnorm_silu", 1.2921),
    ("dual_head", 0.0952), ("gn_stats", 0.7062), ("gn_grad_stats", 1.4124)])
def test_roofline_formulas_give_the_kernel_tables_bounds(row, want_ms):
    b = 4
    if row in ("attn_tail", "attn_tail_bwd"):
        fn = getattr(roofline, row)
        got = sum(ATTN[s] * fn(b, r, r, c) for s, (r, c) in enumerate(STAGES))
    elif row == "groupnorm_silu":
        got = sum(n * roofline.groupnorm_silu(b, STAGES[s][0] ** 2, STAGES[s][1], film)
                  for s, film, n in GN_EVAL)
    elif row == "dual_head":
        got = roofline.dual_head(b, 512, 512, 48)
    else:
        fn = getattr(roofline, row)
        got = sum(GN_STEP[s] * fn(b, r * r, c) for s, (r, c) in enumerate(STAGES))
    assert round(got * 1e3, 4) == want_ms


def test_call_list_is_the_calls_the_port_makes():
    """The shapes the port hands its kernel wrappers in one bf16
    evaluation (recorded on the CPU, where each wrapper runs its plain
    version) are the roofline's call list."""
    from noisediff_tpu_torch.models import NoiseDiffNet, blocks
    from noisediff_tpu_torch.models import noisediff_net as ndn_mod

    seen = []
    orig = (blocks.fused_attn_tail, blocks.fused_groupnorm_film_silu, ndn_mod.fused_dual_head)

    def attn(x, *a, **k):
        seen.append(("attn", tuple(x.shape)))
        return orig[0](x, *a, **k)

    def gn(x, w, b, fs, fsh, *a, **k):
        seen.append(("gn", (x.shape[0], x.shape[1], x.shape[2], fs is not None)))
        return orig[1](x, w, b, fs, fsh, *a, **k)

    def head(x, *a, **k):
        seen.append(("head", tuple(x.shape)))
        return orig[2](x, *a, **k)

    blocks.fused_attn_tail, blocks.fused_groupnorm_film_silu, ndn_mod.fused_dual_head = (
        attn, gn, head)
    try:
        x, t, c = _inputs(2, 32, 48)
        with torch.no_grad():
            NoiseDiffNet(dim=16, dtype=torch.bfloat16).eval()(x, t, c)
    finally:
        blocks.fused_attn_tail, blocks.fused_groupnorm_film_silu, ndn_mod.fused_dual_head = orig
    want = [k for k in roofline.noisediffnet_calls(NDN, 2, 32, 48) if k[0] != "gn_pixel"]
    assert sorted(seen) == sorted(want)


def test_weights_are_a_function_of_the_seed():
    shapes = weights.shapes_of(RefNet(dim=16))
    a = weights.seeded_state(shapes, 5, CPU)
    b = weights.seeded_state(shapes, 5, CPU)
    c = weights.seeded_state(shapes, 6, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(bool((a[k] > 0).all()) for k in a if k.endswith("norm.weight"))


def test_reference_model_agrees_with_the_ports_fp32_route():
    prog, ref, _ = _pair(NDN)
    x, t, c = _inputs(2, 32, 48)
    with torch.no_grad():
        a, r = prog(x, t, c), ref(x, t, c)
    assert float((a - r).norm() / r.norm()) < 1e-5


def test_reference_sampler_agrees_with_the_ports():
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.ops.schedules import make_schedule

    prog, ref, _ = _pair(NDN)
    gd = GaussianDiffusion(prog, make_schedule("sigmoid2", 1000), image_size=32, device="cpu")
    ac = ref_diffusion.alphas_cumprod("sigmoid2", 1000)
    assert np.array_equal(ac, gd.schedule.alphas_cumprod.astype(np.float64))
    x, _, c = _inputs(2, 32, 32)
    with torch.no_grad():
        a = gd.dpm_solver_sample((2, 32, 32, 4), c, sampling_timesteps=10, init_noise=x)
        r = ref_diffusion.dpm_solver_2m(lambda xx, tt: ref(xx, tt, c), x, ac, 10)
        t = torch.randint(0, 1000, (2,))
        la = gd.loss(0.1 * x, c, t=t, noise=x.flip(0))
        lr = ref_diffusion.pred_v_loss(lambda xx, tt: ref(xx, tt, c), 0.1 * x, t, x.flip(0), ac)
    assert float((a - r).norm() / r.norm()) < 1e-4
    assert abs(float(la) - float(lr)) <= 1e-5 * abs(float(lr))


def test_reference_frame_evaluation_agrees_with_the_ports():
    from noisediff_tpu_torch.ops import metrics as M
    from noisediff_tpu_torch.ops import raw

    prog, ref, _ = _pair(LSID)
    g = torch.Generator().manual_seed(1)
    bayer_in = (512 + 30 * torch.rand(96, 128, generator=g)).round()
    bayer_gt = (512 + 9000 * torch.rand(96, 128, generator=g)).round()
    ds = 3 * torch.rand(96, 128, generator=g)
    with torch.no_grad():
        noisy = (raw.pack_raw_withdarkshading(bayer_in, ds, 100.0) * 100.0).clamp(0, 1)
        clean = raw.pack_raw(bayer_gt).clamp(0, 1)
        out = M.illuminance_correct(prog(noisy[None])[0].clamp(0, 1), clean)
        p, s = M.psnr(out, clean, 1.0), M.ssim(out, clean, 1.0)
        want, rp, rs = ref_lsid.evaluate_frame(ref, bayer_in, bayer_gt, ds, 100.0)
    assert float((out - want).abs().max()) < 1e-6
    assert abs(float(p) - float(rp)) < 1e-4 and abs(float(s) - float(rs)) < 1e-6
