"""Full-frame denoiser evaluation: the per-frame body of the port's
`cli/test_denoising.evaluate` with `--correct_darkshading --correct_illum`,
one frame at a time, closed loop. A frame's two float32 mosaics are
uploaded (`_upload`: pinned, then copied), packed with the dark shading of
its ISO and amplified by the ratio (`ops/raw`), the ground truth packed,
LSID run in fp32 with TF32 off, the output illuminance-corrected and
scored (`ops/metrics`), and PSNR and SSIM read on the host.

Traffic parameters: `bayer` (the mosaic's size), `ratio`, `isos` (the ISOs
a pair draws from), `level` (the range of a scene's mean level, a share of
the white point), `gain` and `read_noise` (the shot noise's DN per
electron and the read noise in DN of the short exposure), `darkshading`
(the dark shading's scale in DN), `pool` (mosaic pairs made in set-up and
sent in turn), `sample` (finished frames the reference checks),
`profiled` (frames in the traced part).

A unit is one frame; the window runs frames until `seconds` have passed
and the running frame has been scored.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import common, port, trace
from harness.flops import forward_flops
from harness.roofline import peak_flops
from reference import lsid as ref_lsid

BLACK, WHITE = 512.0, 16383.0


def _smooth(g, shape, cells: int, device) -> torch.Tensor:
    """A smooth random field in [0, 1) of `shape` (C, H, W): uniform noise on
    a grid of `cells` pixels, bilinearly upsampled."""
    c, h, w = shape
    coarse = torch.rand((1, c, -(-h // cells) + 1, -(-w // cells) + 1), generator=g,
                        device=device)
    up = torch.nn.functional.interpolate(coarse, scale_factor=cells, mode="bilinear",
                                         align_corners=False)
    return up[0, :, :h, :w]


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """(4, h, w) as R, G1, B, G2 -> the (2h, 2w) RGGB mosaic."""
    _, h, w = packed.shape
    out = torch.empty((2 * h, 2 * w), device=packed.device)
    out[0::2, 0::2], out[0::2, 1::2] = packed[0], packed[1]
    out[1::2, 1::2], out[1::2, 0::2] = packed[2], packed[3]
    return out


def make_pool(tr: dict, seed: int, device) -> tuple:
    """`pool` pairs of host mosaics (noisy short exposure, long exposure)
    with their ISO, and a dark shading map (DN, the mosaic's size) for
    each ISO drawn, all from the seed."""
    h, w = tr["bayer"]
    ratio, lo, hi = tr["ratio"], *tr["level"]
    pairs, maps = [], {}
    for i in range(tr["pool"]):
        g = torch.Generator(device=device).manual_seed(common.sub_seed(seed, 3, i))
        rng = np.random.default_rng(common.sub_seed(seed, 4, i))
        iso = int(rng.choice(tr["isos"]))
        level = rng.uniform(lo, hi)
        scene = (level * (0.2 + 1.6 * _smooth(g, (4, h // 2, w // 2), 64, device)
                          * _smooth(g, (1, h // 2, w // 2), 8, device))).clamp(0, 1)
        clean_dn = _unpack(scene) * (WHITE - BLACK)
        gt = (clean_dn + BLACK + torch.randn((h, w), generator=g, device=device)).round()
        if iso not in maps:
            gm = torch.Generator(device=device).manual_seed(common.sub_seed(seed, 5, iso))
            maps[iso] = tr["darkshading"] * (
                _smooth(gm, (1, h, w), 256, device)[0]
                + 0.5 * torch.rand((1, w), generator=gm, device=device) - 0.75)
        signal = clean_dn / ratio
        noise = torch.randn((h, w), generator=g, device=device) * torch.sqrt(
            tr["gain"] * signal + tr["read_noise"] ** 2)
        noisy = (signal + noise + BLACK + maps[iso]).round()
        pairs.append({"iso": iso,
                      "in": noisy.clamp(0, WHITE).cpu().numpy(),
                      "gt": gt.clamp(0, WHITE).cpu().numpy()})
    return pairs, {iso: m.cpu().numpy() for iso, m in maps.items()}


def run(ctx) -> dict:
    cfg, tr, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    from noisediff_tpu_torch.cli.test_denoising import _upload
    from noisediff_tpu_torch.ops import metrics as M
    from noisediff_tpu_torch.ops import raw as raw_ops

    parts = {"imports": time.perf_counter() - ctx.t_start}
    port.program_settings()
    control = getattr(ctx, "control", None)
    if control == "tf32":  # the reference in the program's place, one precision below
        model = port.reference_model(cfg, dev)
        port.precision_flags(True)
    else:
        model = port.program_model(cfg, dev)
    state = port.seeded_weights(cfg, model, common.sub_seed(seed, 0), dev)
    model.load_state_dict(state)
    model.eval()
    parts["model"] = time.perf_counter() - ctx.t_start - sum(parts.values())
    pairs, ds_host = make_pool(tr, seed, dev)
    parts["inputs"] = time.perf_counter() - ctx.t_start - sum(parts.values())
    maps = {}
    ratio = float(tr["ratio"])
    upload_ms = []

    def frame(i, events=False):
        pair = pairs[i % len(pairs)]
        iso = pair["iso"]
        if events:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        x_in, x_gt = _upload(pair["in"], dev), _upload(pair["gt"], dev)
        if iso not in maps:
            maps[iso] = _upload(ds_host[iso], dev)
        with torch.no_grad():
            noisy = raw_ops.pack_raw_withdarkshading(x_in, maps[iso], ratio) * ratio
            noisy = noisy.clamp(0.0, 1.0)
            clean = raw_ops.pack_raw(x_gt).clamp(0.0, 1.0)
            if events:
                ev[1].record()
            out = model(noisy[None])[0].clamp(0.0, 1.0)
            out = M.illuminance_correct(out, clean)
            p, s = M.psnr(out, clean, 1.0), M.ssim(out, clean, 1.0)
            p, s = float(p), float(s)
        if events:
            upload_ms.append(ev[0].elapsed_time(ev[1]))
        return out, p, s

    for i in range(len(pairs)):  # every ISO's dark shading to the card, every shape warm
        frame(i)
    sample = common.Reservoir(seed, tr["sample"])
    times = []
    events = bool(ctx.trace) and dev.type == "cuda"
    t_first = time.perf_counter()
    parts["warm-up"] = t_first - ctx.t_start - sum(parts.values())
    n = 0
    while True:
        t0 = time.perf_counter()
        with record_function("pb::frame"):
            got = frame(n, events)
        times.append(time.perf_counter() - t0)
        sample.offer(n, lambda: got)
        n += 1
        if time.perf_counter() - t_first >= ctx.seconds:
            break
    window = time.perf_counter() - t_first
    hw = (tr["bayer"][0] // 2, tr["bayer"][1] // 2)
    record = {"setup_s": t_first - ctx.t_start, "window_seconds": window, "units": n,
              "items_per_unit": 1, "chips": 1, "unit_seconds": times,
              "flops_per_unit": forward_flops(cfg, 1, *hw), "peak_flops": peak_flops(cfg),
              "upload_ms": upload_ms, "setup_parts": parts}
    if ctx.trace:
        record["trace"] = trace.profiled(lambda: [frame(n + k) for k in range(tr["profiled"])],
                                         dev, common.ROOT)
        record["trace"]["units"] = tr["profiled"]
    record["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    sampled = [(i, (out.cpu(), p, s)) for i, (out, p, s) in sample.items()]
    del model, got, sample
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gaps = check(cfg, tr, state, pairs, ds_host, sampled, dev)
    record["setup_parts"]["(check, after the window)"] = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": ctx.limits[k]} for k, v in gaps.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"attempted": n, "failed": 0, "record": record, "checks": checks, "correct": correct}


def check(cfg, tr, state, pairs, ds_host, sampled, dev) -> dict:
    """Over the sampled frames, the worst gaps between the program's
    output frame, PSNR and SSIM and the reference's on the same mosaics,
    dark shading and weights: relative L2 of the frame, |dPSNR| in dB,
    |dSSIM| against the reference's SSIM in float64 (NaN fails)."""
    port.precision_flags(False)
    ref = port.reference_model(cfg, dev)
    ref.load_state_dict(state)
    ref.eval()
    worst = {"frame_rel_l2": 0.0, "psnr_gap_db": 0.0, "ssim_gap": 0.0}
    for i, (out, p, s) in sampled:
        pair = pairs[i % len(pairs)]
        with torch.no_grad():
            want, rp, rs = ref_lsid.evaluate_frame(
                ref, torch.from_numpy(pair["in"]).to(dev), torch.from_numpy(pair["gt"]).to(dev),
                torch.from_numpy(ds_host[pair["iso"]]).to(dev), float(tr["ratio"]))
        want = want.cpu().double()
        gaps = {"frame_rel_l2": float((out.double() - want).norm() / want.norm()),
                "psnr_gap_db": abs(p - float(rp)), "ssim_gap": abs(s - float(rs))}
        for k, v in gaps.items():
            worst[k] = max(worst[k], v if np.isfinite(v) else float("inf"))
    return worst
