#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (noisediff_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Every phase runs, in this order (any failure exits non-zero):
  env      the card's name and power limit, torch / CUDA versions, TF32 flags
  build    nvcc builds every kernel of the port from noisediff_tpu_torch/csrc/
           (one compiler process per source, all at once)
  kernels  each kernel against its plain PyTorch version on the card, at
           every shape the generation and training paths give it;
           CUDA-event timings of both beside the card's bound for the same
           work
  model    the full-width (dim 48) NoiseDiffNet forward on the card, bf16
           through the kernels, against the same weights on the CPU
  profile  one model evaluation at the canonical shape: CUDA-event time and
           torch.profiler device time by kernel, with the idle share
  main     bulk generation through the port's CLI at the canonical config
           (NoiseDiffNet dim 48, crop 512, batch 4, sigmoid2, DPM-Solver++
           10-step lambda grid) from seeded random weights saved as a
           reference-layout .pth, over a miniature SID tree made from the
           seed: 2 batches of 4 patches. Checks the npy contract, that every
           kernel ran the expected number of times per batch, and that
           --skip_existing regenerates a deleted patch identically.
  train_check  one training step's loss and every parameter gradient of
           the full-width (dim 48) NoiseDiffNet on the card (bf16, every
           kernel and its backward) against the same step on the CPU (B 2,
           64^2); every parameter the forward reads gets a finite gradient
  train    training through the port's CLI at the canonical config
           (script.sh:8: NoiseDiffNet dim 48, crop 512, batch 4, sigmoid2,
           pred_v, bf16 over fp32 parameters), 1 epoch over a miniature SID
           tree made from the seed (2 pairs of 2848x4256 Bayer frames,
           rebalanced to 100 samples: 25 steps). Checks the losses, the
           kernels' launches per step, the snapshots, and generates from
           net_final.pth through the generation CLI; reports steps/s and
           samples/s over the window after the first 3 steps on the card's
           clock (loader waits and uploads included), the epoch's wall
           time and loader waits, the step-time spread and peak memory
  train profile  the training step's period three ways (batch on the card
           with no host sync; the same with a sync after each step; batch
           uploaded before each step) and the device busy time by kernel
           class (torch.profiler); the idle share of each and of the CLI
           run's step
The last lines are the kernels JSON line, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# bf16 tensor-core, fp32 vector and memory peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# canonical generation and training config
BATCH, CROP, DIM = 4, 512, 48
STAGES = [(CROP >> i, DIM << i) for i in range(4)]  # (resolution, channels)
# launches per model evaluation at each shape (NoiseDiffNet dim 48)
ATTN_PER_EVAL = {0: 3, 1: 2, 2: 2, 3: 2}  # shot_attn + down/up attn per stage
GN_PER_EVAL = [  # (stage, groups, film, count)
    (0, 2, True, 1), (0, 2, False, 3),  # shot_time; shot_time, pos_block1/2 block2
    (0, 8, True, 5), (0, 8, False, 5),  # downs_0 x2, ups_3 x2, final_res_block
    (1, 8, True, 4), (1, 8, False, 4),
    (2, 8, True, 4), (2, 8, False, 4),
    (3, 8, True, 6), (3, 8, False, 6),  # downs_3 x2, mid x2, ups_0 x2
]
# GroupNorms per training step at each stage: the time-FiLM and plain ones
# above plus the two per-pixel-FiLM ones of pos_block1/2 at full resolution
GN_PER_STEP = {0: 16, 1: 8, 2: 8, 3: 12}
DPM_STEPS = 10
N_BATCHES = 2
# the miniature training tree: 2 pairs at SID Sony's frame size, one ISO800
# x250 bucket rebalanced to int(100 / 2) * 2 = 100 samples
SID_BAYER = (2848, 4256)
TRAIN_STEPS = 100 // BATCH
PROFILE_STEPS = 8
FRAME = 640  # packed frame side of the smoke tree
GRID_NAMES = {f"{x}_{y}" for x in (0, 128) for y in (0, 128)}
# stated tolerances, kernel vs plain version on the same card inputs:
# |k - p| <= ATOL + RTOL * |p|; bf16 outputs may differ by a rounding flip
# at each stored intermediate (fp32 sums in another order)
TOLS = {"attn_tail": (3e-2, 3e-2), "groupnorm_silu": (2e-2, 2e-2), "dual_head": (1e-2, 1e-2),
        # dx = g + dtok2 with dtok2 stored in bf16: a rounding flip of dtok2
        # is relative to |dtok2| <= |dx| + |g|, the scale of this check
        "attn_tail_bwd dx": (3e-2, 3e-2)}
# fp32 sums over up to 262144 rows in another order: within 1e-4 of the
# largest sum of the call
SUM_RTOL = 1e-4
# gradients, by relative L2: the plain backward rounds the weight gradients
# to bf16 (autograd through the weights' cast) where the kernel keeps fp32,
# and every sum over pixels runs in another order
GRAD_REL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_scaled(name, got, want, rtol):
    """|k - p| <= rtol * max |p| elementwise; returns the max abs error."""
    import torch

    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = float((g - w).abs().max())
    if err > rtol * float(w.abs().max()):
        raise AssertionError(f"{name}: max abs err {err} over {rtol} x max |plain|")
    return err


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-12))


def compare(name, got, want, scale=None):
    """|k - p| <= atol + rtol * scale elementwise, scale |p| by default;
    returns the max abs error."""
    import torch

    rtol, atol = TOLS[name]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (g - w).abs()
    bad = int((err > atol + rtol * (w.abs() if scale is None else scale)).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} elements outside atol {atol} + rtol {rtol}; "
                             f"max abs err {float(err.max())}")
    return float(err.max())


# ---------------------------------------------------------------------------
def phase_kernels(seed: int):
    """Kernel vs plain version and timings at every generation-path shape."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        fused_attn_tail, fused_dual_head, fused_groupnorm_film_silu, reference_attn_tail,
        reference_dual_head, reference_groupnorm_film_silu)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    results = {}

    # attn_tail at the four stages
    rows = []
    for st, (res, c) in enumerate(STAGES):
        x = randn(BATCH, res, res, c, dtype=torch.bfloat16)
        tok = randn(BATCH, c, scale=0.3, dtype=torch.bfloat16)
        p = (1.0 + 0.1 * randn(c), 0.1 * randn(c), randn(2 * c, c, scale=c ** -0.5),
             0.1 * randn(2 * c), randn(c, 2 * c, scale=(2 * c) ** -0.5), 0.1 * randn(c),
             randn(c, c, scale=c ** -0.5), 0.1 * randn(c))
        args = (x, tok) + p
        err = compare("attn_tail", fused_attn_tail(*args), reference_attn_tail(*args))
        ms = time_ms(lambda: fused_attn_tail(*args))
        plain = time_ms(lambda: reference_attn_tail(*args), reps=5)
        pix = BATCH * res * res
        moved = 2 * nbytes(x) + nbytes(tok) + 5 * c * c * 2 + 6 * c * 4
        b_ms, b_by = bound(moved, 10 * pix * c * c, PEAK_BF16_FLOPS)
        rows.append(dict(shape=[BATCH, res, res, c], calls=ATTN_PER_EVAL[st], ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
        log(f"  attn_tail {res}^2 x {c}: {ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.4f} "
            f"{b_by}), max abs err {err:.3g}")
        del x, args
    results["attn_tail"] = rows

    # groupnorm_silu at every (stage, groups, FiLM) the path uses
    rows = []
    for st, groups, film, count in GN_PER_EVAL:
        res, c = STAGES[st]
        x = randn(BATCH, res * res, c, dtype=torch.bfloat16)
        gamma, beta = 1.0 + 0.1 * randn(c), 0.1 * randn(c)
        fs, fsh = (0.2 * randn(BATCH, c), 0.2 * randn(BATCH, c)) if film else (None, None)
        args = (x, gamma, beta, fs, fsh, groups)
        err = compare("groupnorm_silu", fused_groupnorm_film_silu(*args),
                      reference_groupnorm_film_silu(*args))
        ms = time_ms(lambda: fused_groupnorm_film_silu(*args))
        plain = time_ms(lambda: reference_groupnorm_film_silu(*args), reps=5)
        moved = 2 * nbytes(x) + 2 * c * 4 + (2 * BATCH * c * 4 if film else 0)
        b_ms, b_by = bound(moved, 8 * x.numel(), PEAK_FP32_FLOPS)
        rows.append(dict(shape=[BATCH, res * res, c], groups=groups, film=film,
                         calls=count, ms=ms, plain_ms=plain, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err))
        log(f"  groupnorm_silu {res}^2 x {c} G{groups} film={film}: {ms:.4f} ms "
            f"(plain {plain:.4f}, bound {b_ms:.4f} {b_by}), max abs err {err:.3g}")
        del x, args
    results["groupnorm_silu"] = rows

    # dual_head at full resolution
    c = DIM
    x, sa, sb = (randn(BATCH, CROP, CROP, c, dtype=torch.bfloat16) for _ in range(3))
    p = (randn(c, c, scale=c ** -0.5), 0.1 * randn(c), randn(4, c, scale=c ** -0.5),
         0.1 * randn(4), randn(4, c, scale=c ** -0.5), 0.1 * randn(4))
    args = (x, sa, sb) + p
    err = compare("dual_head", fused_dual_head(*args), reference_dual_head(*args))
    ms = time_ms(lambda: fused_dual_head(*args))
    plain = time_ms(lambda: reference_dual_head(*args), reps=5)
    pix = BATCH * CROP * CROP
    moved = 3 * nbytes(x) + pix * 4 * 4 + (c * c + 8 * c + c + 8) * 4
    b_ms, b_by = bound(moved, 2 * pix * (c * c + 8 * c), PEAK_BF16_FLOPS)
    results["dual_head"] = [dict(shape=[BATCH, CROP, CROP, c], calls=1, ms=ms,
                                 plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                 max_abs_err=err)]
    log(f"  dual_head {CROP}^2 x {c}: {ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.4f} "
        f"{b_by}), max abs err {err:.3g}")
    del x, sa, sb, args
    torch.cuda.empty_cache()
    results.update(kernels_training(randn))
    torch.cuda.empty_cache()
    return results


def kernels_training(randn):
    """The training path's kernels at the canonical training shapes: gn_stats
    and gn_grad_stats at the four stages, the attn_tail backward at the four
    stages (every gradient against autograd of the plain version)."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        fused_attn_tail_bwd, gn_grad_stats, gn_stats, reference_attn_tail_bwd,
        reference_gn_grad_stats, reference_gn_stats)

    results = {"gn_stats": [], "gn_grad_stats": [], "attn_tail_bwd": []}
    for st, (res, c) in enumerate(STAGES):
        x = randn(BATCH, res, res, c, scale=1.5, dtype=torch.bfloat16) + 0.5
        g = randn(BATCH, res, res, c, dtype=torch.bfloat16)
        out_bytes = 2 * BATCH * c * 4
        for name, fn, ref, args, reads, flops in (
                ("gn_stats", gn_stats, reference_gn_stats, (x,), nbytes(x), 3 * x.numel()),
                ("gn_grad_stats", gn_grad_stats, reference_gn_grad_stats, (g, x),
                 2 * nbytes(x), 3 * x.numel())):
            got, want = fn(*args), ref(*args)
            err = max(compare_scaled(name, a, b, SUM_RTOL) for a, b in zip(got, want))
            if not all(torch.equal(a, b) for a, b in zip(got, fn(*args))):
                raise AssertionError(f"{name} {res}^2 x {c}: two calls differ")
            ms = time_ms(lambda: fn(*args))
            plain = time_ms(lambda: ref(*args), reps=5)
            b_ms, b_by = bound(reads + out_bytes, flops, PEAK_FP32_FLOPS)
            results[name].append(dict(shape=[BATCH, res, res, c], calls=GN_PER_STEP[st], ms=ms,
                                      plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                      max_abs_err=err))
            log(f"  {name} {res}^2 x {c}: {ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.4f} "
                f"{b_by}), max abs err {err:.3g}")

        tok = randn(BATCH, c, scale=0.3, dtype=torch.bfloat16)
        p = (1.0 + 0.1 * randn(c), 0.1 * randn(c), randn(2 * c, c, scale=c ** -0.5),
             0.1 * randn(2 * c), randn(c, 2 * c, scale=(2 * c) ** -0.5), 0.1 * randn(c),
             randn(c, c, scale=c ** -0.5), 0.1 * randn(c))
        args = (x, tok) + p + (g,)
        got, want = fused_attn_tail_bwd(*args), reference_attn_tail_bwd(*args)
        # dx elementwise; the reduced gradients (dtok and the parameters') by
        # relative L2
        compare("attn_tail_bwd dx", got[0], want[0], scale=want[0].float().abs() + g.float().abs())
        names = ("dx", "dtok", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2", "dwp", "dbp")
        rels = {}
        for n, a, b in zip(names, got, want):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"attn_tail_bwd {res}^2 x {c}: {n} is not finite")
            rels[n] = rel_l2(a, b)
        worst = max(rels, key=rels.get)
        if rels[worst] > GRAD_REL:
            raise AssertionError(f"attn_tail_bwd {res}^2 x {c}: rel L2 {rels}")
        # every sum runs in a fixed order: a second call gives the same bits
        if not all(torch.equal(a, b) for a, b in zip(got, fused_attn_tail_bwd(*args))):
            raise AssertionError(f"attn_tail_bwd {res}^2 x {c}: two calls differ")
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        ms = time_ms(lambda: fused_attn_tail_bwd(*args), reps=10)
        plain = time_ms(lambda: reference_attn_tail_bwd(*args), reps=3)
        pix = BATCH * res * res
        moved = 3 * nbytes(x) + nbytes(tok) + 5 * c * c * 2 + 6 * c * 4 + BATCH * c * 4 \
            + (5 * c * c + 6 * c) * 4
        b_ms, b_by = bound(moved, 30 * pix * c * c, PEAK_BF16_FLOPS)
        results["attn_tail_bwd"].append(dict(
            shape=[BATCH, res, res, c], calls=ATTN_PER_EVAL[st], ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_l2=rels))
        log(f"  attn_tail_bwd {res}^2 x {c}: {ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.4f} "
            f"{b_by}), worst rel L2 {rels[worst]:.3g} ({worst}), max abs err {err:.3g}")
        del x, g, args, got, want
    return results


def phase_model(seed: int):
    """Full-width model on the card (bf16, kernels) vs the CPU (plain versions)."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.models import NoiseDiffNet

    torch.manual_seed(seed)
    ref = NoiseDiffNet(dim=DIM).eval()
    rng = np.random.default_rng(seed)
    b, s = 1, 64
    x = torch.from_numpy(rng.standard_normal((b, s, s, 4)).astype(np.float32))
    cond = {"clean_img": torch.from_numpy(rng.uniform(0, 0.3, (b, s, s, 4)).astype(np.float32)),
            "position": torch.from_numpy(rng.uniform(0, 1, (b, s, s, 2)).astype(np.float32)),
            "iso_ratio_idx": torch.tensor([24])}
    t = torch.tensor([421])
    out = {}
    with torch.inference_mode():
        want32 = ref(x, t, cond)
        cpu_bf = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16).eval()
        cpu_bf.load_state_dict(ref.state_dict())
        want16 = cpu_bf(x, t, cond).float()
        card = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16)
        card.load_state_dict(ref.state_dict())
        card = card.cuda().to(memory_format=torch.channels_last).eval()
        got = card(x.cuda(), t.cuda(), {k: v.cuda() for k, v in cond.items()}).float().cpu()
    if got.shape != (b, s, s, 4) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"model output on the card: shape {tuple(got.shape)} or not finite")
    for name, want in (("cpu_bf16", want16), ("cpu_fp32", want32)):
        out[name] = float((got - want).norm() / want.norm())
    log(f"  dim-48 forward {b}x{s}x{s}: card bf16 vs CPU bf16 rel L2 {out['cpu_bf16']:.4g}, "
        f"vs CPU fp32 {out['cpu_fp32']:.4g}")
    # bf16 through ~60 layers on both sides; the kernels and the CPU's plain
    # versions store the same intermediates in bf16
    if out["cpu_bf16"] > 5e-2:
        raise AssertionError(f"card forward disagrees with the CPU bf16 forward: {out}")
    return out


def _category(name: str) -> str:
    if "attn_tail_bwd" in name or "wgrad_partial" in name or "sum_splits" in name:
        return "attn_tail backward kernel"
    if "attn_tail" in name:
        return "attn_tail kernel"
    if "channel_partial_sums<true>" in name or "ILb1E" in name:
        return "gn_grad_stats kernel"
    if "channel_partial_sums" in name or "sum_partials" in name:
        return "GroupNorm statistics (gn_stats, or groupnorm_silu's first pass)"
    if name.startswith("gn_") or "gn_apply" in name or "gn_coeffs" in name:
        return "groupnorm_silu kernel"
    if "dual_head" in name:
        return "dual_head kernel"
    low = name.lower()
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "gemm", "sm90", "wgrad")):
        return "convolutions and matmuls (cuDNN / cuBLAS)"
    return "other (elementwise, copies, concat, upsample)"


def phase_profile(seed: int, evals: int = 3):
    """One model evaluation at the canonical shape: CUDA-event time, and the
    device time by kernel from torch.profiler, with the device's idle share."""
    import torch

    from noisediff_tpu_torch.models import NoiseDiffNet

    torch.manual_seed(seed)
    dev = torch.device("cuda")
    model = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last)
    model.eval()
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((BATCH, CROP, CROP, 4), generator=g, device=dev)
    cond = {"clean_img": 0.2 * torch.rand((BATCH, CROP, CROP, 4), generator=g, device=dev),
            "position": torch.rand((BATCH, CROP, CROP, 2), generator=g, device=dev),
            "iso_ratio_idx": torch.full((BATCH,), 24, device=dev)}
    t = torch.full((BATCH,), 500, device=dev)
    with torch.inference_mode():
        eval_ms = time_ms(lambda: model(x, t, cond), reps=10, warmup=2)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(evals):
                model(x, t, cond)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / evals
    by_name = _device_ms_by_name(prof, evals)
    busy = sum(by_name.values())
    log(f"  one evaluation ({BATCH}x{CROP}^2, dim {DIM}, bf16): {eval_ms:.4f} ms by CUDA events; "
        f"profiled wall {wall_ms:.4f} ms, device busy {busy:.4f} ms "
        f"(idle share {max(0.0, 1 - busy / wall_ms):.4f})")
    if not by_name:
        log("  torch.profiler recorded no device time")
        return dict(eval_ms=eval_ms)
    cats = {}
    for name, ms in by_name.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {cat}")
    log("  top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {ms:9.4f} ms  {name[:110]}")
    return dict(eval_ms=eval_ms, wall_ms=wall_ms, busy_ms=busy, categories=cats)


def _device_ms_by_name(prof, n: int):
    by_name = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / n
    return by_name


def _canonical_batch(g, dev):
    import torch

    return {
        "noise": 0.02 * torch.randn((BATCH, CROP, CROP, 4), generator=g, device=dev),
        "clean_img": 0.2 * torch.rand((BATCH, CROP, CROP, 4), generator=g, device=dev),
        "coord": torch.rand((BATCH, CROP, CROP, 2), generator=g, device=dev),
        "iso_ratio_idx": torch.full((BATCH,), 24, device=dev),
    }


def phase_train_check(seed: int):
    """One training step's loss and gradients, full-width model: card (bf16,
    kernels) vs the CPU (plain versions) in bf16 and fp32."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter
    from noisediff_tpu_torch.ops.schedules import make_schedule

    torch.manual_seed(seed)
    ref = NoiseDiffNet(dim=DIM)
    rng = np.random.default_rng(seed)
    b, s = 2, 64
    img = torch.from_numpy((0.02 * rng.standard_normal((b, s, s, 4))).astype(np.float32))
    cond = {"clean_img": torch.from_numpy(rng.uniform(0, 0.3, (b, s, s, 4)).astype(np.float32)),
            "position": torch.from_numpy(rng.uniform(0, 1, (b, s, s, 2)).astype(np.float32)),
            "iso_ratio_idx": torch.tensor([24, 3])}
    t = torch.tensor([421, 37])
    noise = torch.from_numpy(rng.standard_normal((b, s, s, 4)).astype(np.float32))
    schedule = make_schedule("sigmoid2", 1000)

    def step(dtype, dev):
        model = NoiseDiffNet(dim=DIM, dtype=dtype)
        model.load_state_dict(ref.state_dict())
        model = model.to(dev, memory_format=torch.channels_last).train()
        gd = GaussianDiffusion(model, schedule, image_size=s, device=dev)
        loss = gd.loss(img.to(dev), {k: v.to(dev) for k, v in cond.items()}, t=t.to(dev),
                       noise=noise.to(dev))
        loss.backward()
        return float(loss), {n: (None if p.grad is None else p.grad.float().cpu())
                             for n, p in model.named_parameters()}

    loss32, g32 = step(None, torch.device("cpu"))
    loss16, g16 = step(torch.bfloat16, torch.device("cpu"))
    loss_card, gc = step(torch.bfloat16, torch.device("cuda"))
    out = {"loss_card": loss_card, "loss_cpu_bf16": loss16, "loss_cpu_fp32": loss32}
    # bf16 through ~60 layers forward and back on both sides: the loss
    # within 2e-2, each gradient as close to the fp32 one as the CPU's bf16
    # gradient is (within 2x + 0.02), all gradients within 5e-2 of the CPU
    # bf16 ones
    if abs(loss_card - loss16) > 2e-2 * abs(loss16):
        raise AssertionError(f"train_check: loss {out}")
    bad, worst, cat_c, cat_16 = {}, 0.0, [], []
    for name, gr in gc.items():
        if is_unread_parameter(name):
            if gr is not None:
                raise AssertionError(f"train_check: {name} is never read but has a gradient")
            continue
        if gr is None or not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"train_check: {name} has no finite gradient on the card")
        r = rel_l2(gr, g32[name])
        limit = 2 * rel_l2(g16[name], g32[name]) + 0.02
        worst = max(worst, rel_l2(gr, g16[name]))
        if r > limit:
            bad[name] = (r, limit)
        cat_c.append(gr.flatten())
        cat_16.append(g16[name].flatten())
    out["grad_rel_l2_all"] = rel_l2(torch.cat(cat_c), torch.cat(cat_16))
    out["grad_rel_l2_worst_param"] = worst
    n_read = sum(1 for n in gc if not is_unread_parameter(n))
    log(f"  dim-48 train step {b}x{s}^2: loss card {loss_card:.6f}, CPU bf16 {loss16:.6f}, "
        f"CPU fp32 {loss32:.6f}; {n_read} read parameters with finite gradients on the card; "
        f"all gradients vs CPU bf16 rel L2 {out['grad_rel_l2_all']:.4g}, worst parameter "
        f"{worst:.4g}")
    if bad or out["grad_rel_l2_all"] > 5e-2:
        raise AssertionError(f"train_check: gradients disagree: {bad} {out}")
    return out


def make_train_tree(root: str, seed: int) -> None:
    """A miniature SID training tree: 2 short/long pairs at the Sony frame
    size as .npy sidecars, one ISO800 x250 bucket."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    sid = os.path.join(root, "SID")
    for sub in ("short", "long"):
        os.makedirs(os.path.join(sid, "Sony", sub))
    lines = []
    for i in (1, 2):
        in_fn, gt_fn = f"{i:05d}_00_0.04s.ARW", f"{i:05d}_00_10s.ARW"
        clean = rng.integers(512, 4096, size=SID_BAYER).astype(np.uint16)
        dark = (512 + (clean - 512) // 250 + rng.integers(0, 24, size=SID_BAYER)).astype(np.uint16)
        np.save(os.path.join(sid, "Sony", "short", in_fn + ".npy"), dark)
        np.save(os.path.join(sid, "Sony", "long", gt_fn + ".npy"), clean)
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO800 F1.8")
    with open(os.path.join(sid, "Sony_train_list.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def phase_train(seed: int, workdir: str):
    """Training through the CLI at the canonical config; the counted run of
    the training path."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli import test_diffusion, train_diffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    make_train_tree(workdir, seed)
    out = os.path.join(workdir, "train")
    argv = [
        "--use_tb_logger", "--save_epoch_freq", "1", "--generation_result", "noise",
        "--name", "train_diffusion", "--net_name", "NoiseDiffNet", "--beta_schedule", "sigmoid2",
        "--positional_encoding", "--trainset", "SonyTrainDataset", "--dim", str(DIM),
        "--crop_size", str(CROP), "--with_camera_settings", "--batch_size", str(BATCH),
        "--max_iter", "1", "--random_seed", str(seed), "--device", "cuda",
        "--num_workers", "4", "--log_freq", "5",
        "--sid_folder", os.path.join(workdir, "SID"), "--save_folder", out,
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    summary = train_diffusion.main(argv)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    steps = summary["steps"]
    if steps != TRAIN_STEPS:
        raise AssertionError(f"expected {TRAIN_STEPS} steps: {summary['steps']}")
    if not all(np.isfinite(summary["losses"])):
        raise AssertionError(f"non-finite losses: {summary['losses']}")
    per_step = {"fused_attn_tail": 9, "fused_attn_tail_bwd": 9, "gn_stats": 44,
                "gn_grad_stats": 44, "fused_dual_head": 1, "fused_groupnorm_film_silu": 0}
    for name, want in per_step.items():
        if counts[name] != want * steps:
            raise AssertionError(f"{name}: {counts[name]} launches in {steps} training steps, "
                                 f"expected {want} per step")
    snap = os.path.join(out, "train_diffusion", "snapshot")
    for comp in ("net", "ema"):
        sd = torch.load(os.path.join(snap, f"{comp}_final.pth"), map_location="cpu",
                        weights_only=True)
        NoiseDiffNet(dim=DIM).load_state_dict(sd, strict=True)
    # the rate over the window after the first 3 steps, on the device's
    # clock from the end of step 3 to the end of the last: every loader wait
    # and upload in between shows as a later end
    ends, secs = summary["step_end_seconds"], summary["step_seconds"]
    period = (ends[-1] - ends[2]) / (steps - 3)
    rate = 1.0 / period
    epoch_s, waited = summary["epoch_seconds"][0], summary["loader_wait_seconds"][0]
    q = np.percentile(secs[3:], [0, 25, 50, 75, 100])
    log(f"  {steps} steps, losses {summary['losses'][0]:.5f} -> {summary['losses'][-1]:.5f}; "
        f"after the first 3 steps {rate:.4f} steps/s, {BATCH * rate:.4f} samples/s "
        f"({period * 1e3:.4f} ms per step)")
    log(f"  whole epoch, loader start-up and first steps included: {epoch_s:.4f} s wall, "
        f"{steps / epoch_s:.4f} steps/s; host time waiting for the loader {waited:.4f} s")
    log(f"  step seconds (start, upload included, to end) after the first 3: median "
        f"{q[2]:.5f}, quartiles {q[1]:.5f} / {q[3]:.5f}, min {q[0]:.5f}, max {q[4]:.5f}; "
        f"first 3 {[round(v, 4) for v in secs[:3]]}")
    log(f"  peak device memory {peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated)")
    log(f"  launches on the training path: {counts}")

    # generation from the trained net through the generation CLI
    gen = os.path.join(workdir, "gen")
    make_sid_tree(gen, seed)
    gen_argv = [
        "--name", "from_net_final", "--resume", os.path.join(snap, "net_final.pth"),
        "--generation_result", "noise", "--testset", "NoiseImageGenerationDataset",
        "--save_npy", "--random_seed", str(seed), "--beta_schedule", "sigmoid2",
        "--batch_size", str(BATCH), "--net_name", "NoiseDiffNet", "--positional_encoding",
        "--dim", str(DIM), "--crop_size", str(CROP), "--with_camera_settings",
        "--sampler", "dpm", "--device", "cuda", "--num_workers", "2", "--iso", "800",
        "--ratio", "250", "--sid_folder", os.path.join(gen, "SID"), "--pretrained_dir", gen,
        "--save_folder", os.path.join(gen, "out"),
    ]
    g = test_diffusion.main(gen_argv)
    files = glob.glob(os.path.join(g["out_dir"], "*.npy"))
    if g["generated"] != len(files) or not files or not all(
            np.isfinite(np.load(f)).all() for f in files):
        raise AssertionError(f"generation from net_final.pth: {g}")
    log(f"  generated {len(files)} patches from net_final.pth through the generation CLI")
    return dict(counts=counts, steps=steps, steps_per_s=rate, samples_per_s=BATCH * rate,
                period_ms=period * 1e3, epoch_seconds=epoch_s, loader_wait_seconds=waited,
                step_seconds=secs, peak_bytes=peak)


def phase_train_profile(seed: int, cli_period_ms: float):
    """Where a training step's time goes, at the canonical shape. The step
    period, host wall over PROFILE_STEPS steps up to a final sync, in three
    ways, each read twice (A B C C B A): A the batch already on the card
    and no host sync between steps (host launches are all that can hold
    the card back); B the same with a sync after each step; C the batch
    uploaded from host memory before each step, as the trainer does. Then
    the device busy time by kernel class from torch.profiler. The idle
    share of each is 1 - busy / period; the CLI run's (cli_period_ms) adds
    the loader threads."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.train.state import make_diffusion_train_step, make_optimizer
    from noisediff_tpu_torch.train.trainer_diffusion import upload_batch

    torch.manual_seed(seed)
    dev = torch.device("cuda")
    model = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last)
    model.train()
    gd = GaussianDiffusion(model, make_schedule("sigmoid2", 1000), image_size=CROP, device=dev)
    step = make_diffusion_train_step(gd, make_optimizer(model.parameters()))
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = _canonical_batch(g, dev)
    host_batch = {k: v.cpu().numpy() for k, v in batch.items()}
    for _ in range(3):
        step(batch, g)

    def window(sync: bool, upload: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            out = step(upload_batch(host_batch, tuple(batch), dev) if upload else batch, g)
            if sync:
                float(out["diffusion_loss"])
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS

    modes = {"A on card, no sync": (False, False), "B on card, sync each step": (True, False),
             "C uploaded each step, no sync": (False, True)}
    order = list(modes) + list(reversed(modes))
    reads = {m: [] for m in modes}
    for m in order:
        reads[m].append(window(*modes[m]))
    periods = {m: float(np.mean(v)) for m, v in reads.items()}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step(batch, g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    by_name = _device_ms_by_name(prof, PROFILE_STEPS)
    busy = sum(by_name.values())
    log(f"  one training step ({BATCH}x{CROP}^2, dim {DIM}, bf16), ms per step over "
        f"{PROFILE_STEPS} steps, two readings each:")
    for m, v in reads.items():
        log(f"    {m}: {v[0]:.4f}, {v[1]:.4f}")
    log(f"    the CLI run (loader threads added): {cli_period_ms:.4f}")
    if not by_name:
        log("  torch.profiler recorded no device time")
        return dict(periods=periods, wall_ms=wall_ms)
    log(f"  device busy {busy:.4f} ms per step (torch.profiler; profiled wall {wall_ms:.4f} ms)")
    log("  device idle share: " + ", ".join(
        f"{m[0]} {max(0.0, 1 - busy / p):.4f}" for m, p in periods.items())
        + f", CLI {max(0.0, 1 - busy / cli_period_ms):.4f}")
    cats = {}
    for name, ms in by_name.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {cat}")
    log("  top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {ms:9.4f} ms  {name[:110]}")
    return dict(periods=periods, wall_ms=wall_ms, busy_ms=busy, categories=cats)


def make_sid_tree(root: str, seed: int) -> None:
    """A miniature SID tree: clean Bayer frames of 1280^2 (packed 640^2,
    whose patch grid has 4 distinct 512^2 origins) for N_BATCHES batches,
    and one ISO800 x250 training pair."""
    import numpy as np

    rng = np.random.default_rng(seed)
    long_dir = os.path.join(root, "SID", "Sony", "long")
    os.makedirs(long_dir)
    for i in range(N_BATCHES * BATCH // 4):
        arr = rng.integers(512, 4096, size=(2 * FRAME, 2 * FRAME)).astype(np.uint16)
        np.save(os.path.join(long_dir, f"{i + 1:05d}_00_10s.ARW.npy"), arr)
    with open(os.path.join(root, "SID", "Sony_train_list.txt"), "w") as f:
        f.write("./Sony/short/00001_00_0.04s.ARW ./Sony/long/00001_00_10s.ARW ISO800 F1.8\n")


def phase_main(seed: int, workdir: str):
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli import test_diffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    make_sid_tree(workdir, seed)
    torch.manual_seed(seed)
    ckpt = os.path.join(workdir, "net_seeded.pth")
    sd = NoiseDiffNet(dim=DIM).state_dict()
    torch.save({"module." + k: v for k, v in sd.items()}, ckpt)  # DDP-style keys
    argv = [
        "--name", "ISO800_Ratio250", "--resume", ckpt, "--generation_result", "noise",
        "--testset", "NoiseImageGenerationDataset", "--save_npy", "--random_seed", str(seed),
        "--beta_schedule", "sigmoid2", "--batch_size", str(BATCH), "--net_name", "NoiseDiffNet",
        "--positional_encoding", "--dim", str(DIM), "--crop_size", str(CROP),
        "--with_camera_settings", "--sampler", "dpm", "--dpm_spacing", "lambda",
        "--device", "cuda", "--num_workers", "2", "--iso", "800", "--ratio", "250",
        "--sid_folder", os.path.join(workdir, "SID"), "--pretrained_dir", workdir,
        "--save_folder", os.path.join(workdir, "out"),
    ]
    reset_launch_counts()
    summary = test_diffusion.main(argv)
    counts = launch_counts()

    n = summary["generated"]
    if n != N_BATCHES * BATCH or summary["batches"] != N_BATCHES:
        raise AssertionError(f"expected {N_BATCHES} batches of {BATCH} patches: {summary}")
    per_batch = {"fused_attn_tail": 9 * DPM_STEPS, "fused_groupnorm_film_silu": 42 * DPM_STEPS,
                 "fused_dual_head": DPM_STEPS, "fused_attn_tail_bwd": 0, "gn_stats": 0,
                 "gn_grad_stats": 0}
    for name, want in per_batch.items():
        if counts[name] != want * N_BATCHES:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want} per batch "
                                 f"x {N_BATCHES} batches")
    files = sorted(glob.glob(os.path.join(summary["out_dir"], "*.npy")))
    if len(files) != n or glob.glob(os.path.join(summary["out_dir"], "*.tmp.npy")):
        raise AssertionError(f"{len(files)} npy files for {n} patches, or temp files left")
    for path in files:
        base = os.path.basename(path)[:-4]
        clean, noisy, coord = base.split("+")
        if clean != noisy or not clean.endswith("_00_10s") or coord not in GRID_NAMES:
            raise AssertionError(f"unexpected output name {base}")
        arr = np.load(path)
        if arr.shape != (4, CROP, CROP) or arr.dtype != np.float32 or not np.isfinite(arr).all():
            raise AssertionError(f"{base}: {arr.shape} {arr.dtype} or not finite")
    secs = summary["batch_seconds"]
    rate = n / sum(secs)
    steady = BATCH * (len(secs) - 1) / sum(secs[1:])
    log(f"  generated {n} patches of {CROP}^2 in {sum(secs):.3f} s of sampling: "
        f"{rate:.4f} patches/s ({steady:.4f} after the first batch); batch seconds "
        f"{[round(s, 4) for s in secs]}")
    log(f"  launches on the main path: {counts}")

    # resume: a deleted patch comes back identical, nothing else is resampled
    victim = files[0]
    before = np.load(victim)
    os.remove(victim)
    again = test_diffusion.main(argv + ["--skip_existing"])
    if again["batches"] != 1 or not np.array_equal(np.load(victim), before):
        raise AssertionError(f"--skip_existing did not regenerate {victim} identically: {again}")
    log("  --skip_existing regenerated the deleted patch bit-identically")
    return dict(counts=counts, patches=n, patches_per_s=rate, steady_patches_per_s=steady,
                batch_seconds=secs)


# ---------------------------------------------------------------------------
KERNEL_META = {  # name: (wrapper, source, TPU kernel it replaces, path of its timed calls)
    "attn_tail": ("fused_attn_tail", "noisediff_tpu_torch/csrc/attn_tail.cu",
                  "noisediff_tpu/ops/pallas/attn_tail.py:190", "generation"),
    "groupnorm_silu": ("fused_groupnorm_film_silu",
                       "noisediff_tpu_torch/csrc/groupnorm_silu.cu",
                       "noisediff_tpu/ops/pallas/groupnorm_silu.py:105", "generation"),
    "dual_head": ("fused_dual_head", "noisediff_tpu_torch/csrc/dual_head.cu",
                  "noisediff_tpu/ops/pallas/dual_head.py:77", "generation"),
    "attn_tail_bwd": ("fused_attn_tail_bwd", "noisediff_tpu_torch/csrc/attn_tail.cu",
                      "noisediff_tpu/ops/pallas/attn_tail.py:307", "training"),
    "gn_stats": ("gn_stats", "noisediff_tpu_torch/csrc/gn_stats.cu",
                 "noisediff_tpu/ops/pallas/gn_stats.py:64", "training"),
    "gn_grad_stats": ("gn_grad_stats", "noisediff_tpu_torch/csrc/gn_stats.cu",
                      "noisediff_tpu/ops/pallas/gn_stats.py:246", "training"),
}


def kernels_line(results, gen_counts, train_counts, train_steps):
    """One entry per kernel. ms, plain_ms and bound_ms are summed over the
    calls of one model evaluation at the canonical generation config (the
    generation kernels) or of one training step at the canonical training
    config (the training kernels): each shape's median time times its calls
    (`ms_per`); per_shape has each shape's numbers. `launches` is the
    wrapper's count over the two main-path runs, each counted from zero:
    the main phase's N_BATCHES generated batches and the train phase's
    training steps; launches_per_batch and launches_per_step divide them."""
    out = []
    for name, rows in results.items():
        wrapper, source, replaces, path = KERNEL_META[name]
        tot = {k: sum(r[k] * r["calls"] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
        # the bound of the shapes that carry most of the bound time
        by_bytes = sum(r["bound_ms"] * r["calls"] for r in rows if r["bound_by"] == "bytes")
        gen, train = gen_counts[wrapper], train_counts[wrapper]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": gen + train,
            "launches_generation": gen, "launches_per_batch": gen / N_BATCHES,
            "launches_training": train, "launches_per_step": train / train_steps,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
            "library_ms": None,
            "ms_per": "evaluation" if path == "generation" else "training step",
            "per_shape": rows,
        })
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from noisediff_tpu_torch.cli.common import set_precision_flags
        from noisediff_tpu_torch.ops.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable from here ({exc}); run it from the "
              "root of a checkout", file=sys.stderr)
        return 2

    t_start = time.time()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    set_precision_flags()
    log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.time()
    build_logs = _build.build_all()
    log(f"[build] {len(build_logs)} kernel libraries built in {time.time() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    log("[kernels] kernel vs plain version on the card")
    results = phase_kernels(args.seed)
    log("[model] full-width forward, card vs CPU")
    phase_model(args.seed)
    log("[profile] where one model evaluation spends its time")
    phase_profile(args.seed)
    log("[main] bulk generation through the CLI")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        gen_counts = phase_main(args.seed, workdir)["counts"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("[train_check] full-width training step, card vs CPU")
    phase_train_check(args.seed)
    log("[train] training through the CLI at the canonical config")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        train = phase_train(args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("[train profile] where a training step spends its time")
    phase_train_profile(args.seed, train["period_ms"])
    log(f"[done] {time.time() - t_start:.1f} s")

    print(json.dumps(kernels_line(results, gen_counts, train["counts"], train["steps"])))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
