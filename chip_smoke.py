#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (noisediff_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Every phase runs, in this order (any failure exits non-zero):
  env      the card's name and power limit, torch / CUDA versions, TF32 flags
  build    nvcc builds every kernel of the port from noisediff_tpu_torch/csrc/
           (one compiler process per source, all at once); ptxas's registers
           and spills, and the flash kernel's main-loop SASS per score element
  kernels  each kernel against its plain PyTorch version on the card, at
           every shape the generation, training, DDIM, wgrad and attention
           paths give it; CUDA-event timings of both beside the card's bound
           for the same work, and of one PyTorch call that computes the same
           function where there is one (cuDNN's wgrad, SDPA): per call, and
           for those two kernels, their library calls and the attn_tail
           forward and backward on the card's clock too (back-to-back calls
           queued behind a sleep); the attn_tail forward's plan against its
           kernels (shared memory, occupancy), its routes at 256^2 x 96
           and 128^2 x 192 beside the tiled one, the wrapper's host time per
           call and the dim-96 model's widths; the attn_tail forward and backward also at
           ragged pixel counts (RAGGED_SHAPES); both bit-equal across two
           calls; gn_stats and gn_grad_stats one kernel a call, read from a
           torch.profiler profile of each shape
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
           kernels' launches per step, the snapshots, --use_tb_logger's
           scalars.jsonl, and generates from
           net_final.pth through the generation CLI; reports steps/s and
           samples/s over the window after the first 3 steps on the card's
           clock (loader waits and uploads included), the epoch's wall
           time and loader waits, the step-time spread and peak memory
  train profile  the training step's period three ways (batch on the card
           with no host sync; the same with a sync after each step; batch
           uploaded before each step) and the device busy time by kernel
           class (torch.profiler); the idle share of each and of the CLI
           run's step; then the conv_wgrad route's device time per step and
           whether the gradient reaching its convs is channels-last
  ddim     DDIM-100 generation through the CLI at the canonical config
           (--sampler ddim --sampling_timesteps 100), 2 batches, through the
           fused DDIM tail (the ddim_head kernel): the npy contract, 100
           ddim_head and no dual_head launches per batch, patches/s after
           the first batch; then a DDIM-4 fused sample of the full-width
           model against the unfused sampler from the same noise
  train_wgrad  the conv_wgrad route (NOISEDIFF_WGRAD=pallas): the dim-48
           training step's gradients against the CPU's and against the
           card's cuDNN-wgrad step; training through the CLI over the same
           miniature tree: steps/s beside the default run's and the
           conv_wgrad launches per step
  fp32     --no_mixed_precision (fp32 compute, the plain route of every
           block) through both CLIs: 2 DPM-10 batches after ddim, 2 training
           steps (crop 128, batch 50) after train_wgrad on the default wgrad
           route and 2 under NOISEDIFF_WGRAD=pallas; no kernel launches,
           finite outputs and losses
  attention  blocks.Attention forward and backward at B 4, C 384, 64^2
           tokens (the flash_attention kernel) against the CPU in fp32
  dim96    a dim-96 NoiseDiffNet forward on its route (the heads on their
           plain version, the other kernels at 96..768 channels) at B 1,
           64^2, against the CPU
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
DDIM_STEPS = 100
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
# the DDIM tail: the head within dual_head's bound; the fp32 update's
# coefficients (sqrt(a), c / sqrt(1 / a - 1), ...) scale it by at most ~2
TOLS["ddim_head"] = (2e-2, 2e-2)
# flash attention, bf16 out, held to the rounding bound of its two bf16
# roundings: each version rounds the probabilities to bf16 for p v (the
# kernel unnormalised, the plain version normalised; error <= u P|v|) and
# its output once (<= u |o| <= u P|v|), u = 2^-9. So |k - p| <= 4u P|v|
# = 2^-7 P|v| elementwise, P the softmax in fp32 (`flash_scale`); the rel
# L2 of the whole output within FLASH_REL as well, which a dropped key
# tile or an unmasked ragged tail (a ~1% shift of every row) exceeds
TOLS["flash_attention"] = (2.0 ** -7, 0.0)
FLASH_REL = 2.0 ** -7
# DDIM-4 fused (fp32 head output into the update) against unfused (the
# model's bf16 output), relative L2 of the samples: bf16 rounding of v at
# each step, carried through the next steps' bf16 model
DDIM_REL = 5e-2
# Attention on the card (bf16, the flash kernel) against the CPU in fp32,
# relative L2 of the output and of every gradient
ATTN_REL = 3e-2
ATTN_SHAPE = (4, 384, 64, 64)  # B, C, H, W: 4096 tokens, 4 heads of 32


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


def time_device_ms(fn, n: int = 20, reps: int = 3) -> float:
    """Per-call time on the card's clock: n back-to-back calls between one
    pair of CUDA events, queued behind a sleep kernel so that the wrappers'
    host work (library lookup, allocations, the ctypes call) overlaps the
    card's work instead of falling between the events; the median of reps
    windows, divided by n."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at the card's clock: the host queues the calls
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
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


def flash_scale(q, k, v):
    """P|v| in fp32, P = softmax(q k^T / sqrt(D)): the scale of the flash
    kernel's rounding bound (TOLS["flash_attention"])."""
    import torch

    p = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)
    return p @ v.float().abs()


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


# SASS opcode classes counted in the flash kernel's main loop
SASS_CLASSES = (("MUFU", "exponential (MUFU)"), ("HMMA", "tensor product (HMMA)"),
                ("LDSM", "ldmatrix (LDSM)"), ("F2FP", "bf16x2 pack / round (F2FP)"),
                ("HMNMX2", "bf16x2 max (HMNMX2)"), ("FFMA", "FFMA"), ("FADD", "FADD"),
                ("FMUL", "FMUL"), ("FMNMX", "FMNMX"))


def flash_sass_counts(lib_path: str, nvcc: str):
    """The flash kernel at D = 32 in SASS (cuobjdump): the instructions of its
    main loop (the backward branch's span), by class, per score element. A
    tile body is 64 elements per lane (32 rows x 64 keys / 32 lanes) and
    runs 64 + 4 exponentials (the elements and the 4 rows' rescale factors),
    so the loop holds round(MUFU.EX2 / 68) bodies."""
    import re

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    sections = re.split(r"\n\s*Function : ", text)
    body = next(sec for sec in sections if "flash_attention_fwdILi32E" in sec.split("\n", 1)[0])
    inst = []  # (address, opcode, text)
    for line in body.splitlines():
        mt = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if mt:
            text_i = mt.group(2).strip()
            op = re.sub(r"^@!?U?P\w+\s+", "", text_i).split()[0]
            inst.append((int(mt.group(1), 16), op, text_i))
    loops = []
    for addr, op, text_i in inst:
        tgt = re.findall(r"0x[0-9a-f]+", text_i) if op.startswith("BRA") else None
        if tgt and int(tgt[-1], 16) < addr:
            loops.append([i for i in inst if int(tgt[-1], 16) <= i[0] <= addr])
    span = max(loops, key=lambda sp: sum(1 for i in sp if i[1].startswith("MUFU.EX2")))
    exps = sum(1 for i in span if i[1].startswith("MUFU.EX2"))
    bodies = max(1, round(exps / 68))
    elements = 64 * bodies
    counts = {label: sum(1 for i in span if i[1].split(".")[0] == cls) / elements
              for cls, label in SASS_CLASSES}
    counts["all"] = len(span) / elements
    counts["not MUFU, HMMA or LDSM"] = (len(span) - sum(
        1 for i in span if i[1].split(".")[0] in ("MUFU", "HMMA", "LDSM"))) / elements
    return counts


# ---------------------------------------------------------------------------
def phase_kernels(seed: int):
    """Kernel vs plain version and timings at every generation-path shape."""
    import torch

    from noisediff_tpu_torch.ops.kernels import fused_dual_head, reference_dual_head

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    results = {}

    results["attn_tail"] = kernels_attn_tail(randn)

    results["groupnorm_silu"] = kernels_groupnorm_silu(randn)

    # dual_head at full resolution
    c = DIM
    x, sa, sb = (randn(BATCH, CROP, CROP, c, dtype=torch.bfloat16) for _ in range(3))
    p = (randn(c, c, scale=c ** -0.5), 0.1 * randn(c), randn(4, c, scale=c ** -0.5),
         0.1 * randn(4), randn(4, c, scale=c ** -0.5), 0.1 * randn(4))
    args = (x, sa, sb) + p
    got = fused_dual_head(*args)
    err = compare("dual_head", got, reference_dual_head(*args))
    if not torch.equal(got, fused_dual_head(*args)):
        raise AssertionError("dual_head: two calls differ")
    ms = time_ms(lambda: fused_dual_head(*args))
    dev_ms = time_device_ms(lambda: fused_dual_head(*args))
    host_ms = host_ms_per_call(lambda: fused_dual_head(*args))
    plain = time_ms(lambda: reference_dual_head(*args), reps=5)
    pix = BATCH * CROP * CROP
    moved = 3 * nbytes(x) + pix * 4 * 4 + (c * c + 8 * c + c + 8) * 4
    b_ms, b_by = bound(moved, 2 * pix * (c * c + 8 * c), PEAK_BF16_FLOPS)
    results["dual_head"] = [dict(shape=[BATCH, CROP, CROP, c], calls=1, ms=ms, device_ms=dev_ms,
                                 host_ms=host_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                 max_abs_err=err)]
    log(f"  dual_head {CROP}^2 x {c}: {ms:.4f} ms, dev {dev_ms:.4f} ({dev_ms / b_ms:.2f}x the "
        f"bound {b_ms:.4f} {b_by}; host {host_ms:.4f} per call; plain {plain:.4f}), max abs err "
        f"{err:.3g}, bit-equal across two calls")
    del x, sa, sb, args, got
    torch.cuda.empty_cache()
    results.update(kernels_training(randn))
    torch.cuda.empty_cache()
    fwd, bwd = kernels_ragged(randn)
    results["attn_tail"] += fwd
    results["attn_tail_bwd"] += bwd
    torch.cuda.empty_cache()
    results.update(kernels_ddim(randn))
    results.update(kernels_wgrad(randn, seed))
    results.update(kernels_attention(randn))
    torch.cuda.empty_cache()
    return results


# groupnorm_silu shapes no main path gives: the full frame's /8 stage (B 1,
# a sample over the blocks' shared memory: rows read twice), crop 504's /4
# stage, and the narrowest width the kernel takes
GN_RAGGED = [(1, 178 * 266, 384, 8), (4, 126 * 126, 96, 8), (2, 16 * 16, 8, 2)]


def kernels_groupnorm_silu(randn):
    """groupnorm_silu with the folded conv bias at every (stage, groups,
    FiLM) the evaluation uses, then at GN_RAGGED (calls 0): against the
    plain version, one launch per call, two calls bit-equal, per call and
    on the card's clock beside the bound (x read once, y written once), and
    the wrapper's host time per call. The FiLM is bf16, the halves of one
    (B, 2C) tensor, as the time-MLP gives it."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        fused_groupnorm_film_silu, reference_groupnorm_film_silu)
    from noisediff_tpu_torch.ops.kernels import groupnorm_silu as gs

    shapes = [(BATCH, STAGES[st][0] ** 2, STAGES[st][1], groups, film, count)
              for st, groups, film, count in GN_PER_EVAL]
    shapes += [(b, n, c, groups, True, 0) for b, n, c, groups in GN_RAGGED]
    rows = []
    for b, n, c, groups, film, count in shapes:
        x = randn(b, n, c, scale=1.5, dtype=torch.bfloat16) + 0.3
        gamma, beta, bias = 1.0 + 0.1 * randn(c), 0.1 * randn(c), 0.3 * randn(c)
        fs = fsh = None
        if film:
            t = (0.2 * randn(b, 2 * c)).to(torch.bfloat16)
            fs, fsh = t[:, :c], t[:, c:]
        args = (x, gamma, beta, fs, fsh, groups, 1e-5, bias)
        n0 = fused_groupnorm_film_silu.launches
        got = fused_groupnorm_film_silu(*args)
        if fused_groupnorm_film_silu.launches != n0 + 1:
            raise AssertionError(f"groupnorm_silu {b}x{n}x{c}: "
                                 f"{fused_groupnorm_film_silu.launches - n0} launches in a call")
        err = compare("groupnorm_silu", got, reference_groupnorm_film_silu(*args))
        if not torch.equal(got, fused_groupnorm_film_silu(*args)):
            raise AssertionError(f"groupnorm_silu {b}x{n}x{c}: two calls differ")
        ms = time_ms(lambda: fused_groupnorm_film_silu(*args))
        dev_ms = time_device_ms(lambda: fused_groupnorm_film_silu(*args))
        host_ms = host_ms_per_call(lambda: fused_groupnorm_film_silu(*args))
        plain = time_ms(lambda: reference_groupnorm_film_silu(*args), reps=5)
        moved = 2 * nbytes(x) + 3 * c * 4 + (2 * b * c * 2 if film else 0)
        b_ms, b_by = bound(moved, 8 * x.numel(), PEAK_FP32_FLOPS)
        plan = gs.plan(b, n, c, *gs._kernel(x.device)[2:])
        rows.append(dict(shape=[b, n, c], groups=groups, film=film, bias=True, calls=count,
                         rounds=plan["rounds"], reread=plan["reread"], ms=ms, device_ms=dev_ms,
                         host_ms=host_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err))
        log(f"  groupnorm_silu {b}x{n}x{c} G{groups} film={film} bias: {ms:.4f} ms, dev "
            f"{dev_ms:.4f} ({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; host {host_ms:.4f} "
            f"per call; plain {plain:.4f}; {plan['rounds']} round(s)"
            f"{', rows read twice' if plan['reread'] else ''}), max abs err {err:.3g}, one "
            "launch, bit-equal across two calls")
        del x, args, got
    return rows


def kernels_attn_tail(randn):
    """The attn_tail forward at the four stages on its route (`fwd_plan`):
    against the plain version, two calls bit-equal, per call and on the
    card's clock beside the bound; the fused kernel's shared memory and
    occupancy against the plan; at 256^2 x 96 and 128^2 x 192 the fused
    and streamed routes beside the tiled one they were measured against;
    the wrapper's host time per call; then the dim-96 model's widths (B 1,
    crop 512) on their routes."""
    import torch

    from noisediff_tpu_torch.ops.kernels import _build, fused_attn_tail, reference_attn_tail
    from noisediff_tpu_torch.ops.kernels import attn_tail as at

    lib = _build.library("attn_tail", at._SIGNATURES)
    widths = at.FWD_FUSED_WIDTHS + at.FWD_STREAMED_WIDTHS
    occ = {c: lib.nd_attn_tail_occupancy(c) for c in widths}
    for c in widths:
        if lib.nd_attn_tail_smem(c) != at.fwd_smem_bytes(c):
            raise AssertionError(f"attn_tail C={c}: the kernel takes {lib.nd_attn_tail_smem(c)} "
                                 f"bytes of shared memory, the plan counts {at.fwd_smem_bytes(c)}")
        if occ[c] < 1:
            raise AssertionError(f"attn_tail C={c}: the fused kernel does not fit an SM")
    log(f"  attn_tail fused and streamed routes: shared memory "
        f"{ {c: at.fwd_smem_bytes(c) for c in widths} } bytes (kernel = plan), "
        f"{occ} blocks per SM")
    rows = []
    for st, (res, c) in enumerate(STAGES):
        x = randn(BATCH, res, res, c, dtype=torch.bfloat16)
        args = attn_tail_args(randn, x)
        plan = at.fwd_plan(BATCH, res * res, c, _build.sm_count(x.device), occ.get(c, 1))
        got = fused_attn_tail(*args)
        err = compare("attn_tail", got, reference_attn_tail(*args))
        if not torch.equal(got, fused_attn_tail(*args)):
            raise AssertionError(f"attn_tail {res}^2 x {c}: two calls differ")
        ms = time_ms(lambda: fused_attn_tail(*args))
        dev_ms = time_device_ms(lambda: fused_attn_tail(*args))
        host_ms = host_ms_per_call(lambda: fused_attn_tail(*args))
        plain = time_ms(lambda: reference_attn_tail(*args), reps=5)
        b_ms, b_by = attn_tail_bound(x)
        row = dict(shape=[BATCH, res, res, c], calls=ATTN_PER_EVAL[st], route=plan["route"],
                   launches_per_call=plan["launches"], ms=ms, device_ms=dev_ms, host_ms=host_ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        other = ""
        if plan["route"] != "tiled" and c > 48:  # where the fused route was extended
            alt = lambda: at._launch(*args, 1e-5, route="tiled")  # noqa: E731
            compare("attn_tail", alt(), reference_attn_tail(*args))
            row["tiled_device_ms"] = time_device_ms(alt)
            other = f", tiled route {row['tiled_device_ms']:.4f} on the card's clock"
        rows.append(row)
        log(f"  attn_tail {res}^2 x {c} ({plan['route']}): {ms:.4f} ms, dev {dev_ms:.4f} "
            f"({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; host {host_ms:.4f} per call; "
            f"plain {plain:.4f}){other}, max abs err {err:.3g}, bit-equal across two calls")
        del x, args, got
    for res, c in [(CROP >> i, 96 << i) for i in range(4)]:
        x = randn(1, res, res, c, dtype=torch.bfloat16)
        args = attn_tail_args(randn, x)
        err = compare("attn_tail", fused_attn_tail(*args), reference_attn_tail(*args))
        log(f"  attn_tail dim-96 width 1x{res}^2 x {c} ({at.fwd_route(c)}): max abs err {err:.3g}")
        del x, args
    return rows


def host_ms_per_call(fn, n: int = 50) -> float:
    """The host's time per call with the card kept busy (the calls queued
    behind a sleep, so none waits for the card): what the wrapper costs the
    host, not the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~100 ms at the card's clock
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return host


def profile_calls(fn, n: int = 5):
    """The device work of calls of fn, from torch.profiler: n calls, each
    after a short sleep kernel (`spin_kernel`, a divider in the device
    trace) and followed by a sync. The launches per call are the profile's
    device events other than the dividers over n, rounded up: a record the
    profiler drops or files out of place cannot hide a second launch (a
    profile with fewer events than calls is taken again, up to three
    times). `kernel_us` is each kernel's device time per call, over the
    whole profile. What the dividers show is extra and fails nothing: for
    the call of median span among those with that many events, each event's
    name and device time and the gaps between them, in us (None where no
    call came through whole)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                torch.cuda._sleep(1000)
                fn()
                torch.cuda.synchronize()
            torch.cuda._sleep(1000)
        evs = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        work = [e for e in evs if "spin_kernel" not in e.name]
        if len(work) >= n:
            break
    launches = -(-len(work) // n)
    kernel_us = {}
    for e in work:
        us = (e.time_range.end - e.time_range.start) / n
        kernel_us[e.name] = kernel_us.get(e.name, 0.0) + us
    calls, cur = [], None
    for e in evs:
        if "spin_kernel" in e.name:
            if cur is not None:
                calls.append(cur)
            cur = []
        elif cur is not None:
            cur.append(e)
    full = [c for c in calls if c and len(c) == launches]
    out = dict(launches=launches, kernel_us=kernel_us, span_us=None, kernels=None, gaps_us=None)
    if full:
        spans = [c[-1].time_range.end - c[0].time_range.start for c in full]
        mid = sorted(range(len(full)), key=spans.__getitem__)[len(full) // 2]
        call = full[mid]
        out.update(span_us=spans[mid],
                   kernels=[(e.name, e.time_range.end - e.time_range.start) for e in call],
                   gaps_us=[b.time_range.start - a.time_range.end for a, b in zip(call, call[1:])])
    return out


def kernels_ddim(randn):
    """The DDIM tail at the canonical shape: a middle step of DDIM-100 with
    no noise (eta 0, the main path) and one with noise; no PyTorch call
    computes the head and the update together, so library_ms is null."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        ddim_step_scalars, fused_ddim_head_update, reference_ddim_head_update)
    from noisediff_tpu_torch.ops.schedules import make_schedule

    c = DIM
    x, sa, sb = (randn(BATCH, CROP, CROP, c, dtype=torch.bfloat16) for _ in range(3))
    p = (randn(c, c, scale=c ** -0.5), 0.1 * randn(c), randn(4, c, scale=c ** -0.5),
         0.1 * randn(4), randn(4, c, scale=c ** -0.5), 0.1 * randn(4))
    xt, z = randn(BATCH, CROP, CROP, 4), randn(BATCH, CROP, CROP, 4)
    ac = make_schedule("sigmoid2", 1000).alphas_cumprod
    alpha, alpha_next = ac[499], ac[489]
    rows = []
    for sigma in (0.0, 0.1):
        noise = z if sigma else None
        scal = ddim_step_scalars(alpha, alpha_next, sigma,
                                 (1.0 - alpha_next - sigma ** 2) ** 0.5)
        args = (x, sa, sb, xt, noise) + p + (scal,)
        got = fused_ddim_head_update(*args)
        err = compare("ddim_head", got, reference_ddim_head_update(*args))
        if not torch.equal(got, fused_ddim_head_update(*args)):
            raise AssertionError(f"ddim_head sigma {sigma}: two calls differ")
        ms = time_ms(lambda: fused_ddim_head_update(*args))
        dev_ms = time_device_ms(lambda: fused_ddim_head_update(*args))
        host_ms = host_ms_per_call(lambda: fused_ddim_head_update(*args))
        plain = time_ms(lambda: reference_ddim_head_update(*args), reps=5)
        pix = BATCH * CROP * CROP
        moved = 3 * nbytes(x) + 2 * nbytes(xt) + (nbytes(z) if sigma else 0) \
            + (c * c + 8 * c + c + 8) * 4
        b_ms, b_by = bound(moved, 2 * pix * (c * c + 8 * c), PEAK_BF16_FLOPS)
        # the main path (eta 0) runs one call per evaluation; the noisy
        # variant is checked and timed, not counted
        rows.append(dict(shape=[BATCH, CROP, CROP, c], sigma=sigma, calls=0 if sigma else 1,
                         ms=ms, device_ms=dev_ms, host_ms=host_ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=err))
        log(f"  ddim_head {CROP}^2 x {c} sigma {sigma}: {ms:.4f} ms, dev {dev_ms:.4f} "
            f"({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; host {host_ms:.4f} per call; "
            f"plain {plain:.4f}), max abs err {err:.3g}, bit-equal across two calls")
    return {"ddim_head": rows}


def wgrad_conv_shapes(seed: int):
    """Every conv of a canonical training step (dim 48, B 4, 512^2) that
    takes the conv_wgrad route under NOISEDIFF_WGRAD=pallas, as
    {(H, W, Ci, Co, k): count}, read by hooks on one forward on the card."""
    import torch

    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.models.blocks import Conv2d

    torch.manual_seed(seed)
    dev = torch.device("cuda")
    model = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last)
    model.train()
    shapes = {}

    def hook(mod, args):
        if mod.wgrad_route(args[0]):
            key = (args[0].shape[2], args[0].shape[3], mod.in_channels, mod.out_channels,
                   mod.kernel_size[0])
            shapes[key] = shapes.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d)]
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = _canonical_batch(g, dev)
    cond = {"clean_img": batch["clean_img"], "position": batch["coord"],
            "iso_ratio_idx": batch["iso_ratio_idx"]}
    before = os.environ.get("NOISEDIFF_WGRAD")
    os.environ["NOISEDIFF_WGRAD"] = "pallas"
    try:  # with autograd on: the route is taken only where a backward can run
        model(batch["noise"], torch.full((BATCH,), 500, device=dev), cond)
    finally:
        if before is None:
            del os.environ["NOISEDIFF_WGRAD"]
        else:
            os.environ["NOISEDIFF_WGRAD"] = before
        for h in handles:
            h.remove()
    return shapes


def kernels_wgrad(randn, seed: int):
    """conv_wgrad at every conv shape of a training step, against the tap
    sum, and cuDNN's wgrad (aten.convolution_backward, weight only) as the
    library call."""
    import torch

    from noisediff_tpu_torch.ops.kernels import conv_wgrad, reference_conv_wgrad

    shapes = wgrad_conv_shapes(seed)
    log(f"  conv_wgrad: {sum(shapes.values())} routed convs per training step, "
        f"{len(shapes)} shapes")
    rows = []
    for (h, w, ci, co, k), count in sorted(shapes.items(), key=lambda kv: (-kv[0][0], kv[0])):
        x = randn(BATCH, h, w, ci, dtype=torch.bfloat16)
        g = randn(BATCH, h, w, co, scale=0.1, dtype=torch.bfloat16)
        got = conv_wgrad(g, x, k, k)
        err = compare_scaled("conv_wgrad", got, reference_conv_wgrad(g, x, k, k), SUM_RTOL)
        if not torch.equal(got, conv_wgrad(g, x, k, k)):
            raise AssertionError(f"conv_wgrad {h}^2 {ci}->{co} k{k}: two calls differ")
        wt = torch.zeros((co, ci, k, k), device=x.device, dtype=torch.bfloat16)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels-last views

        def library():
            return torch.ops.aten.convolution_backward(
                gn, xn, wt, None, [1, 1], [k // 2] * 2, [1, 1], False, [0, 0], 1,
                [False, True, False])

        ms = time_ms(lambda: conv_wgrad(g, x, k, k))
        lib_ms = time_ms(library)
        dev_ms = time_device_ms(lambda: conv_wgrad(g, x, k, k))
        lib_dev_ms = time_device_ms(library)
        plain = time_ms(lambda: reference_conv_wgrad(g, x, k, k), reps=3)
        b_ms, b_by = bound(nbytes(x) + nbytes(g) + got.numel() * 4,
                           2 * BATCH * h * w * k * k * ci * co, PEAK_BF16_FLOPS)
        rows.append(dict(shape=[BATCH, h, w, ci, co, k], calls=count, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                         library_device_ms=lib_dev_ms, max_abs_err=err))
        log(f"  conv_wgrad {h}^2 {ci}->{co} {k}x{k} (x{count}): {ms:.4f} ms per call, "
            f"{dev_ms:.4f} on the card's clock (cuDNN {lib_ms:.4f} / {lib_dev_ms:.4f}; plain "
            f"{plain:.4f}; bound {b_ms:.4f} {b_by}, {dev_ms / b_ms:.2f}x), max abs err {err:.3g}")
        del x, g, got
    tot = {key: sum(r[key] * r["calls"] for r in rows)
           for key in ("ms", "library_ms", "device_ms", "library_device_ms", "bound_ms")}
    met = "met" if tot["device_ms"] <= tot["library_device_ms"] else "missed"
    log(f"  conv_wgrad per wgrad-route step: {tot['ms']:.4f} ms per call summed, "
        f"{tot['device_ms']:.4f} on the card's clock; cuDNN {tot['library_ms']:.4f} / "
        f"{tot['library_device_ms']:.4f}; bound {tot['bound_ms']:.4f}; target (at or under "
        f"cuDNN on the card's clock) {met}")
    return {"conv_wgrad": rows}


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def kernels_attention(randn):
    """flash_attention at blocks.Attention's shape in the attention phase
    (B 4, 4 heads of 32, 64^2 tokens), against the plain version, with
    F.scaled_dot_product_attention as the library call. The bound counts
    the exponentials too, at 16 per SM per clock (the SFU rate) at the
    card's maximum SM clock."""
    import torch
    import torch.nn.functional as F

    from noisediff_tpu_torch.ops.kernels import _build, flash_attention, reference_flash_attention

    b, c, h, w = ATTN_SHAPE
    heads, d, n = 4, 32, h * w
    q, k, v = (randn(b, heads, n, d, dtype=torch.bfloat16) for _ in range(3))
    got, want = flash_attention(q, k, v), reference_flash_attention(q, k, v)
    err = compare("flash_attention", got, want, scale=flash_scale(q, k, v))
    rel = rel_l2(got, want)
    if rel > FLASH_REL:
        raise AssertionError(f"flash_attention: rel L2 {rel} over {FLASH_REL}")
    del got, want
    ms = time_ms(lambda: flash_attention(q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    dev_ms = time_device_ms(lambda: flash_attention(q, k, v))
    lib_dev_ms = time_device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    plain = time_ms(lambda: reference_flash_attention(q, k, v), reps=5)
    exps = b * heads * n * n
    exp_ms = exps / (16 * _build.sm_count(q.device) * max_sm_clock_hz()) * 1e3
    b_ms, b_by = bound(4 * nbytes(q), 4 * b * heads * n * n * d, PEAK_BF16_FLOPS)
    if exp_ms > b_ms:
        b_ms, b_by = exp_ms, "operations"
    log(f"  flash_attention {b}x{heads}x{n}x{d}: {ms:.4f} ms per call, {dev_ms:.4f} on the "
        f"card's clock (SDPA {lib_ms:.4f} / {lib_dev_ms:.4f}; plain {plain:.4f}; bound "
        f"{b_ms:.4f} {b_by}: exponentials {exp_ms:.4f}, {dev_ms / b_ms:.2f}x), max abs err "
        f"{err:.3g}, rel L2 {rel:.3g}; target (at or under SDPA on the card's clock) "
        f"{'met' if dev_ms <= lib_dev_ms else 'missed'}")
    return {"flash_attention": [dict(shape=[b, heads, n, d], calls=1, ms=ms, plain_ms=plain,
                                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                     device_ms=dev_ms, library_device_ms=lib_dev_ms,
                                     max_abs_err=err)]}


def attn_tail_args(randn, x, g=None):
    """The attn_tail operands beside x (B, H, W, C) bf16: tok, the LN
    affine, w1, b1, w2, b2, wp, bp, as the AttnBlock passes them; then g."""
    import torch

    c = x.shape[-1]
    tok = randn(x.shape[0], c, scale=0.3, dtype=torch.bfloat16)
    p = (1.0 + 0.1 * randn(c), 0.1 * randn(c), randn(2 * c, c, scale=c ** -0.5),
         0.1 * randn(2 * c), randn(c, 2 * c, scale=(2 * c) ** -0.5), 0.1 * randn(c),
         randn(c, c, scale=c ** -0.5), 0.1 * randn(c))
    return (x, tok) + p + (() if g is None else (g,))


def attn_tail_bwd_bound(x):
    """The attn_tail backward's bound for x (B, H, W, C): x and g read, dx
    written, the weights and vectors read, the gradients written; 30 C^2
    FLOP per pixel on the tensor cores."""
    b, h, w, c = x.shape
    moved = 3 * nbytes(x) + b * c * 2 + 5 * c * c * 2 + 6 * c * 4 + b * c * 4 \
        + (5 * c * c + 6 * c) * 4
    return bound(moved, 30 * b * h * w * c * c, PEAK_BF16_FLOPS)


def check_attn_tail_bwd(label, args):
    """The attn_tail backward kernel against autograd of the plain version:
    dx elementwise, the reduced gradients (dtok and the parameters') by
    relative L2, and a second call bit-equal (every sum in a fixed order).
    Returns (max abs err, {gradient: rel L2})."""
    import torch

    from noisediff_tpu_torch.ops.kernels import fused_attn_tail_bwd, reference_attn_tail_bwd

    got, want = fused_attn_tail_bwd(*args), reference_attn_tail_bwd(*args)
    g = args[-1]
    compare("attn_tail_bwd dx", got[0], want[0], scale=want[0].float().abs() + g.float().abs())
    names = ("dx", "dtok", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2", "dwp", "dbp")
    rels = {}
    for n, a, b in zip(names, got, want):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"attn_tail_bwd {label}: {n} is not finite or misshaped")
        rels[n] = rel_l2(a, b)
    worst = max(rels, key=rels.get)
    if rels[worst] > GRAD_REL:
        raise AssertionError(f"attn_tail_bwd {label}: rel L2 {rels}")
    if not all(torch.equal(a, b) for a, b in zip(got, fused_attn_tail_bwd(*args))):
        raise AssertionError(f"attn_tail_bwd {label}: two calls differ")
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    return err, rels


# pixel counts that are not multiples of 16: the full frame's /8 stage (B 1,
# 178 x 266 x 384), crop 504's /4 stage, the learning gate's tiny scale at /8
RAGGED_SHAPES = [(1, 178, 266, 384), (4, 126, 126, 96), (4, 2, 2, 384)]


def attn_tail_bound(x):
    """The attn_tail forward's bound for x (B, H, W, C): x read, the output
    written, the weights and vectors read; 10 C^2 FLOP per pixel."""
    b, h, w, c = x.shape
    moved = 2 * nbytes(x) + b * c * 2 + 5 * c * c * 2 + 6 * c * 4
    return bound(moved, 10 * b * h * w * c * c, PEAK_BF16_FLOPS)


def kernels_ragged(randn):
    """The attn_tail forward and backward at RAGGED_SHAPES against their
    plain versions, at the square shapes' tolerances; two calls of each
    bit-equal. Their rows have calls 0: no main path gives these
    shapes, so they add to no per-evaluation or per-step sum."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        fused_attn_tail, fused_attn_tail_bwd, reference_attn_tail, reference_attn_tail_bwd)

    fwd, bwd = [], []
    for shape in RAGGED_SHAPES:
        x = randn(*shape, scale=1.5, dtype=torch.bfloat16) + 0.5
        g = randn(*shape, dtype=torch.bfloat16)
        args = attn_tail_args(randn, x, g)
        fa = args[:-1]
        got = fused_attn_tail(*fa)
        err = compare("attn_tail", got, reference_attn_tail(*fa))
        if not torch.equal(got, fused_attn_tail(*fa)):
            raise AssertionError(f"attn_tail {shape}: two calls differ")
        ms = time_ms(lambda: fused_attn_tail(*fa), reps=5)
        fdev_ms = time_device_ms(lambda: fused_attn_tail(*fa), n=5)
        plain = time_ms(lambda: reference_attn_tail(*fa), reps=3)
        b_ms, b_by = attn_tail_bound(x)
        fwd.append(dict(shape=list(shape), calls=0, ms=ms, device_ms=fdev_ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
        berr, rels = check_attn_tail_bwd(f"{shape}", args)
        bms = time_ms(lambda: fused_attn_tail_bwd(*args), reps=5)
        dev_ms = time_device_ms(lambda: fused_attn_tail_bwd(*args), n=5)
        bplain = time_ms(lambda: reference_attn_tail_bwd(*args), reps=3)
        bb_ms, bb_by = attn_tail_bwd_bound(x)
        bwd.append(dict(shape=list(shape), calls=0, ms=bms, device_ms=dev_ms, plain_ms=bplain,
                        bound_ms=bb_ms, bound_by=bb_by, max_abs_err=berr, rel_l2=rels))
        log(f"  ragged {shape}: attn_tail {ms:.4f} ms, dev {fdev_ms:.4f} (bound {b_ms:.4f}), "
            f"max abs err {err:.3g}, bit-equal across two calls; backward {bms:.4f} ms, dev "
            f"{dev_ms:.4f} (bound {bb_ms:.4f}), worst rel L2 {max(rels.values()):.3g}, "
            "bit-equal across two calls")
        del x, g, args, fa
    return fwd, bwd


def kernels_training(randn):
    """The training path's kernels at the canonical training shapes: gn_stats
    and gn_grad_stats at the four stages (one kernel a call, read from a
    profile of calls of each shape: `profile_calls`), the attn_tail backward
    at the four stages (every gradient against autograd of the plain
    version)."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        fused_attn_tail_bwd, gn_grad_stats, gn_stats, reference_attn_tail_bwd,
        reference_gn_grad_stats, reference_gn_stats)

    from noisediff_tpu_torch.ops.kernels import _build
    from noisediff_tpu_torch.ops.kernels import attn_tail as at

    # the host plan's copy of the fused backward's shared-memory layout
    lib = _build.library("attn_tail_bwd", at._BWD_SIGNATURES)
    for c in at.FUSED_WIDTHS:
        if lib.nd_attn_tail_bwd_smem(c) != at.bwd_smem_bytes(c):
            raise AssertionError(f"attn_tail backward C={c}: the kernel takes "
                                 f"{lib.nd_attn_tail_bwd_smem(c)} bytes of shared memory, the "
                                 f"plan counts {at.bwd_smem_bytes(c)}")
    log(f"  attn_tail backward fused route: shared memory "
        f"{ {c: at.bwd_smem_bytes(c) for c in at.FUSED_WIDTHS} } bytes (kernel = plan), "
        f"{ {c: lib.nd_attn_tail_bwd_occupancy(c) for c in at.FUSED_WIDTHS} } blocks per SM")

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
            dev_ms = time_device_ms(lambda: fn(*args))
            host_ms = host_ms_per_call(lambda: fn(*args))
            plain = time_ms(lambda: ref(*args), reps=5)
            prof = profile_calls(lambda: fn(*args))
            if prof["launches"] != 1:
                raise AssertionError(f"{name} {res}^2 x {c}: {prof['launches']} kernels a call "
                                     f"({prof['kernel_us']})")
            b_ms, b_by = bound(reads + out_bytes, flops, PEAK_FP32_FLOPS)
            results[name].append(dict(shape=[BATCH, res, res, c], calls=GN_PER_STEP[st], ms=ms,
                                      device_ms=dev_ms, host_ms=host_ms, plain_ms=plain,
                                      bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                      launches_per_call=prof["launches"],
                                      kernel_us=prof["kernel_us"], profiled_us=prof["span_us"],
                                      kernels=prof["kernels"], gaps_us=prof["gaps_us"]))
            log(f"  {name} {res}^2 x {c}: {ms:.4f} ms, dev {dev_ms:.4f} ({dev_ms / b_ms:.2f}x "
                f"the bound {b_ms:.4f} {b_by}; host {host_ms:.4f} per call; plain {plain:.4f}), "
                f"max abs err {err:.3g}, bit-equal across two calls; profiled: "
                f"{prof['launches']} kernel a call "
                f"({ {k[:40]: round(v, 2) for k, v in prof['kernel_us'].items()} } us)")

        args = attn_tail_args(randn, x, g)
        err, rels = check_attn_tail_bwd(f"{res}^2 x {c}", args)
        worst = max(rels, key=rels.get)
        ms = time_ms(lambda: fused_attn_tail_bwd(*args), reps=10)
        dev_ms = time_device_ms(lambda: fused_attn_tail_bwd(*args), n=10)
        plain = time_ms(lambda: reference_attn_tail_bwd(*args), reps=3)
        b_ms, b_by = attn_tail_bwd_bound(x)
        results["attn_tail_bwd"].append(dict(
            shape=[BATCH, res, res, c], calls=ATTN_PER_EVAL[st], ms=ms, device_ms=dev_ms,
            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, max_abs_err=err, rel_l2=rels))
        log(f"  attn_tail_bwd {res}^2 x {c}: {ms:.4f} ms, dev {dev_ms:.4f} (plain {plain:.4f}, "
            f"bound {b_ms:.4f} {b_by}), worst rel L2 {rels[worst]:.3g} ({worst}), "
            f"max abs err {err:.3g}")
        del x, g, args
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
    if "conv_wgrad" in name:
        return "conv_wgrad kernel"
    if "attn_tail_fwd" in name:  # the forward's kernels, shared bodies included
        return "attn_tail kernel"
    if any(k in name for k in ("attn_tail_bwd", "gemm_rows", "ln_rows", "ln_bwd_rows",
                                "wgrad_gemm", "reduce_tiled", "reduce_fused")):
        return "attn_tail backward kernel"
    if "attn_tail" in name:
        return "attn_tail kernel"
    if "gn_grad_stats" in name:
        return "gn_grad_stats kernel"
    if "gn_stats" in name:
        return "GroupNorm statistics (gn_stats)"
    if "groupnorm_silu" in name:
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
    adds = _add_kernels(prof, evals)

    # the same evaluation with every Block's conv bias on the conv again
    # (the route before the fold), for the add kernels it launches
    from noisediff_tpu_torch.models import blocks

    folded = blocks.Block.forward
    blocks.Block.forward = lambda self, xx, ss=None: self.norm(self.proj(xx), ss)
    try:
        with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof_unfolded:
            for _ in range(evals):
                model(x, t, cond)
            torch.cuda.synchronize()
    finally:
        blocks.Block.forward = folded
    adds_unfolded = _add_kernels(prof_unfolded, evals)
    busy_unfolded = sum(_device_ms_by_name(prof_unfolded, evals).values())
    fold_calls = sum(count for *_, count in GN_PER_EVAL)
    ops, ops_unfolded = _add_ops(prof, evals), _add_ops(prof_unfolded, evals)
    log(f"  add kernels per evaluation: {sum(adds.values()):g} with the conv bias folded into "
        f"groupnorm_silu, {sum(adds_unfolded.values()):g} with it on the conv (aten add calls "
        f"{ops:g} against {ops_unfolded:g}); device busy {busy:.4f} against "
        f"{busy_unfolded:.4f} ms")
    for name in sorted(set(adds) | set(adds_unfolded)):
        log(f"    {adds_unfolded.get(name, 0):g} -> {adds.get(name, 0):g}  {name[:110]}")
    # the host's record of the calls is exact; the device's kernel records
    # can miss a few when the profiler's buffers fill
    if ops_unfolded - ops != fold_calls:
        raise AssertionError(f"the fold should remove {fold_calls} add calls per evaluation, "
                             f"removed {ops_unfolded - ops:g}")
    cats = {}
    for name, ms in by_name.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {cat}")
    log("  top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {ms:9.4f} ms  {name[:110]}")
    return dict(eval_ms=eval_ms, wall_ms=wall_ms, busy_ms=busy, categories=cats)


def _add_kernels(prof, n: int):
    """{kernel name: launches per evaluation} of PyTorch's add kernels (the
    broadcast bias adds among them) in a profile of n evaluations."""
    out = {}
    for e in prof.key_averages():
        low = e.key.lower()
        if str(e.device_type).endswith("CUDA") and "add" in low.replace("padd", ""):
            out[e.key] = out.get(e.key, 0) + e.count / n
    return out


def _add_ops(prof, n: int) -> float:
    """aten add calls per evaluation in a profile of n evaluations (each
    launches one kernel on the card), from the host's records."""
    return sum(e.count for e in prof.key_averages()
               if e.key in ("aten::add", "aten::add_")
               and not str(e.device_type).endswith("CUDA")) / n


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

    from noisediff_tpu_torch.ops.kernels import conv_wgrad

    loss32, g32 = step(None, torch.device("cpu"))
    loss16, g16 = step(torch.bfloat16, torch.device("cpu"))
    loss_card, gc = step(torch.bfloat16, torch.device("cuda"))
    out = {"loss_card": loss_card, "loss_cpu_bf16": loss16, "loss_cpu_fp32": loss32}
    log(f"  CPU fp32 loss {loss32:.6f}")
    # bf16 through ~60 layers forward and back on both sides: the loss
    # within 2e-2, each gradient as close to the fp32 one as the CPU's bf16
    # gradient is (within 2x + 0.02), all gradients within 5e-2 of the CPU
    # bf16 ones
    out.update(_check_grads("train_check", b, s, loss_card, gc, loss16, g16, g32))

    # the same step through the conv_wgrad route
    n0 = conv_wgrad.launches
    os.environ["NOISEDIFF_WGRAD"] = "pallas"
    try:
        loss_w, gw = step(torch.bfloat16, torch.device("cuda"))
    finally:
        del os.environ["NOISEDIFF_WGRAD"]
    routed = conv_wgrad.launches - n0
    if routed == 0:
        raise AssertionError("train_wgrad check: no conv_wgrad launch in the step")
    out["wgrad"] = _check_grads("train_wgrad check", b, s, loss_w, gw, loss16, g16, g32)
    # against the card's cuDNN-wgrad step: cuDNN rounds each weight
    # gradient to bf16, the kernel keeps fp32
    names = [n for n in gc if not is_unread_parameter(n)]
    vs_cudnn = rel_l2(torch.cat([gw[n].flatten() for n in names]),
                      torch.cat([gc[n].flatten() for n in names]))
    worst = max((rel_l2(gw[n], gc[n]), n) for n in names)
    out["wgrad"].update(loss=loss_w, conv_wgrad_launches=routed, rel_l2_vs_cudnn=vs_cudnn,
                        worst_param_vs_cudnn=worst)
    log(f"  with NOISEDIFF_WGRAD=pallas ({routed} conv_wgrad launches): loss {loss_w:.6f}; "
        f"all gradients vs the cuDNN-wgrad step rel L2 {vs_cudnn:.4g}, worst parameter "
        f"{worst[0]:.4g} ({worst[1]})")
    if vs_cudnn > GRAD_REL:
        raise AssertionError(f"train_wgrad check: gradients disagree with cuDNN's: {out}")
    return out


def _check_grads(what, b, s, loss, grads, loss16, g16, g32):
    """A card step's loss and gradients against the CPU's bf16 and fp32
    steps, within train_check's bounds."""
    import torch

    from noisediff_tpu_torch.models import is_unread_parameter

    out = {}
    if abs(loss - loss16) > 2e-2 * abs(loss16):
        raise AssertionError(f"{what}: loss {loss} against CPU bf16 {loss16}")
    bad, worst, cat_c, cat_16 = {}, 0.0, [], []
    for name, gr in grads.items():
        if is_unread_parameter(name):
            if gr is not None:
                raise AssertionError(f"{what}: {name} is never read but has a gradient")
            continue
        if gr is None or not bool(torch.isfinite(gr).all()):
            raise AssertionError(f"{what}: {name} has no finite gradient on the card")
        r = rel_l2(gr, g32[name])
        limit = 2 * rel_l2(g16[name], g32[name]) + 0.02
        worst = max(worst, rel_l2(gr, g16[name]))
        if r > limit:
            bad[name] = (r, limit)
        cat_c.append(gr.flatten())
        cat_16.append(g16[name].flatten())
    out["grad_rel_l2_all"] = rel_l2(torch.cat(cat_c), torch.cat(cat_16))
    out["grad_rel_l2_worst_param"] = worst
    n_read = sum(1 for n in grads if not is_unread_parameter(n))
    log(f"  {what}: dim-48 train step {b}x{s}^2: loss card {loss:.6f}, CPU bf16 {loss16:.6f}; "
        f"{n_read} read parameters with finite gradients on the card; all gradients vs CPU "
        f"bf16 rel L2 {out['grad_rel_l2_all']:.4g}, worst parameter {worst:.4g}")
    if bad or out["grad_rel_l2_all"] > 5e-2:
        raise AssertionError(f"{what}: gradients disagree: {bad} {out}")
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


def train_cli(seed: int, workdir: str, out_name: str, per_step, what: str):
    """One training run through the CLI over the tree in workdir, counted
    from zero: losses, each kernel's launches per step, and the rate over
    the window after the first 3 steps on the device's clock from the end
    of step 3 to the end of the last (loader waits and uploads fall in
    between)."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli import train_diffusion
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    out = os.path.join(workdir, out_name)
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
        raise AssertionError(f"{what}: expected {TRAIN_STEPS} steps: {summary['steps']}")
    if not all(np.isfinite(summary["losses"])):
        raise AssertionError(f"{what}: non-finite losses: {summary['losses']}")
    for name, want in per_step.items():
        if counts[name] != want * steps:
            raise AssertionError(f"{what}: {name}: {counts[name]} launches in {steps} training "
                                 f"steps, expected {want} per step")
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
    log(f"  launches: {counts}")
    return dict(out=out, counts=counts, steps=steps, steps_per_s=rate, samples_per_s=BATCH * rate,
                period_ms=period * 1e3, epoch_seconds=epoch_s, loader_wait_seconds=waited,
                step_seconds=secs, peak_bytes=peak, losses=summary["losses"])


# kernel launches per training step on the default route
TRAIN_PER_STEP = {"fused_attn_tail": 9, "fused_attn_tail_bwd": 9, "gn_stats": 44,
                  "gn_grad_stats": 44, "fused_dual_head": 1, "fused_groupnorm_film_silu": 0,
                  "fused_ddim_head_update": 0, "conv_wgrad": 0, "flash_attention": 0}


def phase_train(seed: int, workdir: str):
    """Training through the CLI at the canonical config; the counted run of
    the training path."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli import test_diffusion
    from noisediff_tpu_torch.models import NoiseDiffNet

    make_train_tree(workdir, seed)
    res = train_cli(seed, workdir, "train", TRAIN_PER_STEP, "train")
    out = res["out"]
    # --use_tb_logger: the loss and LR at step 0 (--vis_step_freq 100)
    with open(os.path.join(out, "train_diffusion", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [(r["tag"], r["step"]) for r in rows] != [("diffusion_loss", 0), ("lr", 0)] or not all(
            np.isfinite(r["value"]) for r in rows):
        raise AssertionError(f"--use_tb_logger wrote {rows}")
    log(f"  scalars.jsonl: {[(r['tag'], r['step'], round(r['value'], 6)) for r in rows]}")
    snap = os.path.join(out, "train_diffusion", "snapshot")
    for comp in ("net", "ema"):
        sd = torch.load(os.path.join(snap, f"{comp}_final.pth"), map_location="cpu",
                        weights_only=True)
        NoiseDiffNet(dim=DIM).load_state_dict(sd, strict=True)

    # generation from the trained net through the generation CLI
    gen = os.path.join(workdir, "gen")
    make_sid_tree(gen, seed)
    argv = gen_argv(gen, os.path.join(snap, "net_final.pth"), seed, "out", ["--sampler", "dpm"])
    g = test_diffusion.main(argv)
    files = glob.glob(os.path.join(g["out_dir"], "*.npy"))
    if g["generated"] != len(files) or not files or not all(
            np.isfinite(np.load(f)).all() for f in files):
        raise AssertionError(f"generation from net_final.pth: {g}")
    log(f"  generated {len(files)} patches from net_final.pth through the generation CLI")
    return res


def phase_fp32_train(seed: int, workdir: str):
    """--no_mixed_precision (fp32 compute) through the training CLI over the
    tree in workdir: 2 steps (crop 128, batch 50) on the default wgrad route
    and 2 more under NOISEDIFF_WGRAD=pallas (the conv_wgrad kernel is
    bf16-only, so no conv takes it), both on the plain route of every block:
    no kernel launches; finite losses."""
    import numpy as np

    from noisediff_tpu_torch.cli import train_diffusion
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    out = {}
    for flag in ("xla", "pallas"):
        argv = [
            "--save_epoch_freq", "1", "--generation_result", "noise", "--name",
            "train_diffusion", "--net_name", "NoiseDiffNet", "--beta_schedule", "sigmoid2",
            "--positional_encoding", "--trainset", "SonyTrainDataset", "--dim", str(DIM),
            "--crop_size", "128", "--with_camera_settings", "--batch_size", "50",
            "--max_iter", "1", "--random_seed", str(seed), "--device", "cuda",
            "--num_workers", "4", "--no_mixed_precision", "--sid_folder",
            os.path.join(workdir, "SID"), "--save_folder", os.path.join(workdir, f"fp32_{flag}"),
        ]
        os.environ["NOISEDIFF_WGRAD"] = flag
        try:
            reset_launch_counts()
            summary = train_diffusion.main(argv)
            counts = launch_counts()
        finally:
            del os.environ["NOISEDIFF_WGRAD"]
        if summary["steps"] != 2 or not all(np.isfinite(summary["losses"])):
            raise AssertionError(f"fp32 training ({flag}): {summary['steps']} steps, "
                                 f"{summary['losses']}")
        if any(counts.values()):
            raise AssertionError(f"fp32 training ({flag}) launched kernels: {counts}")
        log(f"  2 fp32 steps with NOISEDIFF_WGRAD={flag}, losses {summary['losses']}, "
            "no kernel launched")
        out[flag] = {"losses": summary["losses"], "counts": counts}
    return out


def phase_dim96(seed: int):
    """A NoiseDiffNet at --dim 96, bf16, one forward on the card on its route
    (the heads, built for C <= 64, on their plain version; attn_tail and
    groupnorm_silu at 96..768 channels) against the same weights on the CPU."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.manual_seed(seed)
    cpu = NoiseDiffNet(dim=96, dtype=torch.bfloat16).eval()
    card = NoiseDiffNet(dim=96, dtype=torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().to(memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(seed)
    b, s = 1, 64
    x = torch.from_numpy(rng.standard_normal((b, s, s, 4)).astype(np.float32))
    cond = {"clean_img": torch.from_numpy(rng.uniform(0, 0.3, (b, s, s, 4)).astype(np.float32)),
            "position": torch.from_numpy(rng.uniform(0, 1, (b, s, s, 2)).astype(np.float32)),
            "iso_ratio_idx": torch.tensor([24])}
    t = torch.tensor([421])
    with torch.inference_mode():
        want = cpu(x, t, cond).float()
        reset_launch_counts()
        got = card(x.cuda(), t.cuda(), {k: v.cuda() for k, v in cond.items()}).float().cpu()
        counts = launch_counts()
    if got.shape != (b, s, s, 4) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"dim-96 forward: shape {tuple(got.shape)} or not finite")
    rel = rel_l2(got, want)
    want_counts = {"fused_attn_tail": 9, "fused_dual_head": 0}
    if any(counts[k] != v for k, v in want_counts.items()) or not counts[
            "fused_groupnorm_film_silu"]:
        raise AssertionError(f"dim-96 forward launches: {counts}")
    log(f"  dim-96 forward {b}x{s}x{s}: card bf16 vs CPU bf16 rel L2 {rel:.4g}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if rel > 5e-2:
        raise AssertionError(f"dim-96 card forward disagrees with the CPU: rel L2 {rel}")
    return {"rel_l2": rel, "counts": counts}


def phase_train_wgrad(seed: int, workdir: str, routed_per_step: int, default_rate: float):
    """Training through the CLI with NOISEDIFF_WGRAD=pallas over the tree
    phase_train made: the conv_wgrad route's launches per step and its
    steps/s beside the default run's."""
    per_step = dict(TRAIN_PER_STEP, conv_wgrad=routed_per_step)
    os.environ["NOISEDIFF_WGRAD"] = "pallas"
    try:
        res = train_cli(seed, workdir, "train_wgrad", per_step, "train_wgrad")
    finally:
        del os.environ["NOISEDIFF_WGRAD"]
    log(f"  conv_wgrad route: {res['steps_per_s']:.4f} steps/s against the default route's "
        f"{default_rate:.4f} in this run; {routed_per_step} conv_wgrad launches per step")
    return res


def phase_attention(seed: int):
    """blocks.Attention forward and backward on the card (bf16, the flash
    kernel) against the CPU (fp32): the output, the input's and every
    parameter's gradient by relative L2."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.models.blocks import Attention
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    b, c, h, w = ATTN_SHAPE
    torch.manual_seed(seed)
    cpu = Attention(c)
    card = Attention(c, dtype=torch.bfloat16)  # the bf16 route runs the flash kernel
    card.load_state_dict(cpu.state_dict())
    dev = torch.device("cuda")
    card = card.to(dev)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).permute(0, 3, 1, 2)
    gy = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).permute(0, 3, 1, 2)

    reset_launch_counts()
    xc = x.to(dev, torch.bfloat16).requires_grad_(True)
    y = card(xc)
    (y.float() * gy.to(dev)).sum().backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["flash_attention"] != 1:
        raise AssertionError(f"attention: {counts['flash_attention']} flash_attention launches, "
                             "expected 1")
    xr = x.clone().requires_grad_(True)
    yr = cpu(xr)
    (yr * gy).sum().backward()
    rels = {"out": rel_l2(y.detach().cpu(), yr.detach()), "x": rel_l2(xc.grad.cpu(), xr.grad)}
    card_params = dict(card.named_parameters())
    for name, p in cpu.named_parameters():
        rels[name] = rel_l2(card_params[name].grad.cpu(), p.grad)
    worst = max(rels, key=rels.get)
    log(f"  Attention({c}) at {b}x{h}x{w} ({h * w} tokens), card bf16 vs CPU fp32, rel L2: "
        + ", ".join(f"{k} {v:.4g}" for k, v in rels.items()))
    if rels[worst] > ATTN_REL or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"attention: card and CPU disagree: {rels}")
    return dict(counts=counts, rel_l2=rels)


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
    out = dict(periods=periods, wall_ms=wall_ms, busy_ms=busy, categories=cats)
    out["wgrad_route"] = profile_wgrad_route(step, batch, g)
    return out


def profile_wgrad_route(step, batch, gen):
    """The same training step on the conv_wgrad route (NOISEDIFF_WGRAD=
    pallas): whether the gradient reaching each routed conv's backward
    (models/blocks._ConvWgrad) is channels-last, so that to_nhwc(g) is a
    view rather than a copy; then the device busy time per step by kernel
    class (torch.profiler), the conv_wgrad kernels' share among it."""
    import torch

    from noisediff_tpu_torch.models import blocks

    layouts = {"channels-last": 0, "other": 0}
    orig = blocks._ConvWgrad.backward

    def spy(ctx, g):
        layouts["channels-last" if g.is_contiguous(memory_format=torch.channels_last)
                else "other"] += 1
        return orig(ctx, g)

    os.environ["NOISEDIFF_WGRAD"] = "pallas"
    try:
        blocks._ConvWgrad.backward = staticmethod(spy)
        step(batch, gen)
        blocks._ConvWgrad.backward = staticmethod(orig)
        step(batch, gen)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILE_STEPS):
                step(batch, gen)
            torch.cuda.synchronize()
    finally:
        blocks._ConvWgrad.backward = staticmethod(orig)
        del os.environ["NOISEDIFF_WGRAD"]
    log(f"  conv_wgrad route: the gradient reaching the routed convs' backward is "
        f"channels-last at {layouts['channels-last']} of "
        f"{layouts['channels-last'] + layouts['other']} convs (to_nhwc(g) copies at the others)")
    by_name = _device_ms_by_name(prof, PROFILE_STEPS)
    if not by_name:
        log("  torch.profiler recorded no device time on the conv_wgrad route")
        return dict(g_layouts=layouts)
    busy = sum(by_name.values())
    cats = {}
    for name, ms in by_name.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    log(f"  conv_wgrad route: device busy {busy:.4f} ms per step (torch.profiler), of which:")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {cat}")
    return dict(g_layouts=layouts, busy_ms=busy, categories=cats)


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


def gen_setup(workdir: str, seed: int) -> str:
    """The generation phases' miniature SID tree and seeded random weights,
    saved as a reference-layout .pth with DDP-style keys; returns its path."""
    import torch

    from noisediff_tpu_torch.models import NoiseDiffNet

    make_sid_tree(workdir, seed)
    torch.manual_seed(seed)
    ckpt = os.path.join(workdir, "net_seeded.pth")
    sd = NoiseDiffNet(dim=DIM).state_dict()
    torch.save({"module." + k: v for k, v in sd.items()}, ckpt)
    return ckpt


def gen_argv(workdir: str, ckpt: str, seed: int, out: str, sampler):
    return [
        "--name", "ISO800_Ratio250", "--resume", ckpt, "--generation_result", "noise",
        "--testset", "NoiseImageGenerationDataset", "--save_npy", "--random_seed", str(seed),
        "--beta_schedule", "sigmoid2", "--batch_size", str(BATCH), "--net_name", "NoiseDiffNet",
        "--positional_encoding", "--dim", str(DIM), "--crop_size", str(CROP),
        "--with_camera_settings", *sampler,
        "--device", "cuda", "--num_workers", "2", "--iso", "800", "--ratio", "250",
        "--sid_folder", os.path.join(workdir, "SID"), "--pretrained_dir", workdir,
        "--save_folder", os.path.join(workdir, out),
    ]


def run_generation(argv, per_batch, what: str):
    """One generation run through the CLI, counted from zero: the npy
    contract and each kernel's launches per batch; returns the summary,
    the counts and the files."""
    import numpy as np

    from noisediff_tpu_torch.cli import test_diffusion
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    summary = test_diffusion.main(argv)
    counts = launch_counts()

    n = summary["generated"]
    if n != N_BATCHES * BATCH or summary["batches"] != N_BATCHES:
        raise AssertionError(f"{what}: expected {N_BATCHES} batches of {BATCH} patches: {summary}")
    for name, want in per_batch.items():
        if counts[name] != want * N_BATCHES:
            raise AssertionError(f"{what}: {name}: {counts[name]} launches, expected {want} per "
                                 f"batch x {N_BATCHES} batches")
    files = sorted(glob.glob(os.path.join(summary["out_dir"], "*.npy")))
    if len(files) != n or glob.glob(os.path.join(summary["out_dir"], "*.tmp.npy")):
        raise AssertionError(f"{what}: {len(files)} npy files for {n} patches, or temp files left")
    for path in files:
        base = os.path.basename(path)[:-4]
        clean, noisy, coord = base.split("+")
        if clean != noisy or not clean.endswith("_00_10s") or coord not in GRID_NAMES:
            raise AssertionError(f"{what}: unexpected output name {base}")
        arr = np.load(path)
        if arr.shape != (4, CROP, CROP) or arr.dtype != np.float32 or not np.isfinite(arr).all():
            raise AssertionError(f"{what}: {base}: {arr.shape} {arr.dtype} or not finite")
    secs = summary["batch_seconds"]
    rate = n / sum(secs)
    steady = BATCH * (len(secs) - 1) / sum(secs[1:])
    log(f"  generated {n} patches of {CROP}^2 in {sum(secs):.3f} s of sampling: "
        f"{rate:.4f} patches/s ({steady:.4f} after the first batch); batch seconds "
        f"{[round(s, 4) for s in secs]}")
    log(f"  launches: {counts}")
    return dict(counts=counts, patches=n, patches_per_s=rate, steady_patches_per_s=steady,
                batch_seconds=secs, files=files)


def phase_main(seed: int, workdir: str, ckpt: str):
    import numpy as np

    from noisediff_tpu_torch.cli import test_diffusion

    argv = gen_argv(workdir, ckpt, seed, "out", ["--sampler", "dpm", "--dpm_spacing", "lambda"])
    per_batch = {"fused_attn_tail": 9 * DPM_STEPS, "fused_groupnorm_film_silu": 42 * DPM_STEPS,
                 "fused_dual_head": DPM_STEPS, "fused_attn_tail_bwd": 0, "gn_stats": 0,
                 "gn_grad_stats": 0, "fused_ddim_head_update": 0, "conv_wgrad": 0,
                 "flash_attention": 0}
    out = run_generation(argv, per_batch, "main")

    # resume: a deleted patch comes back identical, nothing else is resampled
    victim = out.pop("files")[0]
    before = np.load(victim)
    os.remove(victim)
    again = test_diffusion.main(argv + ["--skip_existing"])
    if again["batches"] != 1 or not np.array_equal(np.load(victim), before):
        raise AssertionError(f"--skip_existing did not regenerate {victim} identically: {again}")
    log("  --skip_existing regenerated the deleted patch bit-identically")
    return out


def phase_ddim(seed: int, workdir: str, ckpt: str):
    """DDIM-100 through the CLI (the fused tail), then DDIM-4 fused against
    unfused from the same noise at full width."""
    import torch

    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import fused_ddim_head_update, fused_dual_head
    from noisediff_tpu_torch.ops.schedules import make_schedule

    argv = gen_argv(workdir, ckpt, seed, "out_ddim",
                    ["--sampler", "ddim", "--sampling_timesteps", str(DDIM_STEPS)])
    per_batch = {"fused_attn_tail": 9 * DDIM_STEPS, "fused_groupnorm_film_silu": 42 * DDIM_STEPS,
                 "fused_ddim_head_update": DDIM_STEPS, "fused_dual_head": 0,
                 "fused_attn_tail_bwd": 0, "gn_stats": 0, "gn_grad_stats": 0, "conv_wgrad": 0,
                 "flash_attention": 0}
    out = run_generation(argv, per_batch, "ddim")
    out.pop("files")

    torch.manual_seed(seed)
    dev = torch.device("cuda")
    model = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last)
    model.eval()
    gd = GaussianDiffusion(model, make_schedule("sigmoid2", 1000), image_size=CROP, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = _canonical_batch(g, dev)
    cond = {"clean_img": batch["clean_img"], "position": batch["coord"],
            "iso_ratio_idx": batch["iso_ratio_idx"]}
    x = torch.randn((BATCH, CROP, CROP, 4), generator=g, device=dev)

    def trunk_fn(xx, t, c):
        return (*model.trunk(xx, t, c), model.head_weights())

    n_tail, n_head = fused_ddim_head_update.launches, fused_dual_head.launches
    fused = gd.ddim_sample(x.shape, cond, sampling_timesteps=4, init_noise=x, trunk_fn=trunk_fn)
    if (fused_ddim_head_update.launches - n_tail, fused_dual_head.launches - n_head) != (4, 0):
        raise AssertionError("ddim: the fused DDIM-4 sample did not run the ddim_head kernel 4 "
                             "times")
    unfused = gd.ddim_sample(x.shape, cond, sampling_timesteps=4, init_noise=x)
    rel = rel_l2(fused, unfused)
    err = float((fused - unfused).abs().max())
    log(f"  DDIM-4 at {BATCH}x{CROP}^2, dim {DIM}: fused tail vs unfused rel L2 {rel:.4g}, max abs "
        f"{err:.4g}")
    if not bool(torch.isfinite(fused).all()) or rel > DDIM_REL:
        raise AssertionError(f"ddim: fused and unfused DDIM-4 disagree: rel L2 {rel}")
    out.update(fused_vs_unfused_rel_l2=rel, fused_vs_unfused_max_abs=err)
    return out


# ---------------------------------------------------------------------------
# every kernel wrapper's name, as launch_counts() keys them
KERNEL_WRAPPERS = ("fused_attn_tail", "fused_attn_tail_bwd", "fused_groupnorm_film_silu",
                   "fused_dual_head", "fused_ddim_head_update", "gn_stats", "gn_grad_stats",
                   "conv_wgrad", "flash_attention")

KERNEL_META = {  # name: (wrapper, source, TPU kernel it replaces, what `ms` is summed over)
    "attn_tail": ("fused_attn_tail", "noisediff_tpu_torch/csrc/attn_tail.cu",
                  "noisediff_tpu/ops/pallas/attn_tail.py:190", "evaluation"),
    "groupnorm_silu": ("fused_groupnorm_film_silu",
                       "noisediff_tpu_torch/csrc/groupnorm_silu.cu",
                       "noisediff_tpu/ops/pallas/groupnorm_silu.py:105", "evaluation"),
    "dual_head": ("fused_dual_head", "noisediff_tpu_torch/csrc/dual_head.cu",
                  "noisediff_tpu/ops/pallas/dual_head.py:77", "evaluation"),
    "attn_tail_bwd": ("fused_attn_tail_bwd", "noisediff_tpu_torch/csrc/attn_tail_bwd.cu",
                      "noisediff_tpu/ops/pallas/attn_tail.py:307", "training step"),
    "gn_stats": ("gn_stats", "noisediff_tpu_torch/csrc/gn_stats.cu",
                 "noisediff_tpu/ops/pallas/gn_stats.py:64", "training step"),
    "gn_grad_stats": ("gn_grad_stats", "noisediff_tpu_torch/csrc/gn_stats.cu",
                      "noisediff_tpu/ops/pallas/gn_stats.py:246", "training step"),
    "ddim_head": ("fused_ddim_head_update", "noisediff_tpu_torch/csrc/dual_head.cu",
                  "noisediff_tpu/ops/pallas/ddim_head.py:132", "DDIM evaluation"),
    "conv_wgrad": ("conv_wgrad", "noisediff_tpu_torch/csrc/conv_wgrad.cu",
                   "noisediff_tpu/ops/pallas/conv_wgrad.py:119", "wgrad-route training step"),
    "flash_attention": ("flash_attention", "noisediff_tpu_torch/csrc/flash_attention.cu",
                        "noisediff_tpu/ops/pallas/flash_attention.py:68", "Attention call"),
}


def kernels_line(results, launches):
    """One entry per kernel. ms, plain_ms, bound_ms and library_ms (and,
    where the rows have them, device_ms and library_device_ms: the same on
    the card's clock, `time_device_ms`; host_ms: the wrapper's host time,
    `host_ms_per_call`) are summed over the calls of one model evaluation
    at the canonical
    generation config, one training step at the canonical training config,
    one DDIM evaluation, one training step on the conv_wgrad route or one
    Attention call (`ms_per`): each shape's median time times its calls;
    per_shape has each shape's numbers. `launches[name]` is (launches, the
    fields that split them): the wrapper's count over the main-path run(s)
    that exercise the kernel, each counted from zero."""
    out = []
    for name, rows in results.items():
        wrapper, source, replaces, per = KERNEL_META[name]
        tot = {k: sum(r[k] * r["calls"] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
        counted = [r for r in rows if r["calls"]]
        lib = (sum(r["library_ms"] * r["calls"] for r in counted)
               if all(r.get("library_ms") is not None for r in counted) else None)
        # the card's clock (time_device_ms) and the wrapper's host time
        # (host_ms_per_call), where the kernel's counted rows have them
        device = {k: sum(r[k] * r["calls"] for r in counted)
                  for k in ("device_ms", "library_device_ms", "host_ms")
                  if counted and all(k in r for r in counted)}
        # the bound of the shapes that carry most of the bound time
        by_bytes = sum(r["bound_ms"] * r["calls"] for r in rows if r["bound_by"] == "bytes")
        n, split = launches[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, **split,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
            "library_ms": lib, **device, "ms_per": per, "per_shape": rows,
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
            if "Compiling entry function" in line:  # the kernel the next lines are about
                log(f"  {name}: {line.split(chr(39))[1][:110]}")
            elif "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    for name in ("groupnorm_silu", "dual_head"):  # designed to run without spills
        spills = [ln.strip() for ln in build_logs.get(name, "").splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]
        if spills:
            raise AssertionError(f"{name}: ptxas reports spills: {spills}")
    sass = flash_sass_counts(_build._lib_path("flash_attention"), _build._nvcc())
    log("  flash_attention D=32 main loop, SASS instructions per score element: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sass.items()))

    log("[kernels] kernel vs plain version on the card")
    results = phase_kernels(args.seed)
    routed_per_step = sum(r["calls"] for r in results["conv_wgrad"])
    log("[model] full-width forward, card vs CPU")
    phase_model(args.seed)
    log("[profile] where one model evaluation spends its time")
    phase_profile(args.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ckpt = gen_setup(workdir, args.seed)
        log("[main] bulk generation through the CLI")
        gen = phase_main(args.seed, workdir, ckpt)
        log("[ddim] DDIM-100 generation through the CLI, the fused DDIM tail")
        ddim = phase_ddim(args.seed, workdir, ckpt)
        log("[fp32] DPM-10 generation through the CLI with --no_mixed_precision")
        run_generation(gen_argv(workdir, ckpt, args.seed, "fp32",
                                ["--sampler", "dpm", "--no_mixed_precision"]),
                       {k: 0 for k in KERNEL_WRAPPERS}, "fp32 generation")
        log(f"  {N_BATCHES} batches of {BATCH} patches, fp32, no kernel launched")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("[train_check] full-width training step, card vs CPU")
    phase_train_check(args.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        log("[train] training through the CLI at the canonical config")
        train = phase_train(args.seed, workdir)
        log("[train_wgrad] training through the CLI on the conv_wgrad route")
        wgrad = phase_train_wgrad(args.seed, workdir, routed_per_step, train["steps_per_s"])
        log("[fp32] training through the CLI with --no_mixed_precision")
        phase_fp32_train(args.seed, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("[train profile] where a training step spends its time")
    phase_train_profile(args.seed, train["period_ms"])
    log("[attention] blocks.Attention forward and backward, card vs CPU")
    attn = phase_attention(args.seed)
    log("[dim96] a dim-96 NoiseDiffNet forward on its route, card vs CPU")
    phase_dim96(args.seed)
    log(f"[done] {time.time() - t_start:.1f} s")

    gc, dc, tc, steps = gen["counts"], ddim["counts"], train["counts"], train["steps"]
    launches = {}
    for name in ("attn_tail", "groupnorm_silu", "dual_head", "attn_tail_bwd", "gn_stats",
                 "gn_grad_stats"):
        w = KERNEL_META[name][0]
        launches[name] = (gc[w] + dc[w] + tc[w], {
            "launches_generation": gc[w], "launches_per_batch": gc[w] / N_BATCHES,
            "launches_ddim": dc[w], "launches_ddim_per_batch": dc[w] / N_BATCHES,
            "launches_training": tc[w], "launches_per_step": tc[w] / steps})
    n = ddim["counts"]["fused_ddim_head_update"]
    launches["ddim_head"] = (n, {"launches_per_batch": n / N_BATCHES})
    n = wgrad["counts"]["conv_wgrad"]
    launches["conv_wgrad"] = (n, {"launches_per_step": n / wgrad["steps"]})
    launches["flash_attention"] = (attn["counts"]["flash_attention"], {})
    print(json.dumps(kernels_line(results, launches)))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
