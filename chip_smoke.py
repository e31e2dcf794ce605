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
           torch.profiler profile of each shape; attn_tail, groupnorm_silu
           and dual_head at the full SID frame's stages (B 1, 1424 x 2128 x
           48 to 178 x 266 x 384), with their time per full-frame evaluation
  model    the full-width (dim 48) NoiseDiffNet forward on the card, bf16
           through the kernels, against the same weights on the CPU
  profile  one model evaluation at the canonical shape: CUDA-event time and
           torch.profiler device time by kernel, with the idle share
  int8     the int8 route's kernels (NOISEDIFF_INT8=1,
           csrc/int8_conv.cu: int8_conv and absmax) at every call shape of
           one dim-48 evaluation (B 4, 512^2, bf16: 77 convs) and of LSID's
           evaluation of one packed full frame (fp32: 21), both dtypes at
           each, and at INT8_RAGGED: bit-equal to the plain version, absmax
           equal to max |x|, every main-path shape on the tiled kernel (its
           launch counter; the small kernel's for what the route rule sends
           there); each shape timed in its path's dtype, the tiled and the
           small kernel in turns, beside its bound, cuDNN's bf16 conv and
           (1x1) torch._int_mm. After fp32
           generation the main phase's DPM-10 run again under the variable
           (77 + 77 launches an evaluation, patches/s, the patches' distance
           from the bf16 run's); after evaluate its first frame under the
           variable (21 + 21 launches, PSNR / SSIM beside the fp32 route's).
           Their launches go into the kernels line
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
           block) through both CLIs: 1 DPM-2 batch after ddim, 2 training
           steps (crop 128, batch 50) after train_wgrad on the default wgrad
           route and 2 under NOISEDIFF_WGRAD=pallas; no kernel launches,
           finite outputs and losses
  denoise  stage 2 of the pipeline: LSID (base width 32, bf16 over fp32
           parameters) trained through the denoising CLI at script.sh:24's
           config (--loss_l1 --crop_size 256 --sub_darkshading --use_sna
           --batch_size 4, SyntheticNoisDiffDenoisingDataset) on the main
           phase's own 8 generated patches, with PMN dark-shading resources
           made from the seed, 13 epochs of 2 steps. Checks the losses, that
           no kernel of the port launched, the snapshots and that
           net_final.pth loads into LSID strictly; reports steps/s and
           samples/s after the first 3 steps on the card's clock, the
           epochs' wall time and loader waits, peak memory; SNA's Poisson
           draw on the card by its moments and apply_sna's lattice; then a
           step's period with the batch on the card and its device busy
           time by kernel class (torch.profiler) with the idle share
  evaluate the denoiser's evaluation through the test_denoising CLI on the
           denoise phase's net_final: 4 SID test pairs at Sony's 2848 x 4256
           Bayer size made from the seed (ISO800 x250), dark shading (float64
           resources) and illuminance correction; no kernel launches, each
           frame's time by part (decode on the host; upload, forward and
           metrics on the card), frames/s, peak memory; the first frame's
           PSNR, SSIM and output against the same CLI on the CPU (EVAL_*)
  kld      the eval_kld CLI: the main phase's generated patches against the
           evaluation tree's real pairs; finite, non-negative KLDs
  fullframe  diffusion/fullframe.generate_full_frame over the whole packed
           frame (B 1, 1424 x 2128 x 4) from gen_setup's dim-48 weights, bf16
           through the kernels, DPM-10: shape, finite values, 9 / 42 / 1
           launches of attn_tail / groupnorm_silu / dual_head an evaluation,
           the device time an evaluation from a profiled DPM-2 sample;
           DPM-2 through the kernels against the fp32 plain route on the card
           beside the bf16 plain route
  fullframe_sharded  (after fullframe) the same frame split by rows over 2
           spawned ranks (NCCL on 2 cards where the machine has them, else
           gloo with both ranks on one card) and over 4 on a 4-card machine
           (fullframe_sharded_rank): DPM-10's seconds a sample and ms an
           evaluation beside fullframe's, each rank's peak memory and
           launches (9 attn_tail, 44 gn_stats, 42 groupnorm_silu_apply, 1
           dual_head an evaluation, no groupnorm_silu), the halo exchanges'
           and all-reduces' count and time an evaluation from a profiled
           DPM-2 sample;
           DPM-2 and DDIM-2 (ddim_head) in bf16 against one card from the
           same x_T, and fp32 DPM-2 at 256 x 384 within 1e-4 rel L2 of one
           card. The kernels phase checks gn_stats and the groupnorm_silu
           apply entry at every shard shape (712 x 2128 x 48 .. 44 x 266 x
           384). Its launches go into the kernels line
           (launches_fullframe_sharded)
  denoise_check  one LSID step from make_denoising_train_step (flip and
           SNA off, B 2, 256^2) on the card against the CPU: fp32 on both
           within DENOISE_FP32_LOSS / DENOISE_FP32_GRAD, bf16 on the card
           within train_check's bounds
  attention  blocks.Attention forward and backward at B 4, C 384, 64^2
           tokens (the flash_attention kernel) against the CPU in fp32
  dim96    a dim-96 NoiseDiffNet forward on its route (the heads on their
           plain version, the other kernels at 96..768 channels) at B 1,
           64^2, against the CPU
  posemb   the UNet_PosEmbV2 family (models/others.py) at dim 48: each
           net's parameter count and a bf16 forward on the card against
           fp32 on the CPU; UNet_PosEmbV2_CameraCond through the training
           CLI at the canonical config on both wgrad routes (one epoch of
           the train phase's tree, 25 steps) and through the generation CLI
           from its net_final.pth (DPM-10, 2 batches; DDIM-100 unfused, 1
           batch), each run's launches of attn_tail (forward and backward),
           groupnorm_silu, gn_stats, gn_grad_stats and conv_wgrad against
           the family's tables; UNet_PosEmbV2 and UNet_PosEmbV2_NoPosition
           one epoch and 1 DPM-10 batch each; CameraCond's device busy time
           an evaluation and a step, peak memory; LinearAttention at B 4, C
           384, 64^2 against the CPU; interpolate at t = 10. Its launches
           are added to the kernels line (launches_posemb)
Multi-process data parallelism, --remat and --profile (ranks are processes
with torchrun's environment, `spawn_ranks`, forked from a server that
imported torch and the port once, `rank_context`; the independent runs of
one phase start together, `spawn_jobs`, so their start-up overlaps and
their rates are read under each other's load):
  dist_cli denoise  (after denoise) the denoising CLI at script.sh:24's
           config as spawned processes, all at once: --launcher none, and
           --launcher pytorch at world size 1 over NCCL (and 2 with 2
           cards): losses bit-equal to --launcher none's, only rank 0 writes
           its run directory, log and snapshots, which load strictly; steps/s
  dist_gen (after it) the generation CLI with --launcher pytorch on 2
           ranks (NCCL, which generation never calls, so both may share
           one card), DPM-10 over the main phase's grid: disjoint patch sets
           whose union has the main phase's names, finite, CHW
  dist_cli (after fp32 training) the same for the training CLI at the
           canonical config, 25 steps; its largest world's run (world size 1
           on one card) also takes --profile
  profile_cli  that run's trace of steps 5-9 names the port's kernels;
           device time by class and the NCCL all-reduce's share
  reference_steps  the canonical training step in one process (bf16, bf16
           with --remat, fp32): what dist_step, remat and train_sharded
           hold their steps against
  dist_step  the canonical training step on 2 ranks under DDP (NCCL with
           2 cards, else gloo over CUDA tensors on one card), 3 steps: both
           ranks log the same loss and grad norm and end bit-equal; the
           first step against one process on the concatenated batch (loss
           and gradients within train_check's bounds, grad norm within
           2e-2, updated parameters within 2 lr); each rank's peak memory
  remat    the canonical training step with and without --remat: loss and
           gradients within train_check's bounds (and whether bit-equal),
           peak device memory and a step's time for both, the recompute's
           extra launches
  train_sharded  the canonical training step on the grid (parallel/mesh.py
           make_mesh: data x spatial x model) over {spatial 2}, {model 2}
           and {spatial 2, model 2} (train_sharded_rank; NCCL where the
           machine has a card a rank, else gloo with the ranks on one card;
           scripts/port_train_sharded.py runs it alone): fp32 and bf16 first
           steps against dist_step's one-process steps (fp32 loss, grad norm
           and every gathered gradient and Adam-updated parameter within
           1e-4 rel L2; bf16 within twice the one-process bf16-against-fp32
           distance plus 0.02), each rank's launches a step (9 / 9 attn_tail
           forward / backward, 44 / 44 gn_stats / gn_grad_stats, 1
           dual_head, nothing else), NOISEDIFF_WGRAD=pallas refused under a
           spatial shard; each rank's step ms, peak memory, parameter and
           Adam bytes, and the collectives' count and host ms a step
The closed-loop learning gate (scripts/port_learning_gate.py):
  gate     (after train_sharded) the seven kernels against their plain
           versions at the gate's shapes: attn_tail, groupnorm_silu and
           dual_head at B 16 (training) and B 32 (generation) over 64^2 x
           48 .. 8^2 x 384 (the full frame's checks), attn_tail backward,
           gn_stats and gn_grad_stats at B 16, ddim_head at B 32; then the
           gate at its smoke scale through the four CLIs and eval_kld in
           bf16 (dim 48, crop 64, 50 diffusion and 15 LSID epochs),
           counted from zero: the JAX
           slow test's three thresholds (KLD halved, generated std below
           0.3, PSNR gain above 1 dB) and each of the seven kernels
           launched (launches_gate in the kernels line)
  sweep    (after gate, on its smoke workdir) the sampler KLD sweep
           (scripts/port_dpm_step_sweep.py) of the gate's EMA weights:
           DPM-5 on the lambda grid and its two DDIM legs at
           SWEEP_DDIM_STEPS (20; the smoke scale's 50 cut to make room for
           the int8 phases), the fused tail and unfused from the same
           draws, counted from zero: attn_tail, groupnorm_silu, dual_head
           and ddim_head each launched (launches_sweep in the kernels
           line), the two DDIM KLDs within SWEEP_DDIM_RTOL
Each section of main logs `  <name> phase <s> s` when it ends, passed or
failed (`timed`). The last lines are {"phase_seconds": {name: s}, "total_s":
s}, the kernels JSON line, the card's name and power limit, and {"ok":
true, "device": {...}}. On the way out, whether a phase passed
or failed, the script stops and reaps every process it started that still
runs (`stop_children`; it is the subreaper of its descendants), among them
the resource tracker of the generation CLI's spawned DataLoader workers,
which would otherwise end only after the script had.
"""
from __future__ import annotations

import argparse
import contextlib
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
# the fp32 generation check's depth: one batch of DPM-2 (the plain route in
# fp32 takes seconds an evaluation)
FP32_GEN_STEPS = 2
N_BATCHES = 2
# the miniature training tree: 2 pairs at SID Sony's frame size, one ISO800
# x250 bucket rebalanced to int(100 / 2) * 2 = 100 samples
SID_BAYER = (2848, 4256)
TRAIN_STEPS = 100 // BATCH
# training steps in each timed window and each torch.profiler profile of a
# step (train profile, posemb): the profiler's processing, seconds a step on
# the host, grows with the steps it records
PROFILE_STEPS = 3
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


# seconds of each section of main, by the name of its [tag] (timed); a name
# met twice adds up
PHASE_SECONDS: dict = {}


@contextlib.contextmanager
def timed(name: str):
    """Log `  <name> phase <s> s` when the block ends, whether it passed or
    raised, and add its seconds to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s = time.perf_counter() - t0
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + s
        log(f"  {name} phase {s:.1f} s")


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
    args = (x, sa, sb) + head_params(randn, c)
    got = fused_dual_head(*args)
    err = compare("dual_head", got, reference_dual_head(*args))
    if not torch.equal(got, fused_dual_head(*args)):
        raise AssertionError("dual_head: two calls differ")
    ms = time_ms(lambda: fused_dual_head(*args))
    dev_ms = time_device_ms(lambda: fused_dual_head(*args))
    host_ms = host_ms_per_call(lambda: fused_dual_head(*args))
    plain = time_ms(lambda: reference_dual_head(*args), reps=5)
    b_ms, b_by = bound(*head_work(x), PEAK_BF16_FLOPS)
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
    for name, rows in kernels_stages(randn, 1, FULLFRAME_STAGES, "full frame",
                                     "fullframe_calls").items():
        results[name] += rows
    torch.cuda.empty_cache()
    sharded = kernels_sharded(randn)
    results["gn_stats"] += sharded["gn_stats"]
    results["groupnorm_silu_apply"] = sharded["groupnorm_silu_apply"]
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
        want = reference_attn_tail(*args)
        scale, cancel = attn_tail_scale(x, want, got)
        err = compare("attn_tail", got, want, scale=scale)
        if not torch.equal(got, fused_attn_tail(*args)):
            raise AssertionError(f"attn_tail {res}^2 x {c}: two calls differ")
        ms = time_ms(lambda: fused_attn_tail(*args))
        dev_ms = time_device_ms(lambda: fused_attn_tail(*args))
        host_ms = host_ms_per_call(lambda: fused_attn_tail(*args))
        plain = time_ms(lambda: reference_attn_tail(*args), reps=5)
        b_ms, b_by = attn_tail_bound(x)
        row = dict(shape=[BATCH, res, res, c], calls=ATTN_PER_EVAL[st], route=plan["route"],
                   launches_per_call=plan["launches"], ms=ms, device_ms=dev_ms, host_ms=host_ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                   past_output_scale=cancel)
        other = ""
        if plan["route"] != "tiled" and c > 48:  # where the fused route was extended
            alt = lambda: at._launch(*args, 1e-5, route="tiled")  # noqa: E731
            tiled = alt()
            compare("attn_tail", tiled, want, scale=attn_tail_scale(x, want, tiled)[0])
            del tiled
            row["tiled_device_ms"] = time_device_ms(alt)
            other = f", tiled route {row['tiled_device_ms']:.4f} on the card's clock"
        rows.append(row)
        log(f"  attn_tail {res}^2 x {c} ({plan['route']}): {ms:.4f} ms, dev {dev_ms:.4f} "
            f"({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; host {host_ms:.4f} per call; "
            f"plain {plain:.4f}){other}, max abs err {err:.3g}, bit-equal across two calls; "
            f"{cancel['n']} element(s) past atol + rtol |out|: {cancel['worst']}")
        del x, args, got, want, scale
    for res, c in [(CROP >> i, 96 << i) for i in range(4)]:
        x = randn(1, res, res, c, dtype=torch.bfloat16)
        args = attn_tail_args(randn, x)
        got, want = fused_attn_tail(*args), reference_attn_tail(*args)
        scale, cancel = attn_tail_scale(x, want, got)
        err = compare("attn_tail", got, want, scale=scale)
        log(f"  attn_tail dim-96 width 1x{res}^2 x {c} ({at.fwd_route(c)}): max abs err {err:.3g}"
            f"; {cancel['n']} element(s) past atol + rtol |out|")
        del x, args, got, want, scale
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
    p = head_params(randn, c)
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
        io = 2 * nbytes(xt) + (nbytes(z) if sigma else 0)
        b_ms, b_by = bound(*head_work(x, io), PEAK_BF16_FLOPS)
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
        want = reference_attn_tail(*fa)
        scale, cancel = attn_tail_scale(x, want, got)
        err = compare("attn_tail", got, want, scale=scale)
        del want, scale
        if not torch.equal(got, fused_attn_tail(*fa)):
            raise AssertionError(f"attn_tail {shape}: two calls differ")
        ms = time_ms(lambda: fused_attn_tail(*fa), reps=5)
        fdev_ms = time_device_ms(lambda: fused_attn_tail(*fa), n=5)
        plain = time_ms(lambda: reference_attn_tail(*fa), reps=3)
        b_ms, b_by = attn_tail_bound(x)
        fwd.append(dict(shape=list(shape), calls=0, ms=ms, device_ms=fdev_ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=err, past_output_scale=cancel))
        berr, rels = check_attn_tail_bwd(f"{shape}", args)
        bms = time_ms(lambda: fused_attn_tail_bwd(*args), reps=5)
        dev_ms = time_device_ms(lambda: fused_attn_tail_bwd(*args), n=5)
        bplain = time_ms(lambda: reference_attn_tail_bwd(*args), reps=3)
        bb_ms, bb_by = attn_tail_bwd_bound(x)
        bwd.append(dict(shape=list(shape), calls=0, ms=bms, device_ms=dev_ms, plain_ms=bplain,
                        bound_ms=bb_ms, bound_by=bb_by, max_abs_err=berr, rel_l2=rels))
        log(f"  ragged {shape}: attn_tail {ms:.4f} ms, dev {fdev_ms:.4f} (bound {b_ms:.4f}), "
            f"max abs err {err:.3g} ({cancel['n']} element(s) past atol + rtol |out|), "
            f"bit-equal across two calls; backward {bms:.4f} ms, dev "
            f"{dev_ms:.4f} (bound {bb_ms:.4f}), worst rel L2 {max(rels.values()):.3g}, "
            "bit-equal across two calls")
        del x, g, args, fa
    return fwd, bwd


# the full SID frame (B 1, 1424 x 2128 packed) at each stage of the dim-48
# UNet: (H, W, C), the stages of full-frame generation
FULLFRAME = (1424, 2128)
FULLFRAME_STAGES = [(FULLFRAME[0] >> i, FULLFRAME[1] >> i, DIM << i) for i in range(4)]


def attn_tail_scale(x, want, got):
    """The scale of every attn_tail forward check's bound: |out - x| + |x|.
    out = round(round(proj) + x) stores the proj output in bf16 before the
    residual add, so a rounding flip of proj (an fp32 sum in another order)
    is relative to |proj| ~ |out - x|, which exceeds |out| where the add
    cancels (at 178 x 266 x 384 one element of 18 M: out 0.03125 = x
    4.3125 + proj -4.28125, off by one ulp of proj). Returns the scale and,
    for the log, how many elements are past the bound scaled by |out| alone,
    with the worst one's out, x, proj and error."""
    rtol, atol = TOLS["attn_tail"]
    g, w, xf = got.float(), want.float(), x.float()
    err = (g - w).abs()
    past = err > atol + rtol * w.abs()
    worst = {}
    if bool(past.any()):
        i = int((err * past).flatten().argmax())
        worst = {"out": float(w.flatten()[i]), "x": float(xf.flatten()[i]),
                 "proj": float((w - xf).flatten()[i]), "err": float(err.flatten()[i])}
    return (w - xf).abs() + xf.abs(), {"n": int(past.sum()), "worst": worst}


def kernels_stages(randn, b, stages, label, calls_key, tag=None):
    """attn_tail, groupnorm_silu (each (groups, FiLM) the evaluation uses,
    with the conv bias) and dual_head at batch b over the UNet's stages
    (H, W, C): against the plain versions, two calls bit-equal, one
    groupnorm_silu launch a call, per call and on the card's clock beside
    the bound. Rows have calls 0 (no per-evaluation sum at the canonical
    shape), `calls_key`, the calls of one evaluation at these stages, and
    `tag`'s fields; label names the shapes in the log."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        fused_attn_tail, fused_dual_head, fused_groupnorm_film_silu, reference_attn_tail,
        reference_dual_head, reference_groupnorm_film_silu)

    tag = tag or {}
    rows = {"attn_tail": [], "groupnorm_silu": [], "dual_head": []}
    for st, (h, w, c) in enumerate(stages):
        x = randn(b, h, w, c, scale=1.5, dtype=torch.bfloat16) + 0.3
        args = attn_tail_args(randn, x)
        got = fused_attn_tail(*args)
        want = reference_attn_tail(*args)
        scale, cancel = attn_tail_scale(x, want, got)
        err = compare("attn_tail", got, want, scale=scale)
        if not torch.equal(got, fused_attn_tail(*args)):
            raise AssertionError(f"attn_tail {label} {b}x{h}x{w}x{c}: two calls differ")
        del got, want, scale
        ms = time_ms(lambda: fused_attn_tail(*args), reps=5)
        dev_ms = time_device_ms(lambda: fused_attn_tail(*args), n=5)
        plain = time_ms(lambda: reference_attn_tail(*args), reps=2, warmup=1)
        b_ms, b_by = attn_tail_bound(x)
        rows["attn_tail"].append(dict(shape=[b, h, w, c], calls=0,
                                      **{calls_key: ATTN_PER_EVAL[st]}, **tag, ms=ms,
                                      device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                                      bound_by=b_by, max_abs_err=err,
                                      past_output_scale=cancel))
        log(f"  {label} attn_tail {b}x{h}x{w}x{c}: {ms:.4f} ms, dev {dev_ms:.4f} "
            f"({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; plain {plain:.4f}), max abs "
            f"err {err:.3g}, bit-equal across two calls; {cancel['n']} element(s) past atol + "
            f"rtol |out|, where the residual add cancels: {cancel['worst']}")
        del args
        xg = x.reshape(b, h * w, c)
        for gst, groups, film, count in GN_PER_EVAL:
            if gst != st:
                continue
            gamma, beta, bias = 1.0 + 0.1 * randn(c), 0.1 * randn(c), 0.3 * randn(c)
            fs = fsh = None
            if film:
                t = (0.2 * randn(b, 2 * c)).to(torch.bfloat16)
                fs, fsh = t[:, :c], t[:, c:]
            gargs = (xg, gamma, beta, fs, fsh, groups, 1e-5, bias)
            n0 = fused_groupnorm_film_silu.launches
            got = fused_groupnorm_film_silu(*gargs)
            if fused_groupnorm_film_silu.launches != n0 + 1:
                raise AssertionError(f"groupnorm_silu {label} {b}x{h * w}x{c}: more than one "
                                     "launch in a call")
            err = compare("groupnorm_silu", got, reference_groupnorm_film_silu(*gargs))
            if not torch.equal(got, fused_groupnorm_film_silu(*gargs)):
                raise AssertionError(f"groupnorm_silu {label} {b}x{h * w}x{c}: two calls differ")
            del got
            ms = time_ms(lambda: fused_groupnorm_film_silu(*gargs), reps=5)
            dev_ms = time_device_ms(lambda: fused_groupnorm_film_silu(*gargs), n=5)
            plain = time_ms(lambda: reference_groupnorm_film_silu(*gargs), reps=2, warmup=1)
            moved = 2 * nbytes(xg) + 3 * c * 4 + (2 * b * c * 2 if film else 0)
            b_ms, b_by = bound(moved, 8 * xg.numel(), PEAK_FP32_FLOPS)
            rows["groupnorm_silu"].append(dict(
                shape=[b, h * w, c], groups=groups, film=film, bias=True, calls=0,
                **{calls_key: count}, **tag, ms=ms, device_ms=dev_ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
            log(f"  {label} groupnorm_silu {b}x{h * w}x{c} G{groups} film={film}: {ms:.4f} ms, "
                f"dev {dev_ms:.4f} ({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; plain "
                f"{plain:.4f}), max abs err {err:.3g}, one launch, bit-equal across two calls")
            del gargs
        if st == 0:
            sa, sb = (randn(b, h, w, c, dtype=torch.bfloat16) for _ in range(2))
            hargs = (x, sa, sb) + head_params(randn, c)
            got = fused_dual_head(*hargs)
            err = compare("dual_head", got, reference_dual_head(*hargs))
            if not torch.equal(got, fused_dual_head(*hargs)):
                raise AssertionError(f"dual_head {label}: two calls differ")
            del got
            ms = time_ms(lambda: fused_dual_head(*hargs), reps=5)
            dev_ms = time_device_ms(lambda: fused_dual_head(*hargs), n=5)
            plain = time_ms(lambda: reference_dual_head(*hargs), reps=2, warmup=1)
            b_ms, b_by = bound(*head_work(x), PEAK_BF16_FLOPS)
            rows["dual_head"].append(dict(shape=[b, h, w, c], calls=0, **{calls_key: 1}, **tag,
                                          ms=ms, device_ms=dev_ms, plain_ms=plain,
                                          bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
            log(f"  {label} dual_head {b}x{h}x{w}x{c}: {ms:.4f} ms, dev {dev_ms:.4f} "
                f"({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; plain {plain:.4f}), max abs "
                f"err {err:.3g}, bit-equal across two calls")
            del sa, sb, hargs
        del x, xg
        torch.cuda.empty_cache()
    for name, rs in rows.items():
        dev = sum(r["device_ms"] * r[calls_key] for r in rs)
        bnd = sum(r["bound_ms"] * r[calls_key] for r in rs)
        log(f"  {name}: {dev:.4f} ms of the card's clock per {label} evaluation against a "
            f"bound of {bnd:.4f} ({dev / bnd:.2f}x)")
    return rows


def head_params(randn, c):
    """fc1 (C x C), its bias, fc2 (4 x C), its bias, final_conv (4 x C),
    its bias: the heads' parameters in fp32."""
    return (randn(c, c, scale=c ** -0.5), 0.1 * randn(c), randn(4, c, scale=c ** -0.5),
            0.1 * randn(4), randn(4, c, scale=c ** -0.5), 0.1 * randn(4))


def head_work(x, io_bytes=None):
    """The heads' bytes (x and the shot's a and b read, the parameters, and
    io_bytes: by default dual_head's 4 fp32 channels written) and
    operations over x's pixels."""
    c = x.shape[-1]
    pix = x.numel() // c
    if io_bytes is None:
        io_bytes = pix * 4 * 4
    return 3 * nbytes(x) + io_bytes + (c * c + 8 * c + c + 8) * 4, 2 * pix * (c * c + 8 * c)


# the spatial axis: the full frame's rows over 2 and 4 ranks (one process a
# card; two ranks share one card where the machine has one)
SHARDED_WORLDS = (2, 4)
# GroupNorms a sharded evaluation runs at each stage: all 44 take the
# gn_stats sums (GN_PER_STEP's count), the 42 of the kernel's route the
# apply kernel (the per-pixel-FiLM two apply in plain torch)
APPLY_PER_EVAL = {st: sum(n for s, _, _, n in GN_PER_EVAL if s == st) for st in range(4)}
# the fp32 sharded-against-one-card check: a reduced frame, DPM-2, within
# fp32 rounding through two evaluations (an off-by-one halo row moves the
# seams' rows by the size of the signal)
SHARDED_FP32_FRAME = (256, 384)
SHARDED_FP32_REL = 1e-4


def sharded_shapes():
    """(world, shard rows, stage, (h, w, c)): every shard shape of the full
    frame's four stages over SHARDED_WORLDS ranks, each distinct shard
    height once (712 over 2; 360 and 352 over 4)."""
    from noisediff_tpu_torch.parallel.mesh import split_rows

    return [(world, rows, st, (rows >> st, FULLFRAME[1] >> st, DIM << st))
            for world in SHARDED_WORLDS
            for rows in sorted(set(split_rows(FULLFRAME[0], world)), reverse=True)
            for st in range(4)]


def kernels_sharded(randn):
    """The spatially sharded GroupNorm's two kernels at every shard shape
    (`sharded_shapes`: 712 x 2128 x 48 .. 44 x 266 x 384): gn_stats (the
    shard's sums, which the model all-reduces) and groupnorm_silu_apply
    (silu(x a + bb) from given fp32 coefficients) against their plain
    versions, the apply kernel one launch a call and bit-equal across two
    calls (and whether to the plain version), per call and on the card's
    clock beside the bound. Rows carry `sharded_calls`, the calls of one
    sharded full-frame evaluation on a rank of 2 (0 for the 4-rank shapes);
    the apply rows have it as `calls` too (its `ms` is per such
    evaluation), the gn_stats rows calls 0 (its `ms` is per training step)."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        gn_stats, groupnorm_silu_apply, reference_gn_stats, reference_groupnorm_silu_apply)

    rows = {"groupnorm_silu_apply": [], "gn_stats": []}
    for world, n, st, (h, w, c) in sharded_shapes():
        first = world == SHARDED_WORLDS[0]
        x = randn(1, h, w, c, scale=1.5, dtype=torch.bfloat16) + 0.3
        got, want = gn_stats(x), reference_gn_stats(x)
        err = max(compare_scaled("gn_stats", a, b, SUM_RTOL) for a, b in zip(got, want))
        ms = time_ms(lambda: gn_stats(x), reps=5)
        dev_ms = time_device_ms(lambda: gn_stats(x), n=5)
        plain = time_ms(lambda: reference_gn_stats(x), reps=2, warmup=1)
        b_ms, b_by = bound(nbytes(x) + 2 * c * 4, 3 * x.numel(), PEAK_FP32_FLOPS)
        rows["gn_stats"].append(dict(shape=[1, h, w, c], world=world, calls=0,
                                     sharded_calls=GN_PER_STEP[st] if first else 0, ms=ms,
                                     device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                                     bound_by=b_by, max_abs_err=err))
        log(f"  sharded gn_stats 1x{h}x{w}x{c} (a shard of {n} rows over {world}): {ms:.4f} ms, "
            f"dev {dev_ms:.4f} ({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; plain "
            f"{plain:.4f}), max abs err {err:.3g}")

        xg = x.view(1, h * w, c)
        a, bb = 1.0 + 0.2 * randn(1, c), 0.3 * randn(1, c)
        n0 = groupnorm_silu_apply.launches
        got = groupnorm_silu_apply(xg, a, bb)
        if groupnorm_silu_apply.launches != n0 + 1:
            raise AssertionError(f"groupnorm_silu_apply 1x{h * w}x{c}: not one launch a call")
        want = reference_groupnorm_silu_apply(xg, a, bb)
        err = compare("groupnorm_silu", got, want)
        equal = bool(torch.equal(got, want))
        if not torch.equal(got, groupnorm_silu_apply(xg, a, bb)):
            raise AssertionError(f"groupnorm_silu_apply 1x{h * w}x{c}: two calls differ")
        del got, want
        ms = time_ms(lambda: groupnorm_silu_apply(xg, a, bb), reps=5)
        dev_ms = time_device_ms(lambda: groupnorm_silu_apply(xg, a, bb), n=5)
        plain = time_ms(lambda: reference_groupnorm_silu_apply(xg, a, bb), reps=2, warmup=1)
        b_ms, b_by = bound(2 * nbytes(xg) + 2 * c * 4, 5 * xg.numel(), PEAK_FP32_FLOPS)
        calls = APPLY_PER_EVAL[st] if first else 0
        rows["groupnorm_silu_apply"].append(dict(
            shape=[1, h * w, c], world=world, calls=calls, sharded_calls=calls, ms=ms,
            device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            equal_to_plain=equal))
        log(f"  groupnorm_silu_apply 1x{h * w}x{c} (a shard of {n} rows over {world}): "
            f"{ms:.4f} ms, dev {dev_ms:.4f} ({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; "
            f"plain {plain:.4f}), max abs err {err:.3g}, "
            f"{'bit-equal to the plain version' if equal else 'not bit-equal to the plain version'}"
            ", one launch, bit-equal across two calls")
        del x, xg
        torch.cuda.empty_cache()
    for name, rs in rows.items():
        dev = sum(r["device_ms"] * r["sharded_calls"] for r in rs)
        bnd = sum(r["bound_ms"] * r["sharded_calls"] for r in rs)
        log(f"  {name}: {dev:.4f} ms of the card's clock per sharded full-frame evaluation (a "
            f"rank of {SHARDED_WORLDS[0]}) against a bound of {bnd:.4f} ({dev / bnd:.2f}x)")
    return rows


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


def _device_events(prof):
    """The profile's device kernels and copies: its CUDA events other than
    the device spans of record_function ranges (the optimizer's
    'Optimizer.step#Adam.step', whose kernels have events of their own)."""
    return [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]


def _device_ms_by_name(prof, n: int):
    by_name = {}
    for e in _device_events(prof):
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


def _check_grads(what, b, s, loss, grads, loss16, g16, g32, model="dim-48"):
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
    log(f"  {what}: {model} train step {b}x{s}^2: loss card {loss:.6f}, CPU bf16 {loss16:.6f}; "
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


def train_cli(seed: int, workdir: str, out_name: str, per_step, what: str,
              net_name: str = "NoiseDiffNet"):
    """One training run of `net_name` through the CLI over the tree in
    workdir, counted from zero: losses, each kernel's launches per step,
    and the rate over the window after the first 3 steps on the device's
    clock from the end of step 3 to the end of the last (loader waits and
    uploads fall in between)."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli import train_diffusion
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    out = os.path.join(workdir, out_name)
    argv = train_argv(seed, workdir, out, net_name)
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


def make_sid_tree(root: str, seed: int, batches: int = N_BATCHES) -> None:
    """A miniature SID tree: clean Bayer frames of 1280^2 (packed 640^2,
    whose patch grid has 4 distinct 512^2 origins) for `batches` batches,
    and one ISO800 x250 training pair."""
    import numpy as np

    rng = np.random.default_rng(seed)
    long_dir = os.path.join(root, "SID", "Sony", "long")
    os.makedirs(long_dir)
    for i in range(batches * BATCH // 4):
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


def gen_argv(workdir: str, ckpt: str, seed: int, out: str, sampler,
             net_name: str = "NoiseDiffNet"):
    return [
        "--name", "ISO800_Ratio250", "--resume", ckpt, "--generation_result", "noise",
        "--testset", "NoiseImageGenerationDataset", "--save_npy", "--random_seed", str(seed),
        "--beta_schedule", "sigmoid2", "--batch_size", str(BATCH), "--net_name", net_name,
        "--positional_encoding", "--dim", str(DIM), "--crop_size", str(CROP),
        "--with_camera_settings", *sampler,
        "--device", "cuda", "--num_workers", "2", "--iso", "800", "--ratio", "250",
        "--sid_folder", os.path.join(workdir, "SID"), "--pretrained_dir", workdir,
        "--save_folder", os.path.join(workdir, out),
    ]


def run_generation(argv, per_batch, what: str, batches: int = N_BATCHES):
    """One generation run through the CLI over a tree of `batches` batches,
    counted from zero: the npy contract and each kernel's launches per
    batch; returns the summary, the counts and the files."""
    import numpy as np

    from noisediff_tpu_torch.cli import test_diffusion
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    summary = test_diffusion.main(argv)
    counts = launch_counts()

    n = summary["generated"]
    if n != batches * BATCH or summary["batches"] != batches:
        raise AssertionError(f"{what}: expected {batches} batches of {BATCH} patches: {summary}")
    for name, want in per_batch.items():
        if counts[name] != want * batches:
            raise AssertionError(f"{what}: {name}: {counts[name]} launches, expected {want} per "
                                 f"batch x {batches} batches")
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
    # with one batch there is no batch after the first
    steady = BATCH * (len(secs) - 1) / sum(secs[1:]) if len(secs) > 1 else None
    after = f"{steady:.4f} after the first batch" if steady else "one batch"
    log(f"  generated {n} patches of {CROP}^2 in {sum(secs):.3f} s of sampling: "
        f"{rate:.4f} patches/s ({after}); batch seconds {[round(s, 4) for s in secs]}")
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
# the denoising stage at script.sh:24's config: LSID (base width 32), crop
# 256, batch 4, over the main phase's 8 generated 512^2 patches: 2 steps an
# epoch, 13 epochs (the LR staircase changes after epochs 6 and 10)
DENOISE_BATCH, DENOISE_CROP, DENOISE_EPOCHS = 4, 256, 13
DENOISE_SAVE_FREQ = 6
DENOISE_PROFILE_STEPS = 8
# denoise_check: one LSID step (B 2, 256^2, L1, flip and SNA off). fp32 on
# the card against fp32 on the CPU with TF32 off: the loss within
# DENOISE_FP32_LOSS and each gradient within DENOISE_FP32_GRAD relative L2
# (sums in another order through 23 convolutions forward and back); bf16 on
# the card: _check_grads' bounds (the loss within 2e-2 of the CPU's bf16
# one, each gradient as close to the CPU's fp32 one as the CPU's bf16
# gradient is, within 2x + 0.02, all within 5e-2 of the CPU's bf16 ones)
DENOISE_FP32_LOSS = 1e-5
DENOISE_FP32_GRAD = 1e-3
# SNA's Poisson draw on the card, each channel's mean and variance within
# this many standard errors of lam
POISSON_SE = 5.0


def make_denoise_resources(root: str, seed: int, size=(2 * FRAME, 2 * FRAME),
                           dtype: str = "float32") -> str:
    """PMN dark-shading resources at a Bayer frame size (the smoke tree's
    2 FRAME square by default), in PMN's format: darkshading_{high,low}
    ISO_{k,b}.npy of `dtype` and darkshading_BLE.pkl keyed by ISO; returns
    their directory."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed + 2)
    res = os.path.join(root, "resources")
    os.makedirs(res)
    for band in ("low", "high"):
        np.save(os.path.join(res, f"darkshading_{band}ISO_k.npy"),
                rng.normal(0, 1e-3, size).astype(dtype))
        np.save(os.path.join(res, f"darkshading_{band}ISO_b.npy"),
                rng.normal(0, 2.0, size).astype(dtype))
    with open(os.path.join(res, "darkshading_BLE.pkl"), "wb") as f:
        pickle.dump({800: 0.3}, f)
    return res


def check_poisson_on_card():
    """torch.poisson on the card (SNA's draw) at a fixed lam field: every
    draw an integer, each channel's mean and variance within POISSON_SE
    standard errors of lam; then apply_sna's noisy increment on the card
    lies on the lattice K * ratio / (WP - BL)."""
    import torch

    from noisediff_tpu_torch.ops import sna

    dev = torch.device("cuda")
    lam = torch.tensor([0.5, 3.0, 40.0, 900.0], device=dev)
    draws = torch.poisson(lam.expand(1024, 1024, 4).contiguous(),
                          generator=torch.Generator(device=dev).manual_seed(0))
    d = draws.reshape(-1, 4).double()
    n, lam = d.shape[0], lam.double()
    mean_z = ((d.mean(0) - lam) / (lam / n).sqrt()).abs()
    var_z = ((d.var(0) - lam) / (lam * ((2 + 1 / lam) / n).sqrt())).abs()
    log(f"  torch.poisson on the card, lam {lam.tolist()}: |mean - lam| "
        f"{[round(v, 3) for v in mean_z.tolist()]} and |var - lam| "
        f"{[round(v, 3) for v in var_z.tolist()]} standard errors ({n} draws each)")
    if not bool((d == d.round()).all()) or bool((mean_z > POISSON_SE).any()) or bool(
            (var_z > POISSON_SE).any()):
        raise AssertionError("torch.poisson on the card does not have Poisson moments")

    g = torch.Generator(device=dev).manual_seed(1)
    clean = 0.2 * torch.rand((2, 64, 64, 4), device=dev, generator=g)
    noisy = clean + 0.01
    iso, ratio = torch.tensor([800, 800], device=dev), torch.tensor([250.0, 100.0], device=dev)
    wb = torch.tensor([[0.5, 0.25, 0.4, 0.25], [0.0, 0.0, 0.0, 0.0]], device=dev)
    out, clean2 = sna.apply_sna(torch.Generator(device=dev).manual_seed(2), noisy, clean, iso,
                                ratio, wb)
    k = sna.kmax_for_iso(iso, sna.draw_jitter(torch.Generator(device=dev).manual_seed(2), 2))
    unit = float(k[0] * ratio[0] / (sna.WP - sna.BL))
    steps = ((out[0].double() - noisy[0].double()) / unit)
    off = float((steps - steps.round()).abs().max())
    if off > 1e-2 or not torch.equal(out[1], noisy[1]) or not torch.equal(clean2[1], clean[1]):
        raise AssertionError(f"apply_sna on the card: increment off the lattice by {off}, or a "
                             "sample without gains changed")
    log(f"  apply_sna on the card: increments on the lattice (max {off:.2e} off), mean "
        f"{float(steps.mean()):.3f} units; the sample without gains passes through bit for bit")


def _lsid_step(dtype, dev, sd, batch):
    import torch

    from noisediff_tpu_torch.models import LSID
    from noisediff_tpu_torch.train.state import make_denoising_train_step, make_optimizer

    model = LSID(dtype=dtype)
    model.load_state_dict(sd)
    model = model.to(dev, memory_format=torch.channels_last).train()
    step = make_denoising_train_step(model, make_optimizer(model.parameters(), lr=2e-4),
                                     augment_flip=False, use_sna=False)
    metrics = step({k: v.to(dev) for k, v in batch.items()}, torch.Generator(device=dev))
    return float(metrics["loss_sum"]), {n: p.grad.float().cpu()
                                        for n, p in model.named_parameters()}


def phase_denoise_check(seed: int):
    """One LSID training step from make_denoising_train_step (flip and SNA
    off) at B 2, 256^2 on the card against the same step on the CPU, in
    fp32 on both and in bf16 on the card (DENOISE_* bounds)."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.models import LSID
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.manual_seed(seed)
    sd = LSID().state_dict()
    rng = np.random.default_rng(seed)
    b, s = 2, DENOISE_CROP
    clean = rng.uniform(0, 0.4, (b, s, s, 4)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.05, clean.shape), 0, 1).astype(np.float32)
    batch = {"noisy_img": torch.from_numpy(noisy), "clean_img": torch.from_numpy(clean),
             "iso": torch.tensor([800, 800]), "ratio": torch.tensor([250.0, 250.0])}
    cpu, card = torch.device("cpu"), torch.device("cuda")
    loss32, g32 = _lsid_step(None, cpu, sd, batch)
    loss16, g16 = _lsid_step(torch.bfloat16, cpu, sd, batch)
    reset_launch_counts()
    loss_c32, gc32 = _lsid_step(None, card, sd, batch)
    loss_c16, gc16 = _lsid_step(torch.bfloat16, card, sd, batch)
    if any(launch_counts().values()):
        raise AssertionError(f"denoise_check: a kernel of the port ran: {launch_counts()}")
    worst32 = max((rel_l2(gc32[n], g32[n]), n) for n in g32)
    log(f"  fp32: loss card {loss_c32:.7f}, CPU {loss32:.7f}; worst parameter gradient rel L2 "
        f"{worst32[0]:.3g} ({worst32[1]}); bounds {DENOISE_FP32_LOSS} relative on the loss, "
        f"{DENOISE_FP32_GRAD} per gradient")
    if abs(loss_c32 - loss32) > DENOISE_FP32_LOSS * abs(loss32) or worst32[0] > DENOISE_FP32_GRAD:
        raise AssertionError(f"denoise_check: fp32 step disagrees with the CPU: {worst32}")
    out = _check_grads("denoise_check bf16", b, s, loss_c16, gc16, loss16, g16, g32, "LSID")
    out.update(loss_card_fp32=loss_c32, loss_cpu_fp32=loss32, loss_card_bf16=loss_c16,
               loss_cpu_bf16=loss16, worst_fp32=worst32)

    # the opt-in conv_wgrad route (NOISEDIFF_WGRAD=pallas), as the JAX
    # model's convs take it: against the CPU's steps and the cuDNN-wgrad step
    os.environ["NOISEDIFF_WGRAD"] = "pallas"
    try:
        loss_w, gw = _lsid_step(torch.bfloat16, card, sd, batch)
    finally:
        del os.environ["NOISEDIFF_WGRAD"]
    routed = launch_counts()["conv_wgrad"]
    if routed == 0:
        raise AssertionError("denoise_check: no conv_wgrad launch under NOISEDIFF_WGRAD=pallas")
    out["wgrad"] = _check_grads("denoise_check wgrad", b, s, loss_w, gw, loss16, g16, g32, "LSID")
    worst = max((rel_l2(gw[n], gc16[n]), n) for n in gw)
    log(f"  with NOISEDIFF_WGRAD=pallas ({routed} conv_wgrad launches): worst parameter "
        f"gradient vs the cuDNN-wgrad step rel L2 {worst[0]:.4g} ({worst[1]})")
    if worst[0] > GRAD_REL:
        raise AssertionError(f"denoise_check: conv_wgrad gradients disagree with cuDNN's: {worst}")
    return out


def phase_denoise(seed: int, workdir: str, gen_dir: str):
    """Stage 2 of the pipeline on the card: LSID trained through the
    denoising CLI at script.sh:24's config on the main phase's own
    generated patches (linked into <synthetic>/ISO800_Ratio250), the dark
    shading subtracted with resources made from the seed."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli import train_denoising
    from noisediff_tpu_torch.models import LSID
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    files = sorted(glob.glob(os.path.join(gen_dir, "*.npy")))
    if len(files) != N_BATCHES * BATCH:
        raise AssertionError(f"denoise: {len(files)} generated patches, expected "
                             f"{N_BATCHES * BATCH}")
    synth = os.path.join(workdir, "synthetic", "ISO800_Ratio250")
    os.makedirs(synth)
    for f in files:
        os.link(f, os.path.join(synth, os.path.basename(f)))
    res = make_denoise_resources(workdir, seed)
    out = os.path.join(workdir, "denoise", "weights")
    argv = [
        "--loss_l1", "--crop_size", str(DENOISE_CROP), "--sub_darkshading", "--use_sna",
        "--trainset", "SyntheticNoisDiffDenoisingDataset", "--batch_size", str(DENOISE_BATCH),
        "--net_name", "LSID", "--name", "train_denoising", "--max_iter", str(DENOISE_EPOCHS),
        "--save_epoch_freq", str(DENOISE_SAVE_FREQ), "--random_seed", str(seed),
        "--device", "cuda", "--num_workers", "4", "--sid_folder", os.path.join(workdir, "SID"),
        "--synthetic_folder", os.path.dirname(synth), "--resources_path", res,
        "--save_folder", out,
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    summary = train_denoising.main(argv)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    per_epoch = len(files) // DENOISE_BATCH
    steps = summary["steps"]
    if steps != per_epoch * DENOISE_EPOCHS or not all(np.isfinite(summary["losses"])):
        raise AssertionError(f"denoise: {steps} steps, losses {summary['losses']}")
    if any(counts.values()):
        raise AssertionError(f"denoise: a kernel of the port ran on the LSID path: {counts}")
    snap = os.path.join(out, "train_denoising", "snapshot")
    want = {f"{c}_{e}.pth" for c in ("net", "optimizer_G")
            for e in range(0, DENOISE_EPOCHS, DENOISE_SAVE_FREQ)} | {"net_final.pth"}
    if set(os.listdir(snap)) != want:
        raise AssertionError(f"denoise: snapshots {sorted(os.listdir(snap))}")
    LSID().load_state_dict(torch.load(os.path.join(snap, "net_final.pth"), map_location="cpu",
                                      weights_only=True), strict=True)
    # the card's clock: from the end of each step to the end of the next one
    # in the same epoch (the loader wait and upload between them included),
    # from the end of the third step on; and each step from its start mark
    # (before its upload) to its end
    ends, secs = summary["step_end_seconds"], summary["step_seconds"]
    gaps = [ends[i + 1] - ends[i] for i in range(2, steps - 1) if (i + 1) % per_epoch]
    period = float(np.mean(gaps))
    step_s = float(np.mean(secs[3:]))
    wall = summary["epoch_seconds"]
    log(f"  {steps} steps ({DENOISE_EPOCHS} epochs of {per_epoch}) on {len(files)} generated "
        f"patches, losses {summary['losses'][0]:.5f} -> {summary['losses'][-1]:.5f}")
    log(f"  after the first 3 steps, on the card's clock: {1 / period:.4f} steps/s, "
        f"{DENOISE_BATCH / period:.4f} samples/s (end to end within an epoch, loader wait and "
        f"upload included: {period * 1e3:.4f} ms); step start to end {step_s * 1e3:.4f} ms")
    log(f"  epoch wall seconds (loader start-up, the epoch's sync and snapshots included): "
        f"first {wall[0]:.4f}, median {statistics.median(wall):.4f}; the whole run "
        f"{sum(wall):.4f} s, {steps / sum(wall):.4f} steps/s; host time waiting for the "
        f"loader {sum(summary['loader_wait_seconds']):.4f} s over the run")
    log(f"  peak device memory {peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated); "
        f"snapshots {sorted(want)}; net_final.pth loads into LSID strictly; no kernel launched")
    # what one item costs the host, in one thread (clean frames cached)
    from noisediff_tpu_torch.data.datasets import DataPaths, SyntheticNoisDiffDenoisingDataset

    ds = SyntheticNoisDiffDenoisingDataset(
        DataPaths(data_folder=os.path.join(workdir, "SID"), synthetic_folder=os.path.dirname(synth),
                  resources_path=res), DENOISE_CROP, sub_darkshading=True, seed=seed)
    for i in range(len(ds)):
        ds[i]
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    item_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
    log(f"  one item of the dataset on the host, one thread: {item_ms:.4f} ms")
    return dict(steps=steps, period_ms=period * 1e3, steps_per_s=1 / period,
                samples_per_s=DENOISE_BATCH / period, run_steps_per_s=steps / sum(wall),
                item_ms=item_ms,
                step_ms=step_s * 1e3, peak_bytes=peak, losses=summary["losses"],
                epoch_seconds=wall, argv=argv, snapshots=sorted(want))


def phase_denoise_profile(seed: int, cli_period_ms: float):
    """One denoising step at script.sh:24's shape (LSID bf16, B 4, 256^2,
    flip and SNA on, L1, Adam), the batch on the card: the period over
    DENOISE_PROFILE_STEPS steps with no host sync, the device busy time by
    kernel class (torch.profiler) and the idle share."""
    import torch

    from noisediff_tpu_torch.models import LSID
    from noisediff_tpu_torch.train.state import make_denoising_train_step, make_optimizer

    torch.manual_seed(seed)
    dev = torch.device("cuda")
    model = LSID(dtype=torch.bfloat16).to(dev, memory_format=torch.channels_last).train()
    step = make_denoising_train_step(model, make_optimizer(model.parameters(), lr=2e-4),
                                     use_sna=True)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (DENOISE_BATCH, DENOISE_CROP, DENOISE_CROP, 4)
    clean = 0.3 * torch.rand(shape, generator=g, device=dev)
    batch = {"clean_img": clean, "noisy_img": (clean + 0.02 * torch.randn(
        shape, generator=g, device=dev)).clamp(0, 1),
        "iso": torch.full((DENOISE_BATCH,), 800, device=dev),
        "ratio": torch.full((DENOISE_BATCH,), 250.0, device=dev)}
    for _ in range(3):
        step(batch, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DENOISE_PROFILE_STEPS):
        step(batch, g)
    torch.cuda.synchronize()
    period = (time.perf_counter() - t0) * 1e3 / DENOISE_PROFILE_STEPS
    # the host's time for one step queued behind a sleep of ~1 s: a step
    # that waited for the card anywhere would wait for the sleep. One step
    # only: a few steps' ~400 launches each fill the launch queue, which
    # then holds the host back without any synchronisation
    torch.cuda._sleep(2_000_000_000)
    t0 = time.perf_counter()
    step(batch, g)
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    log(f"  host time of one step with the card kept busy: {host:.4f} ms")
    if host > 500:
        raise AssertionError(f"denoise profile: the step waits for the card ({host} ms)")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(DENOISE_PROFILE_STEPS):
            step(batch, g)
        torch.cuda.synchronize()
    by_name = _device_ms_by_name(prof, DENOISE_PROFILE_STEPS)
    busy = sum(by_name.values())
    kernels = sum(e.count for e in _device_events(prof)) / DENOISE_PROFILE_STEPS
    # CUDA runtime calls inside the steps that would wait for the card (the
    # device-wide synchronize after them, and the profiler's own, aside)
    waits = {e.key: e.count for e in prof.key_averages() if e.key in (
        "cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy")}
    if waits:
        raise AssertionError(f"denoise profile: runtime calls that wait for the card: {waits}")
    log(f"  one step ({DENOISE_BATCH}x{DENOISE_CROP}^2, LSID bf16, SNA, Adam), batch on the "
        f"card, no sync: {period:.4f} ms per step over {DENOISE_PROFILE_STEPS} steps "
        f"({kernels:g} device kernels and copies a step, {1e3 * period / max(kernels, 1):.2f} "
        f"us of host time each; no runtime call inside the steps waits for the card); the CLI "
        f"run: {cli_period_ms:.4f}")
    if not by_name:
        log("  torch.profiler recorded no device time")
        return dict(period_ms=period, host_ms=host)
    log(f"  device busy {busy:.4f} ms per step (torch.profiler); idle share: batch on the card "
        f"{max(0.0, 1 - busy / period):.4f}, CLI {max(0.0, 1 - busy / cli_period_ms):.4f}")
    cats = {}
    for name, ms in by_name.items():
        cats[_category(name)] = cats.get(_category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.4f} ms  {100 * ms / busy:5.1f}%  {cat}")
    log("  top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {ms:9.4f} ms  {name[:110]}")
    return dict(period_ms=period, host_ms=host, busy_ms=busy, categories=cats, kernels=kernels)


# the evaluation: 4 SID test pairs at the Sony Bayer size, ISO800 x250
EVAL_PAIRS, EVAL_RATIO = 4, 250
# the first frame on the card against the CPU (fp32 on both, TF32 off):
# PSNR within EVAL_PSNR dB, SSIM within EVAL_SSIM, the output frame within
# EVAL_OUT relative L2 (sums of 12.1 M values and 23 convolutions in
# another order; fp32 rounding moves them ~1e-6)
EVAL_PSNR, EVAL_SSIM, EVAL_OUT = 1e-3, 1e-5, 1e-4
EVAL_KLD_KEYS = {"iso", "ratio", "kld_forward", "kld_inverse", "kld_symmetric", "n_real",
                 "n_synth"}
# full-frame generation: DPM-10 on the lambda grid, and DPM-2 for the
# bf16-against-fp32 check
FULLFRAME_STEPS, FULLFRAME_CHECK_STEPS = 10, 2


def make_eval_tree(root: str, seed: int) -> str:
    """A SID test tree at Sony's Bayer size: EVAL_PAIRS ISO800 x250 pairs
    (a smooth textured clean frame; the short exposure it over the ratio
    with Poisson shot noise and read noise) as .npy sidecars, in
    Sony_test_list.txt and Sony_train_list.txt; returns the SID folder."""
    import numpy as np

    rng = np.random.default_rng(seed + 3)
    sid = os.path.join(root, "SID")
    for sub in ("short", "long"):
        os.makedirs(os.path.join(sid, "Sony", sub))
    h, w = SID_BAYER
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    lines = []
    for i in range(1, EVAL_PAIRS + 1):
        in_fn, gt_fn = f"{i:05d}_00_0.04s.ARW", f"{i:05d}_00_10s.ARW"
        clean = (0.05 + 0.5 * (0.5 + 0.5 * np.sin(4 * i * xx + 3 * yy))
                 * rng.uniform(0.6, 1.0, (h, w)).astype(np.float32))
        long_dn = 512 + clean * 15871
        short = (512 + rng.poisson(clean * (15871 / EVAL_RATIO))
                 + rng.normal(0, 3.0, (h, w)).astype(np.float32))
        np.save(os.path.join(sid, "Sony", "short", in_fn + ".npy"),
                np.clip(short, 0, 16383).astype(np.uint16))
        np.save(os.path.join(sid, "Sony", "long", gt_fn + ".npy"),
                np.clip(long_dn, 0, 16383).astype(np.uint16))
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO800 F1.8\n")
    for name in ("Sony_test_list.txt", "Sony_train_list.txt"):
        with open(os.path.join(sid, name), "w") as f:
            f.write("".join(lines))
    with open(os.path.join(sid, "Sony_test_first.txt"), "w") as f:
        f.write(lines[0])
    return sid


def phase_evaluate(seed: int, workdir: str, net_final: str):
    """The denoiser's evaluation through the port's test_denoising CLI on
    the card: the denoise phase's net_final over EVAL_PAIRS full SID frames
    (2848 x 4256 Bayer, 1424 x 2128 x 4 packed) with the dark shading and
    the illuminance correction; no kernel of the port launches; the first
    frame against the same CLI on the CPU (EVAL_* bounds)."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli import test_denoising
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    root = os.path.join(workdir, "eval")
    t0 = time.perf_counter()
    sid = make_eval_tree(root, seed)
    # float64 maps: the evaluation takes the dark shading as float32, as
    # the JAX package does
    res = make_denoise_resources(root, seed, SID_BAYER, "float64")
    log(f"  made {EVAL_PAIRS} SID test pairs of {SID_BAYER[0]}x{SID_BAYER[1]} and their dark "
        f"shading in {time.perf_counter() - t0:.1f} s")
    try:
        import PIL  # noqa: F401

        visual = ["--visualize_img"]
    except ImportError:
        visual = []
    argv = ["--resume", net_final, "--ratio", str(EVAL_RATIO), "--correct_darkshading",
            "--correct_illum", "--sid_folder", sid, "--resources_path", res,
            "--save_folder", os.path.join(root, "out")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = test_denoising.main(argv + visual + ["--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if out["n"] != EVAL_PAIRS or not np.isfinite([out["PSNR"], out["SSIM"]]).all():
        raise AssertionError(f"evaluate: {out['n']} frames, PSNR {out['PSNR']}, SSIM "
                             f"{out['SSIM']}")
    if any(counts.values()):
        raise AssertionError(f"evaluate: a kernel of the port ran on the LSID path: {counts}")
    if visual and len(glob.glob(os.path.join(root, "out", "*_output.png"))) != EVAL_PAIRS:
        raise AssertionError("evaluate: --visualize_img did not write a PNG a frame")
    frames = out["frames"]
    parts = {k: [f[k] for f in frames] for k in ("decode_s", "upload_s", "forward_s",
                                                 "metrics_s", "visual_s", "frame_s")}
    later = sum(parts["frame_s"][1:])
    steady = (EVAL_PAIRS - 1) / later
    unwritten = (EVAL_PAIRS - 1) / (later - sum(parts["visual_s"][1:]))
    log(f"  {out['n']} frames through the CLI ({'with' if visual else 'without'} "
        f"--visualize_img: PIL {'imports' if visual else 'is absent'}): mean PSNR "
        f"{out['PSNR']:.4f}, SSIM {out['SSIM']:.5f}; {out['n'] / out['seconds']:.4f} frames/s "
        f"over the loop ({out['seconds']:.3f} s), {out['n'] / wall:.4f} over the CLI call "
        f"({wall:.3f} s, the model's build and load included); after the first frame "
        f"{steady:.4f} frames/s, {unwritten:.4f} without the PNGs' writes; no kernel launched")
    for k, v in parts.items():
        log(f"    {k}: first frame {v[0] * 1e3:.4f} ms, later frames "
            f"{[round(x * 1e3, 4) for x in v[1:]]} ms ("
            f"{'card' if k in ('upload_s', 'forward_s', 'metrics_s') else 'host'} clock)")
    log(f"  peak device memory {peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated)")

    first = argv + ["--test_list", os.path.join(sid, "Sony_test_first.txt")]
    card = test_denoising.evaluate(test_denoising.build_parser().parse_args(
        first + ["--device", "cuda"]), keep=1)
    t0 = time.perf_counter()
    cpu = test_denoising.evaluate(test_denoising.build_parser().parse_args(
        first + ["--device", "cpu"]), keep=1)
    cpu_s = time.perf_counter() - t0
    a, b = card["outputs"][0], cpu["outputs"][0]
    rel = float(np.linalg.norm(a.astype(np.float64) - b) / np.linalg.norm(b.astype(np.float64)))
    d_psnr = abs(frames[0]["PSNR"] - cpu["frames"][0]["PSNR"])
    d_ssim = abs(frames[0]["SSIM"] - cpu["frames"][0]["SSIM"])
    c0 = cpu["frames"][0]
    log(f"  first frame, card vs CPU (fp32, TF32 off): PSNR {frames[0]['PSNR']:.6f} / "
        f"{c0['PSNR']:.6f} (|d| {d_psnr:.3g} dB), SSIM {frames[0]['SSIM']:.7f} / "
        f"{c0['SSIM']:.7f} (|d| {d_ssim:.3g}), output frame rel L2 {rel:.3g}; bounds "
        f"{EVAL_PSNR} dB, {EVAL_SSIM}, {EVAL_OUT}")
    log(f"  the CPU: {cpu_s:.3f} s for the frame ({c0['decode_s']:.4f} s decode, "
        f"{c0['forward_s']:.4f} s packing and forward, {c0['metrics_s']:.4f} s metrics)")
    if a.shape != (FULLFRAME[0], FULLFRAME[1], 4) or d_psnr > EVAL_PSNR or \
            d_ssim > EVAL_SSIM or rel > EVAL_OUT:
        raise AssertionError(f"evaluate: the card's first frame disagrees with the CPU's: "
                             f"{a.shape}, PSNR {d_psnr}, SSIM {d_ssim}, rel L2 {rel}")
    return dict(n=out["n"], psnr=out["PSNR"], ssim=out["SSIM"], first=first,
                save_folder=os.path.join(root, "out"), first_frame=card["frames"][0],
                first_output=a, frames_per_s=out["n"] / out["seconds"],
                cli_frames_per_s=out["n"] / wall,
                steady_frames_per_s=steady, steady_frames_per_s_without_png=unwritten,
                parts=parts, peak_bytes=peak, cpu_seconds=cpu_s, cpu_frame=c0,
                d_psnr=d_psnr, d_ssim=d_ssim, out_rel_l2=rel, sid=sid)


def phase_kld(sid: str, gen_dir: str):
    """The port's eval_kld CLI: the main phase's generated patches against
    the evaluation tree's real ISO800 x250 pairs; three finite,
    non-negative KLDs under the JAX CLI's keys."""
    import numpy as np

    from noisediff_tpu_torch.cli import eval_kld

    t0 = time.perf_counter()
    out = eval_kld.main(["--iso", "800", "--ratio", str(EVAL_RATIO), "--generated", gen_dir,
                         "--sid_folder", sid])
    secs = time.perf_counter() - t0
    klds = [out[k] for k in ("kld_forward", "kld_inverse", "kld_symmetric")]
    want_synth = N_BATCHES * BATCH * 4 * CROP * CROP
    if set(out) != EVAL_KLD_KEYS or not np.isfinite(klds).all() or min(klds) < 0 or \
            out["n_synth"] != want_synth:
        raise AssertionError(f"kld: {out}")
    log(f"  KLD forward {klds[0]:.5f}, inverse {klds[1]:.5f}, symmetric {klds[2]:.5f} "
        f"({out['n_real']} real and {out['n_synth']} generated values; {secs:.2f} s on the host)")
    return out


@contextlib.contextmanager
def plain_route():
    """Every block built inside runs its plain version: the kernels' width
    rule answers no (`models.blocks._WIDTH_OK`)."""
    from noisediff_tpu_torch.models import blocks

    saved = dict(blocks._WIDTH_OK)
    blocks._WIDTH_OK.update({k: (lambda c: False) for k in saved})
    try:
        yield
    finally:
        blocks._WIDTH_OK.update(saved)


def phase_fullframe(seed: int, ckpt: str, sid: str):
    """Full-frame generation (diffusion/fullframe.generate_full_frame) on
    the card: the gen_setup weights (dim 48, bf16 through the kernels),
    DPM-10 on the lambda grid over the whole packed frame of the evaluation
    tree's first clean frame (B 1, 1424 x 2128 x 4); shape, finite values,
    each kernel's launches per evaluation x 10; then DPM-2 from one initial
    noise through the kernels, on the plain route in bf16 and on the plain
    route in fp32."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.data.datasets import iso_ratio_index
    from noisediff_tpu_torch.data.raw_host import load_packed_frame
    from noisediff_tpu_torch.diffusion.fullframe import generate_full_frame
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.weights import load_into

    dev = torch.device("cuda")
    clean = load_packed_frame(os.path.join(sid, "Sony", "long", "00001_00_10s.ARW"))
    idx = iso_ratio_index(800, EVAL_RATIO)
    schedule = make_schedule("sigmoid2", 1000)

    def diffusion(dtype):
        model = NoiseDiffNet(dim=DIM, dtype=dtype)
        load_into(model, ckpt)
        model = model.to(dev, memory_format=torch.channels_last).eval()
        return GaussianDiffusion(model, schedule, image_size=FULLFRAME[0], device=dev)

    gd = diffusion(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, *FULLFRAME, 4), generator=g, device=dev)
    generate_full_frame(gd, clean, idx, sampling_timesteps=1, init_noise=x)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = generate_full_frame(gd, clean, idx, sampler="dpm", sampling_timesteps=FULLFRAME_STEPS,
                              dpm_spacing="lambda", init_noise=x)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (*FULLFRAME, 4) or not np.isfinite(out).all():
        raise AssertionError(f"fullframe: output {out.shape} or not finite")
    want = {"fused_attn_tail": 9, "fused_groupnorm_film_silu": 42, "fused_dual_head": 1}
    for name, per_eval in want.items():
        if counts[name] != per_eval * FULLFRAME_STEPS:
            raise AssertionError(f"fullframe: {name}: {counts[name]} launches, expected "
                                 f"{per_eval} per evaluation x {FULLFRAME_STEPS}")
    if any(v for k, v in counts.items() if k not in want):
        raise AssertionError(f"fullframe: launches {counts}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:  # a short sample, per evaluation
        generate_full_frame(gd, clean, idx, sampling_timesteps=FULLFRAME_CHECK_STEPS,
                            init_noise=x)
        torch.cuda.synchronize()
    by_name = _device_ms_by_name(prof, FULLFRAME_CHECK_STEPS)
    busy = sum(by_name.values())
    log(f"  DPM-{FULLFRAME_STEPS} over 1x{FULLFRAME[0]}x{FULLFRAME[1]}x4: {secs:.4f} s a sample "
        f"(synchronised), {secs * 1e3 / FULLFRAME_STEPS:.4f} ms an evaluation; std of the "
        f"noise {float(out.std()):.5f}; peak device memory {peak / 2 ** 30:.3f} GiB; launches "
        f"{ {k: v for k, v in counts.items() if v} }; device busy {busy:.4f} ms an evaluation "
        f"(a profiled DPM-{FULLFRAME_CHECK_STEPS} sample over {FULLFRAME_CHECK_STEPS})")

    # DPM-2 through the kernels (bf16) against the plain route in fp32, with
    # the plain route in bf16 beside them: the kernels' sample must be as
    # close to the fp32 one as the plain bf16 sample is, within 2x + 0.02
    # (train_check's rule for bf16 against fp32: bf16 rounding through ~60
    # layers at each of the two evaluations, the kernels storing the same
    # intermediates in bf16 as the plain versions)
    kern = generate_full_frame(gd, clean, idx, sampling_timesteps=FULLFRAME_CHECK_STEPS,
                               init_noise=x)
    del gd
    reset_launch_counts()
    plain32 = generate_full_frame(diffusion(None), clean, idx,
                                  sampling_timesteps=FULLFRAME_CHECK_STEPS, init_noise=x)
    with plain_route():
        gd16 = diffusion(torch.bfloat16)
    plain16 = generate_full_frame(gd16, clean, idx, sampling_timesteps=FULLFRAME_CHECK_STEPS,
                                  init_noise=x)
    if any(launch_counts().values()):
        raise AssertionError(f"fullframe: the plain routes launched kernels: {launch_counts()}")

    def rel(a, b):
        return float(np.linalg.norm((a - b).astype(np.float64)) / np.linalg.norm(b))

    r_kern, r_plain, r_kp = rel(kern, plain32), rel(plain16, plain32), rel(kern, plain16)
    limit = 2 * r_plain + 0.02
    log(f"  DPM-{FULLFRAME_CHECK_STEPS} full frame, rel L2 against the fp32 plain route: "
        f"kernels (bf16) {r_kern:.4g}, plain bf16 {r_plain:.4g} (bound {limit:.4g}); kernels "
        f"against plain bf16 {r_kp:.4g}")
    if not np.isfinite(kern).all() or r_kern > limit:
        raise AssertionError(f"fullframe: the kernels' DPM-2 sample is {r_kern} from fp32, over "
                             f"{limit}")
    return dict(seconds=secs, eval_ms=secs * 1e3 / FULLFRAME_STEPS, peak_bytes=peak,
                busy_ms=busy, busy_by_class=_by_class(by_name), counts=counts,
                rel_kernels_fp32=r_kern, rel_plain16_fp32=r_plain,
                rel_kernels_plain16=r_kp)


# ---------------------------------------------------------------------------
# multi-process data parallelism, --remat and --profile
# ---------------------------------------------------------------------------

DIST_STEPS = 3  # the 2-rank step's depth
PORT_DIR = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT = 300  # seconds a spawned rank may take


def free_ports(n: int) -> list:
    """n distinct free local ports (all bound at once, then released)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def become_subreaper() -> None:
    """Make this process the parent of any process its children leave
    behind (Linux PR_SET_CHILD_SUBREAPER), so that `stop_children` also
    finds a grandchild whose parent ended first, such as a DataLoader
    worker of a rank that was killed."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def child_pids() -> list:
    """The pids whose parent is this process, read from /proc."""
    me, pids = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == me:
            pids.append(int(name))
    return pids


def stop_children(grace: float = 10.0) -> list:
    """Stop every process this script started that still runs, and reap
    it: multiprocessing's children (the spawned DataLoader workers of the
    generation CLI), the resource tracker that their spawn context started
    (it ignores SIGTERM and ends only once its pipe closes, which would
    otherwise be after this process has exited), then any other child,
    SIGTERM and after `grace` seconds SIGKILL. Returns what it had to stop,
    also printed to stderr."""
    import gc
    import multiprocessing
    import signal
    from multiprocessing import resource_tracker

    gc.collect()  # a DataLoader iterator nothing holds frees its queues' semaphores
    stopped = []
    procs = multiprocessing.active_children()
    for p in procs:
        stopped.append(f"multiprocessing child {p.pid} ({p.name})")
        p.terminate()
    for p in procs:
        p.join(grace)
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        stopped.append(f"resource tracker {tracker._pid}")
        tracker._stop()  # closes its pipe and waits for it to end
    pids = child_pids()
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            cmd = ""
        if cmd:  # a zombie has an empty command line: it only needs reaping
            stopped.append(f"process {pid} ({cmd[:120]})")
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGTERM)
    deadline = time.time() + grace
    while pids:
        for pid in list(pids):
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                done = pid
            if done:
                pids.remove(pid)
        if pids and time.time() > deadline:
            for pid in pids:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            deadline = float("inf")
        if pids:
            time.sleep(0.05)
    if stopped:
        print(f"chip_smoke: stopped on the way out: {stopped}", file=sys.stderr, flush=True)
    return stopped


# what a spawned rank imports, imported once by the server its processes
# fork from (multiprocessing's forkserver, which never touches the card), so
# that a rank starts without paying those imports again
RANK_PRELOAD = ["torch", "torch.distributed", "noisediff_tpu_torch.cli.test_diffusion",
                "noisediff_tpu_torch.cli.train_diffusion",
                "noisediff_tpu_torch.cli.train_denoising",
                "noisediff_tpu_torch.diffusion.fullframe", "noisediff_tpu_torch.parallel.mesh",
                "noisediff_tpu_torch.train.state", "chip_smoke"]


def rank_context():
    """The multiprocessing context the ranks start from: forkserver with
    RANK_PRELOAD. Its server starts on the first call (main makes it first,
    so that the server imports while the kernels build)."""
    import multiprocessing
    from multiprocessing import forkserver

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(RANK_PRELOAD)
    forkserver.ensure_running()
    return ctx


def _rank_process(env: dict, log_path: str) -> None:
    """A rank in the process the forkserver made for it: env as its whole
    environment, its output appended to log_path, then rank_main's exit
    code."""
    fd = os.open(log_path, os.O_WRONLY | os.O_APPEND)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    os.environ.clear()
    os.environ.update(env)
    os.chdir(PORT_DIR)
    sys.exit(rank_main())


def spawn_ranks(job: dict, world: int, workdir: str, launcher_env: bool = True):
    """Run `job` (rank_main) as `world` processes with torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a free local
    port; launcher_env False gives one process no launcher environment),
    each with its output in workdir/<job>.rank<r>.log; returns each rank's
    result (JSON). The processes fork from `rank_context`'s server. Every
    process still running is killed on the way out."""
    return spawn_jobs([(job, world, launcher_env)], workdir)[0]


def spawn_jobs(specs, workdir: str):
    """Run several independent jobs at once, each as spawn_ranks runs one:
    specs is a list of (job, world, launcher_env), each job on a port of its
    own. Their processes start together, so their start-up (the CUDA
    context, first calls) overlaps; their timings are read under each
    other's load. Returns each job's rank results, in the order of specs; a
    rank that fails fails the call, and every process still running is
    killed on the way out."""
    ctx = rank_context()
    runs = []  # (tag, world, job, procs, logs)
    try:
        for (job, world, launcher_env), port in zip(specs, free_ports(len(specs))):
            tag = job["job"] + "-" + str(job.get("name", ""))
            procs, logs = [], []
            runs.append((tag, world, job, procs, logs))
            for rank in range(world):
                env = dict(os.environ, CHIP_SMOKE_JOB=json.dumps(job),
                           PYTHONPATH=os.pathsep.join(
                               [PORT_DIR] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
                for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
                    env.pop(k, None)
                if launcher_env:
                    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                logs.append(os.path.join(workdir, f"{tag}.rank{rank}.log"))
                open(logs[-1], "w").close()
                procs.append(ctx.Process(target=_rank_process, args=(env, logs[-1]),
                                         name=f"{tag}.rank{rank}"))
                procs[-1].start()
        t0 = time.time()
        for tag, world, _, procs, logs in runs:
            for rank, p in enumerate(procs):
                p.join(timeout=max(1.0, RANK_TIMEOUT - (time.time() - t0)))
                if p.exitcode != 0:
                    with open(logs[rank]) as f:
                        tail = f.read()[-6000:]
                    code = "still running" if p.exitcode is None else f"exited {p.exitcode}"
                    raise AssertionError(f"{tag}: rank {rank} of {world} {code}:\n{tail}")
    finally:
        for *_, procs, _ in runs:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    warned = []
    for *_, logs in runs:
        for path in logs:
            with open(path) as f:
                warned += [ln.strip() for ln in f if "Warning" in ln or "warning" in ln]
    if warned:
        log(f"  warnings in the ranks' output: {sorted(set(warned))[:6]}")
    results = []
    for _, world, job, _, _ in runs:
        ranks = []
        for rank in range(world):
            with open(job["result"] % rank) as f:
                ranks.append(json.load(f))
        results.append(ranks)
    return results


def rank_main() -> int:
    """One process that chip_smoke spawned (spawn_ranks): the job in
    CHIP_SMOKE_JOB. "dist_step": the canonical training step on this rank's
    rows of the global batch, under DDP over job["backend"];
    "fullframe_sharded": this rank's rows of the full frame
    (fullframe_sharded_rank); "cli": one of the port's CLIs' main. Writes
    its result to job["result"] % rank."""
    import torch

    job = json.loads(os.environ["CHIP_SMOKE_JOB"])
    rank = int(os.environ.get("RANK", "0"))
    if job["job"] == "dist_step":
        out = dist_step_rank(job)
    elif job["job"] == "fullframe_sharded":
        out = fullframe_sharded_rank(job)
    elif job["job"] == "train_sharded":
        out = train_sharded_rank(job)
    else:
        from noisediff_tpu_torch.cli import test_diffusion, train_denoising, train_diffusion
        from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

        cli = {"test_diffusion": test_diffusion, "train_denoising": train_denoising,
               "train_diffusion": train_diffusion}[job["cli"]]
        argv = [a.replace("{rank}", str(rank)) for a in job["argv"]]
        reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli.main(argv)
        wall = time.perf_counter() - t0
        out = {k: summary[k] for k in ("steps", "losses", "step_end_seconds", "step_seconds",
                                       "snapshots", "generated", "batches", "batch_seconds",
                                       "out_dir", "epoch_seconds") if k in summary}
        out.update(launches=launch_counts(), wall_s=wall,
                   peak_bytes=torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0)
    with open(job["result"] % rank, "w") as f:
        json.dump(out, f)
    return 0


def _span_stats(prof, n: int):
    """{span: (count, host ms)} per evaluation (or step) of the grid's
    profiler spans (mesh.SPANS) in a profile of n of them, and the NCCL
    kernels' device ms, where there are any."""
    from noisediff_tpu_torch.parallel import mesh

    out = {}
    for e in prof.key_averages():
        if e.key in mesh.SPANS and not str(e.device_type).endswith("CUDA"):
            out[e.key] = {"count": e.count / n, "host_ms": e.cpu_time_total / 1e3 / n}
    by_name = _device_ms_by_name(prof, n)
    out["nccl_device_ms"] = sum(v for k, v in by_name.items() if "nccl" in k.lower())
    # the rank's own device work: every kernel and copy but NCCL's
    own = {k: v for k, v in by_name.items() if "nccl" not in k.lower()}
    out["compute_device_ms"] = sum(own.values())
    out["by_class"] = _by_class(own)
    return out


def _by_class(by_name):
    """{kernel class (`_category`): device ms} of a {kernel name: ms} map."""
    out = {}
    for k, v in by_name.items():
        out[_category(k)] = out.get(_category(k), 0.0) + v
    return out


def _collective_host_us(shard, dev, n: int = 50):
    """Host microseconds a call of the spatial axis's two collectives alone,
    at the full frame's stage-0 shard (a 1-row halo of 2128 x 48 bf16; a
    (2, 1, 384) fp32 sum), n calls back to back then a synchronise: what
    each of an evaluation's 50 halo exchanges and 44 all-reduces costs the
    host besides the compute."""
    import torch

    from noisediff_tpu_torch.parallel import mesh

    x = torch.zeros((1, DIM, 8, FULLFRAME[1]), device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    s = torch.zeros((2, 1, 384), device=dev)
    out = {}
    for name, fn in (("halo_rows", lambda: mesh.halo_rows(x, 1, shard)),
                     ("all_reduce_sum", lambda: mesh.all_reduce_sum(s))):
        fn()
        torch.cuda.synchronize(dev)
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t0) * 1e6 / n
    return out


def fullframe_sharded_rank(job):
    """The body of one fullframe_sharded rank: the main phase's dim-48
    weights (bf16, kernels) over the evaluation tree's first clean frame,
    split by rows over the process group (job["backend"]) through
    generate_full_frame: a DPM-1 warm-up; DPM-10 timed between barriers
    (synchronised) with its launches and this rank's peak memory; a DPM-2
    sample under torch.profiler (the halo exchanges' and the all-reduces'
    spans, the device time by class, an evaluation's share); the
    collectives' host time alone; DPM-2 and DDIM-2 from the x_T of phase_fullframe,
    then fp32 DPM-2 over SHARDED_FP32_FRAME (rank 0 saves the three
    frames to job["out"] % name)."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli.common import set_precision_flags
    from noisediff_tpu_torch.data.datasets import iso_ratio_index
    from noisediff_tpu_torch.data.raw_host import load_packed_frame
    from noisediff_tpu_torch.diffusion.fullframe import generate_full_frame
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.parallel import mesh
    from noisediff_tpu_torch.weights import load_into

    set_precision_flags()
    shard, dev = mesh.setup(torch.device("cuda"), job["backend"])
    clean = load_packed_frame(job["frame"])
    idx = iso_ratio_index(800, EVAL_RATIO)

    def diffusion(dtype):
        model = NoiseDiffNet(dim=DIM, dtype=dtype)
        load_into(model, job["ckpt"])
        model = model.to(dev, memory_format=torch.channels_last).eval()
        return GaussianDiffusion(model, make_schedule("sigmoid2", 1000),
                                 image_size=FULLFRAME[0], device=dev)

    def run(gd, frame, steps, x, sampler="dpm"):
        return generate_full_frame(gd, frame, idx, sampler=sampler, sampling_timesteps=steps,
                                   init_noise=x)

    gd = diffusion(torch.bfloat16)
    x = torch.randn((1, *FULLFRAME, 4), generator=torch.Generator(device=dev).manual_seed(
        job["seed"]), device=dev)
    run(gd, clean, 1, x)  # warm-up
    torch.cuda.synchronize(dev)
    mesh.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    frame = run(gd, clean, FULLFRAME_STEPS, x)
    torch.cuda.synchronize(dev)
    mesh.barrier()
    secs = time.perf_counter() - t0
    out = dict(rank=shard.rank, world=shard.world, backend=torch.distributed.get_backend(),
               device=str(dev), bounds=mesh.SpatialShard(shard.rank, shard.world,
                                                         FULLFRAME[0]).bounds,
               seconds=secs, launches=launch_counts(),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               frame_ok=(frame is None if shard.rank else
                         frame.shape == (*FULLFRAME, 4) and bool(np.isfinite(frame).all())))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:  # a short sample, per evaluation
        run(gd, clean, FULLFRAME_CHECK_STEPS, x)
        torch.cuda.synchronize(dev)
    out["spans"] = _span_stats(prof, FULLFRAME_CHECK_STEPS)
    out["collective_host_us"] = _collective_host_us(
        mesh.SpatialShard(shard.rank, shard.world, FULLFRAME[0]), dev)
    reset_launch_counts()
    frames = {"dpm2": run(gd, clean, FULLFRAME_CHECK_STEPS, x)}
    out["launches_dpm2"] = launch_counts()
    reset_launch_counts()
    frames["ddim2"] = run(gd, clean, FULLFRAME_CHECK_STEPS, x, sampler="ddim")
    out["launches_ddim2"] = launch_counts()
    del gd
    torch.cuda.empty_cache()
    fh, fw = SHARDED_FP32_FRAME
    reset_launch_counts()
    frames["fp32"] = run(diffusion(None), np.ascontiguousarray(clean[:fh, :fw]),
                         FULLFRAME_CHECK_STEPS, x[:, :fh, :fw].contiguous())
    out["launches_fp32"] = launch_counts()
    if shard.rank == 0:
        for name, f in frames.items():
            np.save(job["out"] % name, f)
    mesh.teardown()
    return out


def _train_model(seed: int, dev, dtype, remat=False):
    """The full-width NoiseDiffNet from the seed on `dev`, channels-last, in
    training mode."""
    import torch

    from noisediff_tpu_torch.models import NoiseDiffNet

    torch.manual_seed(seed)
    model = NoiseDiffNet(dim=DIM, dtype=dtype, remat=remat)
    return model.to(dev, memory_format=torch.channels_last).train()


def _param_digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in tensors:
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dist_step_rank(job):
    """The body of one dist_step rank: the canonical training step (dim 48,
    crop 512, bf16, Adam) on this rank's rows of the global batch of
    BATCH, DIST_STEPS times. Rank 0 saves the first step's all-reduced
    gradients and updated parameters; every rank returns its logged
    metrics, a digest of its parameters after the last step, its peak
    memory, its launches and its steps' CUDA-event times."""
    import torch

    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import is_unread_parameter
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.parallel import mesh
    from noisediff_tpu_torch.train.state import make_diffusion_train_step, make_optimizer
    from noisediff_tpu_torch.train.trainer_diffusion import step_seed

    seed = job["seed"]
    shard, dev = mesh.setup(torch.device("cuda"), job["backend"])
    model = _train_model(seed, dev, torch.bfloat16)
    net = mesh.wrap(model, dev, is_unread_parameter)
    gd = GaussianDiffusion(net, make_schedule("sigmoid2", 1000), image_size=CROP, device=dev)
    step = make_diffusion_train_step(gd, make_optimizer(model.parameters()), shard=shard)
    batch = {k: shard.rows(v) for k, v in
             _canonical_batch(torch.Generator(device=dev).manual_seed(seed), dev).items()}
    g = torch.Generator(device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    metrics, ms = [], []
    for i in range(DIST_STEPS):
        g.manual_seed(step_seed(seed, i))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(batch, g)
        end.record()
        metrics.append({k: float(v) for k, v in m.items()})
        ms.append(start.elapsed_time(end))
        if i == 0 and shard.rank == 0:
            torch.save({"grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()
                                  if p.grad is not None},
                        "params": {n: p.detach().cpu() for n, p in model.named_parameters()}},
                       job["first_step"])
    out = dict(rank=shard.rank, world=shard.world, backend=torch.distributed.get_backend(),
               device=str(dev), metrics=metrics, step_ms=ms,
               digest=_param_digest(model.parameters()),
               peak_bytes=torch.cuda.max_memory_allocated(dev), launches=launch_counts())
    mesh.teardown()
    return out


def phase_fullframe_sharded(seed: int, ckpt: str, sid: str, workdir: str, one_card: dict):
    """The full frame split by rows (generate_full_frame under a process
    group): 2 ranks (NCCL on 2 cards where the machine has them, else gloo
    with both ranks on one card), and 4 where it has 4 cards
    (fullframe_sharded_rank). Checks each rank's launches (per evaluation:
    9 attn_tail, 44 gn_stats, 42 groupnorm_silu_apply, 1 dual_head, no
    groupnorm_silu: its statistics would see one shard; DDIM-2: 2
    ddim_head; fp32: none), rank 0's frame, DPM-2 and DDIM-2 in bf16
    against one card from the same x_T within SHARDED_BF16 (below), and fp32
    DPM-2 over SHARDED_FP32_FRAME against one card within SHARDED_FP32_REL.
    Reports seconds a DPM-10 sample and ms an evaluation beside one card's
    (`one_card`, phase_fullframe's run in this call), each rank's peak
    memory, and the halo exchanges' and all-reduces' count and host ms an
    evaluation (with the NCCL kernels' device ms) from a profile."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.cli.common import set_precision_flags
    from noisediff_tpu_torch.data.datasets import iso_ratio_index
    from noisediff_tpu_torch.data.raw_host import load_packed_frame
    from noisediff_tpu_torch.diffusion.fullframe import generate_full_frame
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.parallel import mesh
    from noisediff_tpu_torch.weights import load_into

    set_precision_flags()
    dev = torch.device("cuda")
    frame_path = os.path.join(sid, "Sony", "long", "00001_00_10s.ARW")
    clean = load_packed_frame(frame_path)
    idx = iso_ratio_index(800, EVAL_RATIO)

    def diffusion(dtype):
        model = NoiseDiffNet(dim=DIM, dtype=dtype)
        load_into(model, ckpt)
        model = model.to(dev, memory_format=torch.channels_last).eval()
        return GaussianDiffusion(model, make_schedule("sigmoid2", 1000),
                                 image_size=FULLFRAME[0], device=dev)

    # one card, the ranks' inputs: phase_fullframe's x_T
    x = torch.randn((1, *FULLFRAME, 4), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    fh, fw = SHARDED_FP32_FRAME
    gd = diffusion(torch.bfloat16)
    want = {s: generate_full_frame(gd, clean, idx, sampler=s, init_noise=x,
                                   sampling_timesteps=FULLFRAME_CHECK_STEPS)
            for s in ("dpm", "ddim")}
    want["fp32"] = generate_full_frame(diffusion(None), np.ascontiguousarray(clean[:fh, :fw]), idx,
                                       sampling_timesteps=FULLFRAME_CHECK_STEPS,
                                       init_noise=x[:, :fh, :fw].contiguous())
    del gd, x
    torch.cuda.empty_cache()

    # bf16 split against bf16 on one card: the two differ by where they
    # round (each shard's conv carries its bias, the one-card route folds it
    # into groupnorm_silu; the statistics sum in another order), the size
    # of difference bf16 itself makes against fp32 on one card
    # (phase_fullframe's kernels-against-fp32 rel L2); bound: twice that,
    # plus train_check's 0.02
    limit = 2 * one_card["rel_kernels_fp32"] + 0.02
    cards = torch.cuda.device_count()
    per_eval = {"fused_attn_tail": 9, "gn_stats": 44, "groupnorm_silu_apply": 42,
                "fused_dual_head": 1}
    runs = {}
    for world in [w for w in SHARDED_WORLDS if w == 2 or cards >= w]:
        backend = "nccl" if cards >= world else "gloo"
        log(f"  {world} ranks over {min(world, cards)} card(s), {backend}"
            + ("" if backend == "nccl" else " (NCCL refuses two ranks on one card)"))
        job = dict(job="fullframe_sharded", name=world, seed=seed, ckpt=ckpt, frame=frame_path,
                   backend=backend, result=os.path.join(workdir, f"ffs{world}.rank%d.json"),
                   out=os.path.join(workdir, f"ffs{world}-%s.npy"))
        ranks = spawn_ranks(job, world, workdir)
        for r in ranks:
            n = r["launches"]
            want_n = {k: v * FULLFRAME_STEPS for k, v in per_eval.items()}
            if {k: v for k, v in n.items() if v} != want_n:
                raise AssertionError(f"fullframe_sharded {world}: rank {r['rank']} launched {n}, "
                                     f"expected {want_n}")
            if r["launches_ddim2"]["fused_ddim_head_update"] != FULLFRAME_CHECK_STEPS or \
                    r["launches_ddim2"]["fused_dual_head"]:
                raise AssertionError(f"fullframe_sharded {world}: DDIM-2 launches "
                                     f"{r['launches_ddim2']}")
            if any(r["launches_fp32"].values()):
                raise AssertionError(f"fullframe_sharded {world}: fp32 launched "
                                     f"{r['launches_fp32']}")
            if not r["frame_ok"]:
                raise AssertionError(f"fullframe_sharded {world}: rank {r['rank']}'s frame")
        got = {k: np.load(job["out"] % k) for k in ("dpm2", "ddim2", "fp32")}
        rel = {k: float(np.linalg.norm((got[k] - want[w]).astype(np.float64))
                        / np.linalg.norm(want[w]))
               for k, w in (("dpm2", "dpm"), ("ddim2", "ddim"), ("fp32", "fp32"))}
        secs = max(r["seconds"] for r in ranks)
        spans = ranks[0]["spans"]
        log(f"  DPM-{FULLFRAME_STEPS} over 1x{FULLFRAME[0]}x{FULLFRAME[1]}x4 on {world} ranks: "
            f"{secs:.4f} s a sample, {secs * 1e3 / FULLFRAME_STEPS:.4f} ms an evaluation "
            f"(one card, this call: {one_card['seconds']:.4f} s, "
            f"{one_card['eval_ms']:.4f} ms); rows "
            f"{[r['bounds'] for r in ranks]}; peak memory a rank "
            f"{[round(r['peak_bytes'] / 2 ** 30, 3) for r in ranks]} GiB (one card "
            f"{one_card['peak_bytes'] / 2 ** 30:.3f})")
        log(f"  an evaluation, rank 0's profile of a DPM-{FULLFRAME_CHECK_STEPS} sample: "
            + ", ".join(f"{k} {spans[k]['count']:g} calls {spans[k]['host_ms']:.4f} ms"
                        for k in (mesh.HALO_SPAN, mesh.GN_SPAN) if k in spans)
            + f"; on the card: its own work {spans['compute_device_ms']:.4f} ms (one card "
            f"{one_card['busy_ms']:.4f}), NCCL's "
            f"kernels {spans['nccl_device_ms']:.4f} ms; host us a call alone: "
            f"{ {k: round(v, 1) for k, v in ranks[0]['collective_host_us'].items()} }")
        log("  device ms an evaluation by class, rank 0 against one card: " + "; ".join(
            f"{k} {spans['by_class'].get(k, 0.0):.4f} / {v:.4f}"
            for k, v in sorted(one_card["busy_by_class"].items(), key=lambda kv: -kv[1])))
        log(f"  against one card from the same x_T: DPM-2 bf16 rel L2 {rel['dpm2']:.4g}, "
            f"DDIM-2 bf16 {rel['ddim2']:.4g} (bound {limit:.4g}); fp32 DPM-2 at "
            f"{fh}x{fw} {rel['fp32']:.4g} (bound {SHARDED_FP32_REL:g})")
        if rel["fp32"] > SHARDED_FP32_REL or max(rel["dpm2"], rel["ddim2"]) > limit:
            raise AssertionError(f"fullframe_sharded {world}: {rel} over the bounds")
        runs[world] = dict(backend=backend, seconds=secs, eval_ms=secs * 1e3 / FULLFRAME_STEPS,
                           rel=rel, bound_bf16=limit, spans=spans,
                           collective_host_us=[r["collective_host_us"] for r in ranks],
                           peak_bytes=[r["peak_bytes"] for r in ranks],
                           counts={k: sum(r["launches"][k] for r in ranks)
                                   for k in ranks[0]["launches"]},
                           ddim_counts={k: sum(r["launches_ddim2"][k] for r in ranks)
                                        for k in ranks[0]["launches_ddim2"]})
    return runs


def reference_steps(seed: int):
    """One process, the whole global batch: the canonical training step's
    first step with the dist_step ranks' weights, batch and draws, in bf16
    (stored activations and --remat) and fp32 on the card. Returns, for
    each, the loss, grad norm, gradients and updated parameters (on the
    host), the first step's launches and peak device memory and, for bf16,
    a step's time (CUDA events, median of 3) and device busy time
    (torch.profiler over 1 step)."""
    import torch

    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.train.state import make_diffusion_train_step, make_optimizer
    from noisediff_tpu_torch.train.trainer_diffusion import step_seed

    dev = torch.device("cuda")
    out = {}
    for name, dtype, remat in (("bf16", torch.bfloat16, False), ("remat", torch.bfloat16, True),
                               ("fp32", None, False)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = _train_model(seed, dev, dtype, remat)
        gd = GaussianDiffusion(model, make_schedule("sigmoid2", 1000), image_size=CROP, device=dev)
        step = make_diffusion_train_step(gd, make_optimizer(model.parameters()))
        batch = _canonical_batch(torch.Generator(device=dev).manual_seed(seed), dev)
        g = torch.Generator(device=dev).manual_seed(step_seed(seed, 0))
        init = {n: p.detach().cpu() for n, p in model.named_parameters()}
        reset_launch_counts()
        m = step(batch, g)
        r = dict(loss=float(m["diffusion_loss"]), grad_norm=float(m["grad_norm"]), init=init,
                 launches=launch_counts(), peak_bytes=torch.cuda.max_memory_allocated(),
                 grads={n: p.grad.float().cpu() for n, p in model.named_parameters()
                        if p.grad is not None},
                 params={n: p.detach().cpu() for n, p in model.named_parameters()})
        if dtype is not None:
            r["step_ms"] = time_ms(lambda: step(batch, g), reps=3, warmup=1)
            r["peak_bytes_steps"] = torch.cuda.max_memory_allocated()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                step(batch, g)
                torch.cuda.synchronize()
            r["busy_ms"] = sum(_device_ms_by_name(prof, 1).values())
        out[name] = r
        del model, gd, step, batch
    torch.cuda.empty_cache()
    return out


def phase_dist_step(seed: int, workdir: str, ref):
    """The canonical training step (dim 48, crop 512, global batch 4,
    bf16) on 2 ranks, DDP: over NCCL where the machine has 2 cards, else
    over gloo on CUDA tensors with both ranks on one card (NCCL refuses two
    ranks on one card). Both ranks log the same loss and grad norm and end
    with bit-equal parameters after DIST_STEPS steps; the first step's
    loss and all-reduced gradients agree with the one-process step on the
    concatenated batch with the same draws (`ref`) within train_check's
    bf16 bounds (_check_grads: the fp32 step as the reference), its grad
    norm within 2e-2. Adam's first update moves an element by
    lr * g / (|g| + eps), so the updated parameters are held where the two
    gradients settle that sign: on every element whose one-process
    gradient exceeds twice its distance to the 2-rank gradient and 1e-5
    (1e3 Adam eps), both steps moved the parameter by the same +-lr, within
    1e-2 lr (eps and fp32 rounding of the parameter), and such elements
    are at least a quarter of the total (47.6% in the first reading: the
    rest have gradients below 1e-5 or within twice the bf16 noise)."""
    import torch

    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    first = os.path.join(workdir, "dist_first_step.pt")
    job = dict(job="dist_step", name=backend, seed=seed, backend=backend, first_step=first,
               result=os.path.join(workdir, "dist_step.rank%d.json"))
    t0 = time.time()
    r0, r1 = spawn_ranks(job, 2, workdir)
    wall = time.time() - t0
    if r0["metrics"] != r1["metrics"]:
        raise AssertionError(f"dist_step: the ranks logged {r0['metrics']} and {r1['metrics']}")
    if r0["digest"] != r1["digest"]:
        raise AssertionError("dist_step: the ranks' parameters differ after "
                             f"{DIST_STEPS} steps")
    saved = torch.load(first, weights_only=True)
    m0 = r0["metrics"][0]
    b16, f32 = ref["bf16"], ref["fp32"]
    checks = _check_grads("dist_step", BATCH, CROP, m0["diffusion_loss"], saved["grads"],
                          b16["loss"], b16["grads"], f32["grads"])
    if abs(m0["grad_norm"] - b16["grad_norm"]) > 2e-2 * b16["grad_norm"]:
        raise AssertionError(f"dist_step: grad norm {m0['grad_norm']} against the one-process "
                             f"step's {b16['grad_norm']}")
    lr = 1e-4
    worst, held, total = _settled_updates(saved["grads"], saved["params"], b16, lr)
    if worst > 1e-2 * lr or 4 * held < total:
        raise AssertionError(f"dist_step: on {held} of {total} elements whose gradient sign "
                             f"is settled the updates differ by up to {worst} (bound "
                             f"{1e-2 * lr}; at least a quarter of the elements must be held)")
    log(f"  2 ranks over {backend} ({r0['device']}, {r1['device']}), global batch {BATCH} "
        f"({BATCH // 2} a rank), {DIST_STEPS} steps: both ranks logged losses "
        f"{[round(m['diffusion_loss'], 6) for m in r0['metrics']]} and grad norms "
        f"{[round(m['grad_norm'], 4) for m in r0['metrics']]}; parameters bit-equal across "
        "the ranks")
    log(f"  first step against one process on the concatenated batch: loss "
        f"{m0['diffusion_loss']:.6f} / {b16['loss']:.6f}, grad norm {m0['grad_norm']:.6f} / {b16['grad_norm']:.6f}; "
        f"Adam's first update equal within {worst:.3g} (bound {1e-2 * lr:.3g}) on the {held} of "
        f"{total} elements whose gradient sign is settled")
    for r in (r0, r1):
        log(f"  rank {r['rank']}: peak device memory {r['peak_bytes'] / 2 ** 30:.3f} GiB; step "
            f"CUDA-event ms {[round(v, 3) for v in r['step_ms']]}; launches {r['launches']}")
    log(f"  {wall:.1f} s for both ranks, start-up included")
    return dict(backend=backend, ranks=[r0, r1], checks=checks, held=held, total=total)


TRAIN_GRIDS = {"spatial2": {"spatial": 2}, "model2": {"model": 2},
               "spatial2_model2": {"spatial": 2, "model": 2}}
SHARDED_STEPS = 2  # timed bf16 steps a rank, after the checked first one
TRAIN_FP32_REL = 1e-4


def _state_bytes(model, opt) -> int:
    """This rank's parameter and Adam-moment bytes."""
    import torch

    n = sum(p.numel() * p.element_size() for p in model.parameters())
    return n + sum(t.numel() * t.element_size() for st in opt.state.values()
                   for t in st.values() if torch.is_tensor(t) and t.dim() > 0)


def train_sharded_rank(job):
    """The body of one train_sharded rank: the grid job["axes"] over
    job["backend"]; the canonical training step (dim 48, crop 512, global
    batch BATCH, Adam) from _train_model's seeded weights, this rank's part
    of the canonical batch (Grid.local) and the first step's draws, in fp32
    and then bf16. Rank 0 saves each first step's gathered gradients and
    parameters to job["first_step"] % dtype; every rank returns each step's
    loss, grad norm, launches and parameter and Adam bytes, and for bf16
    SHARDED_STEPS more steps' CUDA-event ms, the peak memory, a profile of a
    step (the collectives' spans) and, on a spatial grid, whether
    NOISEDIFF_WGRAD=pallas is refused."""
    import torch

    from noisediff_tpu_torch.cli.common import set_precision_flags
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import blocks, is_unread_parameter
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.parallel import mesh
    from noisediff_tpu_torch.train.state import make_diffusion_train_step, make_optimizer
    from noisediff_tpu_torch.train.trainer_diffusion import step_seed

    seed = job["seed"]
    set_precision_flags()  # fp32 products in fp32, as the one-process reference
    _, dev = mesh.setup(torch.device("cuda"), job["backend"])
    grid = mesh.make_mesh(job["axes"])
    out = dict(rank=grid.rank, coords=grid.coords, backend=torch.distributed.get_backend(),
               device=str(dev))
    schedule = make_schedule("sigmoid2", 1000)
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = _train_model(seed, dev, dtype)
        mesh.shard_parameters(model, grid.model)
        net = mesh.wrap(model, dev, is_unread_parameter, grid.replica_group)
        opt = make_optimizer(model.parameters())
        step = make_diffusion_train_step(
            GaussianDiffusion(net, schedule, image_size=CROP, device=dev), opt, grid=grid)
        batch = grid.local(_canonical_batch(torch.Generator(device=dev).manual_seed(seed), dev))
        g = torch.Generator(device=dev).manual_seed(step_seed(seed, 0))
        reset_launch_counts()
        m = step(batch, g)
        r = dict(loss=float(m["diffusion_loss"]), grad_norm=float(m["grad_norm"]),
                 launches=launch_counts(), state_bytes=_state_bytes(model, opt))
        grads = mesh.gather_params(model, grads=True)
        params = mesh.gather_params(model)
        if grid.rank == 0:
            torch.save({"grads": {n: v.float().cpu() for n, v in grads.items() if v is not None},
                        "params": {n: v.cpu() for n, v in params.items()}},
                       job["first_step"] % name)
        del grads, params
        if dtype is not None:
            ms = []
            for i in range(1, 1 + SHARDED_STEPS):
                g.manual_seed(step_seed(seed, i))
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                step(batch, g)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            r.update(step_ms=ms, peak_bytes=torch.cuda.max_memory_allocated(dev))
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                step(batch, g)
                torch.cuda.synchronize(dev)
            r["spans"] = _span_stats(prof, 1)
            whole = mesh.gather_params(model)
            r["digest"] = _param_digest(whole[n] for n in sorted(whole))
            del whole
            shard = grid.spatial(CROP)
            if shard is not None:
                # the JAX conv_wgrad_p refuses a spatial shard; so must the port
                os.environ["NOISEDIFF_WGRAD"] = "pallas"
                try:
                    gd = GaussianDiffusion(model, schedule, image_size=CROP, device=dev)
                    with mesh.activate(shard):
                        gd.loss(batch["noise"], {"clean_img": batch["clean_img"],
                                                 "position": batch["coord"],
                                                 "iso_ratio_idx": batch["iso_ratio_idx"]},
                                t=torch.zeros(batch["noise"].shape[0], dtype=torch.long,
                                              device=dev))
                    r["wgrad_refused"] = None
                except ValueError as exc:
                    r["wgrad_refused"] = str(exc) == blocks.WGRAD_SPATIAL_ERROR
                finally:
                    del os.environ["NOISEDIFF_WGRAD"]
        out[name] = r
        del model, net, opt, step, batch
    mesh.teardown()
    return out


def _all_rel(got, want) -> float:
    """rel L2 of every tensor of `want` together."""
    import torch

    names = sorted(want)
    return rel_l2(torch.cat([got[n].float().flatten() for n in names]),
                  torch.cat([want[n].float().flatten() for n in names]))


def _settled_updates(grads, params, ref, lr: float = 1e-4):
    """Adam's first update against one process's (`ref`: its init, grads
    and params): on every element whose one-process gradient exceeds twice
    its distance to `grads` and 1e-5 (1e3 Adam eps) both steps moved the
    parameter by the same +-lr. Returns (largest difference of the two
    updates there, elements held, elements)."""
    import torch

    worst, held, total = 0.0, 0, 0
    for n, g in grads.items():
        want = ref["grads"][n]
        settled = want.abs() > torch.clamp(2 * (g - want).abs(), min=1e-5)
        step2 = params[n].float() - ref["init"][n].float()
        step1 = ref["params"][n].float() - ref["init"][n].float()
        if bool(settled.any()):
            worst = max(worst, float((step2 - step1).abs()[settled].max()))
        held += int(settled.sum())
        total += g.numel()
    return worst, held, total


def phase_train_sharded(seed: int, workdir: str, ref):
    """The canonical training step on each grid of TRAIN_GRIDS
    (train_sharded_rank), held against the one-process first steps of
    `ref` (reference_steps: the same weights, batch and draws). fp32: the
    loss, grad norm, every gathered gradient and every Adam-updated
    parameter within TRAIN_FP32_REL rel L2, and the update equal to the
    one-process one on the elements whose gradient sign is settled (as
    dist_step). bf16: the loss and grad norm within twice the one-process
    bf16-against-fp32 distance plus 0.02 of the fp32 step, the gradients
    within train_check's bounds (_check_grads), the parameters within twice
    their bf16-against-fp32 distance plus 0.02. Every rank launches, a
    step, exactly TRAIN_PER_STEP's kernels (none in fp32), logs one loss
    and grad norm, and on a spatial grid refuses NOISEDIFF_WGRAD=pallas.
    Reports each rank's step ms and peak memory beside one process's, its
    parameter and Adam bytes, and the collectives' count and host ms a
    step from a profile."""
    import torch

    from noisediff_tpu_torch.models import is_unread_parameter
    from noisediff_tpu_torch.parallel import mesh

    cards = torch.cuda.device_count()
    want_launches = {k: TRAIN_PER_STEP.get(k, 0) for k in KERNEL_WRAPPERS}
    f32, b16 = ref["fp32"], ref["bf16"]
    read = [n for n in f32["grads"] if not is_unread_parameter(n)]
    runs = {}
    for name, axes in TRAIN_GRIDS.items():
        t0 = time.time()
        world = 1
        for v in axes.values():
            world *= v
        backend = "nccl" if cards >= world else "gloo"
        job = dict(job="train_sharded", name=name, seed=seed, axes=axes, backend=backend,
                   first_step=os.path.join(workdir, f"ts_{name}_%s.pt"),
                   result=os.path.join(workdir, f"ts_{name}.rank%d.json"))
        ranks = spawn_ranks(job, world, workdir)
        wall = time.time() - t0
        for dt in ("fp32", "bf16"):
            seen = {(r[dt]["loss"], r[dt]["grad_norm"]) for r in ranks}
            if len(seen) != 1:
                raise AssertionError(f"train_sharded {name} {dt}: the ranks logged {seen}")
        for r in ranks:
            if any(r["fp32"]["launches"].values()):
                raise AssertionError(f"train_sharded {name}: fp32 launched {r['fp32']['launches']}")
            if r["bf16"]["launches"] != want_launches:
                raise AssertionError(f"train_sharded {name}: rank {r['rank']} launched "
                                     f"{r['bf16']['launches']} a step, expected {want_launches}")
            if "spatial" in axes and r["bf16"].get("wgrad_refused") is not True:
                raise AssertionError(f"train_sharded {name}: NOISEDIFF_WGRAD=pallas under a "
                                     f"spatial shard gave {r['bf16'].get('wgrad_refused')}")
        got = {dt: torch.load(job["first_step"] % dt, weights_only=True)
               for dt in ("fp32", "bf16")}
        m32, m16 = ranks[0]["fp32"], ranks[0]["bf16"]

        # fp32: the same sums in another order. The parameters after Adam
        # are held all together: a zero-initialised one (every GroupNorm
        # bias) is +-lr on each element after the first step, the sign of
        # a gradient that may be rounding noise; Adam's update is held
        # where the gradient's sign is settled (as dist_step)
        rel32 = dict(loss=abs(m32["loss"] - f32["loss"]) / abs(f32["loss"]),
                     grad_norm=abs(m32["grad_norm"] - f32["grad_norm"]) / f32["grad_norm"])
        if sorted(got["fp32"]["grads"]) != sorted(read) or \
                sorted(got["fp32"]["params"]) != sorted(f32["params"]):
            raise AssertionError(f"train_sharded {name}: gathered names differ from one process's")
        g_worst = max((rel_l2(got["fp32"]["grads"][n], f32["grads"][n]), n) for n in read)
        p_all = _all_rel(got["fp32"]["params"], f32["params"])
        p_worst = max((rel_l2(v, f32["params"][n]), n) for n, v in got["fp32"]["params"].items())
        upd_worst, held, total = _settled_updates(got["fp32"]["grads"], got["fp32"]["params"], f32)
        log(f"  {name}: {world} ranks over {backend}; fp32 against one process: loss "
            f"{m32['loss']:.6f} / {f32['loss']:.6f} (rel {rel32['loss']:.3g}), grad norm "
            f"{m32['grad_norm']:.6f} / {f32['grad_norm']:.6f} (rel {rel32['grad_norm']:.3g}); "
            f"worst gradient rel L2 {g_worst[0]:.3g} ({g_worst[1]}); parameters after Adam "
            f"{p_all:.3g} (worst {p_worst[0]:.3g}, {p_worst[1]}); bound {TRAIN_FP32_REL:g}; "
            f"Adam's update equal within {upd_worst:.3g} (bound 1e-6) on the {held} of {total} "
            f"elements whose gradient sign is settled")
        if max(rel32.values()) > TRAIN_FP32_REL or g_worst[0] > TRAIN_FP32_REL or \
                p_all > TRAIN_FP32_REL or upd_worst > 1e-6 or 4 * held < total:
            raise AssertionError(f"train_sharded {name}: fp32 step off one process's: {rel32}, "
                                 f"{g_worst}, {p_all}, {upd_worst}, {held}/{total}")

        # bf16: the kernels' route, held as the split frame is
        checks = _check_grads(f"train_sharded {name}", BATCH, CROP, m16["loss"],
                              got["bf16"]["grads"], b16["loss"], b16["grads"], f32["grads"])
        for k in ("loss", "grad_norm"):
            limit = 2 * abs(b16[k] - f32[k]) + 0.02 * abs(f32[k])
            if abs(m16[k] - f32[k]) > limit:
                raise AssertionError(f"train_sharded {name}: bf16 {k} {m16[k]} against fp32 "
                                     f"{f32[k]} (bf16 one process {b16[k]}; bound {limit})")
        p16 = _all_rel(got["bf16"]["params"], f32["params"])
        p16_limit = 2 * _all_rel(b16["params"], f32["params"]) + 0.02
        upd16, held16, _ = _settled_updates(got["bf16"]["grads"], got["bf16"]["params"], b16)
        log(f"  {name} bf16: loss {m16['loss']:.6f} (one process {b16['loss']:.6f}), grad norm "
            f"{m16['grad_norm']:.6f} ({b16['grad_norm']:.6f}); parameters after Adam against "
            f"fp32 {p16:.3g} (bound {p16_limit:.3g}), the update equal to one process's bf16 "
            f"within {upd16:.3g} (bound 1e-6) on {held16} settled elements; launches a rank a "
            f"step { {k: v for k, v in m16['launches'].items() if v} }; parameters "
            f"{'bit-equal' if len({r['bf16']['digest'] for r in ranks}) == 1 else 'not bit-equal'}"
            f" across the ranks after {2 + SHARDED_STEPS} steps")
        if p16 > p16_limit or upd16 > 1e-6 or 4 * held16 < total:
            raise AssertionError(f"train_sharded {name}: bf16 parameters after Adam: {p16} "
                                 f"(bound {p16_limit}), {upd16}, {held16}/{total}")
        for r in ranks:
            b = r["bf16"]
            spans = b["spans"]
            log(f"  rank {r['rank']} {r['coords']}: step ms {[round(v, 3) for v in b['step_ms']]} "
                f"(one process {b16['step_ms']:.3f}); peak {b['peak_bytes'] / 2 ** 30:.3f} GiB "
                f"(one process {b16['peak_bytes_steps'] / 2 ** 30:.3f}); parameters and Adam "
                f"{b['state_bytes'] / 2 ** 20:.1f} MiB; a step: "
                + ", ".join(f"{k} {spans[k]['count']:g} calls {spans[k]['host_ms']:.3f} ms"
                            for k in mesh.SPANS if k in spans)
                + f"; its device work {spans['compute_device_ms']:.3f} ms, NCCL's "
                f"{spans['nccl_device_ms']:.3f}")
        log(f"  {name}: {wall:.1f} s, start-up included")
        runs[name] = dict(backend=backend, world=world, fp32=dict(rel32, grad=g_worst[0],
                                                                   params=p_all),
                          bf16=checks, ranks=ranks, wall_s=wall,
                          counts={k: sum(r["bf16"]["launches"][k] for r in ranks)
                                  for k in KERNEL_WRAPPERS})
    return runs


def phase_remat(ref):
    """The canonical training step with and without --remat (ref): the
    loss and gradients within train_check's bounds (and whether they are
    bit-equal), peak device memory and a step's time (CUDA events) for
    both, and the kernels the recompute launches again."""
    a, b = ref["bf16"], ref["remat"]
    checks = _check_grads("remat", BATCH, CROP, b["loss"], b["grads"], a["loss"], a["grads"],
                          ref["fp32"]["grads"], model="dim-48 --remat")
    same = b["loss"] == a["loss"] and all(
        bool((b["grads"][n] == g).all()) for n, g in a["grads"].items())
    gib = 2 ** 30
    log(f"  loss {b['loss']:.6f} with --remat, {a['loss']:.6f} without; loss and gradients "
        f"{'bit-equal' if same else 'not bit-equal'}")
    log(f"  peak device memory of the first step (Adam state included): "
        f"{b['peak_bytes'] / gib:.3f} GiB with --remat, {a['peak_bytes'] / gib:.3f} without; "
        f"a step's device busy time {b['busy_ms']:.4f} ms with, {a['busy_ms']:.4f} without "
        f"(torch.profiler, 1 step); the step {b['step_ms']:.4f} / {a['step_ms']:.4f} ms "
        "(CUDA events around it, host waits included, median of 3)")
    extra = {k: b["launches"][k] - a["launches"][k] for k in a["launches"]
             if b["launches"][k] != a["launches"][k]}
    log(f"  launches a step with --remat {b['launches']}; the recompute's extra {extra}")
    return dict(bit_equal=same, checks=checks, peak_bytes=b["peak_bytes"],
                plain_peak_bytes=a["peak_bytes"], step_ms=b["step_ms"], plain_step_ms=a["step_ms"],
                busy_ms=b["busy_ms"], plain_busy_ms=a["busy_ms"],
                launches=b["launches"], extra_launches=extra)


def train_argv(seed: int, workdir: str, out: str, net_name: str = "NoiseDiffNet"):
    """The training CLI at the canonical config over the tree in workdir."""
    return [
        "--use_tb_logger", "--save_epoch_freq", "1", "--generation_result", "noise",
        "--name", "train_diffusion", "--net_name", net_name, "--beta_schedule", "sigmoid2",
        "--positional_encoding", "--trainset", "SonyTrainDataset", "--dim", str(DIM),
        "--crop_size", str(CROP), "--with_camera_settings", "--batch_size", str(BATCH),
        "--max_iter", "1", "--random_seed", str(seed), "--device", "cuda",
        "--num_workers", "4", "--log_freq", "5",
        "--sid_folder", os.path.join(workdir, "SID"), "--save_folder", out,
    ]


def _cli_rate(res) -> float:
    """Steps/s on the card's clock from the end of step 3 on of a CLI run's
    result: the mean gap between consecutive step ends within an epoch
    (each epoch's ends are counted from its own first step)."""
    ends, per_epoch = res["step_end_seconds"], res["steps"] // len(res["epoch_seconds"])
    gaps = [ends[i + 1] - ends[i] for i in range(2, res["steps"] - 1) if (i + 1) % per_epoch]
    return len(gaps) / sum(gaps)


# rank 0's snapshots of a one-epoch run of the training CLI
TRAIN_SNAPSHOTS = [f"{c}_{e}.pth" for c, e in (("net", 0), ("ema", 0), ("optimizer_G", 0),
                                               ("net", "final"), ("ema", "final"))]


def _load_noisediffnet(snap: str) -> None:
    import torch

    from noisediff_tpu_torch.models import NoiseDiffNet

    for c in ("net", "ema"):
        NoiseDiffNet(dim=DIM).load_state_dict(torch.load(
            os.path.join(snap, f"{c}_final.pth"), map_location="cpu", weights_only=True))


def _load_lsid(snap: str) -> None:
    import torch

    from noisediff_tpu_torch.models import LSID

    LSID().load_state_dict(torch.load(os.path.join(snap, "net_final.pth"), map_location="cpu",
                                      weights_only=True))


def phase_dist_cli(workdir: str, what: str, argv, snapshots, load, profile: bool = False):
    """One of the training CLIs as spawned processes, all started at once:
    --launcher none (one process, no launcher environment) and --launcher
    pytorch at world size 1 over NCCL, and world size 2 where the machine
    has 2 cards, each rank with its own save folder. The world-1 losses are
    bit-equal to the --launcher none run's; only rank 0 creates its run
    directory, logs and snapshots (`snapshots`: the file names), which
    `load` loads strictly; steps/s and global samples/s beside the
    one-process run's. `profile`: the largest world's run also takes
    --profile (its trace is phase_profile_cli's; `profile_folder`)."""
    import torch

    cli = "train_diffusion" if what == "train" else "train_denoising"
    name = argv[len(argv) - 1 - argv[::-1].index("--name") + 1]  # the run's --name
    worlds = [1] + ([2] if torch.cuda.device_count() >= 2 else [])
    runs = [("none", 1, "none", [])] + [
        (f"world{w}", w, "pytorch", ["--profile"] if profile and w == worlds[-1] else [])
        for w in worlds]
    folders, specs = {}, []
    for tag, world, launcher, extra in runs:
        folders[tag] = os.path.join(workdir, f"dist_{what}_{tag}", "rank{rank}", "weights")
        specs.append((dict(job="cli", name=f"{what}_{tag}", cli=cli,
                           argv=argv + ["--launcher", launcher, "--save_folder", folders[tag]]
                           + extra,
                           result=os.path.join(workdir, f"dist_{what}_{tag}.rank%d.json")),
                      world, launcher != "none"))
    results = dict(zip(folders, spawn_jobs(specs, workdir)))
    one = results["none"][0]
    out = {"none": one}
    for world in worlds:
        res, folder = results[f"world{world}"], folders[f"world{world}"]
        if world == 1 and res[0]["losses"] != one["losses"]:
            raise AssertionError(f"dist_cli {what}: world-1 NCCL losses {res[0]['losses']} are "
                                 f"not bit-equal to --launcher none's {one['losses']}")
        if any(r["losses"] != res[0]["losses"] for r in res):
            raise AssertionError(f"dist_cli {what}: the ranks logged different losses")
        run0 = os.path.join(folder.replace("{rank}", "0"), name)
        if sorted(os.listdir(os.path.join(run0, "snapshot"))) != sorted(snapshots):
            raise AssertionError(f"dist_cli {what}: rank 0 snapshots "
                                 f"{sorted(os.listdir(os.path.join(run0, 'snapshot')))}")
        if not glob.glob(os.path.join(run0, "*.log")):
            raise AssertionError(f"dist_cli {what}: rank 0 wrote no log file")
        for r in range(1, world):
            if os.path.exists(os.path.dirname(folder.replace("{rank}", str(r)))):
                raise AssertionError(f"dist_cli {what}: rank {r} created a run directory")
            if res[r]["snapshots"]:
                raise AssertionError(f"dist_cli {what}: rank {r} saved {res[r]['snapshots']}")
        load(os.path.join(run0, "snapshot"))
        out[f"world{world}"] = res
    per = BATCH if what == "train" else DENOISE_BATCH
    for tag, res in out.items():
        res = res if isinstance(res, list) else [res]
        world = len(res)
        rate = _cli_rate(res[0])
        log(f"  {what} {tag}: --launcher {'none' if 'none' in tag else 'pytorch'} world {world}"
            f"{'' if 'none' in tag else ' (NCCL)'}: {res[0]['steps']} steps a rank, "
            f"{rate:.4f} steps/s after the first 3 on the card's clock, {rate * per:.4f} global "
            f"samples/s; the run {res[0]['wall_s']:.2f} s wall; peak device memory "
            f"{res[0]['peak_bytes'] / 2 ** 30:.3f} GiB a rank; losses "
            f"{res[0]['losses'][0]:.6f} -> {res[0]['losses'][-1]:.6f}")
    log(f"  world-1 NCCL losses bit-equal to --launcher none's ({len(one['losses'])} steps); "
        "only rank 0 wrote its run directory, log and snapshots, which load strictly "
        f"(the {len(specs)} runs at once, so each rate was read under the others' load)")
    if profile:
        out.update(profile_folder=folders[f"world{worlds[-1]}"], profile_world=worlds[-1])
    return out


def phase_dist_gen(seed: int, workdir: str, ckpt: str, main_files):
    """test_diffusion --launcher pytorch with 2 ranks (NCCL, which
    generation never calls, so two ranks may share one card), DPM-10 over
    the main phase's grid, each rank with its own save folder: disjoint npy
    sets whose union has the one-process run's names; every patch finite
    in the reference CHW layout."""
    import numpy as np

    argv = gen_argv(workdir, ckpt, seed, "dist_gen/rank{rank}", ["--sampler", "dpm"])
    job = dict(job="cli", name="gen", cli="test_diffusion", argv=argv + ["--launcher", "pytorch"],
               result=os.path.join(workdir, "dist_gen.rank%d.json"))
    t0 = time.time()
    res = spawn_ranks(job, 2, workdir)
    wall = time.time() - t0
    names = []
    for r in res:
        files = sorted(glob.glob(os.path.join(r["out_dir"], "*.npy")))
        for path in files:
            arr = np.load(path)
            if arr.shape != (4, CROP, CROP) or not np.isfinite(arr).all():
                raise AssertionError(f"dist_gen: {path}: {arr.shape} or not finite")
        names.append({os.path.basename(p) for p in files})
    want = {os.path.basename(p) for p in main_files}
    if names[0] & names[1] or names[0] | names[1] != want or not all(names):
        raise AssertionError(f"dist_gen: rank sets {names} against the one-process set {want}")
    log(f"  2 ranks wrote {len(names[0])} + {len(names[1])} disjoint patches, the one-process "
        f"run's {len(want)} names, finite, CHW; batch seconds "
        f"{[[round(s, 4) for s in r['batch_seconds']] for r in res]}; {wall:.1f} s wall, "
        "start-up included")
    log(f"  launches by rank: {[r['launches'] for r in res]}")
    return dict(ranks=res)


def phase_profile_cli(workdir: str, dist_train: dict):
    """The training CLI with --profile under --launcher pytorch over NCCL,
    at world size 2 where the machine has 2 cards, else 1: the largest
    world's run of phase_dist_cli (`dist_train`; the same argv with
    --profile). Rank 0's trace of steps 5-9 exists under
    <save_folder>/profile and names the port's kernels with nonzero
    launches; the device time by kernel class and of the copies, and the
    NCCL all-reduce's share of the steps' device time and of their span (at
    world size 1 NCCL's in-place all-reduce of one rank launches nothing:
    DDP's cost there is its bucket copies)."""
    world, out = dist_train["profile_world"], dist_train["profile_folder"]
    traces = glob.glob(os.path.join(out.replace("{rank}", "0"), "train_diffusion", "profile",
                                    "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile: traces {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("profile: the trace has no kernel events")
    launches, ms = {}, {}
    for e in kernels + [e for e in events if e.get("cat") == "gpu_memcpy"]:
        if e.get("cat") == "gpu_memcpy":
            cat = "copies (gpu_memcpy)"
        elif "nccl" in e["name"].lower():
            cat = "NCCL all-reduce"
        else:
            cat = _category(e["name"])
        launches[cat] = launches.get(cat, 0) + 1
        ms[cat] = ms.get(cat, 0.0) + e.get("dur", 0) / 1e3
    for cat in ("attn_tail kernel", "attn_tail backward kernel",
                "GroupNorm statistics (gn_stats)", "gn_grad_stats kernel", "dual_head kernel"):
        if not launches.get(cat):
            raise AssertionError(f"profile: the trace names no {cat}: {launches}")
    steps = 5
    busy = sum(ms.values())
    span = (max(e["ts"] + e.get("dur", 0) for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    nccl = ms.get("NCCL all-reduce", 0.0)
    log(f"  {os.path.relpath(traces[0], workdir)}: {len(kernels)} kernels over {steps} steps; "
        f"device busy {busy / steps:.4f} ms a step, the kernels' span {span / steps:.4f} ms a step")
    log(f"  NCCL all-reduce (world {world}): {launches.get('NCCL all-reduce', 0)} kernels, "
        f"{nccl / steps:.4f} ms a step, {nccl / busy:.4f} of the busy time, {nccl / span:.4f} "
        "of the span")
    for cat, v in sorted(ms.items(), key=lambda kv: -kv[1]):
        log(f"    {v / steps:9.4f} ms a step  {launches[cat] / steps:7.1f} launches a step  {cat}")
    return dict(world=world, launches=launches, ms=ms, busy_ms=busy / steps,
                span_ms=span / steps, nccl_ms=nccl / steps)


# the UNet_PosEmbV2 family (models/others.py) at dim 48: the JAX package's
# pinned parameter counts (tests/test_models.py:50-63)
POSEMB_PARAMS = {"UNet_PosEmbV2": 19_702_596, "UNet_PosEmbV2_NoPosition": 19_700_308,
                 "UNet_PosEmbV2_CameraCond": 21_262_164}
POSEMB_CAM = "UNet_PosEmbV2_CameraCond"
# launches an evaluation: attn_tail at CameraCond's 8 AttnBlocks (4 down, 4
# up); groupnorm_silu at every GroupNorm but the per-pixel-FiLM ones of
# pos_block1/2's block1 (NoPosition's plain pos blocks run it: 2 more)
POSEMB_ATTN = {"UNet_PosEmbV2": 0, "UNet_PosEmbV2_NoPosition": 0,
               "UNet_PosEmbV2_CameraCond": 8}
POSEMB_GN_EVAL = {"UNet_PosEmbV2": 42, "UNet_PosEmbV2_NoPosition": 44,
                  "UNet_PosEmbV2_CameraCond": 42}
# a training step: gn_stats and gn_grad_stats at all 44 GroupNorms; on the
# NOISEDIFF_WGRAD=pallas route conv_wgrad at the 59 stride-1 1x1 / 3x3 convs
# with Ci, Co >= 32 (tests/test_torch_port_posemb.py counts both on the CPU)
POSEMB_GN_STEP = 44
POSEMB_WGRAD_PER_STEP = 59
# the forward on the card (bf16, kernels) against the CPU in fp32: the bound
# of the NoiseDiffNet forward's check (phase_model)
POSEMB_FWD_REL = 5e-2
POSEMB_FWD_SHAPE = (2, 128)  # B, side
LINATTN_SHAPE = (4, 384, 64, 64)  # B, C, H, W
INTERP_T = 10


def posemb_per_batch(name: str, evals: int):
    """Each kernel's launches in a generation batch of `evals` evaluations."""
    out = {k: 0 for k in KERNEL_WRAPPERS}
    out.update(fused_attn_tail=POSEMB_ATTN[name] * evals,
               fused_groupnorm_film_silu=POSEMB_GN_EVAL[name] * evals)
    return out


def posemb_per_step(name: str, wgrad: bool):
    """Each kernel's launches in a training step (wgrad: the conv_wgrad
    route)."""
    out = {k: 0 for k in KERNEL_WRAPPERS}
    out.update(fused_attn_tail=POSEMB_ATTN[name], fused_attn_tail_bwd=POSEMB_ATTN[name],
               gn_stats=POSEMB_GN_STEP, gn_grad_stats=POSEMB_GN_STEP,
               conv_wgrad=POSEMB_WGRAD_PER_STEP if wgrad else 0)
    return out


def _posemb_cfg():
    from types import SimpleNamespace

    return SimpleNamespace(dim=DIM, inp_dim=4, cond_dim=4)


def _posemb_inputs(b: int, s: int, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, s, 4)).astype(np.float32))
    cond = {"clean_img": torch.from_numpy(rng.uniform(0, 0.3, (b, s, s, 4)).astype(np.float32)),
            "position": torch.from_numpy(rng.uniform(0, 1, (b, s, s, 2)).astype(np.float32)),
            "iso_ratio_idx": torch.from_numpy(rng.integers(0, 75, b))}
    t = torch.from_numpy(rng.integers(0, 1000, b))
    return x, t, cond


def posemb_forward_check(seed: int, name: str):
    """The parameter count at dim 48, then one forward on the card (bf16,
    the kernels) against the same weights in fp32 on the CPU (the plain
    versions), with the kernels' launches of the evaluation."""
    import torch

    from noisediff_tpu_torch.models import define_network
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.manual_seed(seed)
    cpu = define_network(name, _posemb_cfg()).eval()
    n = sum(p.numel() for p in cpu.parameters())
    if n != POSEMB_PARAMS[name]:
        raise AssertionError(f"{name}: {n} parameters at dim {DIM}, expected "
                             f"{POSEMB_PARAMS[name]}")
    card = define_network(name, _posemb_cfg(), dtype=torch.bfloat16)
    card.load_state_dict(cpu.state_dict(), strict=True)
    card = card.cuda().to(memory_format=torch.channels_last).eval()
    b, s = POSEMB_FWD_SHAPE
    x, t, cond = _posemb_inputs(b, s, seed)
    with torch.inference_mode():
        want = cpu(x, t, cond)
        reset_launch_counts()
        got = card(x.cuda(), t.cuda(), {k: v.cuda() for k, v in cond.items()}).float().cpu()
        counts = launch_counts()
    if got.shape != (b, s, s, 4) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} forward on the card: shape {tuple(got.shape)} or not "
                             "finite")
    want_counts = posemb_per_batch(name, 1)
    if counts != want_counts:
        raise AssertionError(f"{name} forward launches {counts}, expected {want_counts}")
    rel = rel_l2(got, want)
    log(f"  {name}: {n} parameters; forward {b}x{s}^2 card bf16 vs CPU fp32 rel L2 {rel:.4g}; "
        f"launches {({k: v for k, v in counts.items() if v})}")
    if rel > POSEMB_FWD_REL:
        raise AssertionError(f"{name}: card forward disagrees with the CPU: rel L2 {rel}")
    return {"params": n, "rel_l2": rel}


def posemb_profile(seed: int, steps: int = PROFILE_STEPS, evals: int = 3):
    """UNet_PosEmbV2_CameraCond at the canonical shape: the device busy time
    of an evaluation and of a training step (torch.profiler), with the
    profiled wall time and the idle share, and the step's peak memory."""
    import torch

    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import define_network
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.train.state import make_diffusion_train_step, make_optimizer

    torch.manual_seed(seed)
    dev = torch.device("cuda")
    model = define_network(POSEMB_CAM, _posemb_cfg(), dtype=torch.bfloat16)
    model = model.to(dev, memory_format=torch.channels_last)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = _canonical_batch(g, dev)
    cond = {"clean_img": batch["clean_img"], "position": batch["coord"],
            "iso_ratio_idx": batch["iso_ratio_idx"]}
    x = torch.randn((BATCH, CROP, CROP, 4), generator=g, device=dev)
    t = torch.full((BATCH,), 500, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}

    def profiled(fn, n):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        by_name = _device_ms_by_name(prof, n)
        cats = {}
        for name, ms in by_name.items():
            cats[_category(name)] = cats.get(_category(name), 0.0) + ms
        return sum(by_name.values()), wall, cats

    model.eval()
    with torch.inference_mode():
        eval_ms = time_ms(lambda: model(x, t, cond), reps=10, warmup=2)
        busy, wall, cats = profiled(lambda: model(x, t, cond), evals)
    out["eval"] = dict(cuda_event_ms=eval_ms, busy_ms=busy, wall_ms=wall, categories=cats)
    model.train()
    gd = GaussianDiffusion(model, make_schedule("sigmoid2", 1000), image_size=CROP, device=dev)
    step = make_diffusion_train_step(gd, make_optimizer(model.parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(batch, g), reps=steps, warmup=2)
    busy_s, wall_s, cats_s = profiled(lambda: step(batch, g), steps)
    peak = torch.cuda.max_memory_allocated()
    out["step"] = dict(cuda_event_ms=step_ms, busy_ms=busy_s, wall_ms=wall_s, categories=cats_s,
                       peak_bytes=peak)
    for what, r in out.items():
        log(f"  {POSEMB_CAM} one {'evaluation' if what == 'eval' else 'training step'} "
            f"({BATCH}x{CROP}^2, bf16): {r['cuda_event_ms']:.4f} ms by CUDA events"
            + (f", peak {peak / 2 ** 30:.3f} GiB" if what == "step" else ""))
        if not r["busy_ms"]:
            log("  torch.profiler recorded no device time")
            continue
        log(f"    device busy {r['busy_ms']:.4f} ms, profiled wall {r['wall_ms']:.4f} ms (idle "
            f"share {max(0.0, 1 - r['busy_ms'] / r['wall_ms']):.4f})")
        for cat, ms in sorted(r["categories"].items(), key=lambda kv: -kv[1]):
            log(f"    {ms:9.4f} ms  {100 * ms / r['busy_ms']:5.1f}%  {cat}")
    return out


def posemb_surface(seed: int, ckpt: str):
    """blocks.LinearAttention on the card (bf16) against the CPU (fp32), and
    GaussianDiffusion.interpolate at t = INTERP_T from ckpt's
    UNet_PosEmbV2_CameraCond weights at the canonical shape: finite, NHWC."""
    import numpy as np
    import torch

    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import define_network
    from noisediff_tpu_torch.models.blocks import LinearAttention
    from noisediff_tpu_torch.ops.schedules import make_schedule
    from noisediff_tpu_torch.weights import load_into

    b, c, h, w = LINATTN_SHAPE
    torch.manual_seed(seed)
    cpu = LinearAttention(c)
    card = LinearAttention(c)
    card.load_state_dict(cpu.state_dict())
    card = card.cuda()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        want = cpu(x)
        got = card(x.cuda().to(torch.bfloat16)).float().cpu()
    rel = rel_l2(got, want)
    log(f"  LinearAttention({c}) at {b}x{h}x{w}, card bf16 vs CPU fp32: rel L2 {rel:.4g}")
    if rel > ATTN_REL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"LinearAttention: card and CPU disagree: rel L2 {rel}")

    dev = torch.device("cuda")
    model = define_network(POSEMB_CAM, _posemb_cfg(), dtype=torch.bfloat16)
    load_into(model, ckpt)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    gd = GaussianDiffusion(model, make_schedule("sigmoid2", 1000), image_size=CROP, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = _canonical_batch(g, dev)
    cond = {"clean_img": batch["clean_img"], "position": batch["coord"],
            "iso_ratio_idx": batch["iso_ratio_idx"]}
    x1 = 0.05 * torch.randn((BATCH, CROP, CROP, 4), generator=g, device=dev)
    x2 = 0.05 * torch.randn((BATCH, CROP, CROP, 4), generator=g, device=dev)
    t0 = time.perf_counter()
    y = gd.interpolate(x1, x2, cond, t=INTERP_T, lam=0.5, generator=g)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if y.shape != x1.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"interpolate: shape {tuple(y.shape)} or not finite")
    log(f"  interpolate at t={INTERP_T} ({INTERP_T} evaluations, {BATCH}x{CROP}^2): finite "
        f"{tuple(y.shape)}, std {float(y.std()):.4g}, {secs:.3f} s")
    return {"linear_attention_rel_l2": rel, "interpolate_seconds": secs}


def phase_posemb(seed: int, workdir: str):
    """The UNet_PosEmbV2 family at dim 48, crop 512, batch 4, bf16: each
    net's parameter count and its forward against the CPU;
    UNet_PosEmbV2_CameraCond trained through the training CLI on both
    wgrad routes (one epoch of the miniature tree, TRAIN_STEPS steps) and
    sampled through the generation CLI from its net_final.pth (DPM-10, 2
    batches; DDIM-100 unfused, 1 batch); UNet_PosEmbV2 and
    UNet_PosEmbV2_NoPosition trained one epoch and sampled 1 DPM-10 batch
    each; each run's launches counted from zero against the tables above;
    CameraCond's device busy time an evaluation and a step; LinearAttention
    and interpolate on the card."""
    import torch

    out = {"forward": {name: posemb_forward_check(seed, name) for name in POSEMB_PARAMS}}
    make_train_tree(workdir, seed)
    gen2, gen1 = os.path.join(workdir, "gen2"), os.path.join(workdir, "gen1")
    make_sid_tree(gen2, seed)
    make_sid_tree(gen1, seed, batches=1)
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    def snapshot(run):
        return os.path.join(run["out"], "train_diffusion", "snapshot", "net_final.pth")

    train = {}
    for route in ("xla", "pallas"):
        if route == "pallas":
            os.environ["NOISEDIFF_WGRAD"] = "pallas"
        try:
            train[route] = train_cli(seed, workdir, f"posemb_{route}",
                                     posemb_per_step(POSEMB_CAM, route == "pallas"),
                                     f"{POSEMB_CAM} train ({route})", net_name=POSEMB_CAM)
        finally:
            os.environ.pop("NOISEDIFF_WGRAD", None)
        add(train[route]["counts"])
    ckpt = snapshot(train["xla"])
    torch.cuda.reset_peak_memory_stats()
    dpm = run_generation(gen_argv(gen2, ckpt, seed, "dpm", ["--sampler", "dpm"], POSEMB_CAM),
                         posemb_per_batch(POSEMB_CAM, DPM_STEPS), f"{POSEMB_CAM} dpm")
    gen_peak = torch.cuda.max_memory_allocated()
    ddim = run_generation(gen_argv(gen1, ckpt, seed, "ddim", [
        "--sampler", "ddim", "--sampling_timesteps", str(DDIM_STEPS)], POSEMB_CAM),
        posemb_per_batch(POSEMB_CAM, DDIM_STEPS), f"{POSEMB_CAM} ddim (unfused)", batches=1)
    add(dpm["counts"])
    add(ddim["counts"])
    log(f"  {POSEMB_CAM}: training {train['xla']['steps_per_s']:.4f} steps/s (conv_wgrad route "
        f"{train['pallas']['steps_per_s']:.4f}), peak {train['xla']['peak_bytes'] / 2 ** 30:.3f} "
        f"GiB ({train['pallas']['peak_bytes'] / 2 ** 30:.3f}); DPM-10 "
        f"{dpm['steady_patches_per_s']:.4f} patches/s after the first batch, generation peak "
        f"{gen_peak / 2 ** 30:.3f} GiB; DDIM-{DDIM_STEPS} {ddim['patches_per_s']:.4f} "
        "patches/s")
    others = {}
    for name in ("UNet_PosEmbV2", "UNet_PosEmbV2_NoPosition"):
        t = train_cli(seed, workdir, f"posemb_{name}", posemb_per_step(name, False),
                      f"{name} train", net_name=name)
        g = run_generation(gen_argv(gen1, snapshot(t), seed, f"dpm_{name}", ["--sampler", "dpm"],
                                    name), posemb_per_batch(name, DPM_STEPS), f"{name} dpm",
                           batches=1)
        add(t["counts"])
        add(g["counts"])
        others[name] = {"steps_per_s": t["steps_per_s"], "patches_per_s": g["patches_per_s"]}
    out["profile"] = posemb_profile(seed)
    out["surface"] = posemb_surface(seed, ckpt)
    out.update(counts=counts, train=train, dpm=dpm, ddim=ddim, gen_peak_bytes=gen_peak,
               others=others)
    return out


# the learning gate (scripts/port_learning_gate.py) at its smoke scale: the
# gpu scale's dim 48, crop 64, training batch 16 (stages 64^2 x 48 .. 8^2 x
# 384) and generation batch 32, with its epochs cut
GATE_TRAIN_B, GATE_GEN_B, GATE_CROP = 16, 32, 64
GATE_STAGES = [(GATE_CROP >> i, DIM << i) for i in range(4)]
# the wrappers the gate's default route must launch (conv_wgrad only under
# NOISEDIFF_WGRAD=pallas, flash_attention on no shipped model)
GATE_KERNELS = ("attn_tail", "attn_tail_bwd", "gn_stats", "gn_grad_stats", "dual_head",
                "groupnorm_silu", "ddim_head")


def _gate_row(name, shape, what, err, fn, ref, b):
    """A gate-shape row: calls 0 (it adds to no per-evaluation or per-step
    sum), the path that gives the shape, per-call times beside the bound."""
    ms = time_ms(fn, reps=5)
    plain = time_ms(ref, reps=3, warmup=1)
    log(f"  gate {name} {list(shape)} ({what}): {ms:.4f} ms (plain {plain:.4f}, bound {b[0]:.4f} "
        f"{b[1]}), max abs err {err:.3g}")
    return dict(shape=list(shape), gate=what, calls=0, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], max_abs_err=err)


def kernels_gate(randn):
    """The seven kernels of the gate's default route against their plain
    versions at the gate's own shapes, which no other phase gives:
    attn_tail, groupnorm_silu and dual_head through kernels_stages at the
    training batch (B 16) and the generation batch (B 32), 64^2 x 48 ..
    8^2 x 384; then what only the gate runs at these shapes: attn_tail's
    backward, gn_stats and gn_grad_stats at B 16 over the four stages, and
    the DDIM tail at B 32, 64^2; the stated tolerances, two calls
    bit-equal."""
    import torch

    from noisediff_tpu_torch.ops.kernels import (
        ddim_step_scalars, fused_attn_tail_bwd, fused_ddim_head_update, gn_grad_stats, gn_stats,
        reference_attn_tail_bwd, reference_ddim_head_update, reference_gn_grad_stats,
        reference_gn_stats)
    from noisediff_tpu_torch.ops.schedules import make_schedule

    rows = {name: [] for name in GATE_KERNELS}
    stages = [(res, res, c) for res, c in GATE_STAGES]
    for b, what in ((GATE_TRAIN_B, "training"), (GATE_GEN_B, "generation")):
        for name, rs in kernels_stages(randn, b, stages, f"gate {what}", "eval_calls",
                                       {"gate": what}).items():
            rows[name] += rs

    def equal_twice(name, fn, got):
        again = fn()
        same = (all(torch.equal(a, b) for a, b in zip(got, again))
                if isinstance(got, tuple) else torch.equal(got, again))
        if not same:
            raise AssertionError(f"gate {name}: two calls differ")

    b = GATE_TRAIN_B
    for res, c in GATE_STAGES:
        x = randn(b, res, res, c, scale=1.5, dtype=torch.bfloat16) + 0.3
        g = randn(b, res, res, c, dtype=torch.bfloat16)
        args = attn_tail_args(randn, x, g)
        err, rels = check_attn_tail_bwd(f"gate {tuple(x.shape)}", args)
        row = _gate_row("attn_tail_bwd", x.shape, "training", err,
                        lambda: fused_attn_tail_bwd(*args),
                        lambda: reference_attn_tail_bwd(*args), attn_tail_bwd_bound(x))
        rows["attn_tail_bwd"].append(dict(row, rel_l2=rels))
        out_bytes = 2 * b * c * 4
        for name, fn, ref, sargs, reads in (
                ("gn_stats", gn_stats, reference_gn_stats, (x,), nbytes(x)),
                ("gn_grad_stats", gn_grad_stats, reference_gn_grad_stats, (g, x),
                 2 * nbytes(x))):
            got = fn(*sargs)
            err = max(compare_scaled(name, a, w, SUM_RTOL) for a, w in zip(got, ref(*sargs)))
            equal_twice(name, lambda: fn(*sargs), got)
            rows[name].append(_gate_row(
                name, x.shape, "training", err, lambda: fn(*sargs), lambda: ref(*sargs),
                bound(reads + out_bytes, 3 * x.numel(), PEAK_FP32_FLOPS)))
        del x, g, args
    torch.cuda.empty_cache()
    # a middle step of the gate's DDIM-50 over T 1000, eta 0, at the
    # generation batch
    res, c = GATE_STAGES[0]
    x, sa, sb = (randn(GATE_GEN_B, res, res, c, dtype=torch.bfloat16) for _ in range(3))
    xt = randn(GATE_GEN_B, res, res, 4)
    ac = make_schedule("sigmoid2", 1000).alphas_cumprod
    scal = ddim_step_scalars(ac[499], ac[479], 0.0, (1.0 - ac[479]) ** 0.5)
    dargs = (x, sa, sb, xt, None) + head_params(randn, c) + (scal,)
    got = fused_ddim_head_update(*dargs)
    err = compare("ddim_head", got, reference_ddim_head_update(*dargs))
    equal_twice("ddim_head", lambda: fused_ddim_head_update(*dargs), got)
    row = _gate_row("ddim_head", x.shape, "generation", err,
                    lambda: fused_ddim_head_update(*dargs),
                    lambda: reference_ddim_head_update(*dargs),
                    bound(*head_work(x, 2 * nbytes(xt)), PEAK_BF16_FLOPS))
    rows["ddim_head"].append(dict(row, sigma=0.0, library_ms=None))
    return rows


def phase_gate(seed: int, workdir: str):
    """The closed-loop learning gate through the port's CLIs at its smoke
    scale on the card (bf16): the seven kernels checked at its shapes
    first, then the gate run counted from zero; asserts the JAX slow test's
    three thresholds and that each of the seven kernels launched."""
    import importlib.util

    import torch

    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    rows = kernels_gate(randn)
    torch.cuda.empty_cache()

    spec = importlib.util.spec_from_file_location(
        "port_learning_gate", os.path.join(PORT_DIR, "scripts", "port_learning_gate.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    reset_launch_counts()
    t0 = time.time()
    result = gate.main(["--scale", "smoke", "--seed", str(seed), "--workdir",
                        os.path.join(workdir, "gate")])
    seconds = time.time() - t0
    counts = launch_counts()
    log(f"  smoke scale {result['config']}: {seconds:.1f} s; stages "
        f"{ {k: round(v, 1) for k, v in result['seconds'].items()} }")
    log(f"  KLD untrained {result['kld_untrained']['kld_symmetric']:.6f}, DDIM "
        f"{result['kld_trained']['kld_symmetric']:.6f} (improvement "
        f"{result['kld_improvement']:.4f}), DPM-10 "
        f"{result['kld_trained_dpm']['kld_symmetric']:.6f} (DPM / DDIM "
        f"{result['dpm_vs_ddim_kld_ratio']:.4f}); generated std "
        f"{result['generated_noise_std']:.6f}; PSNR noisy {result['psnr_noisy_input']:.4f}, "
        f"denoised {result['psnr_denoised']:.4f} dB (gain {result['psnr_gain']:.4f}), SSIM "
        f"{result['ssim_denoised']:.6f}")
    if result["missed"]:
        raise AssertionError(f"gate: thresholds missed: {result['missed']}")
    missing = [name for name in GATE_KERNELS if counts[KERNEL_META[name][0]] == 0]
    if missing:
        raise AssertionError(f"gate: {missing} launched no time in the gate run: {counts}")
    log(f"  thresholds {result['thresholds']} passed; launches: {counts}")
    return dict(rows=rows, counts=counts, result=result, seconds=seconds)


# the inference kernels the sweep phase must launch, and how far apart its
# fused and unfused DDIM KLDs may be: both are bf16 on the card from the
# same draws, the fused tail carrying its update in fp32
SWEEP_KERNELS = ("attn_tail", "groupnorm_silu", "dual_head", "ddim_head")
SWEEP_DDIM_RTOL = 0.02
# the sweep's depth: DDIM at 20 steps (the smoke scale's 50 took 45 of the
# phase's 63 s; the fused and unfused legs still run from the same draws)
# and DPM-5 on the lambda grid
SWEEP_DDIM_STEPS = 20
SWEEP_DPM_STEPS = "5"


def phase_sweep(workdir: str):
    """The sampler KLD sweep on the gate phase's smoke workdir, counted
    from zero: the EMA weights at DPM-SWEEP_DPM_STEPS (lambda grid) and
    DDIM-SWEEP_DDIM_STEPS fused and unfused. Asserts each of SWEEP_KERNELS
    launched and the two DDIM KLDs within SWEEP_DDIM_RTOL of each other."""
    import importlib.util

    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    spec = importlib.util.spec_from_file_location(
        "port_dpm_step_sweep", os.path.join(PORT_DIR, "scripts", "port_dpm_step_sweep.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    reset_launch_counts()
    t0 = time.time()
    result = sweep.main(["--workdir", os.path.join(workdir, "gate"), "--scale", "smoke",
                         "--steps", SWEEP_DPM_STEPS, "--spacing", "lambda",
                         "--set", f"ddim={SWEEP_DDIM_STEPS}"])
    seconds = time.time() - t0
    counts = launch_counts()
    rows = {(r["sampler"], r["steps"]): r for r in result["sweep"]}
    for r in result["sweep"]:
        log(f"  {r['sampler']}-{r['steps']}{' ' + r['spacing'] if r['spacing'] else ''}: KLD "
            f"{r['kld_symmetric']:.6f} ({r['vs_ddim_ratio']:.4f} of DDIM), std "
            f"{r['generated_noise_std']:.6f}, {r['seconds']:.1f} s")
    fused = rows[("ddim", SWEEP_DDIM_STEPS)]["kld_symmetric"]
    unfused = rows[("ddim_unfused", SWEEP_DDIM_STEPS)]["kld_symmetric"]
    rel = abs(unfused - fused) / fused
    log(f"  {seconds:.1f} s; DDIM-{SWEEP_DDIM_STEPS} fused {fused:.6f} against unfused "
        f"{unfused:.6f}: "
        f"{rel:.4%} apart (tolerance {SWEEP_DDIM_RTOL:.0%}); launches: {counts}")
    if rel > SWEEP_DDIM_RTOL:
        raise AssertionError(f"sweep: fused DDIM KLD {fused} and unfused {unfused} are "
                             f"{rel:.4%} apart (tolerance {SWEEP_DDIM_RTOL:.0%})")
    missing = [name for name in SWEEP_KERNELS if counts[KERNEL_META[name][0]] == 0]
    if missing:
        raise AssertionError(f"sweep: {missing} launched no time in the sweep: {counts}")
    return dict(counts=counts, result=result, seconds=seconds)


# ---------------------------------------------------------------------------
# the int8 route (NOISEDIFF_INT8=1)
PEAK_INT8_OPS = 1979e12
# LSID's evaluation: one packed full SID frame, fp32 (the evaluation CLI)
INT8_LSID_INPUT = (1, FULLFRAME[0], FULLFRAME[1], 4)
# shapes no main path gives (B, H, W, Ci, Co, k, padding): ragged depth
# steps (Ci 24, 48; 20, not a multiple of 8), Co 16, 72 and 20 (not a
# multiple of 8), padding (0, 1) (a split frame's rows with their halos),
# H and W of 1, odd sizes
INT8_RAGGED = [(2, 37, 53, 24, 16, 3, (1, 1)), (1, 19, 23, 48, 72, 3, (0, 1)),
               (3, 1, 1, 48, 24, 3, (1, 1)), (2, 9, 1, 16, 16, 1, (0, 0)),
               (1, 33, 17, 20, 20, 3, (1, 1))]


@contextlib.contextmanager
def int8_route():
    """NOISEDIFF_INT8=1 while models are built inside: each Conv2d reads it
    at construction (the trainers refuse it; generation and evaluation take
    it)."""
    old = os.environ.get("NOISEDIFF_INT8")
    os.environ["NOISEDIFF_INT8"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["NOISEDIFF_INT8"]
        else:
            os.environ["NOISEDIFF_INT8"] = old


def int8_calls(model, *inputs):
    """{(x shape, kq shape, padding, into, bias): calls} of one forward of
    `model` (built under `int8_route`) on the card."""
    import torch

    from noisediff_tpu_torch.models import blocks

    seen = {}
    real = blocks.int8_conv

    def rec(x, kq, sw, amax, padding, bias=None, into=None):
        key = (tuple(x.shape), tuple(kq.shape), tuple(padding), into is not None,
               bias is not None)
        seen[key] = seen.get(key, 0) + 1
        return real(x, kq, sw, amax, padding, bias, into)

    blocks.int8_conv = rec
    try:
        with torch.no_grad():
            model(*inputs)
        if inputs[0].is_cuda:
            torch.cuda.synchronize()
    finally:
        blocks.int8_conv = real
    return seen


def int8_operands(randn, key, dtype):
    """Seeded operands of one int8 call shape: x, the quantized weight,
    max|x| (the kernel's, held equal to the plain version's), the bias
    and the previous part's output where the call has them."""
    import torch

    from noisediff_tpu_torch.ops.kernels import absmax, reference_absmax
    from noisediff_tpu_torch.ops.kernels.int8_conv import out_size, quantize_weight

    (b, h, w, ci), (co, k, _, _), pad, has_into, has_bias = key
    x = randn(b, h, w, ci, scale=2.0, dtype=dtype)
    kq, sw = quantize_weight(randn(co, ci, k, k, scale=(ci * k * k) ** -0.5))
    ho, wo = out_size(x.shape, kq.shape, pad)
    into = randn(b, ho, wo, co, dtype=dtype) if has_into else None
    bias = randn(co, scale=0.1) if has_bias else None
    amax = absmax(x)
    if not torch.equal(amax, reference_absmax(x)):
        raise AssertionError(f"absmax {key} {dtype}: {float(amax)} against "
                             f"{float(reference_absmax(x))}")
    return x, kq, sw, amax, pad, bias, into


def int8_check(randn, key, dtype, want_route=None):
    """The kernel against its plain version at one call shape: bit-equal
    (the integer sums are exact on both sides and every other step is the
    same IEEE operation), launched on the route `int8_conv.route` names
    (on the card its counter moves by one, the other's not; on the CPU the
    plain version runs and neither moves; `want_route` where the caller
    knows it); returns the operands and the route."""
    import torch

    from noisediff_tpu_torch.ops.kernels import int8_conv, int8_conv_small, reference_int8_conv
    from noisediff_tpu_torch.ops.kernels.int8_conv import route

    ops = int8_operands(randn, key, dtype)
    x, kq, sw, amax, pad, bias, into = ops
    r = route(x, kq, into)
    before = (int8_conv.launches, int8_conv_small.launches)
    got = int8_conv(x, kq, sw, amax, pad, bias, None if into is None else into.clone())
    moved = (int8_conv.launches - before[0], int8_conv_small.launches - before[1])
    expect = ((1, 0) if r == "tiled" else (0, 1)) if x.is_cuda else (0, 0)
    if moved != expect or want_route not in (None, r):
        raise AssertionError(f"int8_conv {key} {dtype}: route {r} (wanted {want_route}), "
                             f"counters moved {moved}")
    want = reference_int8_conv(x, kq, sw, amax, pad, bias, into)
    if got.shape != want.shape or not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max()) if got.shape == want.shape else -1
        raise AssertionError(f"int8_conv {key} {dtype}: not bit-equal to the plain version "
                             f"({r} kernel), max abs err {err}")
    return ops, r


def int8_rows(randn, key, dtype, calls: dict):
    """Check one main-path call shape (on the tiled route) and time it: the
    tiled kernel (per call and on the card's clock) and the small kernel
    (the first design, on the card's clock) in turns on the same inputs
    (tiled, small, small, tiled), the plain version, the bound, cuDNN's
    bf16 conv of the same shape (the yardstick) and, at a 1x1,
    torch._int_mm of the same integer product (library_ms; no PyTorch call
    computes the quantized conv itself); absmax beside
    torch.linalg.vector_norm(x, inf). Returns (int8_conv row, absmax row)."""
    import torch
    import torch.nn.functional as F

    from noisediff_tpu_torch.ops.kernels import absmax, int8_conv, int8_conv_small
    from noisediff_tpu_torch.ops.kernels import reference_absmax, reference_int8_conv

    (x, kq, sw, amax, pad, bias, into), r = int8_check(randn, key, dtype, want_route="tiled")
    (b, h, w, ci), (co, k, _, _) = key[:2]
    dst = None if into is None else into.clone()
    fn = lambda: int8_conv(x, kq, sw, amax, pad, bias, dst)  # noqa: E731
    small = lambda: int8_conv_small(x, kq, sw, amax, pad, bias, dst)  # noqa: E731
    turns = {"tiled": [], "small": []}
    for name, f in (("tiled", fn), ("small", small), ("small", small), ("tiled", fn)):
        turns[name].append(time_device_ms(f, n=10, reps=2))
    dev_ms, small_ms = (statistics.mean(turns[n]) for n in ("tiled", "small"))
    ms = time_ms(fn, reps=10)
    plain = time_ms(lambda: reference_int8_conv(x, kq, sw, amax, pad, bias, into), reps=3,
                    warmup=1)
    out = fn()
    ops = 2.0 * out.numel() * ci * k * k
    io = nbytes(x, kq, sw, out) + (nbytes(into) if into is not None else 0)
    b_ms, b_by = bound(io, ops, PEAK_INT8_OPS)
    xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    wc = torch.randn(co, ci, k, k, device=x.device, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    cudnn = time_device_ms(lambda: F.conv2d(xc, wc, padding=pad), n=10, reps=2)
    library = None
    if k == 1:
        xq = torch.randint(-127, 128, (b * h * w, ci), device=x.device, dtype=torch.int8)
        try:
            library = time_device_ms(lambda: torch._int_mm(xq, kq[:, 0, 0, :ci].t()), n=10,
                                     reps=2)
        except RuntimeError as exc:
            log(f"    torch._int_mm refused ({b * h * w}, {ci}) x ({ci}, {co}): {exc}")
    tag = dict(shape=[b, h, w, ci], dtype=str(dtype).replace("torch.", ""), **calls)
    conv = dict(tag, kernel=[co, k, k, ci], padding=list(pad), into=into is not None,
                bias=bias is not None, route=r, ms=ms, device_ms=dev_ms, small_device_ms=small_ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=library,
                cudnn_bf16_ms=cudnn, max_abs_err=0.0)
    a_dev = time_device_ms(lambda: absmax(x), n=10, reps=2)
    a_ms = time_ms(lambda: absmax(x), reps=5)
    a_plain = time_ms(lambda: reference_absmax(x), reps=3, warmup=1)
    a_lib = time_device_ms(lambda: torch.linalg.vector_norm(x, float("inf")), n=10, reps=2)
    a_bound = nbytes(x) / PEAK_BYTES * 1e3
    amax_row = dict(tag, ms=a_ms, device_ms=a_dev, plain_ms=a_plain, bound_ms=a_bound,
                    bound_by="bytes", library_ms=a_lib, max_abs_err=0.0)
    log(f"    {key[0]} x {co}x{k}x{k} pad {tuple(pad)}{' +into' if into is not None else ''}"
        f"{' +bias' if bias is not None else ''} {conv['dtype']} {calls}: {r} dev {dev_ms:.4f} ms "
        f"({dev_ms / b_ms:.2f}x the bound {b_ms:.4f} {b_by}; small kernel {small_ms:.4f}, "
        f"{small_ms / b_ms:.2f}x; per call {ms:.4f}; plain {plain:.3f}; cuDNN bf16 {cudnn:.4f}"
        f"{'' if library is None else f'; _int_mm {library:.4f}'}); absmax dev {a_dev:.4f} "
        f"({a_dev / a_bound:.2f}x {a_bound:.4f}; vector_norm {a_lib:.4f})")
    return conv, amax_row


def phase_int8_kernels(seed: int):
    """The int8 kernels against their plain versions at every call shape
    of one int8 evaluation of NoiseDiffNet dim 48 (B 4, 512^2, bf16; read
    from a forward on the card) and of LSID's evaluation (one packed full
    frame, fp32), both dtypes at each, and at INT8_RAGGED: bit-equal, and
    absmax equal to max |x|. The main path's dtype at each is timed (rows
    with `calls`, the convs of one generation evaluation, or `lsid_calls`,
    one LSID evaluation)."""
    import torch

    from noisediff_tpu_torch.models import LSID, NoiseDiffNet

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 19)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    t0 = time.time()
    with int8_route():
        torch.manual_seed(seed)
        net = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16).to(dev).eval()
        lsid = LSID().to(dev).eval()
    x = randn(BATCH, CROP, CROP, 4)
    cond = {"clean_img": x.abs() * 0.1, "position": x[..., :2].abs(),
            "iso_ratio_idx": torch.tensor([24, 3, 5, 7], device=dev)}
    gen = int8_calls(net, x, torch.tensor([999, 500, 20, 3], device=dev), cond)
    lsid_calls = int8_calls(lsid, randn(*INT8_LSID_INPUT, scale=0.05).abs())
    del net, lsid, x, cond
    torch.cuda.empty_cache()
    n_gen, n_lsid = sum(gen.values()), sum(lsid_calls.values())
    log(f"  {n_gen} int8 convs an evaluation of NoiseDiffNet dim {DIM} at {BATCH}x{CROP}^2 "
        f"(bf16) over {len(gen)} call shapes, {len({k[:2] for k in gen})} (input, kernel) "
        f"shapes; LSID at {INT8_LSID_INPUT} (fp32): {n_lsid} over {len(lsid_calls)}")
    conv_rows, amax_rows = [], []
    for keys, timed, other, field in ((gen, torch.bfloat16, torch.float32, "calls"),
                                      (lsid_calls, torch.float32, torch.bfloat16, "lsid_calls")):
        for key, n in sorted(keys.items()):
            calls = {"calls": 0, "lsid_calls": 0}
            calls[field] = n
            c, a = int8_rows(randn, key, timed, calls)
            conv_rows.append(c)
            amax_rows.append(a)
            int8_check(randn, key, other, want_route="tiled")
            torch.cuda.empty_cache()
    ragged = {}
    for b, h, w, ci, co, k, pad in INT8_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            for into, bias in ((False, False), (True, True)):
                _, r = int8_check(randn, ((b, h, w, ci), (co, k, k, ci + (-ci % 32)), pad, into,
                                          bias), dtype)
                ragged[r] = ragged.get(r, 0) + 1
    log(f"  every shape bit-equal to the plain version in fp32 and bf16 on the tiled kernel "
        f"(and {len(INT8_RAGGED)} ragged shapes with and without the previous part and the "
        f"bias, by route {ragged}); {time.time() - t0:.1f} s")
    tot = {k: sum(r[k] * r["calls"] for r in conv_rows)
           for k in ("device_ms", "small_device_ms", "bound_ms", "cudnn_bf16_ms")}
    a_tot = {k: sum(r[k] * r["calls"] for r in amax_rows) for k in ("device_ms", "bound_ms")}
    lsid_tot = {k: sum(r[k] * r["lsid_calls"] for r in conv_rows)
                for k in ("device_ms", "small_device_ms", "bound_ms", "cudnn_bf16_ms")}
    log(f"  an evaluation's int8 convs: {tot['device_ms']:.4f} ms on the card's clock "
        f"(small kernel {tot['small_device_ms']:.4f}; bound {tot['bound_ms']:.4f}; cuDNN's "
        f"bf16 convs of the same shapes {tot['cudnn_bf16_ms']:.4f}); its absmax calls "
        f"{a_tot['device_ms']:.4f} (bound {a_tot['bound_ms']:.4f}); LSID's evaluation: int8 "
        f"convs {lsid_tot['device_ms']:.4f} ms (small kernel {lsid_tot['small_device_ms']:.4f}; "
        f"bound {lsid_tot['bound_ms']:.4f}; cuDNN bf16 {lsid_tot['cudnn_bf16_ms']:.4f})")
    return {"int8_conv": conv_rows, "absmax": amax_rows, "per_eval": n_gen, "lsid": n_lsid}


def phase_int8_generation(seed: int, workdir: str, ckpt: str, main: dict, per_eval: int):
    """The main phase's DPM-10 run (the same tree, checkpoint and seed)
    through the generation CLI with NOISEDIFF_INT8=1: per_eval int8_conv and
    absmax launches an evaluation beside the other kernels' per batch;
    patches/s beside the main phase's, and the patches' distance from the
    bf16 run's."""
    import numpy as np

    argv = gen_argv(workdir, ckpt, seed, "int8", ["--sampler", "dpm", "--dpm_spacing", "lambda"])
    per_batch = {"fused_attn_tail": 9 * DPM_STEPS, "fused_groupnorm_film_silu": 42 * DPM_STEPS,
                 "fused_dual_head": DPM_STEPS, "int8_conv": per_eval * DPM_STEPS,
                 "int8_conv_small": 0, "absmax": per_eval * DPM_STEPS,
                 "fused_ddim_head_update": 0, "conv_wgrad": 0}
    with int8_route():
        out = run_generation(argv, per_batch, "int8 generation")
    main_dir = os.path.join(workdir, "out", "ISO800_Ratio250", "npy", "generated")
    a = np.stack([np.load(f) for f in out["files"]])
    b = np.stack([np.load(os.path.join(main_dir, os.path.basename(f))) for f in out["files"]])
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    log(f"  {per_eval} int8_conv + {per_eval} absmax launches an evaluation; "
        f"{out['patches_per_s']:.4f} patches/s ({out['steady_patches_per_s']:.4f} after the "
        f"first batch) against the bf16 run's {main['patches_per_s']:.4f} "
        f"({main['steady_patches_per_s']:.4f}); patches rel L2 from the bf16 run's {rel:.5f}, "
        f"std {a.std():.6f} against {b.std():.6f}")
    if not np.isfinite(a).all() or rel > 0.5:
        raise AssertionError(f"int8 generation: patches {rel} rel L2 from the bf16 run's")
    return dict(out, rel_l2=rel, std=float(a.std()), bf16_std=float(b.std()))


def phase_int8_evaluate(evaluation: dict):
    """The evaluate phase's first frame through the evaluation CLI's
    `evaluate` with NOISEDIFF_INT8=1 (LSID in fp32): 21 int8_conv and
    absmax launches, PSNR and SSIM beside the fp32 route's, the output's
    distance from it and the frame's seconds."""
    import numpy as np

    from noisediff_tpu_torch.cli import test_denoising
    from noisediff_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    argv = [a + "_int8" if a == evaluation["save_folder"] else a for a in evaluation["first"]]
    reset_launch_counts()
    with int8_route():
        out = test_denoising.evaluate(test_denoising.build_parser().parse_args(
            argv + ["--device", "cuda"]), keep=1)
    counts = launch_counts()
    f, f32 = out["frames"][0], evaluation["first_frame"]
    rel = float(np.linalg.norm(out["outputs"][0].astype(np.float64) - evaluation["first_output"])
                / np.linalg.norm(evaluation["first_output"].astype(np.float64)))
    log(f"  PSNR {f['PSNR']:.6f} / SSIM {f['SSIM']:.7f} against the fp32 route's "
        f"{f32['PSNR']:.6f} / {f32['SSIM']:.7f}; output rel L2 {rel:.5f}; {counts['int8_conv']} "
        f"int8_conv, {counts['absmax']} absmax launches; forward {f['forward_s'] * 1e3:.4f} ms, "
        f"frame {f['frame_s']:.4f} s (the fp32 route's first frame: forward "
        f"{f32['forward_s'] * 1e3:.4f} ms, frame {f32['frame_s']:.4f} s)")
    if counts["int8_conv"] != 21 or counts["int8_conv_small"] or counts["absmax"] != 21 or \
            not np.isfinite([f["PSNR"], f["SSIM"]]).all() or rel > 0.5:
        raise AssertionError(f"int8 evaluate: {counts}, PSNR {f['PSNR']}, rel L2 {rel}")
    return dict(psnr=f["PSNR"], ssim=f["SSIM"], fp32_psnr=f32["PSNR"], fp32_ssim=f32["SSIM"],
                rel_l2=rel, forward_s=f["forward_s"], frame_s=f["frame_s"], counts=counts)


KERNEL_WRAPPERS = ("fused_attn_tail", "fused_attn_tail_bwd", "fused_groupnorm_film_silu",
                   "fused_dual_head", "fused_ddim_head_update", "gn_stats", "gn_grad_stats",
                   "conv_wgrad", "flash_attention", "groupnorm_silu_apply", "int8_conv",
                   "int8_conv_small", "absmax")

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
    # the apply phase of row 3's TPU kernel, launched with the coefficients
    # of the statistics all-reduced over the ranks
    "groupnorm_silu_apply": ("groupnorm_silu_apply", "noisediff_tpu_torch/csrc/groupnorm_silu.cu",
                             "noisediff_tpu/ops/pallas/groupnorm_silu.py:105",
                             "sharded full-frame evaluation (a rank of 2)"),
    # no Pallas kernel: XLA's int8 conv and max|x| in blocks._quantized_conv
    "int8_conv": ("int8_conv", "noisediff_tpu_torch/csrc/int8_conv.cu",
                  "noisediff_tpu/models/blocks.py:209", "int8 evaluation (NOISEDIFF_INT8=1)"),
    "absmax": ("absmax", "noisediff_tpu_torch/csrc/int8_conv.cu",
               "noisediff_tpu/models/blocks.py:203", "int8 evaluation (NOISEDIFF_INT8=1)"),
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
                  for k in ("device_ms", "library_device_ms", "host_ms", "small_device_ms")
                  if counted and all(k in r for r in counted)}
        # one full-frame evaluation (B 1, 1424 x 2128), where the kernel has such rows
        ff = [r for r in rows if r.get("fullframe_calls")]
        if ff:
            device.update({f"fullframe_{k}": sum(r[k] * r["fullframe_calls"] for r in ff)
                           for k in ("device_ms", "plain_ms", "bound_ms")})
        # one sharded full-frame evaluation on a rank of 2, where it has such rows
        sh = [r for r in rows if r.get("sharded_calls")]
        if sh:
            device.update({f"sharded_{k}": sum(r[k] * r["sharded_calls"] for r in sh)
                           for k in ("device_ms", "plain_ms", "bound_ms")})
        # one LSID evaluation of a packed full frame (fp32), where it has such rows
        ls = [r for r in rows if r.get("lsid_calls")]
        if ls:
            device.update({f"lsid_{k}": sum(r[k] * r["lsid_calls"] for r in ls)
                           for k in ("device_ms", "plain_ms", "bound_ms", "small_device_ms")
                           if all(k in r for r in ls)})
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

    t_start = time.perf_counter()
    with timed("env"):
        rank_context()  # the spawned ranks' server imports torch and the port meanwhile
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        set_precision_flags()
        log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s); allow_tf32 matmul="
            f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    with timed("build"):
        build_logs = _build.build_all()
        log(f"[build] {len(build_logs)} kernel libraries built")
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

    with timed("kernels"):
        log("[kernels] kernel vs plain version on the card")
        results = phase_kernels(args.seed)
        routed_per_step = sum(r["calls"] for r in results["conv_wgrad"])
    with timed("model"):
        log("[model] full-width forward, card vs CPU")
        phase_model(args.seed)
    with timed("profile"):
        log("[profile] where one model evaluation spends its time")
        phase_profile(args.seed)
    with timed("int8 kernels"):
        log("[int8 kernels] the int8 route's kernels (NOISEDIFF_INT8=1) against their plain "
            "versions")
        int8 = phase_int8_kernels(args.seed)
        results.update(int8_conv=int8["int8_conv"], absmax=int8["absmax"])
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with timed("gen_setup"):
            ckpt = gen_setup(workdir, args.seed)
        with timed("main"):
            log("[main] bulk generation through the CLI")
            gen = phase_main(args.seed, workdir, ckpt)
        with timed("ddim"):
            log("[ddim] DDIM-100 generation through the CLI, the fused DDIM tail")
            ddim = phase_ddim(args.seed, workdir, ckpt)
        with timed("fp32 generation"):
            log(f"[fp32 generation] DPM-{FP32_GEN_STEPS} generation through the CLI with "
                "--no_mixed_precision")
            fp32_tree = os.path.join(workdir, "fp32_tree")
            make_sid_tree(fp32_tree, args.seed, batches=1)
            run_generation(gen_argv(fp32_tree, ckpt, args.seed, "fp32",
                                    ["--sampler", "dpm", "--no_mixed_precision",
                                     "--sampling_timesteps", str(FP32_GEN_STEPS)]),
                           {k: 0 for k in KERNEL_WRAPPERS}, "fp32 generation", batches=1)
            log(f"  1 batch of {BATCH} patches, fp32, no kernel launched")
        with timed("int8 generation"):
            log("[int8 generation] the main phase's DPM-10 generation through the CLI with "
                "NOISEDIFF_INT8=1")
            int8_gen = phase_int8_generation(args.seed, workdir, ckpt, gen, int8["per_eval"])
        with timed("denoise"):
            log("[denoise] LSID trained through the denoising CLI on the main phase's patches")
            denoise = phase_denoise(args.seed, workdir, os.path.join(
                workdir, "out", "ISO800_Ratio250", "npy", "generated"))
        with timed("dist_cli denoise"):
            log("[dist_cli denoise] the denoising CLI under --launcher pytorch, NCCL")
            dist_denoise = phase_dist_cli(workdir, "denoise", denoise["argv"],
                                          denoise["snapshots"], _load_lsid)
        with timed("dist_gen"):
            log("[dist_gen] generation through the CLI on 2 ranks, --launcher pytorch")
            dist_gen = phase_dist_gen(args.seed, workdir, ckpt, glob.glob(os.path.join(
                workdir, "out", "ISO800_Ratio250", "npy", "generated", "*.npy")))
        with timed("poisson"):
            log("[poisson] SNA's Poisson draw on the card")
            check_poisson_on_card()
        with timed("denoise profile"):
            log("[denoise profile] where a denoising step spends its time")
            phase_denoise_profile(args.seed, denoise["period_ms"])
        with timed("evaluate"):
            log("[evaluate] the denoiser's PSNR / SSIM through the test_denoising CLI, full "
                "frames")
            evaluation = phase_evaluate(args.seed, workdir, os.path.join(
                workdir, "denoise", "weights", "train_denoising", "snapshot", "net_final.pth"))
        with timed("int8 evaluate"):
            log("[int8 evaluate] the first SID frame through the evaluation CLI with "
                "NOISEDIFF_INT8=1")
            int8_eval = phase_int8_evaluate(evaluation)
        with timed("kld"):
            log("[kld] real against generated noise through the eval_kld CLI")
            phase_kld(evaluation["sid"], os.path.join(
                workdir, "out", "ISO800_Ratio250", "npy", "generated"))
        with timed("fullframe"):
            log("[fullframe] full-frame generation, DPM-10 over the whole packed SID frame")
            fullframe = phase_fullframe(args.seed, ckpt, evaluation["sid"])
        with timed("fullframe_sharded"):
            log("[fullframe_sharded] the full frame split by rows over 2 ranks (and 4 on 4 "
                "cards)")
            sharded = phase_fullframe_sharded(args.seed, ckpt, evaluation["sid"], workdir,
                                              fullframe)
    finally:
        with timed("cleanup"):
            shutil.rmtree(workdir, ignore_errors=True)
    with timed("denoise_check"):
        log("[denoise_check] one LSID training step, card vs CPU")
        phase_denoise_check(args.seed)
    with timed("train_check"):
        log("[train_check] full-width training step, card vs CPU")
        phase_train_check(args.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with timed("train"):
            log("[train] training through the CLI at the canonical config")
            train = phase_train(args.seed, workdir)
        with timed("train_wgrad"):
            log("[train_wgrad] training through the CLI on the conv_wgrad route")
            wgrad = phase_train_wgrad(args.seed, workdir, routed_per_step, train["steps_per_s"])
        with timed("fp32 train"):
            log("[fp32 train] training through the CLI with --no_mixed_precision")
            phase_fp32_train(args.seed, workdir)
        with timed("dist_cli train"):
            log("[dist_cli train] the training CLI under --launcher pytorch, NCCL; the largest "
                "world's run with --profile")
            dist_train = phase_dist_cli(workdir, "train", train_argv(args.seed, workdir, ""),
                                        TRAIN_SNAPSHOTS, _load_noisediffnet, profile=True)
        with timed("profile_cli"):
            log("[profile_cli] the trace of dist_cli train's --profile run (--launcher "
                "pytorch, its largest world)")
            profile_cli = phase_profile_cli(workdir, dist_train)
    finally:
        with timed("cleanup"):
            shutil.rmtree(workdir, ignore_errors=True)
    with timed("train profile"):
        log("[train profile] where a training step spends its time")
        phase_train_profile(args.seed, train["period_ms"])
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with timed("reference_steps"):
            log("[reference_steps] the canonical training step in one process, fp32 and bf16")
            ref = reference_steps(args.seed)
        with timed("dist_step"):
            log("[dist_step] the canonical training step on 2 ranks, DDP")
            dist_step = phase_dist_step(args.seed, workdir, ref)
        with timed("remat"):
            log("[remat] the canonical training step with and without --remat")
            remat = phase_remat(ref)
        with timed("train_sharded"):
            log("[train_sharded] the canonical training step on the data x spatial x model "
                "grid")
            train_sharded = phase_train_sharded(args.seed, workdir, ref)
            del ref
    finally:
        with timed("cleanup"):
            shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with timed("gate"):
            log("[gate] the closed-loop learning gate through the CLIs, smoke scale, bf16")
            gate = phase_gate(args.seed, workdir)
            log(f"  {gate['seconds']:.1f} s of gate run")
        with timed("sweep"):
            log(f"[sweep] the sampler KLD sweep on the gate's EMA weights: "
                f"DPM-{SWEEP_DPM_STEPS} lambda, DDIM-{SWEEP_DDIM_STEPS} fused and unfused")
            sweep = phase_sweep(workdir)
    finally:
        with timed("cleanup"):
            shutil.rmtree(workdir, ignore_errors=True)
    for name, rows in gate["rows"].items():
        results[name] += rows
    with timed("attention"):
        log("[attention] blocks.Attention forward and backward, card vs CPU")
        attn = phase_attention(args.seed)
    with timed("dim96"):
        log("[dim96] a dim-96 NoiseDiffNet forward on its route, card vs CPU")
        phase_dim96(args.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with timed("posemb"):
            log("[posemb] the UNet_PosEmbV2 family: forwards, CameraCond trained and sampled "
                "through the CLIs, the other two nets, LinearAttention, interpolate")
            posemb = phase_posemb(args.seed, workdir)
    finally:
        with timed("cleanup"):
            shutil.rmtree(workdir, ignore_errors=True)
    run_s = time.perf_counter() - t_start
    log(f"[done] {run_s:.1f} s")

    gc, dc, tc, steps = gen["counts"], ddim["counts"], train["counts"], train["steps"]
    fc, pc = fullframe["counts"], posemb["counts"]
    # the full frame on 2 ranks, both ranks' counts
    sc, sdc = sharded[2]["counts"], sharded[2]["ddim_counts"]
    launches = {}
    for name in ("attn_tail", "groupnorm_silu", "dual_head", "attn_tail_bwd", "gn_stats",
                 "gn_grad_stats"):
        w = KERNEL_META[name][0]
        sw = sweep["counts"][w] if name in SWEEP_KERNELS else 0
        total = gc[w] + dc[w] + tc[w] + fc[w] + pc[w] + sc[w] + gate["counts"][w] + sw
        launches[name] = (total, {
            "launches_fullframe_sharded": sc[w],
            # the UNet_PosEmbV2 family's CLI runs (posemb phase)
            "launches_posemb": pc[w],
            "launches_generation": gc[w], "launches_per_batch": gc[w] / N_BATCHES,
            "launches_ddim": dc[w], "launches_ddim_per_batch": dc[w] / N_BATCHES,
            "launches_training": tc[w], "launches_per_step": tc[w] / steps,
            "launches_fullframe": fc[w],
            # apart from the counts above: the spawned ranks' own counters
            # and one --remat step
            "launches_dist_step": sum(r["launches"][w] for r in dist_step["ranks"]),
            # the first bf16 step of every rank of each grid
            "launches_train_sharded": {g: r["counts"][w] for g, r in train_sharded.items()},
            "launches_dist_gen": sum(r["launches"][w] for r in dist_gen["ranks"]),
            "launches_dist_train_world1": dist_train["world1"][0]["launches"][w],
            "launches_remat_step": remat["launches"][w],
            # the learning gate's smoke run (gate phase)
            "launches_gate": gate["counts"][w],
            # the sampler sweep on its weights (sweep phase)
            "launches_sweep": sw})
    n, n_sh = ddim["counts"]["fused_ddim_head_update"], sdc["fused_ddim_head_update"]
    n_gate = gate["counts"]["fused_ddim_head_update"]
    n_sweep = sweep["counts"]["fused_ddim_head_update"]
    launches["ddim_head"] = (n + n_sh + n_gate + n_sweep, {
        "launches_per_batch": n / N_BATCHES, "launches_fullframe_sharded_ddim": n_sh,
        "launches_gate": n_gate, "launches_sweep": n_sweep})
    n = sc["groupnorm_silu_apply"]
    launches["groupnorm_silu_apply"] = (n, {
        "launches_per_rank_per_eval": n / (2 * FULLFRAME_STEPS),
        "launches_fullframe_sharded_ddim": sdc["groupnorm_silu_apply"],
        "launches_fullframe_sharded_4": sharded[4]["counts"]["groupnorm_silu_apply"]
        if 4 in sharded else None})
    n, n_pos = wgrad["counts"]["conv_wgrad"], pc["conv_wgrad"]
    launches["conv_wgrad"] = (n + n_pos, {"launches_per_step": n / wgrad["steps"],
                                          "launches_posemb": n_pos})
    launches["flash_attention"] = (attn["counts"]["flash_attention"], {})
    for name in ("int8_conv", "absmax"):
        n, n_eval = int8_gen["counts"][name], int8_eval["counts"][name]
        launches[name] = (n + n_eval, {
            "launches_generation": n, "launches_per_eval": n / (N_BATCHES * DPM_STEPS),
            "launches_evaluate": n_eval})
    # the small kernel on both int8 paths (each shape there takes the tiled one)
    launches["int8_conv"][1]["launches_small"] = (int8_gen["counts"]["int8_conv_small"]
                                                  + int8_eval["counts"]["int8_conv_small"])
    print(json.dumps({"phase_seconds": PHASE_SECONDS, "total_s": run_s}))
    print(json.dumps(kernels_line(results, launches)))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    become_subreaper()
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
