#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (noisediff_tpu_torch) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Every phase runs, in this order (any failure exits non-zero):
  env      the card's name and power limit, torch / CUDA versions, TF32 flags
  build    nvcc builds every kernel of the generation path from
           noisediff_tpu_torch/csrc/ (one compiler process per source)
  kernels  each kernel against its plain PyTorch version on the card, at
           every shape the generation path gives it; CUDA-event timings of
           both beside the card's bound for the same work
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

# canonical generation config
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
DPM_STEPS = 10
N_BATCHES = 2
FRAME = 640  # packed frame side of the smoke tree
GRID_NAMES = {f"{x}_{y}" for x in (0, 128) for y in (0, 128)}
# stated tolerances, kernel vs plain version on the same card inputs:
# |k - p| <= ATOL + RTOL * |p|; bf16 outputs may differ by a rounding flip
# at each stored intermediate (fp32 sums in another order)
TOLS = {"attn_tail": (3e-2, 3e-2), "groupnorm_silu": (2e-2, 2e-2), "dual_head": (1e-2, 1e-2)}


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


def compare(name, got, want):
    import torch

    rtol, atol = TOLS[name]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (g - w).abs()
    bad = int((err > atol + rtol * w.abs()).sum())
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
        rows.append(dict(shape=[BATCH, res, res, c], per_eval=ATTN_PER_EVAL[st], ms=ms,
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
                         per_eval=count, ms=ms, plain_ms=plain, bound_ms=b_ms,
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
    results["dual_head"] = [dict(shape=[BATCH, CROP, CROP, c], per_eval=1, ms=ms,
                                 plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                 max_abs_err=err)]
    log(f"  dual_head {CROP}^2 x {c}: {ms:.4f} ms (plain {plain:.4f}, bound {b_ms:.4f} "
        f"{b_by}), max abs err {err:.3g}")
    del x, sa, sb, args
    torch.cuda.empty_cache()
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
    if "attn_tail" in name:
        return "attn_tail kernel"
    if name.startswith("gn_") or "gn_partial" in name or "gn_apply" in name or "gn_coeffs" in name:
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
    by_name = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / evals
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
    from noisediff_tpu_torch.ops.kernels import KERNELS, reset_launch_counts

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
    counts = {k.__name__: k.launches for k in KERNELS}

    n = summary["generated"]
    if n != N_BATCHES * BATCH or summary["batches"] != N_BATCHES:
        raise AssertionError(f"expected {N_BATCHES} batches of {BATCH} patches: {summary}")
    per_batch = {"fused_attn_tail": 9 * DPM_STEPS, "fused_groupnorm_film_silu": 42 * DPM_STEPS,
                 "fused_dual_head": DPM_STEPS}
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
KERNEL_META = {
    "attn_tail": ("fused_attn_tail", "noisediff_tpu_torch/csrc/attn_tail.cu",
                  "noisediff_tpu/ops/pallas/attn_tail.py:190"),
    "groupnorm_silu": ("fused_groupnorm_film_silu",
                       "noisediff_tpu_torch/csrc/groupnorm_silu.cu",
                       "noisediff_tpu/ops/pallas/groupnorm_silu.py:105"),
    "dual_head": ("fused_dual_head", "noisediff_tpu_torch/csrc/dual_head.cu",
                  "noisediff_tpu/ops/pallas/dual_head.py:77"),
}


def kernels_line(results, counts):
    """One entry per kernel. ms, plain_ms and bound_ms are summed over the
    calls of one model evaluation at the canonical config (each shape's
    median time times its calls per evaluation); per_shape has each shape's
    numbers. `launches` is the wrapper's count over the main phase's run of
    N_BATCHES batches, `launches_per_batch` that count over N_BATCHES."""
    out = []
    for name, rows in results.items():
        wrapper, source, replaces = KERNEL_META[name]
        tot = {k: sum(r[k] * r["per_eval"] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
        # the bound of the shapes that carry most of the bound time
        by_bytes = sum(r["bound_ms"] * r["per_eval"] for r in rows if r["bound_by"] == "bytes")
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[wrapper], "launches_per_batch": counts[wrapper] / N_BATCHES,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if by_bytes >= tot["bound_ms"] / 2 else "operations",
            "library_ms": None, "per_shape": rows,
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
        counts = phase_main(args.seed, workdir)["counts"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"[done] {time.time() - t_start:.1f} s")

    print(json.dumps(kernels_line(results, counts)))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
