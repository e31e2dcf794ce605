"""Bulk noise generation: `GaussianDiffusion.dpm_solver_sample` over
batches of 512^2 crops, each result downloaded to the host as the
generation CLI's `Trainer.test` does (its npy write left out).

Traffic parameters (traffic/<name>.json): `batch`, `crop`, `steps`
(DPM-Solver++(2M) on the `spacing` grid), `frame` (the packed frame the
crops' coordinates lie on) and `grid` (the crop grid's stride), `settings`
(how many (ISO, ratio) rows of the conditioning table a batch draws from),
`clean` (the range of the clean crops' mean level), `pool` (distinct
batches made in set-up and sent in turn), `sample` (finished batches the
reference checks), `profiled` (batches in the traced part).

A unit is one batch. The window runs batches back to back, closed loop,
until `seconds` have passed and the running batch has come back.

The check follows the program step by step from its own states: a random
network amplifies rounding along a whole trajectory (the bf16 program's
patches drift 16-30% from the fp32 reference's by the tenth step while
each evaluation is within ~2%), so a whole-trajectory comparison cannot
tell bf16 from the int8 path below it. For each sampled batch the model
wrapper keeps every evaluation's input x_k, timestep and output v_k. The
reference evaluates its model at each x_k and takes the sampler's step
from there; the program's step is from x_k to x_(k+1), the next input or,
after the last step, the downloaded patch. `step_rel_l2` is the worst,
over the sampled patches and steps, of the relative L2 distance between
the program's step (x_(k+1) - x_k) and the reference's, so that one
number holds the model (its bf16 rounding), the sampler's arithmetic and
the download; the first input has to be the batch's x_T.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from harness import common, port, trace
from harness.flops import forward_flops
from harness.roofline import noisediffnet_eval_bounds, peak_flops
from reference import diffusion as ref_diffusion


def make_batches(tr: dict, seed: int, device) -> list:
    """`pool` batches, each a pure function of (seed, index): x_T, the
    clean crops, their coordinates on the frame's crop grid and one
    (ISO, ratio) row for the whole batch."""
    b, crop = tr["batch"], tr["crop"]
    fh, fw = tr["frame"]
    ys = sorted(set(list(range(0, fh - crop + 1, tr["grid"])) + [fh - crop]))
    xs = sorted(set(list(range(0, fw - crop + 1, tr["grid"])) + [fw - crop]))
    lo, hi = tr["clean"]
    out = []
    for i in range(tr["pool"]):
        g = torch.Generator(device=device).manual_seed(common.sub_seed(seed, 1, i))
        rng = np.random.default_rng(common.sub_seed(seed, 2, i))
        level = torch.tensor(rng.uniform(lo, hi, b), dtype=torch.float32, device=device)
        coarse = torch.rand((b, 4, crop // 32, crop // 32), generator=g, device=device)
        field = torch.nn.functional.interpolate(coarse, scale_factor=32, mode="bilinear",
                                                align_corners=False)
        clean = (level[:, None, None, None] * (0.5 + field)).permute(0, 2, 3, 1).clamp(0, 1)
        pos = []
        for y, x in zip(rng.choice(ys, b), rng.choice(xs, b)):
            rows = (torch.arange(crop, device=device, dtype=torch.float32) + float(y)) / (fh - 1)
            cols = (torch.arange(crop, device=device, dtype=torch.float32) + float(x)) / (fw - 1)
            yy, xx = torch.meshgrid(rows, cols, indexing="ij")
            pos.append(torch.stack([yy, xx], dim=-1))
        idx = int(rng.integers(0, tr["settings"]))
        out.append({
            "x_T": torch.randn((b, crop, crop, 4), generator=g, device=device),
            "condition": {"clean_img": clean.contiguous(), "position": torch.stack(pos),
                          "iso_ratio_idx": torch.full((b,), idx, dtype=torch.long,
                                                      device=device)},
        })
    return out


def run(ctx) -> dict:
    cfg, tr, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    import os

    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.ops.schedules import make_schedule

    parts = {"imports": time.perf_counter() - ctx.t_start}
    port.program_settings()
    if getattr(ctx, "control", None) == "int8":  # the program's own path one precision below
        os.environ["NOISEDIFF_INT8"] = "1"
    model = port.program_model(cfg, dev)
    os.environ.pop("NOISEDIFF_INT8", None)
    state = port.seeded_weights(cfg, model, common.sub_seed(seed, 0), dev)
    model.load_state_dict(state)
    model.eval().requires_grad_(False)
    parts["model"] = time.perf_counter() - ctx.t_start - sum(parts.values())

    dispatch = []  # host seconds of each evaluation's call, the card not waited for
    states = []  # (x_k, t_k, v_k) of the running batch: references, not copies

    def model_fn(x, t, condition):
        t0 = time.perf_counter()
        with record_function("pb::model_fn"):
            out = model(x, t, condition)
        dispatch.append(time.perf_counter() - t0)
        states.append((x, int(t[0]), out))
        return out

    diffusion = GaussianDiffusion(model_fn, make_schedule(cfg["beta_schedule"], cfg["timesteps"]),
                                  image_size=tr["crop"], objective=cfg["objective"], device=dev)
    shape = (tr["batch"], tr["crop"], tr["crop"], 4)
    batches = make_batches(tr, seed, dev)
    parts["inputs"] = time.perf_counter() - ctx.t_start - sum(parts.values())

    def unit(i):
        b = batches[i % len(batches)]
        states.clear()
        out = diffusion.dpm_solver_sample(shape, b["condition"], sampling_timesteps=tr["steps"],
                                          init_noise=b["x_T"], step_spacing=tr["spacing"])
        return out.float().cpu().numpy(), list(states)  # waits for the card

    unit(0)  # every shape, the kernels' first launch included
    dispatch.clear()
    sample = common.Reservoir(seed, tr["sample"])
    t_first = time.perf_counter()
    parts["warm-up"] = t_first - ctx.t_start - sum(parts.values())
    n = 0
    while True:
        got = unit(n)
        sample.offer(n, lambda: got)
        n += 1
        if time.perf_counter() - t_first >= ctx.seconds:
            break
    window = time.perf_counter() - t_first
    record = {"setup_s": t_first - ctx.t_start, "window_seconds": window, "units": n,
              "items_per_unit": tr["batch"], "chips": 1,
              "flops_per_unit": tr["steps"] * forward_flops(cfg, *shape[:3]),
              "peak_flops": peak_flops(cfg), "dispatch_s": list(dispatch), "setup_parts": parts}
    if ctx.trace:
        tr_rec = trace.profiled(lambda: [unit(n + k) for k in range(tr["profiled"])], dev,
                                common.ROOT)
        tr_rec["units"] = tr["profiled"]
        tr_rec["bound_s_per_unit"] = tr["steps"] * sum(
            noisediffnet_eval_bounds(cfg, *shape[:3]).values())
        record["trace"] = tr_rec
    record["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    del model, diffusion, got
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gaps = check(cfg, tr, state, batches, sample.items(), dev)
    record["setup_parts"]["(check, after the window)"] = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": ctx.limits[k]} for k, v in gaps.items()}
    return {"attempted": n, "failed": 0, "record": record, "checks": checks,
            "correct": all(c["value"] <= c["limit"] for c in checks.values())}


def check(cfg, tr, state, batches, sampled, dev) -> dict:
    """The worst relative L2 distance, over the sampled batches' patches
    and steps, between the program's step and the reference's from the
    program's state (NaN fails; the module docstring). The parts go to
    standard error: the model outputs' distance alone, and the steps'
    with the program's own outputs in the reference's step (the sampler's
    arithmetic alone)."""
    port.precision_flags(False)
    ref = port.reference_model(cfg, dev)
    ref.load_state_dict(state)
    ref.eval()
    ac = ref_diffusion.alphas_cumprod(cfg["beta_schedule"], cfg["timesteps"])
    times = ref_diffusion.lambda_grid(ac, tr["steps"])
    worst = {"step": 0.0, "model": 0.0, "sampler": 0.0}

    def rel(got, want):  # worst patch
        g, w = got.double().flatten(1), want.double().flatten(1)
        r = float(((g - w).norm(dim=1) / w.norm(dim=1)).max())
        return r if np.isfinite(r) else float("inf")

    for i, (host, states) in sampled:
        b = batches[i % len(batches)]
        nexts = [x for x, _, _ in states[1:]] + [torch.from_numpy(host).to(dev)]
        found = {"step": [rel(states[0][0], b["x_T"]) if states else float("inf")],
                 "model": [], "sampler": []}
        if [t for _, t, _ in states] != times[:-1]:
            found["step"].append(float("inf"))  # not the grid's knots, or a step missing
        prev = prev_own = None
        with torch.no_grad():
            for (x, t, v), x_next, t_next in zip(states, nexts, times[1:]):
                tb = torch.full((x.shape[0],), t, dtype=torch.long, device=dev)
                v_ref = ref(x, tb, b["condition"])
                want, prev = ref_diffusion.dpm_update(x, v_ref, t, t_next, ac, prev)
                own, prev_own = ref_diffusion.dpm_update(x, v, t, t_next, ac, prev_own)
                found["step"].append(rel(x_next - x, want - x))
                found["model"].append(rel(v.float(), v_ref))
                found["sampler"].append(rel(x_next - x, own - x))
        for k, vals in found.items():
            worst[k] = max([worst[k]] + vals)
    print(f"worst model output {worst['model']!r}, worst step with the program's outputs "
          f"{worst['sampler']!r}", file=sys.stderr)
    return {"step_rel_l2": worst["step"]}
