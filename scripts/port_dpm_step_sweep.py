"""Sampler KLD sweep of the PyTorch/CUDA port over a trained gate checkpoint.

The port's counterpart of scripts/dpm_step_sweep.py. It reads a workdir of
scripts/port_learning_gate.py kept with --keep (the synthetic SID tree and
logs/weights/gate_diff/snapshot/), generates the gate's (ISO, ratio)
patches from one set of trained weights through the port's generation CLI
once a leg, and scores each leg with cli/eval_kld:

  * DDIM at the scale's step count through the CLI (the fused tail), and
    unfused (`GaussianDiffusion.ddim_sample` with trunk_fn None, reached
    through `test_diffusion.main(..., fused_tail=False)`), from the same
    draws: every leg seeds its batches alike;
  * DPM-Solver++(2M) at each --steps count on the --spacing grid;
  * with --ddpm, ancestral DDPM over all T steps (the reference's own
    sampler).

Each row's `vs_ddim_ratio` divides by the fused DDIM KLD this run measured
on the same weights. Rows are keyed by (weights, sampler, steps, spacing)
and merged into an existing --out: a row of the same key is replaced,
every other row and top-level field kept. Run as

    python scripts/port_dpm_step_sweep.py --workdir /tmp/gate --scale gpu \\
        --spacing lambda --steps 20,15,12,10,8,6 --out sweep.json
    python scripts/port_dpm_step_sweep.py --workdir /tmp/gate --scale tiny \\
        --device cpu --steps 10 --ddpm

It imports torch, numpy, noisediff_tpu_torch and port_learning_gate only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from port_learning_gate import (  # noqa: E402
    SCALES, card_line, generated_std, run_generation, run_kld, scale_config, trained_weights)


def weights_path(workdir: str, weights: str) -> str:
    """ema: the gate's trained_weights (ema_final.pth, else net_final.pth);
    net: net_final.pth, the online weights."""
    if weights == "ema":
        return trained_weights(workdir)
    return os.path.join(workdir, "logs", "weights", "gate_diff", "snapshot", "net_final.pth")


def legs(cfg, steps, spacing, ddpm):
    """(sampler, steps, spacing, fused_tail) of each leg, fused DDIM first:
    it is the other rows' denominator."""
    out = [("ddim", cfg["ddim"], None, True), ("ddim_unfused", cfg["ddim"], None, False)]
    out += [("dpm", n, spacing, True) for n in steps]
    if ddpm:
        out.append(("ddpm", cfg["T"], None, True))
    return out


def row_key(row):
    return (row["weights"], row["sampler"], row["steps"], row["spacing"])


def _sort_key(row):
    return (row["weights"], row["sampler"], row["spacing"] or "", -row["steps"])


def merge_into(out_path: str, result: dict) -> dict:
    """`result` merged into the artifact at out_path (scripts/dpm_step_sweep.py's
    merge_into): rows of the same key replaced, other rows and top-level
    fields kept. A path that does not exist yet just gets `result`."""
    if not os.path.exists(out_path):
        return dict(result, sweep=sorted(result["sweep"], key=_sort_key))
    with open(out_path) as f:
        old = json.load(f)
    rows = {row_key(r): r for r in old.get("sweep", [])}
    rows.update({row_key(r): r for r in result["sweep"]})
    merged = dict(old, **{k: v for k, v in result.items() if k != "sweep"})
    merged["sweep"] = sorted(rows.values(), key=_sort_key)
    return merged


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True,
                    help="a port_learning_gate.py workdir kept with --keep")
    ap.add_argument("--scale", default="gpu", choices=sorted(SCALES))
    ap.add_argument("--steps", default="20,15,10",
                    help="DPM step counts, comma-separated ('' for none)")
    ap.add_argument("--spacing", default="lambda", choices=("lambda", "time"),
                    help="DPM step grid")
    ap.add_argument("--ddpm", action="store_true",
                    help="add ancestral DDPM over all T steps")
    ap.add_argument("--weights", default="ema", choices=("ema", "net"),
                    help="ema (ema_final.pth, else net_final.pth) or net (net_final.pth)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; bf16, raises without a card) or cpu (fp32)")
    ap.add_argument("--out", default="", help="merge the rows into this JSON")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a scale knob as the gate's --set does, e.g. --set ddim=2")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from noisediff_tpu_torch.cli.common import resolve_device

    resolve_device(args.device)  # raises for cuda without a card
    cfg = scale_config(args)
    wd, dev = args.workdir, args.device
    sid = os.path.join(wd, "SID")
    resume = weights_path(wd, args.weights)
    if not os.path.isdir(sid) or not os.path.exists(resume):
        raise FileNotFoundError(f"{wd} holds no gate run: need {sid} and {resume}")
    device = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    card = card_line(dev)
    steps = [int(s) for s in args.steps.split(",") if s]
    rows, ddim_kld = [], None
    for sampler, n, spacing, fused in legs(cfg, steps, args.spacing, args.ddpm):
        name = f"sweep_{args.weights}_{sampler}{n}" + (f"_{spacing}" if spacing else "")
        t0 = time.perf_counter()
        gen = run_generation(cfg, wd, sid, name, resume, dev,
                             sampler="ddim" if sampler.startswith("ddim") else sampler,
                             steps=n, spacing=spacing, fused_tail=fused)
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        kld = run_kld(wd, sid, gen)
        kld_seconds = time.perf_counter() - t0
        if ddim_kld is None:
            ddim_kld = kld["kld_symmetric"]
        row = {"weights": args.weights, "sampler": sampler, "steps": n, "spacing": spacing,
               "kld": kld, "kld_symmetric": kld["kld_symmetric"],
               "ddim_kld_symmetric": ddim_kld,
               "vs_ddim_ratio": kld["kld_symmetric"] / max(ddim_kld, 1e-12),
               "generated_noise_std": generated_std(gen), "seconds": seconds,
               "kld_seconds": kld_seconds, "resume": resume, "device": device, "card": card,
               "mixed_precision": dev == "cuda"}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "kld"}), flush=True)
    result = {"scale": args.scale, "config": cfg, "sweep": rows}
    print(json.dumps(result))
    if args.out:
        merged = merge_into(args.out, result)
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=1)
    return result


if __name__ == "__main__":
    main()
