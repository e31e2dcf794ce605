"""Append runs of the EMA-gap ladder to EMA_GAP.json.

Each entry is one training run of NoiseDiffNet's diffusion stage at a
learning-gate scale, and the KLD and std of its final EMA and online
weights through each sampler and scoring package. Two kinds of input:

  * a gate run on the card: --card_gate, the --out JSON of
    scripts/port_learning_gate.py (kept with --keep), and --card_sweep, the
    --out JSON of scripts/port_dpm_step_sweep.py over that workdir with
    --weights ema and --weights net (DDIM fused and unfused, DPM); with
    --given, the JSON of tests/torch_port_ema_spread.py --weights
    ema_final=... --weights net_final=... that scored the same weights on
    the CPU through both packages' samplers;
  * a CPU run of both packages: --cpu, the JSON of
    tests/torch_port_ema_spread.py --final_only (one entry a side).

Scores are keyed weights -> scorer -> sampler. Scorers: `port` (the port's
sampler on the run's own device), `port_cpu` (the port's on the CPU in
fp32, for a card run's weights) and `jax` (the JAX package's on the CPU in
fp32). Samplers: `ddim<N>` (fused, the CLI's), `ddim<N>_unfused`,
`dpm<N>`. An entry of the same `run` label is replaced. Run as

    python scripts/port_ema_gap_record.py --run card_horizon_s0 \\
        --card_gate gate.json --card_sweep sweep.json --given given.json --out EMA_GAP.json
    python scripts/port_ema_gap_record.py --run cpu_horizon_s0 --cpu hz_s0.json --out EMA_GAP.json

It reads JSON only (no torch, no JAX).
"""
from __future__ import annotations

import argparse
import json
import os

NOTE = ("One entry a training run of NoiseDiffNet's diffusion stage at a learning-gate scale "
        "(scripts/port_learning_gate.py SCALES; the card runs through that script and "
        "scripts/port_dpm_step_sweep.py, the CPU runs through tests/torch_port_ema_spread.py). "
        "scores: weights -> scorer (port: the port's sampler on the run's device; port_cpu: "
        "the port's on the CPU in fp32; jax: the JAX package's on the CPU in fp32) -> sampler "
        "-> KLD of generated against real noise (cli/eval_kld, the first 200 patches), the "
        "std of the first 64 patches, and the seconds the generation took. A card's numbers "
        "name the card and its power limit (nvidia-smi).")
ENTRY_KEYS = ("run", "package", "device", "card", "scale", "config", "tree", "run_seed",
              "precision", "scores", "train_seconds", "sources")
SCORE_KEYS = ("kld", "std", "seconds")
WEIGHTS = ("ema_final", "net_final")


def _sampler_label(row) -> str:
    if row["sampler"] == "ddim_unfused":
        return f"ddim{row['steps']}_unfused"
    return f"{row['sampler']}{row['steps']}"


def card_entry(run, gate_path, sweep_path, given_path=None) -> dict:
    with open(gate_path) as f:
        gate = json.load(f)
    with open(sweep_path) as f:
        sweep = json.load(f)
    scores = {w: {"port": {}} for w in WEIGHTS}
    for row in sweep["sweep"]:
        scores[f"{row['weights']}_final"]["port"][_sampler_label(row)] = {
            "kld": row["kld_symmetric"], "std": row["generated_noise_std"],
            "seconds": row["seconds"]}
    sources = [os.path.basename(gate_path), os.path.basename(sweep_path)]
    if given_path:
        with open(given_path) as f:
            given = json.load(f)["given"]
        for w in WEIGHTS:
            scores[w]["port_cpu"] = given[w]["port"]
            scores[w]["jax"] = given[w]["jax"]
        sources.append(os.path.basename(given_path))
    return {
        "run": run, "package": "port", "device": gate["device"], "card": gate["card"],
        "scale": gate["scale"], "config": gate["config"], "tree": gate["seed"],
        "run_seed": gate.get("random_seed", 0),
        "precision": "bf16" if gate["mixed_precision"] else "fp32",
        "scores": scores, "train_seconds": gate["seconds"]["train_diffusion"],
        "gate": {"kld_ddim": gate["kld_trained"]["kld_symmetric"],
                 "kld_dpm": gate["kld_trained_dpm"]["kld_symmetric"],
                 "std_ddim": gate["generated_noise_std"], "psnr_gain": gate["psnr_gain"],
                 "seconds_total": gate["seconds"]["total"]},
        "sources": sources,
    }


def cpu_entries(run, path) -> list:
    with open(path) as f:
        res = json.load(f)
    out = []
    for side in ("port", "jax"):
        if side not in res:
            continue
        out.append({
            "run": f"{run}_{side}", "package": side, "device": "cpu", "card": None,
            "scale": res["scale"], "config": res["config"], "tree": res["tree"],
            "run_seed": res["run_seed"], "precision": "fp32",
            "scores": {w: res[side][w] for w in WEIGHTS},
            "train_seconds": res[f"{side}_train_seconds"], "sources": [os.path.basename(path)],
        })
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True, help="the entry's label (CPU: a side is appended)")
    ap.add_argument("--card_gate", default="")
    ap.add_argument("--card_sweep", default="")
    ap.add_argument("--given", default="")
    ap.add_argument("--cpu", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.cpu:
        new = cpu_entries(args.run, args.cpu)
    else:
        new = [card_entry(args.run, args.card_gate, args.card_sweep, args.given or None)]
    record = {"note": NOTE, "entries": []}
    if os.path.exists(args.out):
        with open(args.out) as f:
            record = json.load(f)
    labels = {e["run"] for e in new}
    record["entries"] = [e for e in record["entries"] if e["run"] not in labels] + new
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
