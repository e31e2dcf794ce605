"""Both packages' tiny learning gate, diffusion stage, on one tree and run
seed, every snapshot scored through the port's sampler.

The tiny gate's EMA model scores with a wide spread across trees and run
seeds (its copy at call 500 keeps a quarter of the final average, and the
online model is volatile there), so one pair of gate runs cannot tell the
port from the JAX package. This trains NoiseDiffNet with the tiny gate's
arguments (scripts/port_learning_gate.py SCALES["tiny"], fp32 on the CPU)
through the port's training CLI and the JAX package's, on the gate tree of
--tree, with --random_seed --run_seed and snapshots every --freq epochs;
converts the JAX orbax snapshots (scripts/orbax_to_npz.py); and scores each
net_* and ema_* through the port's generation CLI (DDIM-16) and eval_kld,
the same sampler for both sides. Run on the CPU, one run at a time (two at
once slow each several-fold):

    JAX_PLATFORMS=cpu python tests/torch_port_ema_spread.py --tree 0 --run_seed 0 \\
        --workdir /tmp/spread --out spread_t0_s0.json

It writes {side: {snapshot: {"kld", "std"}}} with the arguments, and prints
each score as it goes.
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import port_learning_gate as plg  # noqa: E402


def train(side: str, cfg: dict, workdir: str, sid: str, run_seed: int, freq: int) -> str:
    """One side's diffusion stage; returns its snapshot directory."""
    argv = plg.train_diffusion_argv(cfg, workdir, sid, "cpu")
    argv[argv.index("--save_epoch_freq") + 1] = str(freq)
    folder = os.path.join(workdir, side, "weights")
    argv[argv.index("--save_folder") + 1] = folder
    argv += ["--random_seed", str(run_seed)]
    if side == "port":
        from noisediff_tpu_torch.cli import train_diffusion
    else:
        i = argv.index("--device")
        del argv[i:i + 2]
        from noisediff_tpu.cli import train_diffusion
    train_diffusion.main(argv)
    return os.path.join(folder, "gate_diff", "snapshot")


def snapshots(side: str, snap: str):
    """(name, path) of every net_* and ema_* snapshot, the JAX side's
    converted to .npz first."""
    if side == "jax":
        subprocess.run([sys.executable, os.path.join(REPO, "scripts", "orbax_to_npz.py"), snap],
                       check=True)
        files = glob.glob(os.path.join(snap, "*.npz"))
    else:
        files = glob.glob(os.path.join(snap, "*.pth"))
    out = []
    for path in sorted(files):
        name = os.path.basename(path).rsplit(".", 1)[0]
        if name.startswith(("net_", "ema_")):
            out.append((name, path))
    return out


def score(cfg: dict, workdir: str, sid: str, side: str, name: str, path: str) -> dict:
    gen = plg.run_generation(cfg, workdir, sid, f"gen_{side}_{name}", path, "cpu")
    return {"kld": plg.run_kld(workdir, sid, gen)["kld_symmetric"],
            "std": plg.generated_std(gen)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=int, default=0, help="the gate's --seed: which tree")
    ap.add_argument("--run_seed", type=int, default=0, help="both CLIs' --random_seed")
    ap.add_argument("--freq", type=int, default=20, help="snapshot every this many epochs")
    ap.add_argument("--sides", default="port,jax")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cfg = dict(plg.SCALES["tiny"])
    os.makedirs(args.workdir, exist_ok=True)
    sid = plg.build_tree(args.workdir, cfg, seed=args.tree)
    result = {"tree": args.tree, "run_seed": args.run_seed, "config": cfg}
    for side in args.sides.split(","):
        t0 = time.perf_counter()
        snap = train(side, cfg, args.workdir, sid, args.run_seed, args.freq)
        result[f"{side}_train_seconds"] = time.perf_counter() - t0
        scores = result[side] = {}
        for name, path in snapshots(side, snap):
            scores[name] = score(cfg, args.workdir, sid, side, name, path)
            print(side, name, scores[name], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
