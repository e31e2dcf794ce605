"""Both packages' learning gate, diffusion stage, on one tree and run seed,
every snapshot scored through the port's sampler, the JAX package's, or both.

One gate run's EMA model scores with a spread over trees and run seeds (at
the tiny scale its copy at call 500 keeps a quarter of the final average,
and the online model is volatile there), so one pair of gate runs cannot
tell the port from the JAX package. This trains NoiseDiffNet with the
arguments of a scale of scripts/port_learning_gate.py (--scale: tiny, the
default, or horizon, gpu, ...; fp32 on the CPU) through the port's training
CLI and the JAX package's, on the gate tree of --tree, with --random_seed
--run_seed and snapshots every --freq epochs; converts the JAX orbax
snapshots (scripts/orbax_to_npz.py); and scores each net_* and ema_*
snapshot (--final_only: net_final and ema_final) with eval_kld after
generating through each package of --score_with (port: the port's
generation CLI, the JAX .npz; jax: the JAX package's generation CLI, the
orbax snapshot or the port's .pth through its torch import) at the scale's
DDIM steps and, where the scale has them, its DPM steps. --weights
NAME=PATH (repeatable) scores a given .pth as side "given" without training,
e.g. the weights of a gate run on the card. Each generation runs in a
fresh process; the first of a workdir writes every patch and keeps their
names (generated_names.json), later ones run only the batches that hold
the 200 patches the KLD reads (the same patches: each batch draws from its
own seed). Run on the CPU, one run at a time (two at once slow each
several-fold):

    JAX_PLATFORMS=cpu python tests/torch_port_ema_spread.py --tree 0 --run_seed 0 \\
        --workdir /tmp/spread --out spread_t0_s0.json
    JAX_PLATFORMS=cpu python tests/torch_port_ema_spread.py --scale horizon --sides jax \\
        --final_only --score_with port,jax --workdir /tmp/hz --out hz_jax_s0.json

It writes {side: {snapshot: {scorer: {sampler: {"kld", "std", "seconds"}}}}}
with the arguments and each side's training seconds, and prints each score
as it goes.
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


def train_argv(side: str, cfg: dict, workdir: str, sid: str, run_seed: int, freq: int) -> list:
    """One side's training CLI argv: the port gate's, with snapshots every
    `freq` epochs into <workdir>/<side>/weights and the run seed; the JAX
    CLI has no --device."""
    argv = plg.train_diffusion_argv(cfg, workdir, sid, "cpu")
    argv[argv.index("--save_epoch_freq") + 1] = str(freq)
    argv[argv.index("--save_folder") + 1] = os.path.join(workdir, side, "weights")
    argv += ["--random_seed", str(run_seed)]
    if side == "jax":
        i = argv.index("--device")
        del argv[i:i + 2]
    return argv


def train(side: str, cfg: dict, workdir: str, sid: str, run_seed: int, freq: int) -> str:
    """One side's diffusion stage; returns its snapshot directory."""
    if side == "port":
        from noisediff_tpu_torch.cli import train_diffusion
    else:
        from noisediff_tpu.cli import train_diffusion
    train_diffusion.main(train_argv(side, cfg, workdir, sid, run_seed, freq))
    return os.path.join(workdir, side, "weights", "gate_diff", "snapshot")


def snapshots(side: str, snap: str, final_only: bool = False):
    """{name: {scorer: path}} of every net_* and ema_* snapshot (net_final
    and ema_final only with final_only): the port's .pth for both scorers;
    the JAX orbax directory for the JAX scorer and its .npz (converted
    first) for the port's."""
    if side == "jax":
        subprocess.run([sys.executable, os.path.join(REPO, "scripts", "orbax_to_npz.py"), snap],
                       check=True)
        files = glob.glob(os.path.join(snap, "*.npz"))
    else:
        files = glob.glob(os.path.join(snap, "*.pth"))
    out = {}
    for path in sorted(files):
        name = os.path.basename(path).rsplit(".", 1)[0]
        if not name.startswith(("net_", "ema_")):
            continue
        if final_only and not name.endswith("_final"):
            continue
        out[name] = {"port": path, "jax": path[:-len(".npz")] if side == "jax" else path}
    return out


def samplers(cfg: dict):
    """(label, sampler, steps, spacing) the gate scores: DDIM at the scale's
    steps, and DPM-Solver++ where the scale has DPM steps."""
    out = [(f"ddim{cfg['ddim']}", None, cfg["ddim"], None)]
    if cfg["dpm"] > 0:
        out.append((f"dpm{cfg['dpm']}", "dpm", cfg["dpm"], cfg["dpm_spacing"]))
    return out


# cli/eval_kld's --max_patches: the KLD reads the first 200 generated
# patches by name, generated_std the first 64 of them
KLD_PATCHES = 200


def _gen_dir(workdir: str, out_name: str) -> str:
    return os.path.join(workdir, out_name, f"ISO{plg.ISO}_Ratio{int(plg.RATIO)}", "npy",
                        "generated")


def generate(scorer: str, cfg: dict, workdir: str, sid: str, out_name: str, resume: str,
             sampler=None, steps=None, spacing=None, names=None) -> None:
    """Generate the gate's patches from `resume` through `scorer`'s
    generation CLI (fp32 on the CPU; the JAX one without --device). With
    `names`, the names a whole run writes, only the batches that hold the
    first KLD_PATCHES names by sort order run: every other name is on disk
    as an empty file, which --skip_existing skips a batch for (each batch
    draws from its own seed, so a batch that runs writes what it writes in
    a whole run), and the empty files go afterwards."""
    out = os.path.join(workdir, out_name)
    gen = _gen_dir(workdir, out_name)
    argv = plg.generation_argv(cfg, workdir, sid, out, resume, "cpu", sampler, steps, spacing)
    if names:
        os.makedirs(gen, exist_ok=True)
        for name in sorted(names)[KLD_PATCHES:]:
            open(os.path.join(gen, name), "w").close()
        argv.append("--skip_existing")
    if scorer == "port":
        from noisediff_tpu_torch.cli import test_diffusion
    else:
        from noisediff_tpu.cli import test_diffusion
        i = argv.index("--device")
        del argv[i:i + 2]
    test_diffusion.main(argv)
    if names:
        for name in os.listdir(gen):
            if os.path.getsize(os.path.join(gen, name)) == 0:
                os.remove(os.path.join(gen, name))


def score(cfg: dict, workdir: str, sid: str, side: str, name: str, scorer: str, path: str,
          label: str, sampler, steps, spacing) -> dict:
    """Generate from `path` through `scorer`'s sampler in a fresh process
    (one package's thread pools at a time: in the process that trained,
    the other package's pool slows the CPU sampler several-fold), then the
    KLD (the port's eval_kld for both: the patches are plain .npy). The
    first score of a workdir generates every patch and keeps their names;
    later ones generate only the batches the KLD and std read."""
    names_file = os.path.join(workdir, "generated_names.json")
    names = None
    if os.path.exists(names_file):
        with open(names_file) as f:
            names = json.load(f)
    spec = dict(scorer=scorer, cfg=cfg, workdir=workdir, sid=sid,
                out_name=f"gen_{side}_{name}_{scorer}_{label}", resume=path,
                sampler=sampler, steps=steps, spacing=spacing, names=names)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__), "--generate", json.dumps(spec)],
                   check=True)
    seconds = time.perf_counter() - t0
    gen = _gen_dir(workdir, spec["out_name"])
    written = sorted(os.listdir(gen))
    if names is None:
        with open(names_file, "w") as f:
            json.dump(written, f)
    else:
        assert written[:KLD_PATCHES] == sorted(names)[:KLD_PATCHES], gen
    return {"kld": plg.run_kld(workdir, sid, gen)["kld_symmetric"],
            "std": plg.generated_std(gen), "seconds": seconds}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=sorted(plg.SCALES), default="tiny",
                    help="the port gate's scale (scripts/port_learning_gate.py SCALES)")
    ap.add_argument("--tree", type=int, default=0, help="the gate's --seed: which tree")
    ap.add_argument("--run_seed", type=int, default=0, help="both CLIs' --random_seed")
    ap.add_argument("--freq", type=int, default=20, help="snapshot every this many epochs")
    ap.add_argument("--sides", default="port,jax",
                    help="which packages train ('' with --weights: none)")
    ap.add_argument("--score_with", default="port",
                    help="whose sampler generates for the score: port, jax or port,jax")
    ap.add_argument("--final_only", action="store_true",
                    help="score net_final and ema_final only")
    ap.add_argument("--weights", action="append", default=[], metavar="NAME=PATH",
                    help="also score this .pth (side 'given'), e.g. a card run's ema_final.pth")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--out", default="")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = dict(plg.SCALES[args.scale])
    scorers = args.score_with.split(",")
    os.makedirs(args.workdir, exist_ok=True)
    sid = plg.build_tree(args.workdir, cfg, seed=args.tree)
    result = {"scale": args.scale, "tree": args.tree, "run_seed": args.run_seed,
              "score_with": scorers, "config": cfg}

    def score_all(side, snaps):
        scores = result[side] = {}
        for name, paths in snaps.items():
            scores[name] = {}
            for scorer in scorers:
                scores[name][scorer] = {}
                for label, sampler, steps, spacing in samplers(cfg):
                    scores[name][scorer][label] = s = score(
                        cfg, args.workdir, sid, side, name, scorer, paths[scorer],
                        label, sampler, steps, spacing)
                    print(side, name, scorer, label, s, flush=True)

    for side in [s for s in args.sides.split(",") if s]:
        t0 = time.perf_counter()
        snap = train(side, cfg, args.workdir, sid, args.run_seed, args.freq)
        result[f"{side}_train_seconds"] = time.perf_counter() - t0
        score_all(side, snapshots(side, snap, args.final_only))
    if args.weights:
        given = dict(kv.split("=", 1) for kv in args.weights)
        result["given_paths"] = given
        score_all("given", {n: {"port": p, "jax": p} for n, p in given.items()})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    if sys.argv[1:2] == ["--generate"]:  # one score's generation, from score()
        generate(**json.loads(sys.argv[2]))
    else:
        main()
