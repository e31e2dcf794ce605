"""The PyTorch port's training step on the data x spatial x model grid,
alone: chip_smoke.py's one-process reference steps and its `train_sharded`
phase without the other phases.

    python3 scripts/port_train_sharded.py [--seed 0] [--out result.json]

Needs a CUDA machine. Each grid of chip_smoke.TRAIN_GRIDS ({spatial 2},
{model 2}, {spatial 2, model 2}) runs over NCCL where the machine has a card
for every rank (all three on 4 cards), else over gloo with the ranks on one
card. It builds the kernels, takes the canonical training step (NoiseDiffNet
dim 48, crop 512, batch 4, seeded weights, Adam) on one process in bf16,
with --remat and in fp32 (chip_smoke.reference_steps), then on each grid
(chip_smoke.phase_train_sharded, which holds every grid against the one
process and fails on a disagreement), and writes the grids' results as
JSON.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="write the phase's results here as JSON")
    args = ap.parse_args(argv)

    import torch

    from noisediff_tpu_torch.cli.common import set_precision_flags
    from noisediff_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("port_train_sharded: needs a CUDA device", file=sys.stderr)
        return 2
    chip_smoke.log(f"{chip_smoke.card_line()}; {torch.cuda.device_count()} card(s); torch "
                   f"{torch.__version__}, CUDA {torch.version.cuda}")
    set_precision_flags()
    _build.build_all()
    workdir = tempfile.mkdtemp(prefix="train_sharded_")
    try:
        chip_smoke.log("[reference] the canonical training step on one process")
        ref = chip_smoke.reference_steps(args.seed)
        chip_smoke.log("[train_sharded] the same step on the grids")
        runs = chip_smoke.phase_train_sharded(args.seed, workdir, ref)
        one = {k: {m: ref[k][m] for m in ("loss", "grad_norm", "peak_bytes", "step_ms",
                                          "peak_bytes_steps", "busy_ms") if m in ref[k]}
               for k in ref}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": chip_smoke.card_line(), "cards": torch.cuda.device_count(),
                       "one_process": one, "grids": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
