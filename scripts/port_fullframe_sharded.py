"""The PyTorch port's full frame split by rows, alone: chip_smoke.py's
`fullframe` and `fullframe_sharded` phases without the others.

    python3 scripts/port_fullframe_sharded.py [--seed 0] [--out result.json]

Needs a CUDA machine. On one card it runs 2 ranks over gloo (both on the
card); on 2 cards 2 ranks over NCCL; on 4 cards also 4 ranks over NCCL. It
builds the kernels, makes chip_smoke's seeded dim-48 weights and SID
evaluation tree in a temporary directory, generates the whole 1424 x 2128
frame on one card (phase_fullframe) and split over the ranks
(phase_fullframe_sharded), and writes both phases' results as JSON.
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
    ap.add_argument("--out", default="", help="write the phases' results here as JSON")
    args = ap.parse_args(argv)

    import torch

    from noisediff_tpu_torch.cli.common import set_precision_flags
    from noisediff_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("port_fullframe_sharded: needs a CUDA device", file=sys.stderr)
        return 2
    chip_smoke.log(f"{chip_smoke.card_line()}; {torch.cuda.device_count()} card(s); torch "
                   f"{torch.__version__}, CUDA {torch.version.cuda}")
    set_precision_flags()
    _build.build_all()
    workdir = tempfile.mkdtemp(prefix="fullframe_sharded_")
    try:
        ckpt = chip_smoke.gen_setup(workdir, args.seed)
        sid = chip_smoke.make_eval_tree(os.path.join(workdir, "eval"), args.seed)
        chip_smoke.log("[fullframe] one card")
        one_card = chip_smoke.phase_fullframe(args.seed, ckpt, sid)
        chip_smoke.log("[fullframe_sharded] split by rows")
        sharded = chip_smoke.phase_fullframe_sharded(args.seed, ckpt, sid, workdir, one_card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": chip_smoke.card_line(), "cards": torch.cuda.device_count(),
                       "one_card": {k: v for k, v in one_card.items() if k != "counts"},
                       "sharded": sharded}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
