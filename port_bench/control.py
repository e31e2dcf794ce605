"""Readings that set a cell's limits: the program, or its control, over
many seeds in one process, each with a short window at the cell's load.

    python3 port_bench/control.py --workload <name> --seeds 11,12,13 \
        [--control int8|tf32] [--seconds 2] [--out readings.jsonl]

Without --control it reads the program (the lower readings); with it, the
control the cell's driver puts in the program's place, one precision below
the configuration's (the upper readings). Each seed prints one JSON line
with its compared numbers. No run of the benchmark calls this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402  (sets up the import paths)
from harness import common  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run.cache_dirs()
    bench = common.benchmark()
    cell = common.cell(args.workload, bench)
    common.require_cards(cell["chips"])
    import torch

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run.execute(cell, seed, args.seconds, False, torch.device("cuda", 0), bench,
                          t_start=t0, control=args.control)
        line = {"workload": args.workload, "control": args.control, "seed": seed,
                "checks": {k: v["value"] for k, v in res["checks"].items()},
                "attempted": res["attempted"], "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
