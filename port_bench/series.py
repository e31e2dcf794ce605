"""Runs of the benchmark's command one after another, each a new process,
as a check makes them; each run's exit code, last stdout line and the end
of its stderr go to one JSON line of --out.

    python3 port_bench/series.py --workload <name> --seeds 1,2,3 [--trace 0] \
        [--seconds S] --out runs.jsonl

The card's name and power limit (nvidia-smi) are written first.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--seconds", default=None)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps({"card": card(), "workload": args.workload}) + "\n")
    worst = 0
    for seed in args.seeds.split(","):
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
               "--seed", seed, "--trace", str(args.trace)]
        if args.seconds:
            cmd += ["--seconds", args.seconds]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"seed": int(seed), "trace": args.trace, "rc": proc.returncode,
               "wall_s": time.perf_counter() - t0, "result": result,
               "stderr_tail": proc.stderr[-1500:]}
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps({k: row[k] for k in ("seed", "rc", "wall_s")} | {
            "metrics": {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()},
            "correct": (result or {}).get("correct")}), flush=True)
        worst = max(worst, proc.returncode)
    return worst


if __name__ == "__main__":
    sys.exit(main())
