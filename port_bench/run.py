"""The port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in BENCHMARK.json on the CUDA cards of this machine
(never on the CPU: without the cards the cell asks for it exits with code
3 and prints no result), measures for `--seconds` after its set-up, checks
what the timed path produced against the plain reference, and prints the
result as one JSON line, the last of standard output. `--trace 1` adds a
profiled part after the window and reports the per-layer metrics.
`--list` prints the cells and the files each is made of.
"""
import time

T_START = time.perf_counter()  # noqa: E402  (set-up is timed from here)

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))  # the checkout: the port's package
sys.path.insert(0, HERE)  # the benchmark's own packages

from harness import common  # noqa: E402

# The host's intra-op threads (torch, OpenMP). The frame cell pins two
# mosaics a frame with torch's parallel copy; with one thread on each of a
# one-card host's 8 cores, a core taken by a neighbour holds up every copy,
# and runs spread by up to 14%. Half the cores leave room beside the main
# thread and the CUDA driver's.
HOST_THREADS = 4


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the port's own
    libraries are built under noisediff_tpu_torch/build/)."""
    base = os.path.join(common.ROOT, ".port_bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def execute(cell: dict, seed: int, seconds: float, trace: bool, device, bench: dict,
            t_start: float = None, control: str = None) -> dict:
    """One run of `cell` (common.cell's dict) on `device`; returns the
    result line's dict with 'checks', or raises. `control` names the
    precision-below control the driver puts in the program's place
    (control.py; no run of the benchmark sets it)."""
    name = cell["name"]
    tr = cell["traffic_file"]
    limits = common.read_json(os.path.join(common.BENCH_DIR, "limits", f"{name}.json"))
    ctx = SimpleNamespace(config=cell["config_file"], traffic=tr, seed=seed, seconds=seconds,
                          trace=trace, device=device, limits=limits, chips=cell["chips"],
                          control=control,
                          t_start=T_START if t_start is None else t_start)
    out = common.load_file("drivers", tr["driver"]).run(ctx)
    record = out["record"]
    if record is not None:
        print("set-up by part (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in record["setup_parts"].items()), file=sys.stderr)
    metrics = {}
    for m in common.metrics_of(name, trace, bench) if record is not None else []:
        value = common.load_file("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics}
    if device.type == "cuda" and record is not None:
        import torch

        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": cell["chips"],
                            "memory_peak_bytes": int(record["memory_peak_bytes"])}
    if trace and record is not None:
        tr_rec = record["trace"]
        result.setdefault("device", {})
        result["device"]["busy_s"] = tr_rec["busy_s"]
        result["device"]["window_s"] = tr_rec["window_s"]
        result["breakdown"] = tr_rec["breakdown"]
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--list", action="store_true", help="list the cells and their files")
    args = p.parse_args(argv)
    bench = common.benchmark()
    if args.list:
        for w in bench["workloads"]:
            c = common.cell(w["name"], bench)
            print(f"{w['name']}: config {w['config']}, traffic {w['traffic']} "
                  f"(driver {c['traffic_file']['driver']}), chips {w['chips']}")
        return 0
    if not args.workload:
        p.error("--workload is required")
    cell = common.cell(args.workload, bench)
    seconds = bench["run_seconds"] if args.seconds is None else args.seconds
    cache_dirs()
    common.require_cards(cell["chips"])
    import torch

    torch.set_num_threads(HOST_THREADS)
    result = execute(cell, args.seed, seconds, bool(args.trace), torch.device("cuda", 0), bench)
    bad = common.forbidden_modules()
    if bad:
        print(f"port_bench: modules of the JAX package or JAX were loaded: {bad}",
              file=sys.stderr)
        return 4
    checks = result.pop("checks")
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
