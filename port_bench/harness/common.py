"""What every cell shares: finding a cell's files by name, the seeds, the
look for the cards, the check that no JAX module was loaded, the sample
the reference checks, and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration is
`configs/<config>.json`, its traffic mix `traffic/<traffic>.json` (whose
`driver` names `drivers/<driver>.py`), and each metric it reports
`metrics/<metric>.py`. Nothing here names a cell, a model or a metric:
a later change adds them as files.
"""
from __future__ import annotations

import heapq
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
# top-level module names the run may not load (the reference package and its stack)
FORBIDDEN = ("jax", "jaxlib", "flax", "noisediff_tpu")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(path: str = BENCHMARK) -> dict:
    return read_json(path)


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """The workload entry `name`, with its configuration and traffic files
    read in as 'config_file' and 'traffic_file'."""
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    out = dict(w)
    out["config_file"] = read_json(os.path.join(ROOT, config["file"]))
    out["traffic_file"] = read_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    return out


def metrics_of(name: str, trace: bool, bench: Optional[dict] = None) -> List[dict]:
    """The metrics a run of cell `name` reports: with trace 0 the
    end-to-end ones, with trace 1 the per-layer ones; a metric with a
    `workloads` key only in the cells it lists."""
    bench = bench or benchmark()
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def load_file(kind: str, name: str):
    """The module `<kind>/<name>.py` under the benchmark's folder (names may
    hold dots, so it is loaded by path)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of the run (a generator, a batch),
    a pure function of the run's seed, which may exceed 32 bits."""
    import numpy as np

    seq = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *map(int, stream)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one (the whole
    name before the first dot: noisediff_tpu_torch is not noisediff_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def require_cards(chips: int) -> None:
    """Exit with code 3, printing no result, without `chips` CUDA cards."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s), this machine has {have}; "
              "the benchmark does not run on the CPU", file=sys.stderr)
        sys.exit(3)


class Reservoir:
    """The k finished units with the smallest key drawn from the run's seed:
    a uniform sample of however many units the window finishes, of fixed
    size, chosen by the seed."""

    def __init__(self, seed: int, k: int):
        self.seed, self.k = seed, k
        self.heap = []  # (-key, index, item)

    def offer(self, index: int, make_item) -> None:
        key = sub_seed(self.seed, 7, index)
        if len(self.heap) < self.k:
            heapq.heappush(self.heap, (-key, index, make_item()))
        elif key < -self.heap[0][0]:
            heapq.heapreplace(self.heap, (-key, index, make_item()))

    def items(self) -> list:
        """[(index, item)] in index order."""
        return sorted((i, item) for _, i, item in self.heap)


def quantile(values, q: float) -> float:
    """The q-quantile of values by linear interpolation between order
    statistics (numpy's default), over every value given."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def emit(result: Dict, checks: Dict[str, Dict[str, float]]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    stderr; then the result line, `checks` its last key, as the last line
    of stdout."""
    checks = {k: {"value": c["value"] if math.isfinite(c["value"]) else 1e300,
                  "limit": c["limit"]} for k, c in checks.items()}  # JSON has no inf or NaN
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
