"""run.py as the check runs it, on this machine without a card: it
refuses to run, loads nothing of JAX or the JAX package, and finds a cell
that only new files add."""
import json
import os
import shutil
import subprocess
import sys

from harness import common

RUN = os.path.join(common.BENCH_DIR, "run.py")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cell in [w["name"] for w in common.benchmark()["workloads"]]:
        proc = _run([RUN, "--workload", cell, "--seed", str(2 ** 33 + 1), "--seconds", "1",
                     "--trace", "0"], common.ROOT, env)
        assert proc.returncode != 0
        assert not proc.stdout.strip(), proc.stdout
        assert "CUDA card" in proc.stderr


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    """Every module a run imports (the harness, every driver and metric,
    the references, the port's modules the drivers call), compared by the
    whole top-level name."""
    code = f"""
import sys
sys.argv = ["run.py"]
sys.path.insert(0, {common.BENCH_DIR!r})
import run
from harness import common, trace, roofline, flops, weights, port
from reference import noisediff_net, lsid, diffusion
import noisediff_tpu_torch.diffusion.gaussian
import noisediff_tpu_torch.cli.test_denoising, noisediff_tpu_torch.ops.metrics
import noisediff_tpu_torch.ops.raw, noisediff_tpu_torch.models.lsid
import noisediff_tpu_torch.ops.schedules, noisediff_tpu_torch.cli.common
bench = common.benchmark()
for w in bench["workloads"]:
    c = common.cell(w["name"], bench)
    common.load_file("drivers", c["traffic_file"]["driver"])
for m in bench["end_to_end"] + bench["per_layer"]:
    common.load_file("metrics", m["name"])
print(common.forbidden_modules())
"""
    proc = _run(["-c", code], common.ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("noisediff_tpu_torch_probe", sys)
    assert "noisediff_tpu_torch_probe" not in common.forbidden_modules()
    del sys.modules["noisediff_tpu_torch_probe"]


def test_references_import_nothing_of_the_port():
    ref = os.path.join(common.BENCH_DIR, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            with open(os.path.join(ref, name)) as f:
                text = f.read()
            for bad in ("noisediff_tpu", "jax", "flax"):
                assert f"import {bad}" not in text and f"from {bad}" not in text, name


def test_a_cell_added_by_files_alone_is_listed(tmp_path):
    """A throwaway cell in a copy of the benchmark: a traffic file and an
    entry in BENCHMARK.json, no file edited; run.py --list finds it."""
    shutil.copytree(common.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = common.benchmark()
    bench["workloads"].append({"name": "ndn48.gen-dpm2-b1", "config": "noisediffnet-dim48",
                               "traffic": "gen-dpm2-b1", "chips": 1, "why": "a throwaway"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = common.read_json(os.path.join(common.BENCH_DIR, "traffic", "gen-dpm10-b4.json"))
    traffic.update(steps=2, batch=1)
    (tmp_path / "port_bench" / "traffic" / "gen-dpm2-b1.json").write_text(json.dumps(traffic))
    proc = _run([str(tmp_path / "port_bench" / "run.py"), "--list"], str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "ndn48.gen-dpm2-b1: config noisediffnet-dim48, traffic gen-dpm2-b1 (driver gen)" \
        in proc.stdout


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero and prints no result."""
    shutil.copytree(common.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.BENCHMARK, tmp_path / "BENCHMARK.json")
    cell = common.benchmark()["workloads"][0]["name"]
    proc = _run([str(tmp_path / "port_bench" / "run.py"), "--workload", cell, "--seed", "1",
                 "--seconds", "1", "--trace", "0"], str(tmp_path))
    assert proc.returncode != 0 and not proc.stdout.strip()
