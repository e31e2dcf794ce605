"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""
import os
import re

import pytest

from harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = common.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _exists(*parts):
    return os.path.exists(os.path.join(common.BENCH_DIR, *parts))


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(common.BENCHMARK) <= 64 * 1024
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\t" not in word and "\n" not in word
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("port_bench/") and os.path.exists(
            os.path.join(common.ROOT, c["file"]))
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        body = common.read_json(os.path.join(common.ROOT, c["file"]))
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    """The configuration, traffic, driver, limits and every metric the cell
    reports are files the harness finds by name."""
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    c = common.cell(cell, BENCH)
    assert _exists("drivers", f"{c['traffic_file']['driver']}.py")
    limits = common.read_json(os.path.join(common.BENCH_DIR, "limits", f"{cell}.json"))
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for trace in (False, True):
        metrics = common.metrics_of(cell, trace, BENCH)
        assert metrics, (cell, trace)
        for m in metrics:
            assert _exists("metrics", f"{m['name']}.py"), m["name"]
            assert callable(common.load_file("metrics", m["name"]).read)


def test_pairs_of_config_and_traffic_are_unique_and_four_chip_cells_few():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if kind == "end_to_end" else {"layer", "moves"})
    for m in BENCH[kind]:
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for cell in m.get("workloads", []):
            assert cell in CELLS
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"] or "share" in m["name"]:
            assert m["unit"] == "%"


def test_setup_s_is_reported_by_every_cell_beside_another_end_to_end_metric():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    for cell in CELLS:
        names = [m["name"] for m in common.metrics_of(cell, False, BENCH)]
        assert "setup_s" in names and len(names) >= 2


def test_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in [x["name"] for x in common.metrics_of(cell, False, BENCH)]


def test_layers_are_named_alike():
    """Metrics of one layer give the same layer name, as PERF.md lists it."""
    with open(os.path.join(common.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"| {layer} |" in perf, layer
