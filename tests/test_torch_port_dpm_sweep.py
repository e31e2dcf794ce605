"""The port's sampler KLD sweep (scripts/port_dpm_step_sweep.py), the
counterpart of scripts/dpm_step_sweep.py.

CPU tier: the script imports with `jax` and `noisediff_tpu` blocked; it
raises on --device cuda without a card; its merge keeps other rows and
replaces rows of the same key, as the JAX merge_into does; a micro sweep
on a 2-epoch tiny gate workdir (T 8) gives every key, with the fused DDIM-2
equal to the unfused one within FUSED_RTOL. Slow tier: the tiny gate kept
and swept at its own step counts.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import dpm_step_sweep as jax_sweep  # noqa: E402
import port_dpm_step_sweep as sweep  # noqa: E402
import port_learning_gate as plg  # noqa: E402

# fp32 on the CPU: the fused tail and the unfused DDIM compute the same
# update in another order; their KLDs agree to ~1e-6 relative
FUSED_RTOL = 1e-4
ROW_KEYS = {"weights", "sampler", "steps", "spacing", "kld", "kld_symmetric",
            "ddim_kld_symmetric", "vs_ddim_ratio", "generated_noise_std", "seconds",
            "kld_seconds", "resume", "device", "card", "mixed_precision"}


def test_sweep_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'noisediff_tpu',\n"
        "             'learning_gate', 'dpm_step_sweep'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'scripts')!r})\n"
        "import port_dpm_step_sweep\n"
        "from noisediff_tpu_torch.cli import eval_kld, test_diffusion\n"
        "from noisediff_tpu_torch.train import trainer_diffusion\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'noisediff_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_sweep_refuses_cuda_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        sweep.main(["--workdir", str(tmp_path), "--scale", "tiny"])


def _row(weights, sampler, steps, spacing, kld):
    return {"weights": weights, "sampler": sampler, "steps": steps, "spacing": spacing,
            "kld_symmetric": kld}


def test_merge_keeps_other_rows_and_replaces_same_key(tmp_path):
    """As the JAX merge_into: a row of the same key is replaced, every other
    row and top-level field kept; a fresh path gets the result."""
    out = tmp_path / "sweep.json"
    first = {"scale": "gpu", "sweep": [_row("ema", "dpm", 10, "lambda", 0.1),
                                       _row("ema", "dpm", 20, "lambda", 0.2),
                                       _row("ema", "ddim", 50, None, 0.3)]}
    merged = sweep.merge_into(str(out), first)
    assert merged["sweep"] == sorted(first["sweep"], key=sweep._sort_key)
    out.write_text(json.dumps(dict(merged, note="kept")))
    second = {"scale": "gpu", "sweep": [_row("ema", "dpm", 10, "lambda", 0.15),
                                        _row("ema", "dpm", 10, "time", 0.4),
                                        _row("net", "dpm", 10, "lambda", 0.5)]}
    merged = sweep.merge_into(str(out), second)
    rows = {sweep.row_key(r): r["kld_symmetric"] for r in merged["sweep"]}
    assert rows == {("ema", "dpm", 10, "lambda"): 0.15, ("ema", "dpm", 20, "lambda"): 0.2,
                    ("ema", "ddim", 50, None): 0.3, ("ema", "dpm", 10, "time"): 0.4,
                    ("net", "dpm", 10, "lambda"): 0.5}
    assert merged["note"] == "kept" and len(merged["sweep"]) == 5

    # the JAX merge on the same rows (its key is (dpm_steps, spacing)) keeps
    # and replaces alike
    jout = tmp_path / "jax.json"
    jax_rows = lambda rows: [{"dpm_steps": r["steps"], "spacing": r["spacing"],  # noqa: E731
                              "kld_symmetric": r["kld_symmetric"]} for r in rows]
    jout.write_text(json.dumps({"sweep": jax_rows(first["sweep"][:2]), "note": "kept"}))
    jmerged = jax_sweep.merge_into(str(jout), {"sweep": jax_rows(second["sweep"][:2]),
                                               "resume": "r"}, "lambda")
    jrows = {(r["dpm_steps"], r["spacing"]): r["kld_symmetric"] for r in jmerged["sweep"]}
    assert jrows == {(k[2], k[3]): v for k, v in rows.items()
                     if k[0] == "ema" and k[1] == "dpm"}
    assert jmerged["note"] == "kept"


def test_legs_put_fused_ddim_first():
    cfg = plg.SCALES["gpu"]
    legs = sweep.legs(cfg, [20, 10], "lambda", True)
    assert legs == [("ddim", 50, None, True), ("ddim_unfused", 50, None, False),
                    ("dpm", 20, "lambda", True), ("dpm", 10, "lambda", True),
                    ("ddpm", 1000, None, True)]


def _finite(v):
    if isinstance(v, dict):
        return all(_finite(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_finite(x) for x in v)
    return not isinstance(v, float) or math.isfinite(v)


@pytest.fixture(scope="module")
def micro_workdir(tmp_path_factory):
    """A tiny gate workdir: the SID tree and 2 epochs of NoiseDiffNet at
    T 8 through the training CLI (fp32 on the CPU)."""
    import logging

    import torch

    from noisediff_tpu_torch.cli import train_diffusion

    wd = str(tmp_path_factory.mktemp("sweep") / "gate")
    cfg = dict(plg.SCALES["tiny"], epochs=2, T=8)
    sid = plg.build_tree(wd, cfg, seed=0)
    root = logging.getLogger()
    handlers, level, threads = list(root.handlers), root.level, torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        train_diffusion.main(plg.train_diffusion_argv(cfg, wd, sid, "cpu"))
        yield wd
    finally:
        for h in [h for h in root.handlers if h not in handlers]:
            root.removeHandler(h)
            h.close()
        root.setLevel(level)
        torch.set_num_threads(threads)


def test_micro_sweep_gives_every_key(micro_workdir, tmp_path):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    out = tmp_path / "sweep.json"
    try:
        result = sweep.main(["--workdir", micro_workdir, "--scale", "tiny", "--device", "cpu",
                             "--set", "T=8", "--set", "ddim=2", "--steps", "2",
                             "--spacing", "lambda", "--ddpm", "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    rows = {(r["sampler"], r["steps"], r["spacing"]): r for r in result["sweep"]}
    assert list(rows) == [("ddim", 2, None), ("ddim_unfused", 2, None), ("dpm", 2, "lambda"),
                          ("ddpm", 8, None)]
    for r in rows.values():
        assert set(r) == ROW_KEYS
        assert _finite(r) and r["kld_symmetric"] > 0 and r["seconds"] > 0
        assert r["weights"] == "ema" and r["resume"].endswith("ema_final.pth")
        assert r["device"] == "cpu" and r["card"] is None and r["mixed_precision"] is False
        ddim = rows[("ddim", 2, None)]["kld_symmetric"]
        assert r["ddim_kld_symmetric"] == ddim
        assert r["vs_ddim_ratio"] == pytest.approx(r["kld_symmetric"] / ddim, rel=1e-12)
    fused, unfused = rows[("ddim", 2, None)], rows[("ddim_unfused", 2, None)]
    assert unfused["kld_symmetric"] == pytest.approx(fused["kld_symmetric"], rel=FUSED_RTOL)
    assert unfused["generated_noise_std"] == pytest.approx(fused["generated_noise_std"],
                                                           rel=FUSED_RTOL)
    # every leg wrote its own patches, the same names from the same grid
    gen = lambda leg: os.path.join(micro_workdir, leg, "ISO800_Ratio100", "npy",  # noqa: E731
                                   "generated")
    a, b = sorted(os.listdir(gen("sweep_ema_ddim2"))), sorted(os.listdir(
        gen("sweep_ema_ddim_unfused2")))
    assert a == b and len(a) > 16
    np.testing.assert_allclose(np.load(os.path.join(gen("sweep_ema_ddim_unfused2"), a[0])),
                               np.load(os.path.join(gen("sweep_ema_ddim2"), a[0])),
                               rtol=1e-4, atol=1e-5)
    assert json.loads(out.read_text())["sweep"] == json.loads(json.dumps(
        sorted(result["sweep"], key=sweep._sort_key)))


def test_micro_sweep_net_weights_merge(micro_workdir, tmp_path):
    """--weights net reads net_final.pth; its rows join the EMA's in --out."""
    import torch

    out = tmp_path / "sweep.json"
    out.write_text(json.dumps({"sweep": [_row("ema", "dpm", 2, "lambda", 0.5)]}))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = sweep.main(["--workdir", micro_workdir, "--scale", "tiny", "--device", "cpu",
                             "--set", "T=8", "--set", "ddim=2", "--steps", "",
                             "--weights", "net", "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    assert [(r["sampler"], r["weights"]) for r in result["sweep"]] == [
        ("ddim", "net"), ("ddim_unfused", "net")]
    assert result["sweep"][0]["resume"].endswith("net_final.pth")
    keys = [sweep.row_key(r) for r in json.loads(out.read_text())["sweep"]]
    assert keys == [("ema", "dpm", 2, "lambda"), ("net", "ddim", 2, None),
                    ("net", "ddim_unfused", 2, None)]


@pytest.mark.slow
def test_tiny_gate_sweep(tmp_path):
    """The tiny gate kept, then swept on the CPU: DDIM-16 fused and unfused,
    DPM-16 and -10 on the time grid, DDPM-64; every leg learned (below
    half the untrained KLD) and the fused tail equals the unfused DDIM."""
    wd = str(tmp_path / "gate")
    gate = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "port_learning_gate.py"),
         "--workdir", wd, "--scale", "tiny", "--device", "cpu", "--keep",
         "--out", str(tmp_path / "gate.json")], capture_output=True, text=True, timeout=3600)
    assert gate.returncode == 0, gate.stderr[-3000:]
    out = tmp_path / "sweep.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "port_dpm_step_sweep.py"),
         "--workdir", wd, "--scale", "tiny", "--device", "cpu", "--steps", "16,10",
         "--spacing", "time", "--ddpm", "--out", str(out)],
        capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    kld0 = json.loads((tmp_path / "gate.json").read_text())["kld_untrained"]["kld_symmetric"]
    rows = {(r["sampler"], r["steps"]): r for r in json.loads(out.read_text())["sweep"]}
    assert set(rows) == {("ddim", 16), ("ddim_unfused", 16), ("dpm", 16), ("dpm", 10),
                         ("ddpm", 64)}
    for r in rows.values():
        assert set(r) == ROW_KEYS and r["kld_symmetric"] < kld0 / 2, r
    assert rows[("ddim_unfused", 16)]["kld_symmetric"] == pytest.approx(
        rows[("ddim", 16)]["kld_symmetric"], rel=FUSED_RTOL)


def test_chip_smoke_sweep_phase_counts_wrappers_that_exist():
    """chip_smoke's sweep phase asserts launches of the four inference
    kernels of the gate's default route, by wrappers that exist, on the
    smoke scale's DDIM-50."""
    import chip_smoke

    assert set(chip_smoke.SWEEP_KERNELS) <= set(chip_smoke.GATE_KERNELS)
    wrappers = {chip_smoke.KERNEL_META[k][0] for k in chip_smoke.SWEEP_KERNELS}
    assert wrappers == {"fused_attn_tail", "fused_groupnorm_film_silu", "fused_dual_head",
                        "fused_ddim_head_update"}
    assert wrappers <= set(chip_smoke.KERNEL_WRAPPERS)
    assert plg.SCALES["smoke"]["ddim"] == 50 and chip_smoke.SWEEP_DDIM_RTOL == 0.02


def test_h100_sweep_record_is_what_the_script_writes():
    """DPM_STEP_SWEEP_H100.json: the script's rows over one gpu-scale gate
    workdir, every key, the card and each leg's seconds: the lambda grid at
    20..6 steps, the time grid at 20, 15 and 10, DDPM over all T steps and
    the online weights' DPM-10 lambda, each weights' DDIM-50 fused and
    unfused within chip_smoke's SWEEP_DDIM_RTOL."""
    import chip_smoke

    with open(os.path.join(REPO, "DPM_STEP_SWEEP_H100.json")) as f:
        record = json.load(f)
    assert record["scale"] == "gpu" and record["config"] == plg.SCALES["gpu"]
    rows = {sweep.row_key(r): r for r in record["sweep"]}
    assert len(rows) == len(record["sweep"])
    assert record["sweep"] == sorted(record["sweep"], key=sweep._sort_key)
    want = ({("ema", "dpm", n, "lambda") for n in (20, 15, 12, 10, 8, 6)}
            | {("ema", "dpm", n, "time") for n in (20, 15, 10)}
            | {("ema", "ddpm", 1000, None), ("net", "dpm", 10, "lambda")}
            | {(w, s, 50, None) for w in ("ema", "net") for s in ("ddim", "ddim_unfused")})
    assert set(rows) == want
    for key, r in rows.items():
        assert set(r) == ROW_KEYS, key
        assert r["device"] == "NVIDIA H100 80GB HBM3" and r["card"].startswith(r["device"])
        assert r["mixed_precision"] is True and r["seconds"] > 0 and _finite(r)
        weights = "ema_final.pth" if r["weights"] == "ema" else "net_final.pth"
        assert r["resume"].endswith(weights), key
        assert r["ddim_kld_symmetric"] == rows[(r["weights"], "ddim", 50, None)]["kld_symmetric"]
        assert r["vs_ddim_ratio"] == pytest.approx(r["kld_symmetric"] / r["ddim_kld_symmetric"])
    for w in ("ema", "net"):
        fused = rows[(w, "ddim", 50, None)]["kld_symmetric"]
        unfused = rows[(w, "ddim_unfused", 50, None)]["kld_symmetric"]
        assert abs(unfused - fused) / fused <= chip_smoke.SWEEP_DDIM_RTOL, w
