"""The port's learning gate (scripts/port_learning_gate.py) against the JAX
package's (scripts/learning_gate.py).

CPU tier: the synthetic SID tree byte for byte at the tiny and gpu frame
sizes; each CLI call's arguments, parsed by the port's parser, equal the
JAX gate's parsed by the JAX parser in every shared field; the noisy-input
PSNR equals the JAX one; the script and every module of the port import
with `jax` and `noisediff_tpu` blocked; a micro run (one epoch of each
stage) returns every key with finite values. Slow tier: the whole tiny gate
on the CPU with the JAX slow test's thresholds (tests/test_learning_gate.py).
"""
import argparse
import glob
import json
import logging
import math
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import learning_gate as lg  # noqa: E402
import port_learning_gate as plg  # noqa: E402

# the knobs the JAX tpu scale and the port's gpu scale share
GPU_FROM_TPU = ("fh", "fw", "n_train", "n_test", "dim", "crop", "epochs", "batch", "T",
                "ddim", "dpm", "dpm_spacing", "lr", "lsid_width", "den_epochs", "den_lr",
                "den_crop", "gen_batch")


def _files(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_scales_are_the_jax_gates():
    assert plg.SCALES["tiny"] == lg.SCALES["tiny"]
    assert {k: plg.SCALES["gpu"][k] for k in GPU_FROM_TPU} == lg.SCALES["tpu"]
    smoke, gpu = plg.SCALES["smoke"], plg.SCALES["gpu"]
    cut = {k for k in gpu if smoke[k] != gpu[k]}
    assert cut <= {"epochs", "den_epochs"} and all(smoke[k] < gpu[k] for k in cut)
    assert (plg.K_TRUE, plg.VAR_TRUE, plg.ISO, plg.RATIO) == (lg.K_TRUE, lg.VAR_TRUE, lg.ISO,
                                                              lg.RATIO)


@pytest.mark.parametrize("scale", ["tiny", "gpu"])
def test_build_tree_writes_the_jax_gates_files(tmp_path, scale):
    cfg = plg.SCALES[scale]
    jax_cfg = lg.SCALES["tpu" if scale == "gpu" else scale]
    sid_port = plg.build_tree(str(tmp_path / "port"), cfg, seed=3)
    sid_jax = lg.build_tree(str(tmp_path / "jax"), jax_cfg, seed=3)
    port, jax_files = _files(sid_port), _files(sid_jax)
    assert len(port) == 2 * (cfg["n_train"] + cfg["n_test"]) + 2
    assert port == jax_files


def _parse(parser, argv):
    return vars(parser.parse_args(argv))


def _jax_argvs(monkeypatch, workdir, scale_set):
    """The argv of each CLI call of the JAX gate's main (tiny scale with the
    `scale_set` knobs), its CLIs replaced by recorders; common_flags as it
    gives them off the TPU (no jax backend probe)."""
    from noisediff_tpu.cli import eval_kld, test_denoising, test_diffusion
    from noisediff_tpu.cli import train_denoising, train_diffusion

    calls = []

    def generation(argv):
        ns = test_diffusion.build_parser().parse_args(argv)
        out = os.path.join(ns.save_folder, ns.name, "npy", "generated")
        os.makedirs(out, exist_ok=True)
        for i in range(2):
            np.save(os.path.join(out, f"{i:05d}_00_10s+{i:05d}_00_10s+0_{i}.npy"),
                    np.full((4, 16, 16), 0.05, np.float32))
        calls.append(("generation", argv))

    def kld(argv):
        ns = eval_kld.build_parser().parse_args(argv)
        with open(ns.out, "w") as f:
            json.dump({"kld_symmetric": 1.0}, f)
        calls.append(("kld", argv))

    monkeypatch.setattr(test_diffusion, "main", generation)
    monkeypatch.setattr(eval_kld, "main", kld)
    monkeypatch.setattr(train_diffusion, "main", lambda a: calls.append(("train_diffusion", a)))
    monkeypatch.setattr(train_denoising, "main", lambda a: calls.append(("train_denoising", a)))
    monkeypatch.setattr(test_denoising, "evaluate",
                        lambda ns: calls.append(("evaluate", ns)) or
                        {"PSNR": 30.0, "SSIM": 0.9, "n": 2})
    monkeypatch.setattr(lg, "noisy_input_psnr", lambda sid, wd: 24.0)
    monkeypatch.setattr(lg, "common_flags", lambda wd, sid: [
        "--sid_folder", sid, "--pretrained_dir", wd, "--num_workers", "1",
        "--no_mixed_precision"])
    lg.main(["--workdir", workdir, "--scale", "tiny", *scale_set])
    return calls


def test_cli_arguments_are_the_jax_gates(monkeypatch, tmp_path):
    """Every CLI call, parsed: the JAX gate's by the JAX parsers, the port's
    by the port's, equal in every field they share. The trained weights'
    paths differ by the port's '.pth' suffix alone
    (train/checkpoint.py: <name>_<epoch>.pth)."""
    from noisediff_tpu.cli import eval_kld as j_kld
    from noisediff_tpu.cli import test_diffusion as j_gen
    from noisediff_tpu.cli import train_denoising as j_den
    from noisediff_tpu.cli import train_diffusion as j_diff
    from noisediff_tpu_torch.cli import eval_kld as p_kld
    from noisediff_tpu_torch.cli import test_denoising as p_eval
    from noisediff_tpu_torch.cli import test_diffusion as p_gen
    from noisediff_tpu_torch.cli import train_denoising as p_den
    from noisediff_tpu_torch.cli import train_diffusion as p_diff

    knobs = ["--set", "dpm=10", "--set", "dpm_spacing=lambda"]
    wd = str(tmp_path / "work")
    calls = _jax_argvs(monkeypatch, wd, knobs)
    assert [c for c, _ in calls] == ["generation", "kld", "train_diffusion", "generation",
                                     "kld", "generation", "kld", "train_denoising", "evaluate"]
    cfg = plg.scale_config(plg.build_parser().parse_args(
        ["--workdir", wd, "--scale", "tiny", *knobs]))
    sid = os.path.join(wd, "SID")
    weights = plg.trained_weights(wd)
    jax_ns = [c[1] for c in calls]
    gens = [_parse(j_gen.build_parser(), a) for c, a in calls if c == "generation"]
    klds = [_parse(j_kld.build_parser(), a) for c, a in calls if c == "kld"]
    port_gens = [
        plg.generation_argv(cfg, wd, sid, os.path.join(wd, "gen_untrained"), "", "cpu"),
        plg.generation_argv(cfg, wd, sid, os.path.join(wd, "gen_trained"), weights, "cpu"),
        plg.generation_argv(cfg, wd, sid, os.path.join(wd, "gen_trained_dpm"), weights, "cpu",
                            sampler="dpm", steps=cfg["dpm"], spacing=cfg["dpm_spacing"])]
    gen_dir = os.path.join(wd, "{}", "ISO800_Ratio100", "npy", "generated")
    port_klds = [plg.kld_argv(wd, sid, gen_dir.format(name))
                 for name in ("gen_untrained", "gen_trained", "gen_trained_dpm")]
    pairs = [(j, _parse(p_gen.build_parser(), p)) for j, p in zip(gens, port_gens)]
    pairs += [(j, _parse(p_kld.build_parser(), p)) for j, p in zip(klds, port_klds)]
    pairs.append((_parse(j_diff.build_parser(), jax_ns[2]),
                  _parse(p_diff.build_parser(), plg.train_diffusion_argv(cfg, wd, sid, "cpu"))))
    pairs.append((_parse(j_den.build_parser(), jax_ns[7]), _parse(
        p_den.build_parser(),
        plg.train_denoising_argv(cfg, wd, sid, os.path.join(wd, "synth"), "cpu"))))
    dsnap = os.path.join(wd, "logs", "dweights", "gate_denoise", "snapshot")
    pairs.append((vars(jax_ns[8]), _parse(p_eval.build_parser(), plg.evaluate_argv(
        cfg, wd, sid, os.path.join(dsnap, "net_final.pth"), "cpu"))))
    for i, (j, p) in enumerate(pairs):
        shared = sorted(set(j) & set(p) - {"resume"})
        assert len(shared) > 5, (i, shared)
        assert {k: p[k] for k in shared} == {k: j[k] for k in shared}, i
        if "resume" in j:
            assert p["resume"] == (j["resume"] + ".pth" if j["resume"] else ""), i
        assert p.get("device", "cpu") == "cpu"
    # the untrained baseline is a random init, the trained legs read the snapshot
    assert gens[0]["resume"] == "" and gens[1]["resume"].endswith("snapshot/net_final")


def test_noisy_input_psnr_is_the_jax_ones(tmp_path):
    sid = plg.build_tree(str(tmp_path), plg.SCALES["tiny"], seed=1)
    got, want = plg.noisy_input_psnr(sid, str(tmp_path)), lg.noisy_input_psnr(sid, str(tmp_path))
    assert 20.0 < got < 30.0
    assert abs(got - want) <= 1e-9


def test_gate_and_port_import_without_jax():
    """The gate script and every module of the port import with `jax` and
    `noisediff_tpu` blocked (None in sys.modules makes their import raise)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'noisediff_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'scripts')!r})\n"
        "import port_learning_gate\n"
        "import noisediff_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(noisediff_tpu_torch.__path__, "
        "'noisediff_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'noisediff_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) > 30


def test_gate_refuses_cuda_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        plg.main(["--workdir", str(tmp_path / "w"), "--scale", "tiny"])
    assert not os.path.exists(tmp_path / "w")


def _finite(v):
    if isinstance(v, dict):
        return all(_finite(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_finite(x) for x in v)
    return not isinstance(v, float) or math.isfinite(v)


def test_micro_run_returns_every_key(tmp_path):
    """One epoch of each stage at the tiny scale on the CPU (fp32): the JAX
    gate's keys and the port's own, every number finite."""
    import torch

    root = logging.getLogger()
    handlers, level, threads = list(root.handlers), root.level, torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = tmp_path / "gate.json"
        result = plg.main(["--workdir", str(tmp_path / "w"), "--scale", "tiny", "--device",
                           "cpu", "--set", "epochs=1", "--set", "den_epochs=1", "--out",
                           str(out)])
    finally:
        for h in [h for h in root.handlers if h not in handlers]:
            root.removeHandler(h)
            h.close()
        root.setLevel(level)
        torch.set_num_threads(threads)
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    jax_keys = {"scale", "noise_model", "kld_untrained", "kld_trained", "generated_noise_std",
                "kld_improvement", "psnr_noisy_input", "psnr_denoised", "psnr_gain",
                "ssim_denoised", "n_eval_frames"}
    port_keys = {"config", "seed", "random_seed", "device", "card", "mixed_precision",
                 "wgrad_route", "seconds", "train_diffusion", "train_denoising", "thresholds",
                 "missed", "passed"}
    assert set(result) == jax_keys | port_keys
    assert _finite(result)
    assert result["device"] == "cpu" and result["card"] is None
    assert result["mixed_precision"] is False
    assert result["n_eval_frames"] == 2
    assert set(result["seconds"]) == {"tree", "generate_untrained", "kld_untrained",
                                      "train_diffusion", "generate_ddim", "kld_ddim",
                                      "train_denoising", "evaluate", "total"}
    assert result["train_diffusion"]["steps"] == 12  # 4 pairs rebalanced to 100, batch 8
    assert result["missed"] == plg.check(result)
    assert result["passed"] is not bool(result["missed"])


@pytest.mark.slow
def test_port_closed_loop_learning_gate(tmp_path):
    """The whole tiny gate through the port's CLIs on the CPU (fp32), with
    the JAX slow test's thresholds (tests/test_learning_gate.py:49-59)."""
    out = tmp_path / "gate.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "port_learning_gate.py"),
         "--workdir", str(tmp_path / "work"), "--scale", "tiny", "--device", "cpu",
         "--out", str(out)],
        capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(out.read_text())
    kld0 = result["kld_untrained"]["kld_symmetric"]
    kld1 = result["kld_trained"]["kld_symmetric"]
    assert kld1 < kld0 / 2.0, (kld0, kld1)
    assert result["generated_noise_std"] < 0.3, result["generated_noise_std"]
    assert result["psnr_gain"] > 1.0, result
    assert result["passed"] and not result["missed"]


def test_thresholds_are_the_jax_slow_tests():
    base = {"kld_untrained": {"kld_symmetric": 2.0}, "kld_trained": {"kld_symmetric": 0.9},
            "generated_noise_std": 0.05, "psnr_gain": 1.5}
    assert plg.check(base) == []
    assert plg.check(dict(base, kld_trained={"kld_symmetric": 1.0})) == [
        "kld_trained < kld_untrained / 2"]
    assert plg.check(dict(base, generated_noise_std=0.3)) == ["generated_noise_std < 0.3"]
    assert plg.check(dict(base, psnr_gain=1.0)) == ["psnr_gain > 1.0"]


def test_argparse_namespace_has_no_platform_flag():
    """--platform gives way to --device, cuda by default."""
    ap = plg.build_parser()
    ns = ap.parse_args(["--workdir", "w"])
    assert isinstance(ns, argparse.Namespace) and ns.device == "cuda"
    with pytest.raises(SystemExit):
        ap.parse_args(["--workdir", "w", "--platform", "cpu"])


def test_chip_smoke_gate_phase_runs_the_smoke_scale():
    """chip_smoke's gate phase checks the kernels at the shapes the smoke
    scale gives them, and counts wrappers that exist."""
    import chip_smoke

    smoke = plg.SCALES["smoke"]
    assert (chip_smoke.GATE_TRAIN_B, chip_smoke.GATE_GEN_B, chip_smoke.GATE_CROP) == (
        smoke["batch"], smoke["gen_batch"], smoke["crop"])
    assert chip_smoke.GATE_STAGES[0] == (smoke["crop"], smoke["dim"])
    wrappers = {chip_smoke.KERNEL_META[k][0] for k in chip_smoke.GATE_KERNELS}
    assert len(wrappers) == 7 and wrappers <= set(chip_smoke.KERNEL_WRAPPERS)
    assert not wrappers & {"conv_wgrad", "flash_attention", "groupnorm_silu_apply"}


def test_dpm_failure_is_recorded_and_raises(monkeypatch, tmp_path):
    """A failed DPM leg: stage 2 still runs, the result records dpm_error
    and fails, and the gate raises after writing it (a non-zero exit)."""
    from noisediff_tpu_torch.cli import test_denoising, train_denoising, train_diffusion

    def generation(cfg, workdir, sid, out_name, resume, device, sampler=None, steps=None,
                   spacing=None, run=()):
        if sampler == "dpm":
            raise ValueError("no DPM today")
        out = os.path.join(workdir, out_name, "generated")
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, "00001_00_10s+00001_00_10s+0_0.npy"),
                np.full((4, 16, 16), 0.05, np.float32))
        return out

    summary = {"steps": 4, "losses": [0.5] * 4, "epoch_seconds": [1.0],
               "loader_wait_seconds": [0.1], "step_seconds": [0.2] * 4}
    stage2 = []
    monkeypatch.setattr(plg, "run_generation", generation)
    monkeypatch.setattr(plg, "run_kld", lambda wd, sid, gen: {"kld_symmetric": 0.1})
    monkeypatch.setattr(plg, "noisy_input_psnr", lambda sid, wd: 24.0)
    monkeypatch.setattr(train_diffusion, "main", lambda argv: summary)
    monkeypatch.setattr(train_denoising, "main", lambda argv: stage2.append(argv) or summary)
    monkeypatch.setattr(test_denoising, "evaluate",
                        lambda ns: {"PSNR": 30.0, "SSIM": 0.9, "n": 2})
    out = tmp_path / "gate.json"
    with pytest.raises(RuntimeError, match="the DPM leg failed: ValueError: no DPM today"):
        plg.main(["--workdir", str(tmp_path / "w"), "--scale", "tiny", "--device", "cpu",
                  "--set", "dpm=2", "--out", str(out)])
    result = json.loads(out.read_text())
    assert stage2 and result["dpm_error"] == "ValueError: no DPM today"
    assert result["passed"] is False and "kld_trained_dpm" not in result


def test_h100_record_is_what_the_script_writes():
    """LEARNING_GATE_H100.json: each run is the gpu-scale --out JSON with the
    DPM leg, plus only its `run` label (the keys the micro run holds, the
    DPM leg's, and the present training summary's except where the record
    names the run as written by the earlier form; `random_seed` from the
    runs the script wrote with it); two runs on the default route and one
    on conv_wgrad on tree 0, then one default-route run on each of trees
    0, 1 and 2, then tree 0 at --random_seed 1 and in fp32, each passing
    the three thresholds; the second tree-0 default-route run repeats the
    first's readings bit for bit."""
    with open(os.path.join(REPO, "LEARNING_GATE_H100.json")) as f:
        record = json.load(f)
    keys = {"run", "scale", "noise_model", "kld_untrained", "kld_trained",
            "generated_noise_std", "kld_improvement", "psnr_noisy_input", "psnr_denoised",
            "psnr_gain", "ssim_denoised", "n_eval_frames", "kld_trained_dpm", "dpm_steps",
            "dpm_spacing", "dpm_vs_ddim_kld_ratio", "config", "seed", "device", "card",
            "mixed_precision", "wgrad_route", "seconds", "train_diffusion",
            "train_denoising", "thresholds", "missed", "passed"}
    summary = set(plg.training_summary({"steps": 2, "losses": [1.0, 0.5], "epoch_seconds": [1.0],
                                        "loader_wait_seconds": [0.1],
                                        "step_seconds": [0.2, 0.3]}))
    earlier = {"steps", "steps_per_s", "epoch_seconds", "loader_wait_seconds", "loss_first",
               "loss_last"}
    runs = record["runs"]
    assert [r["run"] for r in runs[:3]] == ["gpu_default_1", "gpu_default_2", "gpu_pallas_1"]
    assert [r["wgrad_route"] for r in runs] == ["xla"] * 2 + ["pallas"] + ["xla"] * 5
    assert [(r["seed"], r.get("random_seed", 0)) for r in runs] == [(0, 0)] * 4 + [
        (1, 0), (2, 0), (0, 1), (0, 0)]
    assert [r["mixed_precision"] for r in runs] == [True] * 7 + [False]
    readings = ("kld_untrained", "kld_trained", "kld_trained_dpm", "generated_noise_std",
                "psnr_denoised")
    assert {k: runs[3][k] for k in readings} == {k: runs[0][k] for k in readings}
    for r in runs:
        assert set(r) - {"random_seed"} == keys, r["run"]
        assert r["scale"] == "gpu" and r["config"] == plg.SCALES["gpu"]
        assert r["card"].startswith(r["device"])
        want = earlier if r["run"] in record["earlier_training_summary"] else summary
        assert set(r["train_diffusion"]) == set(r["train_denoising"]) == want, r["run"]
        assert plg.check(r) == r["missed"] == [] and r["passed"], r["run"]
        assert r["kld_improvement"] == pytest.approx(
            r["kld_untrained"]["kld_symmetric"] / r["kld_trained"]["kld_symmetric"])
        assert r["psnr_gain"] == pytest.approx(r["psnr_denoised"] - r["psnr_noisy_input"])
