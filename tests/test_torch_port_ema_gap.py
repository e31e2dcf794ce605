"""The EMA-gap ladder's scales, harness and record.

The port gate's `horizon` scale (scripts/port_learning_gate.py) is its gpu
scale at another width and crop only; the JAX gate's SCALES are as they
were; tests/torch_port_ema_spread.py at its default scale trains with the
argv it always did; EMA_GAP.json parses and every entry holds the ladder's
keys, scored through the samplers the gate runs; the port's EMA equals
the JAX package's over the gpu-scale gate's 4,800 calls.
"""
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import learning_gate as lg  # noqa: E402
import port_ema_gap_record as rec  # noqa: E402
import port_learning_gate as plg  # noqa: E402
import torch_port_ema_spread as spread  # noqa: E402

# scripts/learning_gate.py SCALES, written out
JAX_SCALES = {
    "tiny": dict(fh=96, fw=128, n_train=4, n_test=2, dim=16, crop=16, epochs=160, batch=8,
                 T=64, ddim=16, dpm=0, dpm_spacing="time", lr=3e-4, lsid_width=8,
                 den_epochs=60, den_lr=1e-3, den_crop=16, gen_batch=16),
    "small": dict(fh=192, fw=256, n_train=6, n_test=2, dim=32, crop=32, epochs=80, batch=8,
                  T=256, ddim=25, dpm=10, dpm_spacing="lambda", lr=3e-4, lsid_width=8,
                  den_epochs=30, den_lr=1e-3, den_crop=32, gen_batch=16),
    "tpu": dict(fh=512, fw=768, n_train=8, n_test=3, dim=48, crop=64, epochs=800, batch=16,
                T=1000, ddim=50, dpm=10, dpm_spacing="lambda", lr=2e-4, lsid_width=16,
                den_epochs=150, den_lr=5e-4, den_crop=64, gen_batch=32),
}


def test_jax_gate_scales_are_unaltered():
    assert lg.SCALES == JAX_SCALES


def test_horizon_is_gpu_at_dim_16_and_crop_32():
    """Only the width, the crop and LSID's crop (it crops the generated
    patches, so it follows their crop) differ from gpu: the frames, 4,800
    steps of batch 16, T 1000, the learning rate and the samplers are
    gpu's."""
    gpu, horizon = plg.SCALES["gpu"], plg.SCALES["horizon"]
    assert set(horizon) == set(gpu)
    assert {k: v for k, v in horizon.items() if gpu[k] != v} == dict(dim=16, crop=32,
                                                                      den_crop=32)
    steps = horizon["epochs"] * (100 // horizon["n_train"] * horizon["n_train"]
                                 // horizon["batch"])
    assert steps == 4800


def _todays_train_argv(side, cfg, workdir, sid, run_seed, freq):
    """The harness's training argv as it was before it took --scale."""
    argv = plg.train_diffusion_argv(cfg, workdir, sid, "cpu")
    argv[argv.index("--save_epoch_freq") + 1] = str(freq)
    folder = os.path.join(workdir, side, "weights")
    argv[argv.index("--save_folder") + 1] = folder
    argv += ["--random_seed", str(run_seed)]
    if side != "port":
        i = argv.index("--device")
        del argv[i:i + 2]
    return argv


@pytest.mark.parametrize("side", ["port", "jax"])
def test_spread_harness_tiny_argv_is_todays(side, tmp_path):
    args = spread.build_parser().parse_args(["--workdir", str(tmp_path)])
    assert (args.scale, args.score_with, args.sides, args.final_only, args.weights) == (
        "tiny", "port", "port,jax", False, [])
    cfg = dict(plg.SCALES[args.scale])
    sid = os.path.join(str(tmp_path), "SID")
    got = spread.train_argv(side, cfg, str(tmp_path), sid, args.run_seed, args.freq)
    assert got == _todays_train_argv(side, cfg, str(tmp_path), sid, 0, 20)
    assert spread.samplers(cfg) == [("ddim16", None, 16, None)]


def test_spread_harness_scores_the_gates_samplers_at_horizon():
    assert spread.samplers(plg.SCALES["horizon"]) == [
        ("ddim50", None, 50, None), ("dpm10", "dpm", 10, "lambda")]


def test_ema_gap_record_has_every_key():
    with open(os.path.join(REPO, "EMA_GAP.json")) as f:
        record = json.load(f)
    entries = record["entries"]
    assert entries and len({e["run"] for e in entries}) == len(entries)
    for e in entries:
        assert set(rec.ENTRY_KEYS) <= set(e), e["run"]
        assert e["package"] in ("port", "jax") and e["precision"] in ("bf16", "fp32")
        # the ladder's other candidates ran as horizon with --set dim / crop
        scale = plg.SCALES[e["scale"]]
        assert set(e["config"]) == set(scale), e["run"]
        assert {k for k in scale if e["config"][k] != scale[k]} <= {"dim", "crop"}, e["run"]
        if e["device"] == "cpu":
            assert e["card"] is None and e["precision"] == "fp32"
        else:
            assert e["card"].startswith(e["device"]) and e["card"].endswith(" W")
        cfg = e["config"]
        wanted = {f"ddim{cfg['ddim']}", f"dpm{cfg['dpm']}"}
        assert set(e["scores"]) == set(rec.WEIGHTS), e["run"]
        for weights, by in e["scores"].items():
            assert "port" in by and set(by) <= {"port", "port_cpu", "jax"}, e["run"]
            if e["device"] == "cpu":
                assert set(by) == {"port", "jax"}, e["run"]
            for scorer, samples in by.items():
                assert wanted <= set(samples), (e["run"], weights, scorer)
                for s in samples.values():
                    assert set(rec.SCORE_KEYS) <= set(s)
                    assert s["kld"] > 0 and 0 < s["std"] < 1 and s["seconds"] > 0
        assert e["train_seconds"] > 0



def test_host_ema_matches_jax_over_the_gpu_gates_calls():
    """The gpu-scale gate's 4,800 calls (an update every 20th: copies up
    to call 500, then 214 lerps whose decay ramps to beta 0.995 past call
    3,330) of a drifting parameter sequence: the port's HostEma against
    the JAX HostEma's."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from noisediff_tpu.train import ema as jax_ema
    from noisediff_tpu.train.state import TrainState
    from noisediff_tpu_torch.train import ema as port_ema

    gpu = plg.SCALES["gpu"]
    calls = gpu["epochs"] * (100 // gpu["n_train"] * gpu["n_train"] // gpu["batch"])
    rng = np.random.default_rng(2)
    base = {"a": rng.standard_normal((16, 3, 3, 4)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}

    def online(k):
        return {n: (v + np.float32(1e-3 * k) * np.sin(v * (k + 1))).astype(np.float32)
                for n, v in base.items()}

    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, base),
                        opt_state=None, ema=jax_ema.EmaState.create(
                            jax.tree.map(jnp.asarray, base)))
    jhost = jax_ema.HostEma()
    live = {n: torch.from_numpy(v.copy()) for n, v in base.items()}
    phost = port_ema.HostEma(live.items())
    applied = []
    for k in range(calls):
        new = online(k)
        jstate = jhost.maybe_apply(jstate.replace(params=jax.tree.map(jnp.asarray, new),
                                                  ema=jstate.ema.replace(step=jstate.ema.step + 1)))
        for n in live:
            live[n].copy_(torch.from_numpy(new[n]))
        if phost.maybe_apply(live.values()):
            applied.append(k)
    assert calls == 4800 and applied == list(range(0, calls, 20)) and phost.calls == calls
    lerps = [k for k in applied if port_ema.ema_decay(k) > 0]
    assert len(lerps) == 214 and port_ema.ema_decay(lerps[-1]) == pytest.approx(0.995)
    for k in (lerps[0], 3320, 3340, lerps[-1]):
        assert port_ema.ema_decay(k) == pytest.approx(
            float(jax_ema.ema_decay(jnp.asarray(k))), rel=1e-7)
    for n, v in phost.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.ema.params[n]), rtol=1e-6,
                                   atol=1e-7)
