"""The port's denoiser training on the CPU: one `make_denoising_train_step`
step against the JAX step on the same weights and batch (flip and SNA off:
the losses, grad_norm and the parameters after one Adam step, with and
without weight decay), the flip's axis, and the CLI end to end: the port's
generation CLI writes `.npy` noise, `python -m
noisediff_tpu_torch.cli.train_denoising --device cpu` trains LSID on it
(SNA, dark shading, --use_tb_logger), --resume auto continues the run
exactly, every trainset trains, a JAX optimizer snapshot resumes, and
CUDA is never silently replaced by the CPU.

Tolerance of the step: rtol 5e-4 / atol 5e-5 (PARITY.md:152) on the
losses, grad_norm and parameters; the Adam update itself (about lr per
element in the first step) within 2% of lr."""
import glob
import json
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.models.lsid import LSID as JaxLSID
from noisediff_tpu.train import state as jstate
from noisediff_tpu.train.checkpoint import _save_npz
from noisediff_tpu_torch.cli import test_diffusion as td
from noisediff_tpu_torch.cli import train_denoising as tdn
from noisediff_tpu_torch.models import LSID, NoiseDiffNet
from noisediff_tpu_torch.train.state import make_denoising_train_step, make_optimizer
from noisediff_tpu_torch.weights import jax_params_to_state_dict
from torch_port_util import ATOL, RTOL, load_port, random_params

H_BAYER, W_BAYER = 64, 96
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU; one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0, 0.4, (b, s, s, 4)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.05, clean.shape), 0, 1).astype(np.float32)
    return {"noisy_img": noisy, "clean_img": clean, "iso": np.full(b, 800, np.int32),
            "ratio": np.full(b, 250.0, np.float32)}


def _port_step(params, batch, weight_decay=0.0, seed=0, **flags):
    model = load_port(LSID(base_width=8), params).train()
    opt = make_optimizer(model.parameters(), lr=LR, weight_decay=weight_decay)
    step = make_denoising_train_step(model, opt, **flags)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   torch.Generator().manual_seed(seed))
    return {k: float(v) for k, v in metrics.items()}, model.state_dict()


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("losses", [dict(loss_l1=True), dict(loss_l1=True, loss_mse=True,
                                                             lambda_l1=0.7, lambda_mse=1.3)])
def test_denoising_step_matches_jax(weight_decay, losses):
    model = JaxLSID(lane_fold=False, base_width=8)
    params = random_params(model, jnp.zeros((1, 32, 32, 4)), seed=2)
    batch = _batch()
    tx = jstate.make_optimizer(weight_decay)
    st = jstate.create_train_state(params, tx, with_ema=False)
    st = st.replace(opt_state=jstate.set_learning_rate(st.opt_state, LR))
    jstep = jstate.make_denoising_train_step(
        lambda p, x: model.apply({"params": p}, x), tx, augment_flip=False, use_sna=False,
        donate=False, **{"loss_mse": False, **losses})
    st2, want = jstep(st, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    got, sd = _port_step(params, batch, weight_decay, augment_flip=False, use_sna=False,
                         **losses)
    assert got.keys() == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=RTOL), k
    before, after = jax_params_to_state_dict(params), jax_params_to_state_dict(st2.params)
    assert sd.keys() == after.keys()
    for k in after:
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        np.testing.assert_allclose((sd[k] - before[k]).numpy(), (after[k] - before[k]).numpy(),
                                   rtol=0, atol=0.02 * LR, err_msg=k)


def test_flip_is_along_height():
    """A step that draws the flip equals the unflipped step on the batch
    flipped along H (NHWC dim 1, the reference's NCHW dim 2), not along W."""
    params = random_params(JaxLSID(lane_fold=False, base_width=8), jnp.zeros((1, 32, 32, 4)),
                           seed=4)
    batch = _batch(seed=1)
    draws = {s: bool(torch.rand((), generator=torch.Generator().manual_seed(s)) < 0.5)
             for s in range(8)}
    flipped, kept = [s for s, d in draws.items() if d][0], [s for s, d in draws.items() if not d][0]

    def flip(axis):
        return {k: (v[:, ::-1] if axis == 1 else v[:, :, ::-1]).copy() if v.ndim == 4 else v
                for k, v in batch.items()}

    on, sd_on = _port_step(params, batch, seed=flipped)
    want, sd_want = _port_step(params, flip(1), augment_flip=False)
    assert on == want
    assert all(torch.equal(sd_on[k], sd_want[k]) for k in sd_want)
    assert _port_step(params, batch, seed=kept)[0] == _port_step(params, batch,
                                                                 augment_flip=False)[0]
    assert _port_step(params, flip(2), augment_flip=False)[0]["l1_loss"] != on["l1_loss"]


def test_step_with_sna_reads_iso_and_ratio():
    """SNA on: the step runs on the generator's draws and is reproducible
    from its seed; a batch without gains would leave the losses as they
    were without SNA."""
    params = random_params(JaxLSID(lane_fold=False, base_width=8), jnp.zeros((1, 32, 32, 4)),
                           seed=5)
    batch = _batch(seed=2)
    a = _port_step(params, batch, seed=3, use_sna=True)[0]
    assert a == _port_step(params, batch, seed=3, use_sna=True)[0]
    assert all(np.isfinite(v) for v in a.values())
    losses = {_port_step(params, batch, seed=s, use_sna=True, augment_flip=False)[0]["l1_loss"]
              for s in range(6)}
    assert len(losses) > 1


# ---------------------------------------------------------------------------
# the CLI end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The tree of tests/test_e2e.py (2 ISO800 x250 pairs, 7 clean frames),
    noise patches from the port's generation CLI linked into
    <synthetic>/ISO800_Ratio250, the PMN resources at the Bayer frame size
    and a noise profile."""
    root = tmp_path_factory.mktemp("port_denoise_cli")
    sid = root / "SID"
    (sid / "Sony" / "short").mkdir(parents=True)
    (sid / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in (1, 2):
        in_fn, gt_fn = f"{i:05d}_00_0.04s.ARW", f"{i:05d}_00_10s.ARW"
        for sub, fn in (("short", in_fn), ("long", gt_fn)):
            arr = rng.integers(512, 4096, size=(H_BAYER, W_BAYER)).astype(np.uint16)
            np.save(sid / "Sony" / sub / (fn + ".npy"), arr)
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO800 F1.8")
    for i in range(3, 8):
        arr = rng.integers(512, 4096, size=(H_BAYER, W_BAYER)).astype(np.uint16)
        np.save(sid / "Sony" / "long" / f"{i:05d}_00_10s.ARW.npy", arr)
    (sid / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")
    res = root / "resources"
    res.mkdir()
    for band in ("low", "high"):
        np.save(res / f"darkshading_{band}ISO_k.npy",
                rng.normal(0, 1e-3, (H_BAYER, W_BAYER)).astype(np.float32))
        np.save(res / f"darkshading_{band}ISO_b.npy",
                rng.normal(0, 2.0, (H_BAYER, W_BAYER)).astype(np.float32))
    with open(res / "darkshading_BLE.pkl", "wb") as f:
        pickle.dump({800: 0.5}, f)
    with open(root / "noise_profile_all.pkl", "wb") as f:
        pickle.dump({800: (0.77, 3.5)}, f)

    torch.manual_seed(0)
    torch.save(NoiseDiffNet(dim=16).state_dict(), root / "net.pth")
    gen = td.main([
        "--name", "ISO800_Ratio250", "--testset", "NoiseImageGenerationDataset",
        "--net_name", "NoiseDiffNet", "--beta_schedule", "sigmoid2", "--positional_encoding",
        "--with_camera_settings", "--save_npy", "--dim", "16", "--crop_size", "16",
        "--batch_size", "12", "--diffusion_steps", "8", "--iso", "800", "--ratio", "250",
        "--sampler", "dpm", "--sampling_timesteps", "2", "--no_mixed_precision",
        "--sid_folder", str(sid), "--pretrained_dir", str(root), "--num_workers", "1",
        "--device", "cpu", "--resume", str(root / "net.pth"), "--save_folder", str(root / "gen"),
    ])
    synth = root / "synthetic" / "ISO800_Ratio250"
    synth.mkdir(parents=True)
    for p in glob.glob(os.path.join(gen["out_dir"], "*.npy")):
        os.link(p, synth / os.path.basename(p))
    return root, gen["generated"]


def _argv(root, out, *extra):
    return [
        "--name", "train_denoising", "--net_name", "LSID", "--loss_l1", "--use_sna",
        "--sub_darkshading", "--use_tb_logger", "--trainset", "SyntheticNoisDiffDenoisingDataset",
        "--crop_size", "16", "--batch_size", "12", "--max_iter", "3", "--save_epoch_freq", "1",
        "--log_freq", "3", "--vis_step_freq", "4", "--sid_folder", str(root / "SID"),
        "--synthetic_folder", str(root / "synthetic"), "--resources_path",
        str(root / "resources"), "--pretrained_dir", str(root), "--num_workers", "2",
        "--device", "cpu", "--save_folder", str(root / out / "weights"), *extra,
    ]


@pytest.fixture(scope="module")
def full_run(pipeline):
    root, n = pipeline
    summary = tdn.main(_argv(root, "full"))
    return root, n, root / "full" / "weights" / "train_denoising", summary


def test_cli_trains_lsid_on_generated_noise(full_run):
    root, n, run, summary = full_run
    steps = 3 * (n // 12)
    assert n == 84 and summary["steps"] == steps == len(summary["losses"])
    assert len(summary["step_seconds"]) == len(summary["step_end_seconds"]) == steps
    assert all(np.isfinite(summary["losses"]))
    snap = run / "snapshot"
    assert set(os.listdir(snap)) == {f"{c}_{e}.pth" for c in ("net", "optimizer_G")
                                     for e in range(3)} | {"net_final.pth"}
    assert torch.load(snap / "optimizer_G_2.pth", weights_only=True)["step"] == steps
    net = LSID()
    net.load_state_dict(torch.load(snap / "net_final.pth", weights_only=True), strict=True)
    net0 = torch.load(snap / "net_0.pth", weights_only=True)
    assert any(not torch.equal(net0[k], v) for k, v in net.state_dict().items())
    assert os.path.exists(run / "vis" / "vis_0.jpg")
    rows = [json.loads(line) for line in open(
        root / "full" / "tb_logger" / "train_denoising" / "scalars.jsonl")]
    assert [(r["tag"], r["step"]) for r in rows] == [("l1_loss", s) for s in range(0, steps, 4)]
    assert all(np.isfinite(r["value"]) for r in rows)


def test_resume_auto_continues_the_run(full_run):
    """A run cut after epoch 0 and resumed with --resume auto starts at
    epoch 1 and ends on the uninterrupted run's weights, bit for bit: the
    step counter carries the augmentation stream."""
    root, n, run, _ = full_run
    cut = root / "cut" / "weights" / "train_denoising" / "snapshot"
    cut.mkdir(parents=True)
    for c in ("net", "optimizer_G"):
        shutil.copy(run / "snapshot" / f"{c}_0.pth", cut / f"{c}_0.pth")
    summary = tdn.main(_argv(root, "cut", "--resume", "auto"))
    assert summary["steps"] == 2 * (n // 12)
    want = torch.load(run / "snapshot" / "net_final.pth", weights_only=True)
    got = torch.load(cut / "net_final.pth", weights_only=True)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("trainset,extra", [
    ("RealSonyDenoisingDataset", ["--sub_darkshading"]),
    ("PossionGaussianDenoisingDataset", []),  # no iso or ratio: zeros, SNA off
])
def test_cli_trains_on_each_trainset(pipeline, trainset, extra):
    root, _ = pipeline
    argv = _argv(root, trainset, "--trainset", trainset, "--batch_size", "2", "--max_iter", "2",
                 "--lsid_width", "8", "--loss_mse", *extra)
    argv.remove("--use_sna")
    summary = tdn.main(argv)
    assert summary["steps"] == 2 and all(np.isfinite(summary["losses"]))


def test_jax_optimizer_snapshot_resumes(pipeline, tmp_path):
    """--resume_optim takes a JAX optimizer_G .npz: the Adam moments land
    on the port's parameters through the weight bridge (the up layers'
    flip included), with the step."""
    from noisediff_tpu_torch.train.trainer_denoising import Trainer

    root, _ = pipeline
    params = random_params(JaxLSID(lane_fold=False, base_width=8), jnp.zeros((1, 16, 16, 4)),
                           seed=6)
    tx = jstate.make_optimizer()
    opt_state = tx.init(params)
    rng = np.random.default_rng(7)
    mu = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    nu = jax.tree.map(lambda p: rng.uniform(0, 1, p.shape).astype(np.float32), params)
    adam = opt_state.inner_state[0]._replace(count=jnp.asarray(5, jnp.int32), mu=mu, nu=nu)
    opt_state = opt_state._replace(inner_state=(adam,) + tuple(opt_state.inner_state[1:]))
    path = str(tmp_path / "optimizer_G_3")
    _save_npz(path, {"opt_state": opt_state, "step": np.int32(30)})

    args = tdn.build_parser().parse_args(_argv(root, "optim", "--lsid_width", "8",
                                               "--resume_optim", path + ".npz"))
    tdn.setup_run_dirs(args, with_logger=False)
    trainer = Trainer(args)
    assert trainer.step == 30
    want_mu, want_nu = jax_params_to_state_dict(mu), jax_params_to_state_dict(nu)
    state = trainer.optimizer.state_dict()["state"]
    for i, (name, _) in enumerate(trainer.model.named_parameters()):
        torch.testing.assert_close(state[i]["exp_avg"], want_mu[name], rtol=0, atol=0)
        torch.testing.assert_close(state[i]["exp_avg_sq"], want_nu[name], rtol=0, atol=0)
        assert float(state[i]["step"]) == 5


def test_cli_defaults_to_the_card_and_raises_without_one(pipeline, monkeypatch):
    root, _ = pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(root, "nocard")
    i = argv.index("--device")
    del argv[i:i + 2]
    assert tdn.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tdn.main(argv)


# the cases keep the ids they had when these launchers raised
@pytest.mark.parametrize("argv", [["--launcher", "jax"], ["--launcher", "pytorch"]],
                         ids=["argv0-NotImplementedError", "argv1-NotImplementedError"])
def test_cli_refuses_what_is_not_ported(full_run, monkeypatch, argv):
    """--launcher jax and pytorch (aliases) without a launcher's WORLD_SIZE
    train as one process, rank -1: the first epoch's losses equal the
    default run's, bit for bit, and rank 0's snapshots are written."""
    root, n, _, want = full_run
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = "launcher_" + argv[1]
    summary = tdn.main(_argv(root, out, *argv, "--max_iter", "1"))
    assert summary["steps"] == n // 12
    assert summary["losses"] == want["losses"][:n // 12]
    assert (root / out / "weights" / "train_denoising" / "snapshot" / "net_final.pth").exists()
