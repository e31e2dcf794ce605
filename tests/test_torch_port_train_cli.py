"""The port's training CLI end to end on the CPU (`--device cpu`), on a
miniature SID tree: NoiseDiffNet dim 8 at crop 64, 3 epochs of 6 steps.
The snapshots are written in the reference's format; --resume auto after
epoch 0 ends on the same parameters as the uninterrupted run; net_final
loads through the JAX package's train/torch_import; a JAX optimizer_G
snapshot resumes in the port; and CUDA is never silently replaced by the
CPU."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.train.checkpoint import _save_npz
from noisediff_tpu_torch.cli import train_diffusion as tdc

H_BAYER, W_BAYER = 160, 192
EPOCHS, STEPS = 3, 100 // 16  # 2 pairs rebalanced to 100 samples, batch 16, drop_last


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several test workers on one CPU; torch's own
    thread pool in each of them oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sid_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train_cli") / "SID"
    (root / "Sony" / "short").mkdir(parents=True)
    (root / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in (1, 2):
        in_fn, gt_fn = f"{i:05d}_00_0.04s.ARW", f"{i:05d}_00_10s.ARW"
        for sub, fn in (("short", in_fn), ("long", gt_fn)):
            arr = rng.integers(512, 4096, size=(H_BAYER, W_BAYER)).astype(np.uint16)
            np.save(root / "Sony" / sub / (fn + ".npy"), arr)
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO800 F1.8")
    (root / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")
    return root


def _argv(tree, out, *extra):
    return [
        "--name", "train_diffusion", "--net_name", "NoiseDiffNet", "--dim", "8",
        "--crop_size", "64", "--batch_size", "16", "--max_iter", str(EPOCHS),
        "--save_epoch_freq", "1", "--beta_schedule", "sigmoid2", "--positional_encoding",
        "--with_camera_settings", "--generation_result", "noise",
        "--trainset", "SonyTrainDataset", "--sid_folder", str(tree), "--num_workers", "2",
        "--device", "cpu", "--log_freq", "3", "--save_folder", str(out), *extra,
    ]


@pytest.fixture(scope="module")
def full_run(sid_tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("run_full")
    summary = tdc.main(_argv(sid_tree, out))
    return out / "train_diffusion" / "snapshot", summary


def test_training_writes_reference_snapshots(full_run):
    snap, summary = full_run
    assert summary["steps"] == EPOCHS * STEPS == len(summary["losses"])
    assert len(summary["step_seconds"]) == summary["steps"]
    assert all(np.isfinite(summary["losses"]))
    assert set(os.listdir(snap)) == {f"{c}_{e}.pth" for c in ("net", "ema", "optimizer_G")
                                     for e in range(EPOCHS)} | {"ema_final.pth", "net_final.pth"}
    opt = torch.load(snap / f"optimizer_G_{EPOCHS - 1}.pth", weights_only=True)
    assert opt["step"] == EPOCHS * STEPS and opt["ema_step"] == EPOCHS * STEPS
    assert set(opt["optimizer"]) == {"state", "param_groups"}
    # the model moved in epoch 1; the last epoch runs at LR 0 (the
    # reference's cosine at t = max_iter, stepped per epoch)
    net0, net1, net2 = (torch.load(snap / f"net_{e}.pth", weights_only=True) for e in range(3))
    assert any(not torch.equal(net0[k], net1[k]) for k in net1)
    assert all(torch.equal(net1[k], net2[k]) for k in net1)


def test_resume_auto_continues_the_run(full_run, sid_tree, tmp_path):
    """A run cut after epoch 0 and resumed with --resume auto ends on the
    uninterrupted run's net and EMA."""
    snap, _ = full_run
    cut = tmp_path / "train_diffusion" / "snapshot"
    cut.mkdir(parents=True)
    for c in ("net", "ema", "optimizer_G"):
        shutil.copy(snap / f"{c}_0.pth", cut / f"{c}_0.pth")
    summary = tdc.main(_argv(sid_tree, tmp_path, "--resume", "auto"))
    assert summary["steps"] == (EPOCHS - 1) * STEPS  # from epoch 1
    for c in ("net", "ema"):
        want = torch.load(snap / f"{c}_final.pth", weights_only=True)
        got = torch.load(cut / f"{c}_final.pth", weights_only=True)
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=f"{c} {k}")


def test_net_final_loads_into_the_jax_model(full_run):
    from noisediff_tpu.models import NoiseDiffNet as JaxNet
    from noisediff_tpu.train.torch_import import import_torch_params, load_torch_state_dict

    snap, _ = full_run
    x = jnp.zeros((1, 16, 16, 4))
    cond = {"clean_img": x, "position": jnp.zeros((1, 16, 16, 2)),
            "iso_ratio_idx": jnp.zeros((1,), jnp.int32)}
    shapes = jax.eval_shape(JaxNet(dim=8).init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,), jnp.int32), cond)["params"]
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = load_torch_state_dict(str(snap / "net_final.pth"))
    params = import_torch_params(like, sd, strict=True)
    assert len(jax.tree.leaves(params)) == len(sd)
    assert any(np.any(np.asarray(p)) for p in jax.tree.leaves(params))


def test_jax_optimizer_snapshot_resumes_in_the_port(full_run, sid_tree, tmp_path):
    """--resume_optim takes a JAX optimizer_G .npz: the moments land on the
    port's parameters through the weight bridge, with its counters."""
    from noisediff_tpu.models import NoiseDiffNet as JaxNet
    from noisediff_tpu.train.state import make_optimizer
    from noisediff_tpu_torch.train.trainer_diffusion import Trainer
    from noisediff_tpu_torch.weights import jax_params_to_state_dict

    x = jnp.zeros((1, 64, 64, 4))
    cond = {"clean_img": x, "position": jnp.zeros((1, 64, 64, 2)),
            "iso_ratio_idx": jnp.zeros((1,), jnp.int32)}
    shapes = jax.eval_shape(JaxNet(dim=8).init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,), jnp.int32), cond)["params"]
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    tx = make_optimizer()
    state = tx.init(params)
    mu = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    adam = state.inner_state[0]._replace(count=jnp.asarray(9, jnp.int32), mu=mu, nu=mu)
    state = state._replace(inner_state=(adam,) + tuple(state.inner_state[1:]))
    path = str(tmp_path / "optimizer_G_4")
    _save_npz(path, {"opt_state": state, "step": np.int32(40), "ema_step": np.int32(40)})

    args = tdc.build_parser().parse_args(_argv(sid_tree, tmp_path, "--resume_optim",
                                               path + ".npz"))
    tdc.setup_run_dirs(args, with_logger=False)
    trainer = Trainer(args)
    assert trainer.step == 40 and trainer.ema.calls == 40
    want = jax_params_to_state_dict(mu)
    st = trainer.optimizer.state_dict()["state"]
    for i, (name, _) in enumerate(trainer.model.named_parameters()):
        assert float(st[i]["step"]) == 9.0
        torch.testing.assert_close(st[i]["exp_avg"], want[name], rtol=0, atol=0)


# the cases keep the ids they had when these options raised
@pytest.mark.parametrize("extra", [["--remat"], ["--launcher", "pytorch"]],
                         ids=["extra0-NotImplementedError", "extra1-NotImplementedError"])
def test_unported_options_name_the_roadmap(full_run, sid_tree, tmp_path, monkeypatch, extra):
    """--remat (the ResnetBlocks recomputed in the backward) and --launcher
    pytorch without a launcher's WORLD_SIZE (one process, rank -1) train:
    their losses equal the default run's, bit for bit."""
    _, want = full_run
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    summary = tdc.main(_argv(sid_tree, tmp_path, *extra))
    assert summary["steps"] == EPOCHS * STEPS
    assert summary["losses"] == want["losses"]
    assert os.path.exists(tmp_path / "train_diffusion" / "snapshot" / "net_final.pth")


def test_cuda_request_never_falls_back(sid_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(sid_tree, tmp_path)
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tdc.main(argv)
    argv.remove("--device")
    argv.remove("cuda")  # the default is the card, too
    with pytest.raises(RuntimeError, match="cuda"):
        tdc.main(argv)
