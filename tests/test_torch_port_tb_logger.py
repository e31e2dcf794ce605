"""`--use_tb_logger` of the port's training CLI against the JAX package's,
on the CPU: both write `scalars.jsonl` under the save folder with `weights`
replaced by `tb_logger`, with the same (tag, step) pairs at the same
--vis_step_freq, the same learning rates, and losses of one model on one
miniature SID tree (NoiseDiffNet dim 8 at crop 64, fp32, one epoch of 6
steps).

The two frameworks draw their initial weights, timesteps and noise from
different generators, so the losses agree in size, not value: each side's
mean within a factor of 2 of the other's (at initialisation both are the
pred_v loss of an untrained net, ~0.5-1.5)."""
import json
import os

import numpy as np
import pytest
import torch

from noisediff_tpu.cli import train_diffusion as jax_cli
from noisediff_tpu_torch.cli import train_diffusion as port_cli

H_BAYER, W_BAYER = 160, 192
STEPS = 100 // 16  # 2 pairs rebalanced to 100 samples, batch 16, drop_last
VIS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sid_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tb_tree") / "SID"
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


def _argv(tree, out):
    return [
        "--name", "train_diffusion", "--net_name", "NoiseDiffNet", "--dim", "8",
        "--crop_size", "64", "--batch_size", "16", "--max_iter", "1", "--save_epoch_freq", "1",
        "--beta_schedule", "sigmoid2", "--positional_encoding", "--with_camera_settings",
        "--generation_result", "noise", "--trainset", "SonyTrainDataset",
        "--sid_folder", str(tree), "--num_workers", "2", "--no_mixed_precision",
        "--use_tb_logger", "--vis_step_freq", str(VIS), "--save_folder", str(out / "weights"),
    ]


def _scalars(out):
    path = out / "tb_logger" / "train_diffusion" / "scalars.jsonl"
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_tb_logger_matches_the_jax_trainer(sid_tree, tmp_path):
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    port_cli.main(_argv(sid_tree, port_out) + ["--device", "cpu"])
    jax_cli.main(_argv(sid_tree, jax_out))
    got, want = _scalars(port_out), _scalars(jax_out)
    assert {"tag", "value", "step", "t"} <= set(got[0])
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert [r["step"] for r in got if r["tag"] == "lr"] == list(range(0, STEPS, VIS))
    for g, w in zip(got, want):
        if g["tag"] == "lr":
            assert g["value"] == pytest.approx(w["value"], rel=1e-6)
    losses = [np.array([r["value"] for r in rows if r["tag"] == "diffusion_loss"])
              for rows in (got, want)]
    assert all(np.isfinite(v).all() and (v > 0).all() for v in losses)
    ratio = losses[0].mean() / losses[1].mean()
    assert 0.5 < ratio < 2.0, losses
    # tensorboardX mirrors the stream where it imports
    assert any(n.startswith("events.out.tfevents")
               for n in os.listdir(port_out / "tb_logger" / "train_diffusion"))
