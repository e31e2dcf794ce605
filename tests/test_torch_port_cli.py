"""The port's generation CLI end to end on the CPU (`--device cpu`), on a
miniature SID tree: the npy contract (CHW float32, deterministic names,
no temp files), the sampler dispatch, --skip_existing (no device work for
a complete batch; a deleted patch comes back identical), the weight
formats --resume takes, and that CUDA is never silently replaced by the
CPU."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.train.checkpoint import _save_npz
from noisediff_tpu_torch.cli import test_diffusion as td
from noisediff_tpu_torch.models import NoiseDiffNet
from noisediff_tpu_torch.train import trainer_diffusion

H_BAYER, W_BAYER = 64, 96


@pytest.fixture(scope="module")
def sid_tree(tmp_path_factory):
    """The tree tests/test_e2e.py builds: 2 ISO800 training pairs, 7 clean frames."""
    tmp_path = tmp_path_factory.mktemp("port_e2e")
    root = tmp_path / "SID"
    (root / "Sony" / "short").mkdir(parents=True)
    (root / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for in_fn, gt_fn in (("00001_00_0.04s.ARW", "00001_00_10s.ARW"),
                         ("00002_00_0.04s.ARW", "00002_00_10s.ARW")):
        for sub, fn in (("short", in_fn), ("long", gt_fn)):
            arr = rng.integers(512, 4096, size=(H_BAYER, W_BAYER)).astype(np.uint16)
            np.save(root / "Sony" / sub / (fn + ".npy"), arr)
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO800 F1.8")
    for i in range(3, 8):
        arr = rng.integers(512, 4096, size=(H_BAYER, W_BAYER)).astype(np.uint16)
        np.save(root / "Sony" / "long" / f"{i:05d}_00_10s.ARW.npy", arr)
    (root / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")
    torch.manual_seed(0)
    torch.save(NoiseDiffNet(dim=16).state_dict(), tmp_path / "net.pth")
    return tmp_path


def _argv(tree, out, *extra):
    return [
        "--name", "ISO800_Ratio250", "--testset", "NoiseImageGenerationDataset",
        "--net_name", "NoiseDiffNet", "--beta_schedule", "sigmoid2", "--positional_encoding",
        "--with_camera_settings", "--save_npy", "--dim", "16", "--crop_size", "16",
        "--batch_size", "4", "--diffusion_steps", "8", "--iso", "800", "--ratio", "250",
        "--sid_folder", str(tree / "SID"), "--pretrained_dir", str(tree),
        "--num_workers", "1", "--device", "cpu", "--resume", str(tree / "net.pth"),
        "--save_folder", str(tree / out), *extra,
    ]


@pytest.mark.parametrize("sampler,extra", [
    ("dpm", ["--sampling_timesteps", "3", "--no_mixed_precision"]),
    ("ddim", ["--sampling_timesteps", "2", "--no_mixed_precision"]),
    ("ddpm", []),  # full T=8 ancestral steps, bf16 compute
])
def test_generation_npy_contract(sid_tree, sampler, extra):
    summary = td.main(_argv(sid_tree, f"gen_{sampler}", "--sampler", sampler, *extra))
    out_dir = sid_tree / f"gen_{sampler}" / "ISO800_Ratio250" / "npy" / "generated"
    files = sorted(glob.glob(str(out_dir / "*.npy")))
    assert summary["generated"] == len(files) > 4  # more than one batch, the last short
    assert not glob.glob(str(out_dir / "*.tmp.npy"))
    for p in files:
        clean, noisy, coord = os.path.basename(p)[:-4].split("+")
        assert clean == noisy and clean.endswith("_00_10s")
        x, y = (int(v) for v in coord.split("_"))
        arr = np.load(p)
        assert arr.shape == (4, 16, 16) and arr.dtype == np.float32 and np.isfinite(arr).all()


def test_skip_existing_makes_no_device_call(sid_tree, monkeypatch):
    argv = _argv(sid_tree, "gen_skip", "--sampler", "dpm", "--sampling_timesteps", "2",
                 "--no_mixed_precision", "--skip_existing")
    first = td.main(argv)
    out_dir = first["out_dir"]
    files = sorted(glob.glob(os.path.join(out_dir, "*.npy")))
    before = {p: np.load(p) for p in files}
    stamp = 946684800_000_000_000
    for p in files:
        os.utime(p, ns=(stamp, stamp))

    calls = []
    real = trainer_diffusion.Trainer.sampler

    def counting(self, bs):
        fn = real(self, bs)
        return lambda *a: (calls.append(1), fn(*a))[1]

    monkeypatch.setattr(trainer_diffusion.Trainer, "sampler", counting)
    again = td.main(argv)
    assert calls == [] and again["generated"] == 0 and again["skipped"] == len(files)
    assert all(os.stat(p).st_mtime_ns == stamp for p in files)

    os.remove(files[0])
    third = td.main(argv)
    assert len(calls) == 1 and third["generated"] == 4
    np.testing.assert_array_equal(np.load(files[0]), before[files[0]])


def test_resume_formats_load_the_same_weights(sid_tree, tmp_path):
    """--resume takes a (DDP-prefixed) .pth and a JAX .npz snapshot; both
    give the same model."""
    from noisediff_tpu.models import NoiseDiffNet as JaxNet
    from noisediff_tpu_torch.weights import load_state_dict_file

    from torch_port_util import random_params

    x = jnp.zeros((1, 16, 16, 4))
    cond = {"clean_img": x, "position": jnp.zeros((1, 16, 16, 2)),
            "iso_ratio_idx": jnp.zeros((1,), jnp.int32)}
    params = random_params(JaxNet(dim=16), x, jnp.zeros((1,), jnp.int32), cond, seed=7)
    _save_npz(str(tmp_path / "net_3"), {"params": params})
    from_npz = load_state_dict_file(str(tmp_path / "net_3.npz"))
    torch.save({"module." + k: v for k, v in from_npz.items()}, tmp_path / "net.pth")
    from_pth = load_state_dict_file(str(tmp_path / "net.pth"))
    assert from_npz.keys() == from_pth.keys()
    for k in from_npz:
        assert torch.equal(from_npz[k], from_pth[k]), k
    NoiseDiffNet(dim=16).load_state_dict(from_npz, strict=True)
    assert len(jax.tree_util.tree_leaves(params)) == len(from_npz)


def test_cuda_request_never_falls_back(sid_tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(sid_tree, "gen_cuda", "--sampler", "dpm")
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        td.main(argv)


def test_unported_networks_name_the_roadmap():
    """Every --net_name of the JAX registry builds (the UNet_PosEmbV2
    family among them); an unknown name raises ValueError."""
    from types import SimpleNamespace

    from noisediff_tpu_torch.models import PosEmbUNet, define_network

    cfg = SimpleNamespace(dim=8, inp_dim=4, cond_dim=4)
    for name in ("UNet_PosEmbV2", "UNet_PosEmbV2_NoPosition", "UNet_PosEmbV2_CameraCond"):
        net = define_network(name, cfg)
        assert isinstance(net, PosEmbUNet) and net.dim == 8
    with pytest.raises(ValueError, match="UNetAttn is not found"):
        define_network("UNetAttn", cfg)
