"""The port's LSID evaluation half against the JAX package's, on the CPU:
the test_denoising CLI's `evaluate`, the eval_kld CLI, the manifest's ISO /
ratio and ELD helpers, the raw_host tail (rawpy and exifread stubbed, as
tests/test_raw_host_tail.py stubs them), the denoising trainer's --phase
test, and --device cuda refusing to run without a card.

`evaluate` runs on the same miniature trees with the same LSID weights
(seeded numpy parameters, a JAX `.npz` snapshot read by both CLIs): SID
through the ELD list join, with and without the dark shading (float64
resources, as the JAX package turns them into float32) and the
illuminance correction; the whole SID test list where the ELD lists are
absent, at a frame size that is not a multiple of 16; ELD at ratios 100
and 200 with `.meta.json` sidecars, built as tests/test_eld_eval.py builds
them. Each frame's PSNR within 1e-4 relative and SSIM within 1e-5
absolute of the JAX CLI's (fp32 on both sides; LSID within rtol 5e-4,
PARITY.md:152, moves them far less), and so the means; --visualize_img's
PNGs equal. The eval_kld JSON equals the JAX CLI's."""
import argparse
import json
import os
import pickle
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.cli import eval_kld as jax_kld
from noisediff_tpu.config import paths_from_args as jax_paths_from_args
from noisediff_tpu.cli import test_denoising as jax_td
from noisediff_tpu.data import manifest as jax_manifest
from noisediff_tpu.data import raw_host as jax_raw_host
from noisediff_tpu.data.datasets import DATASETS as JAX_DATASETS
from noisediff_tpu.data.loader import DataLoader as JaxLoader
from noisediff_tpu.models.lsid import LSID as JaxLSID
from noisediff_tpu.train.checkpoint import _save_npz
from noisediff_tpu_torch.cli import eval_kld, test_denoising, train_denoising
from noisediff_tpu_torch.config import paths_from_args
from noisediff_tpu_torch.data import manifest, raw_host
from test_eld_eval import _make_eld_tree
from torch_port_util import random_params

BLACK, WHITE = 512, 16383
PSNR_RTOL, SSIM_ATOL = 1e-4, 1e-5
WIDTH = 8  # LSID's level-1 width in these tests
CURRENT = re.compile(r"Current PSNR: (\S+), SSIM: (\S+)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU; one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _pair(rng, h, w, ratio):
    """(short, long) Bayer mosaics in DN: a smooth clean frame, and the
    short exposure: it over the ratio, with shot and read noise."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    clean = 0.15 + 0.6 * (0.5 + 0.5 * np.sin(3 * xx + 2 * yy)) * rng.uniform(0.7, 1.0, (h, w))
    long_dn = BLACK + clean * (WHITE - BLACK)
    lam = clean * (WHITE - BLACK) / ratio
    short = BLACK + rng.poisson(lam) + rng.normal(0, 2.0, (h, w))
    long_dn[0, :3] = WHITE  # a few saturated pixels the illuminance fit leaves out
    return (np.clip(short, 0, WHITE).astype(np.uint16),
            np.clip(long_dn, 0, WHITE).astype(np.uint16))


def _sid_tree(root, h, w, eld_lists=True, seed=0):
    """A SID tree: pairs at ISO 800 and 3200 (both dark-shading bands) and
    ratios 250 and 100, val and test lists, the ELD lists over subsets of
    them (or none), and PMN resources in float64 at the Bayer size."""
    rng = np.random.default_rng(seed)
    sid = root / "SID"
    for sub in ("short", "long"):
        (sid / "Sony" / sub).mkdir(parents=True)
    rows = {"val": [], "test": []}
    specs = [("val", 1, 800, "0.04s"), ("val", 2, 3200, "0.04s"), ("val", 3, 800, "0.1s"),
             ("test", 4, 3200, "0.04s"), ("test", 5, 800, "0.04s"), ("test", 6, 800, "0.04s")]
    for split, i, iso, expo in specs:
        in_fn, gt_fn = f"{i:05d}_00_{expo}.ARW", f"{i:05d}_00_10s.ARW"
        short, long_dn = _pair(rng, h, w, 10.0 / float(expo[:-1]))
        np.save(sid / "Sony" / "short" / (in_fn + ".npy"), short)
        np.save(sid / "Sony" / "long" / (gt_fn + ".npy"), long_dn)
        rows[split].append((f"./Sony/short/{in_fn}", f"./Sony/long/{gt_fn}", iso))
    for split, rs in rows.items():
        (sid / f"Sony_{split}_list.txt").write_text(
            "".join(f"{a} {b} ISO{iso} F1.8\n" for a, b, iso in rs))
        if eld_lists:  # every pair but one, in another order
            (sid / f"ELD_Sony_{split}.txt").write_text(
                "".join(f"{a} {b}\n" for a, b, _ in reversed(rs[1:])))
    res = root / "resources"
    res.mkdir()
    for band in ("low", "high"):
        np.save(res / f"darkshading_{band}ISO_k.npy", rng.normal(0, 1e-3, (h, w)))
        np.save(res / f"darkshading_{band}ISO_b.npy", rng.normal(0, 2.0, (h, w)))
    with open(res / "darkshading_BLE.pkl", "wb") as f:
        pickle.dump({800: 0.37, 3200: 1.3}, f)
    return sid, res


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """LSID (width 8) with seeded numpy parameters, as a JAX npz snapshot."""
    params = random_params(JaxLSID(lane_fold=False, base_width=WIDTH),
                           jnp.zeros((1, 32, 32, 4)), seed=3)
    path = str(tmp_path_factory.mktemp("lsid") / "net_final")
    _save_npz(path, params)
    return path


# ---------------------------------------------------------------------------
# evaluate against the JAX CLI
# ---------------------------------------------------------------------------

def _evaluate_both(argv, capsys, **kw):
    capsys.readouterr()
    want = jax_td.evaluate(jax_td.build_parser().parse_args(argv))
    want_frames = [(float(p), float(s)) for p, s in CURRENT.findall(capsys.readouterr().out)]
    got = test_denoising.evaluate(
        test_denoising.build_parser().parse_args(argv + ["--device", "cpu"]), **kw)
    assert got["n"] == want["n"] == len(want_frames) == len(got["frames"])
    for (p, s), f in zip(want_frames, got["frames"]):
        np.testing.assert_allclose(f["PSNR"], p, rtol=PSNR_RTOL)
        np.testing.assert_allclose(f["SSIM"], s, rtol=0, atol=SSIM_ATOL)
        assert np.isfinite([f["decode_s"], f["upload_s"], f["forward_s"],
                            f["metrics_s"]]).all()
    np.testing.assert_allclose(got["PSNR"], want["PSNR"], rtol=PSNR_RTOL)
    np.testing.assert_allclose(got["SSIM"], want["SSIM"], rtol=0, atol=SSIM_ATOL)
    return got, want


def _argv(sid, res, weights, out, *extra):
    return ["--net_name", "LSID", "--lsid_width", str(WIDTH), "--ratio", "250",
            "--sid_folder", str(sid), "--resources_path", str(res), "--resume", weights,
            "--save_folder", str(out), *extra]


@pytest.mark.parametrize("flags", [(), ("--correct_darkshading",), ("--correct_illum",),
                                   ("--correct_darkshading", "--correct_illum")])
def test_evaluate_sid_eld_lists_matches_jax(tmp_path, weights, capsys, flags):
    sid, res = _sid_tree(tmp_path, 64, 96)
    got, _ = _evaluate_both(_argv(sid, res, weights, tmp_path / "out", *flags), capsys)
    # the ELD lists name 2 + 2 pairs; the val list's x100 pair leaves at --ratio 250
    assert got["n"] == 3
    assert [os.path.basename(f["in_path"]) for f in got["frames"]] == [
        "00002_00_0.04s.ARW", "00006_00_0.04s.ARW", "00005_00_0.04s.ARW"]


def test_evaluate_sid_fallback_ragged_frame_matches_jax(tmp_path, weights, capsys):
    """No ELD lists: the whole SID test list; a 35 x 51 packed frame (not a
    multiple of 16: LSID's ceil-mode pools and cropped upsamples)."""
    sid, res = _sid_tree(tmp_path, 70, 102, eld_lists=False, seed=1)
    got, _ = _evaluate_both(_argv(sid, res, weights, tmp_path / "out", "--correct_darkshading",
                                  "--correct_illum"), capsys, keep=2)
    assert got["n"] == 3
    assert [o.shape for o in got["outputs"]] == [(35, 51, 4)] * 2
    assert all(o.dtype == np.float32 and o.min() >= 0 for o in got["outputs"])


@pytest.mark.parametrize("ratio", [100, 200])
def test_evaluate_eld_matches_jax(tmp_path, weights, capsys, ratio):
    eld = tmp_path / "ELD"
    _make_eld_tree(str(eld), ratio)
    argv = ["--net_name", "LSID", "--lsid_width", str(WIDTH), "--test_dataset", "ELD",
            "--eld_folder", str(eld), "--ratio", str(ratio), "--correct_illum",
            "--resume", weights, "--save_folder", str(tmp_path / "out")]
    got, _ = _evaluate_both(argv, capsys)
    assert got["n"] == 30


def test_visualize_img_writes_the_jax_png(tmp_path, weights, capsys):
    """rawpy is not installed: both CLIs write the R, (G1 + G2) / 2, B
    preview through PIL, byte for byte the same image."""
    from PIL import Image

    sid, res = _sid_tree(tmp_path, 64, 96, seed=2)
    argv = _argv(sid, res, weights, tmp_path / "jax", "--visualize_img")
    jax_td.evaluate(jax_td.build_parser().parse_args(argv))
    argv = _argv(sid, res, weights, tmp_path / "port", "--visualize_img", "--device", "cpu")
    test_denoising.evaluate(test_denoising.build_parser().parse_args(argv))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for n in names:
        a = np.asarray(Image.open(tmp_path / "jax" / n))
        b = np.asarray(Image.open(tmp_path / "port" / n))
        assert a.shape == b.shape == (32, 48, 3)
        # uint8 of the same fp32 outputs: at most a rounding flip apart
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_visualize_img_without_pil_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    args = test_denoising.build_parser().parse_args(["--save_folder", str(tmp_path)])
    with pytest.raises(ImportError, match="PIL"):
        test_denoising._save_visual(args, "a/00001_00_0.04s.ARW", "b.ARW",
                                    np.zeros((4, 4, 4), np.float32))


def test_visualize_img_rawpy_route(tmp_path, monkeypatch):
    """With rawpy importable and the raw file present: the output written
    into the raw buffer by raw_pattern (R, G1, B, G2 at codes 0..3), DN
    = out * (16383 - black) + black, and LibRaw's half-size postprocess."""
    seen = {}
    pattern = np.array([[0, 1], [3, 2]])

    class _Raw:
        raw_pattern = pattern
        black_level_per_channel = [512, 512, 512, 512]
        raw_image_visible = np.zeros((8, 8), np.float64)

        def postprocess(self, **kw):
            seen.update(kw)
            return np.zeros((4, 4, 3), np.uint8)

    raw = _Raw()
    monkeypatch.setitem(sys.modules, "rawpy", types.SimpleNamespace(imread=lambda p: raw))
    gt = tmp_path / "00001_00_10s.ARW"
    gt.write_bytes(b"\x00")
    out = np.random.default_rng(0).uniform(0, 1, (4, 4, 4)).astype(np.float32)
    args = test_denoising.build_parser().parse_args(["--save_folder", str(tmp_path / "v")])
    path = test_denoising._save_visual(args, "x/00001_00_0.04s.ARW", str(gt), out)
    assert os.path.basename(path) == "00001_00_0.04s_output.png" and os.path.exists(path)
    assert seen == dict(use_camera_wb=True, half_size=True, no_auto_bright=True, output_bps=8)
    dn = out * (16383 - 512) + 512
    vis = raw.raw_image_visible
    for ch, (r, c) in enumerate([(0, 0), (0, 1), (1, 1), (1, 0)]):
        np.testing.assert_allclose(vis[r::2, c::2], dn[..., ch], rtol=1e-6)


def test_test_denoising_cli_defaults_to_the_card_and_raises_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--save_folder", str(tmp_path)]
    assert test_denoising.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        test_denoising.main(argv)
    # --launcher pytorch without a launcher's WORLD_SIZE evaluates as one
    # process (rank -1), as the JAX CLI does
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    seen = {}
    monkeypatch.setattr(test_denoising, "evaluate", lambda args: seen.update(vars(args)) or {})
    assert test_denoising.main(argv + ["--launcher", "pytorch", "--device", "cpu"]) == {}
    assert (seen["dist"], seen["rank"], seen["world_size"], seen["device"]) == (False, -1, 1,
                                                                               "cpu")


def test_test_denoising_cli_main_on_the_cpu(tmp_path, weights):
    sid, res = _sid_tree(tmp_path, 64, 96, seed=4)
    got = test_denoising.main(_argv(sid, res, weights, tmp_path / "o", "--device", "cpu",
                                    "--correct_illum"))
    assert got["n"] == 3 and np.isfinite([got["PSNR"], got["SSIM"]]).all()


def test_orbax_directory_raises(tmp_path):
    (tmp_path / "net_final").mkdir()
    argv = ["--resume", str(tmp_path / "net_final"), "--device", "cpu", "--lsid_width", "8",
            "--sid_folder", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="orbax"):
        test_denoising.evaluate(test_denoising.build_parser().parse_args(argv))


# ---------------------------------------------------------------------------
# eval_kld
# ---------------------------------------------------------------------------

def test_eval_kld_json_equals_jax(tmp_path, capsys):
    sid, _ = _sid_tree(tmp_path, 64, 96, seed=5)
    lines = (sid / "Sony_val_list.txt").read_text() + (sid / "Sony_test_list.txt").read_text()
    (sid / "Sony_train_list.txt").write_text(lines)
    gen = tmp_path / "gen"
    gen.mkdir()
    rng = np.random.default_rng(6)
    for i in range(5):
        np.save(gen / f"a+b+{i}_0.npy", rng.normal(0, 0.03, (4, 16, 16)).astype(np.float32))
    argv = ["--iso", "800", "--ratio", "250", "--generated", str(gen), "--sid_folder", str(sid),
            "--max_patches", "4", "--n_bins", "200"]
    want = jax_kld.main(argv + ["--out", str(tmp_path / "jax.json")])
    capsys.readouterr()
    got = eval_kld.main(argv + ["--out", str(tmp_path / "port.json")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want == printed
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    assert got["n_real"] == 3 * 32 * 48 * 4 and got["n_synth"] == 4 * 4 * 16 * 16
    assert all(got[k] >= 0 for k in ("kld_forward", "kld_inverse", "kld_symmetric"))
    paths = paths_from_args(argparse.Namespace(sid_folder=str(sid)))
    np.testing.assert_array_equal(eval_kld.real_noise_samples(paths, 800, 250.0, 1),
                                  jax_kld.real_noise_samples(paths, 800, 250.0, 1))
    with pytest.raises(RuntimeError, match="no SID pairs"):
        eval_kld.real_noise_samples(paths, 100, 250.0, 1)
    with pytest.raises(RuntimeError, match="no generated"):
        eval_kld.generated_noise_samples(str(tmp_path), 4)


# ---------------------------------------------------------------------------
# manifest helpers and the raw_host tail
# ---------------------------------------------------------------------------

def test_manifest_iso_ratio_and_eld_helpers_equal_jax(tmp_path):
    sid, _ = _sid_tree(tmp_path, 8, 8)
    for split in ("val", "test"):
        sid_list, eld_list = str(sid / f"Sony_{split}_list.txt"), str(sid / f"ELD_Sony_{split}.txt")
        np.testing.assert_array_equal(
            manifest.get_iso_ratio_info(manifest.parse_sid_list(sid_list)),
            jax_manifest.get_iso_ratio_info(jax_manifest.parse_sid_list(sid_list)))
        assert manifest.parse_eld_list(eld_list) == jax_manifest.parse_eld_list(eld_list)
        assert manifest.eld_list_with_iso(sid_list, eld_list) == jax_manifest.eld_list_with_iso(
            sid_list, eld_list)
    info = manifest.get_iso_ratio_info(manifest.parse_sid_list(str(sid / "Sony_val_list.txt")))
    assert info.dtype == np.float64 and info.tolist() == [[800, 100], [800, 250], [3200, 250]]


@pytest.mark.parametrize("ratio", [100, 200])
def test_eld_scene_paths_equal_jax(ratio):
    assert manifest.eld_scene_paths("/eld", ratio) == jax_manifest.eld_scene_paths("/eld", ratio)
    two = manifest.eld_scene_paths("/eld", ratio, cameras=("A", "B"), suffix=".dng",
                                   scenes=(2, 3))
    assert two == jax_manifest.eld_scene_paths("/eld", ratio, cameras=("A", "B"),
                                               suffix=".dng", scenes=(2, 3))
    assert len(two) == 12


def test_eld_scene_paths_other_ratio_raises():
    with pytest.raises(NotImplementedError):
        manifest.eld_scene_paths("/eld", 300)


class _Tag:
    def __init__(self, s):
        self._s = s

    def __str__(self):
        return self._s


def _stub(monkeypatch, name, **attrs):
    monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(**attrs))


def test_extract_iso_from_exif_equals_jax(monkeypatch, tmp_path):
    p = tmp_path / "frame.ARW"
    p.write_bytes(b"\x00" * 16)
    for tags, want in (({"EXIF ISOSpeedRatings": _Tag("1600")}, 1600), ({}, None)):
        _stub(monkeypatch, "exifread", process_file=lambda f, t=tags: t)
        assert raw_host.extract_iso_from_exif(str(p)) == want
        assert jax_raw_host.extract_iso_from_exif(str(p)) == want
    monkeypatch.setitem(sys.modules, "exifread", None)  # not installed
    assert raw_host.extract_iso_from_exif(str(p)) is None


@pytest.mark.parametrize("name,tags", [
    ("a.ARW", {"EXIF ExposureTime": _Tag("1/30"), "EXIF ISOSpeedRatings": _Tag("800")}),
    ("b.dng", {"Image ExposureTime": _Tag("10"), "Image ISOSpeedRatings": _Tag("100")}),
])
def test_metainfo_exif_branches_equal_jax(monkeypatch, tmp_path, name, tags):
    path = tmp_path / name
    path.write_bytes(b"\x00")
    _stub(monkeypatch, "exifread", process_file=lambda f: tags)
    got, want = raw_host.metainfo(str(path)), jax_raw_host.metainfo(str(path))
    assert got == pytest.approx(want)


def test_metainfo_sidecar_wins_over_exif(monkeypatch, tmp_path):
    path = tmp_path / "IMG_0004.ARW"
    path.write_bytes(b"\x00")
    (tmp_path / "IMG_0004.ARW.meta.json").write_text(json.dumps({"iso": 800, "exposure": 0.04}))
    monkeypatch.setitem(sys.modules, "exifread", None)  # never imported
    assert raw_host.metainfo(str(path)) == jax_raw_host.metainfo(str(path)) == (800.0, 0.04)


def _rawpy(monkeypatch, shape, postprocess_result=None):
    class _Raw:
        raw_image = np.zeros(shape, np.uint16)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def postprocess(self, **kw):
            assert kw == dict(use_camera_wb=True, half_size=False, no_auto_bright=True,
                              output_bps=16)
            return postprocess_result

    _stub(monkeypatch, "rawpy", imread=lambda path: _Raw())


def test_modify_raw_file_equals_jax(monkeypatch, tmp_path):
    l, c = 6, 8
    mosaic = np.random.default_rng(0).integers(0, 16383, size=(l, c)).astype(np.uint16)
    header = b"SONYHEADER\x01\x02\x03"
    src = tmp_path / "in.ARW"
    src.write_bytes(header + mosaic.tobytes())
    _rawpy(monkeypatch, (l, c))
    tab = np.full((2, 3), 7777, np.uint16)
    raw_host.modify_raw_file(str(src), tab, (1, 2), str(tmp_path / "port.ARW"))
    jax_raw_host.modify_raw_file(str(src), tab, (1, 2), str(tmp_path / "jax.ARW"))
    blob = (tmp_path / "port.ARW").read_bytes()
    assert blob == (tmp_path / "jax.ARW").read_bytes()
    want = mosaic.copy()
    want[1:3, 2:5] = 7777
    assert blob[: len(header)] == header
    np.testing.assert_array_equal(np.frombuffer(blob[len(header):], np.uint16).reshape(l, c), want)


@pytest.mark.parametrize("save", [False, True])
def test_vis_raw_file_equals_jax(monkeypatch, tmp_path, save):
    rgb16 = np.array([[[0, 32768, 65535], [100, 200, 300]]], np.uint16)
    _rawpy(monkeypatch, (2, 2), postprocess_result=rgb16)
    got = raw_host.vis_raw_file("x.ARW", str(tmp_path / "p.png"), save_file=save)
    want = jax_raw_host.vis_raw_file("x.ARW", str(tmp_path / "j.png"), save_file=save)
    np.testing.assert_array_equal(got, want)
    if save:
        assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()


# ---------------------------------------------------------------------------
# the denoising trainer's --phase test
# ---------------------------------------------------------------------------

def test_denoising_trainer_phase_test(tmp_path, weights, monkeypatch):
    """--phase test builds --testset's loader in order (the JAX loader's
    batches, the last one short) and runs LSID over each batch under
    no_grad; the CLI returns the batches run."""
    sid, _ = _sid_tree(tmp_path, 64, 96, seed=7)
    lines = (sid / "Sony_val_list.txt").read_text() + (sid / "Sony_test_list.txt").read_text()
    (sid / "Sony_train_list.txt").write_text(lines)
    argv = ["--phase", "test", "--testset", "RealSonyDenoisingDataset", "--net_name", "LSID",
            "--lsid_width", str(WIDTH), "--crop_size", "16", "--batch_size", "4",
            "--num_workers", "1", "--sid_folder", str(sid), "--resume", weights + ".npz",
            "--device", "cpu", "--save_folder", str(tmp_path / "w")]
    from noisediff_tpu_torch.train.trainer_denoising import Trainer

    seen = []
    real_init = Trainer.__init__

    def init(self, args):
        real_init(self, args)
        self.model.register_forward_hook(
            lambda m, inp, out: seen.append((inp[0].numpy().copy(), torch.is_grad_enabled())))
    monkeypatch.setattr(Trainer, "__init__", init)
    assert train_denoising.main(argv) == 2  # 6 pairs in batches of 4

    paths = jax_paths_from_args(argparse.Namespace(sid_folder=str(sid)))
    want = [b["noisy_img"] for b in JaxLoader(
        JAX_DATASETS["RealSonyDenoisingDataset"](paths, 16, seed=0), batch_size=4,
        shuffle=False, num_workers=1)]
    assert [x.shape for x, _ in seen] == [w.shape for w in want] == [(4, 16, 16, 4),
                                                                     (2, 16, 16, 4)]
    for (x, grad), w in zip(seen, want):
        assert not grad
        np.testing.assert_array_equal(x, w)

    with pytest.raises(ValueError, match="testset"):
        train_denoising.main(argv[:2] + ["--testset", "TestSet"] + argv[4:])
