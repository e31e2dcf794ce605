"""The port's denoising data against the JAX package's, on the CPU: the
three trainsets of the denoising CLI equal the JAX classes array for array
for the same seed, epoch and index (with and without sub_darkshading, with
and without a packed-frame cache, CHW and HWC noise files), on a miniature
tree synthesised here with the PMN resources and the noise profile; the
raw ops, the dark-shading resources and the cross-stage filename contract
equal theirs too."""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.data import datasets as jds
from noisediff_tpu.data import manifest as jmanifest
from noisediff_tpu.data import native
from noisediff_tpu.data import raw_host as jraw_host
from noisediff_tpu.ops import raw as jraw
from noisediff_tpu_torch.data import datasets as pds
from noisediff_tpu_torch.data import manifest, raw_host
from noisediff_tpu_torch.ops import raw

H_BAYER, W_BAYER = 96, 128  # packed 48 x 64
PATCH, CROP = 24, 16
PAIRS = [(1, 800, "0.04"), (2, 800, "0.04"), (3, 3200, "0.1")]  # ratio 250, 250, 100


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """SID pairs at ISO 800 (x250) and ISO 3200 (x100), generated noise
    patches for both (CHW as the generation CLI writes them, and one HWC),
    the PMN dark-shading resources and a noise profile."""
    root = tmp_path_factory.mktemp("port_denoise_data")
    sid = root / "SID"
    (sid / "Sony" / "short").mkdir(parents=True)
    (sid / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i, iso, expo in PAIRS:
        in_fn, gt_fn = f"{i:05d}_00_{expo}s.ARW", f"{i:05d}_00_10s.ARW"
        for sub, fn in (("short", in_fn), ("long", gt_fn)):
            arr = rng.integers(400, 6000, size=(H_BAYER, W_BAYER)).astype(np.uint16)
            np.save(sid / "Sony" / sub / (fn + ".npy"), arr)
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO{iso} F1.8")
    (sid / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")

    synth = root / "synthetic"
    for folder, frames in (("ISO800_Ratio250", (1, 2)), ("ISO3200_Ratio100", (3,))):
        (synth / folder).mkdir(parents=True)
        for i in frames:
            name = f"{i:05d}_00_10s"
            for x, y in ((0, 0), (20, 8), (40, 24)):
                noise = rng.normal(0, 0.05, (4, PATCH, PATCH)).astype(np.float32)
                if (i, x) == (2, 20):
                    noise = noise.transpose(1, 2, 0)  # an HWC file
                np.save(synth / folder / manifest.npy_patch_name(name, name, x, y), noise)

    res = root / "resources"
    res.mkdir()
    for band, scale in (("low", 1.0), ("high", 3.0)):
        np.save(res / f"darkshading_{band}ISO_k.npy",
                (scale * rng.normal(0, 1e-3, (H_BAYER, W_BAYER))).astype(np.float32))
        np.save(res / f"darkshading_{band}ISO_b.npy",
                (scale * rng.normal(0, 2.0, (H_BAYER, W_BAYER))).astype(np.float32))
    with open(res / "darkshading_BLE.pkl", "wb") as f:
        pickle.dump({800: 0.37, 3200: -1.25}, f)
    with open(root / "noise_profile_all.pkl", "wb") as f:
        pickle.dump({800: (0.8, 6.0), 3200: (3.1, 40.0)}, f)
    return root


def _paths(mod, tree, cache=None):
    return mod.DataPaths(data_folder=str(tree / "SID"), synthetic_folder=str(tree / "synthetic"),
                         resources_path=str(tree / "resources"), pretrained_dir=str(tree),
                         cache_dir=cache)


def _assert_items_equal(jset, pset, epochs=(0, 3), indices=None):
    assert len(pset) == len(jset)
    for epoch in epochs:
        jset.set_epoch(epoch)
        pset.set_epoch(epoch)
        for idx in indices or range(len(pset)):
            want, got = jset[idx], pset[idx]
            assert got.keys() == want.keys()
            for k, w in want.items():
                if isinstance(w, np.ndarray):
                    assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
                    np.testing.assert_array_equal(got[k], w, err_msg=f"{k} @ {epoch}/{idx}")
                else:
                    assert got[k] == w and type(got[k]) is type(w), k


def test_frames_pack_as_the_jax_package_packs_them(tmp_path):
    """The JAX datasets' frames come through its native packer (built on
    demand from csrc/), whose arithmetic the port's `load_packed_frame`
    reproduces: a float32 reciprocal, not a division."""
    assert native.available()
    path = str(tmp_path / "frame.ARW")
    np.save(path + ".npy", np.random.default_rng(1).integers(0, 16384, (32, 48)).astype(
        np.uint16))
    for rescale in (True, False):
        np.testing.assert_array_equal(raw_host.load_packed_frame(path, rescale),
                                      jraw_host.load_packed(path, rescale))


@pytest.mark.parametrize("sub_darkshading", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_synthetic_dataset_equals_jax(tree, tmp_path, sub_darkshading, cached):
    cache = str(tmp_path / "cache") if cached else None
    jset = jds.SyntheticNoisDiffDenoisingDataset(_paths(jds, tree, cache), CROP,
                                                 sub_darkshading=sub_darkshading, seed=5)
    pset = pds.SyntheticNoisDiffDenoisingDataset(_paths(pds, tree, cache), CROP,
                                                 sub_darkshading=sub_darkshading, seed=5)
    assert len(pset) == 9
    assert [p[1:] for p in pset.pair_list] == [p[1:] for p in jset.pair_list]
    _assert_items_equal(jset, pset)
    item = pset[0]
    assert item["noisy_img"].shape == (CROP, CROP, 4) and (item["iso"], item["ratio"]) == (
        3200, 100)


@pytest.mark.parametrize("sub_darkshading", [False, True])
def test_real_sony_dataset_equals_jax(tree, sub_darkshading):
    jset = jds.RealSonyDenoisingDataset(_paths(jds, tree), CROP,
                                        sub_darkshading=sub_darkshading, seed=2)
    pset = pds.RealSonyDenoisingDataset(_paths(pds, tree), CROP,
                                        sub_darkshading=sub_darkshading, seed=2)
    _assert_items_equal(jset, pset, epochs=(0, 1, 7))


def test_poisson_gaussian_dataset_equals_jax(tree):
    jset = jds.PossionGaussianDenoisingDataset(_paths(jds, tree), CROP, seed=4)
    pset = pds.PossionGaussianDenoisingDataset(_paths(pds, tree), CROP, seed=4)
    _assert_items_equal(jset, pset, epochs=(0, 1, 7))
    assert set(pset[0]) == {"clean_img", "noisy_img"}


def test_truncnorm_equals_jax():
    for seed in range(5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert pds._truncnorm(a, 2.0, 1.0, 1.4, 2.6) == jds._truncnorm(b, 2.0, 1.0, 1.4, 2.6)
    # a window the draws never reach clips the last draw
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    assert pds._truncnorm(a, 0.0, 1e-6, 5.0, 6.0) == jds._truncnorm(b, 0.0, 1e-6, 5.0, 6.0) == 5.0


def test_darkshading_resources_equal_jax(tree):
    jd, pd = jraw_host.Darkshading(str(tree / "resources")), raw_host.Darkshading(
        str(tree / "resources"))
    for iso in (800, 3200):  # the low- and high-ISO pairs
        np.testing.assert_array_equal(pd.get(iso), jd.get(iso))
    assert not np.array_equal(pd.get(800), pd.get(3200))


def test_packed_frame_cache_equals_jax(tree, tmp_path):
    path = str(tree / "SID" / "Sony" / "long" / "00001_00_10s.ARW")
    want = jraw_host.PackedFrameCache(str(tmp_path / "j")).get(path)
    cache = raw_host.PackedFrameCache(str(tmp_path / "p"))
    got = cache.get(path)
    assert isinstance(got, np.memmap) and cache.get(path) is got
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(raw_host.PackedFrameCache().get(path), want)


def test_unpack_bayer_inverts_pack():
    packed = np.random.default_rng(2).standard_normal((5, 7, 4)).astype(np.float32)
    got = raw_host.np_unpack_bayer(packed)
    np.testing.assert_array_equal(got, jraw_host.np_unpack_bayer(packed))
    np.testing.assert_array_equal(raw_host.np_pack_bayer(got), packed)


def test_filename_contract_equals_jax():
    for args in (("00001_00_10s.ARW", "00001_00_0.04s.ARW", 8, 4), ("a", "b", 0, 1424)):
        name = manifest.npy_patch_name(*args)
        assert name == jmanifest.npy_patch_name(*args)
        assert manifest.parse_npy_patch_name(name) == jmanifest.parse_npy_patch_name(name)
    for folder in ("ISO800_Ratio250", "ISO25600_Ratio300"):
        assert (manifest.parse_synthetic_folder_name(folder)
                == jmanifest.parse_synthetic_folder_name(folder))


def _bayer(seed, h=8, w=12):
    return np.random.default_rng(seed).integers(0, 16384, (h, w)).astype(np.float32)


@pytest.mark.parametrize("fn,args", [
    ("pack_raw", lambda: (_bayer(0),)),
    ("pack_raw_withoutclip", lambda: (_bayer(1),)),
    ("pack_bayer", lambda: (np.stack([_bayer(2), _bayer(3)]),)),
    ("unpack_to_bayer", lambda: (np.random.default_rng(4).random((2, 3, 5, 4), np.float32),)),
    ("unpack_raw", lambda: (np.random.default_rng(5).random((4, 6, 4), np.float32),)),
    ("pack_raw_withdarkshading", lambda: (_bayer(6), 30 * np.random.default_rng(7).random(
        (8, 12), np.float32), 100.0)),
    ("remove_darkshading_packed", lambda: (np.random.default_rng(8).random((4, 6, 4), np.float32),
                                           30 * np.random.default_rng(9).random((8, 12),
                                                                                np.float32),
                                           250.0)),
    ("darkshading_from_kb", lambda: (np.random.default_rng(10).random((8, 12), np.float32),
                                     np.random.default_rng(11).random((8, 12), np.float32),
                                     800.0, 0.37)),
    ("apply_darkshading", lambda: (_bayer(12), 30 * np.random.default_rng(13).random(
        (8, 12), np.float32))),
])
def test_raw_ops_equal_jax(fn, args):
    a = args()
    want = np.asarray(getattr(jraw, fn)(*(jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                          for x in a)))
    got = getattr(raw, fn)(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                             for x in a)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-6,
                               atol=1e-6)


def test_pack_raw_no_rescale_and_uint16_round_trip():
    bayer = _bayer(14)
    np.testing.assert_array_equal(raw.pack_raw(torch.from_numpy(bayer), rescale=False).numpy(),
                                  np.asarray(jraw.pack_raw(jnp.asarray(bayer), rescale=False)))
    back = raw.unpack_raw(raw.pack_raw(torch.from_numpy(bayer))).numpy()
    np.testing.assert_array_equal(back, np.maximum(bayer, 512).astype(np.uint16))


def test_camera_tables_equal_jax():
    for cam in ("NikonD850", "IMX686", "SonyA7S2_lowISO", "SonyA7S2_highISO", "CRVD", "unknown",
                None):
        assert raw.get_camera_noisy_params(cam) == jraw.get_camera_noisy_params(cam)
    for cam in ("SonyA7S2_50", "SonyA7S2_800", "SonyA7S2_25600", "SonyA7S2_3000",
                "SonyA7S2_x", "IMX686_6400", "NikonD850", None):
        assert raw.get_camera_noisy_params_max(cam) == jraw.get_camera_noisy_params_max(cam)
    np.testing.assert_array_equal(raw.SONY_A7S2_ISO_TABLE, jraw.SONY_A7S2_ISO_TABLE)
    np.testing.assert_array_equal(raw.sony_kmax_array(), jraw.sony_kmax_array())
