"""The port's host data-plane library (`noisediff_tpu_torch/data/native.py`,
built by g++ from `noisediff_tpu_torch/csrc/host/`) on the CPU: bit-equal
to its plain numpy versions (`raw_host.pack_frame`, `raw_host.make_noise_pair`)
and to the JAX package's native module on the same mosaics, at ragged
crops; a compiler that fails raises with its output; the port's datasets
and frame loader call the library."""
import os
import stat

import numpy as np
import pytest

from noisediff_tpu.data import native as jnative
from noisediff_tpu_torch.data import native, raw_host
from noisediff_tpu_torch.data.datasets import DataPaths, SonyTrainDataset

H_BAYER, W_BAYER = 70, 102  # a packed 35 x 51 frame: no dimension a power of two


@pytest.fixture(scope="module")
def mosaics():
    rng = np.random.default_rng(11)
    # the range past both ends of [black, white]: clamps at 0 and above 1
    return tuple(rng.integers(0, 16384, (H_BAYER, W_BAYER)).astype(np.uint16) for _ in range(2))


def test_library_builds_and_loads():
    assert native.available()
    assert jnative.available()


@pytest.mark.parametrize("rescale", [True, False])
@pytest.mark.parametrize("source_dtype", [np.uint16, np.float32])
def test_pack_raw_equals_numpy_and_jax(mosaics, rescale, source_dtype):
    """The mosaic may come as uint16 (a sidecar) or float32 (decode_bayer)."""
    bayer = mosaics[0].astype(source_dtype)
    got = native.pack_raw(bayer, rescale=rescale)
    assert got.shape == (H_BAYER // 2, W_BAYER // 2, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, raw_host.pack_frame(bayer, rescale=rescale))
    np.testing.assert_array_equal(got, jnative.pack_raw(bayer, rescale=rescale))


def test_unpack_raw_equals_numpy_and_jax():
    packed = np.random.default_rng(3).uniform(-0.1, 1.1, (17, 23, 4)).astype(np.float32)
    got = native.unpack_raw(packed)
    np.testing.assert_array_equal(got, jnative.unpack_raw(packed))
    f32 = np.float32
    plain = raw_host.np_unpack_bayer(packed) * f32(raw_host.SCALE) + f32(raw_host.BLACK_LEVEL)
    np.testing.assert_array_equal(
        got, np.clip(plain, f32(0), f32(raw_host.WHITE_POINT)).astype(np.uint16))


@pytest.mark.parametrize("cy,cx,ch,cw", [(0, 0, 35, 51), (5, 7, 16, 24), (34, 50, 1, 1),
                                         (3, 0, 13, 51), (0, 9, 35, 5)])
@pytest.mark.parametrize("ratio", [1.0, 250.0])
def test_make_noise_pair_equals_numpy_and_jax(mosaics, cy, cx, ch, cw, ratio):
    b_in, b_gt = mosaics
    got = native.make_noise_pair(b_in, b_gt, cy, cx, ch, cw, ratio)
    for g, w, j in zip(got, raw_host.make_noise_pair(b_in, b_gt, cy, cx, ch, cw, ratio),
                       jnative.make_noise_pair(b_in, b_gt, cy, cx, ch, cw, ratio)):
        assert g.shape == (ch, cw, 4) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("crop", [(30, 0, 6, 10), (0, 45, 4, 7), (-1, 0, 4, 4)])
def test_make_noise_pair_refuses_crops_outside_the_frame(mosaics, crop):
    with pytest.raises(ValueError):
        native.make_noise_pair(*mosaics, *crop, 1.0)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch, mosaics):
    """No numpy fallback: the compiler's own words come back in the error."""
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'this compiler is broken' >&2\nexit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="this compiler is broken"):
        native.pack_raw(mosaics[0])
    assert not native.available()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="could not be built"):
        native.make_noise_pair(*mosaics, 0, 0, 4, 4, 1.0)
    assert not os.listdir(tmp_path / "build")


def test_datasets_and_frames_go_through_the_library(tmp_path, monkeypatch, mosaics):
    calls = []

    def counted(name):
        real = getattr(native, name)

        def fn(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return fn

    for name in ("pack_raw", "make_noise_pair"):
        monkeypatch.setattr(native, name, counted(name))
    root = tmp_path / "SID"
    for sub, fn, arr in (("short", "00001_00_0.04s.ARW", mosaics[0]),
                         ("long", "00001_00_10s.ARW", mosaics[1])):
        (root / "Sony" / sub).mkdir(parents=True)
        np.save(root / "Sony" / sub / (fn + ".npy"), arr)
    (root / "Sony_train_list.txt").write_text(
        "./Sony/short/00001_00_0.04s.ARW ./Sony/long/00001_00_10s.ARW ISO800 F1.8\n")
    item = SonyTrainDataset(DataPaths(data_folder=str(root)), 16, seed=0)[0]
    assert calls == ["make_noise_pair"] and item["noise"].shape == (16, 16, 4)
    frame = raw_host.load_packed_frame(str(root / "Sony" / "long" / "00001_00_10s.ARW"))
    assert calls[-1] == "pack_raw"
    np.testing.assert_array_equal(frame, raw_host.pack_frame(mosaics[1]))
