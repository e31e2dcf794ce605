"""The port's training data against the JAX package's, on the CPU: the
SonyTrainDataset items and the first epoch of the training loader, on a
miniature SID tree with the same seed, equal bit for bit. The crop is made
before packing on both sides (the JAX package's native library), so the
numbers equal the reference's pack-then-crop order as well."""
import numpy as np
import pytest

from noisediff_tpu.data import native
from noisediff_tpu.data.datasets import DataPaths as JaxPaths
from noisediff_tpu.data.datasets import SonyTrainDataset as JaxSony
from noisediff_tpu.data.loader import create_dataloader
from noisediff_tpu_torch.data.datasets import DataPaths, SonyTrainDataset
from noisediff_tpu_torch.data.loader import TrainLoader
from noisediff_tpu_torch.data.raw_host import make_noise_pair, np_pack_raw

H_BAYER, W_BAYER = 96, 128
CROP = 32


@pytest.fixture(scope="module")
def sid_tree(tmp_path_factory):
    """3 ISO800 pairs (ratio 250) and 1 ISO1600 pair (ratio 100)."""
    root = tmp_path_factory.mktemp("port_train_data") / "SID"
    (root / "Sony" / "short").mkdir(parents=True)
    (root / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i, (iso, expo) in enumerate([(800, "0.04"), (800, "0.04"), (800, "0.04"),
                                     (1600, "0.1")], 1):
        in_fn, gt_fn = f"{i:05d}_00_{expo}s.ARW", f"{i:05d}_00_10s.ARW"
        for sub, fn in (("short", in_fn), ("long", gt_fn)):
            arr = rng.integers(0, 16383, size=(H_BAYER, W_BAYER)).astype(np.uint16)
            np.save(root / "Sony" / sub / (fn + ".npy"), arr)
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO{iso} F1.8")
    (root / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")
    return root


def test_rebalanced_items_equal_jax(sid_tree):
    jds = JaxSony(JaxPaths(data_folder=str(sid_tree)), CROP, seed=3)
    pds = SonyTrainDataset(DataPaths(data_folder=str(sid_tree)), CROP, seed=3)
    # int(100 / 3) * 3 + int(100 / 1) * 1 samples
    assert len(pds) == len(jds) == 33 * 3 + 100
    for epoch in (0, 2):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for idx in (0, 1, 50, 98, 99, 150, 198):
            want, got = jds[idx], pds[idx]
            assert got.keys() == want.keys()
            for k in want:
                if isinstance(want[k], np.ndarray):
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} @ {idx}")
                else:
                    assert got[k] == want[k], k


def test_first_epoch_batches_equal_jax(sid_tree):
    jds = JaxSony(JaxPaths(data_folder=str(sid_tree)), CROP, seed=1)
    pds = SonyTrainDataset(DataPaths(data_folder=str(sid_tree)), CROP, seed=1)
    jl = create_dataloader(jds, phase="train", batch_size=8, num_workers=3, seed=1)
    pl = TrainLoader(pds, batch_size=8, num_workers=3, seed=1)
    jl.set_epoch(0)
    pl.set_epoch(0)
    assert pl.indices() == jl._indices()
    got, want = list(pl), list(jl)
    assert len(got) == len(want) == len(pl) == 199 // 8  # drop_last
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_loader_stops_early_without_leaks(sid_tree):
    """Leaving an epoch early cancels the prefetched batches."""
    pl = TrainLoader(SonyTrainDataset(DataPaths(data_folder=str(sid_tree)), CROP), 4,
                     num_workers=2)
    it = iter(pl)
    first = next(it)
    it.close()
    assert first["noise"].shape == (4, CROP, CROP, 4)


def test_noise_pair_crop_first_equals_pack_first():
    """Cropping the Bayer region before packing gives the numbers of
    packing the whole frame first, and those of the JAX native library."""
    rng = np.random.default_rng(4)
    b_in = rng.integers(0, 16383, size=(64, 96)).astype(np.uint16)
    b_gt = rng.integers(0, 16383, size=(64, 96)).astype(np.uint16)
    noisy, clean, noise = make_noise_pair(b_in, b_gt, 5, 7, 16, 24, 250.0)
    full_in = np.clip(np_pack_raw(b_in.astype(np.float32)) * np.float32(250.0), 0, 1)
    np.testing.assert_allclose(noisy, full_in[5:21, 7:31], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(clean, np_pack_raw(b_gt.astype(np.float32))[5:21, 7:31],
                               rtol=1e-6, atol=1e-7)
    if native.available():
        for got, want in zip((noisy, clean, noise),
                             native.make_noise_pair(b_in, b_gt, 5, 7, 16, 24, 250.0)):
            np.testing.assert_array_equal(got, want)
