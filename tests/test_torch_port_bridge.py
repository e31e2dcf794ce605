"""The weight bridge and the port's host-side copies, against the JAX
package and the reference key fixture, on the CPU."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from noisediff_tpu.data import datasets as jds
from noisediff_tpu.data import manifest as jman
from noisediff_tpu.data import raw_host as jraw
from noisediff_tpu.data.iso_ratio_mapping import COMBINATION_MAPPING as JMAP
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.ops import coords as jcoords
from noisediff_tpu.train import torch_import
from noisediff_tpu_torch.data import datasets as pds
from noisediff_tpu_torch.data import manifest as pman
from noisediff_tpu_torch.data import raw_host as praw
from noisediff_tpu_torch.data.iso_ratio_mapping import COMBINATION_MAPPING as PMAP
from noisediff_tpu_torch.data.loader import generation_loader
from noisediff_tpu_torch.models import NoiseDiffNet
from noisediff_tpu_torch.ops import coords as pcoords
from noisediff_tpu_torch.weights import jax_params_to_state_dict, strip_module_prefix

from torch_port_util import random_params

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def dim48_params():
    x = jnp.zeros((1, 16, 16, 4))
    cond = {"clean_img": x, "position": jnp.zeros((1, 16, 16, 2)),
            "iso_ratio_idx": jnp.zeros((1,), jnp.int32)}
    return random_params(JaxNet(dim=48), x, jnp.zeros((1,), jnp.int32), cond, seed=3)


def test_dim48_keys_shapes_and_count_match_reference():
    with open(os.path.join(FIXTURES, "noisediffnet_torch_keys.json")) as f:
        ref = json.load(f)
    model = NoiseDiffNet(dim=48)
    sd = model.state_dict()
    assert len(ref) == 416 and set(sd) == set(ref)
    for k, shape in ref.items():
        assert list(sd[k].shape) == shape, k
    assert sum(p.numel() for p in model.parameters()) == 21_268_088


def test_bridge_loads_jax_tree_strictly(dim48_params):
    sd = jax_params_to_state_dict(dim48_params)
    NoiseDiffNet(dim=48).load_state_dict(sd, strict=True)
    # spot checks of each layout transform
    p = dim48_params
    np.testing.assert_array_equal(
        sd["init_conv.weight"].numpy(), p["init_conv"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["time_mlp.1.weight"].numpy(), p["time_mlp"]["lin1"]["dense"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["downs.2.3.1.weight"].numpy(),
        p["downs_2_down"]["conv"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["ups.1.0.block1.norm.weight"].numpy(),
        p["ups_1_block1"]["block1"]["norm"]["norm"]["scale"])


def test_bridge_inverts_the_jax_importer(dim48_params):
    """JAX tree -> port state_dict -> the JAX package's own .pth importer
    gives back the same tree."""
    sd = {k: v.numpy() for k, v in jax_params_to_state_dict(dim48_params).items()}
    zeros = jax.tree.map(np.zeros_like, dim48_params)
    back = torch_import.import_torch_params(zeros, sd, strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(dim48_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_strip_module_prefix():
    assert strip_module_prefix({"module.a.weight": 1, "b.bias": 2}) == {"a.weight": 1,
                                                                       "b.bias": 2}


def test_coords_equal_jax():
    np.testing.assert_array_equal(pcoords.make_coord(5, 7, True), jcoords.make_coord(5, 7, True))
    np.testing.assert_array_equal(pcoords.make_coord(5, 7), jcoords.make_coord(5, 7))
    np.testing.assert_array_equal(pcoords.crop_coord_patch(64, 96, 8, 16, 16, 32),
                                  jcoords.crop_coord_patch(64, 96, 8, 16, 16, 32))


def test_manifest_and_mapping_equal_jax():
    assert PMAP == JMAP
    line = "./Sony/short/00001_00_0.1s.ARW ./Sony/long/00001_00_10s.ARW ISO200 F8"
    assert pman.parse_sid_line(line).__dict__ == jman.parse_sid_line(line).__dict__
    for h, w, ps in ((1424, 2128, 512), (64, 96, 16), (512, 512, 512)):
        assert pman.patch_grid(h, w, ps) == jman.patch_grid(h, w, ps)
    assert (pman.SID_PACKED_H, pman.SID_PACKED_W) == (jman.SID_PACKED_H, jman.SID_PACKED_W)


def _tree(tmp_path):
    root = tmp_path / "SID"
    (root / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(1, 5):
        arr = rng.integers(512, 4096, size=(64, 96)).astype(np.uint16)
        np.save(root / "Sony" / "long" / f"{i:05d}_00_10s.ARW.npy", arr)
    (root / "Sony_train_list.txt").write_text(
        "./Sony/short/00001_00_0.04s.ARW ./Sony/long/00001_00_10s.ARW ISO800 F1.8\n"
        "./Sony/short/00003_00_0.1s.ARW ./Sony/long/00003_00_10s.ARW ISO200 F1.8\n")
    return root


def test_raw_decode_and_pack_equal_jax(tmp_path):
    root = _tree(tmp_path)
    path = str(root / "Sony" / "long" / "00002_00_10s.ARW")
    np.testing.assert_array_equal(praw.decode_bayer(path), jraw.decode_bayer(path))
    np.testing.assert_array_equal(praw.load_packed(path), jraw.np_pack_raw(jraw.decode_bayer(path)))


@pytest.mark.parametrize("name", ["NoiseImageGenerationDataset", "GenDarkFrameDataset"])
def test_generation_datasets_equal_jax(tmp_path, name):
    root = _tree(tmp_path)
    kw = dict(iso_value=800, ratio_value=250) if name == "NoiseImageGenerationDataset" else {}
    jd = jds.DATASETS[name](jds.DataPaths(data_folder=str(root)), 16, seed=3, **kw)
    pd = pds.DATASETS[name](pds.DataPaths(data_folder=str(root)), 16, seed=3, **kw)
    assert len(pd) == len(jd) > 0
    for i in range(len(pd)):
        a, b = pd[i], jd[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-7)
            else:
                assert a[k] == b[k], k
    batches = list(generation_loader(pd, 4))
    assert sum(len(bt["image_coord"]) for bt in batches) == len(pd)
    assert batches[0]["coord"].shape == (4, 16, 16, 2)
    assert batches[0]["iso_ratio_idx"].dtype == np.int32
    assert [c for bt in batches for c in bt["image_coord"]] == \
        [pd[i]["image_coord"] for i in range(len(pd))]
