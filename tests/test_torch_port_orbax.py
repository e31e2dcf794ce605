"""JAX orbax snapshots reaching the port: the JAX package's `save_component`
writes orbax `net`, `ema` and `optimizer_G` directories of a dim-16
NoiseDiffNet (and of an Adam with weight decay) and an LSID `net`;
`scripts/orbax_to_npz.py` turns them into the flat `.npz` the JAX package
writes with `_save_npz`; the port loads them strictly, its forwards match
JAX's at rtol 5e-4 / atol 5e-5 (PARITY.md:152), and the Adam moments and
count come through `adam_state_from_jax`. Before the conversion every
loader of the port names the script."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.models.lsid import LSID as JaxLSID
from noisediff_tpu.train import checkpoint as jckpt
from noisediff_tpu.train.state import make_optimizer as jax_optimizer
from noisediff_tpu_torch.models import LSID, NoiseDiffNet
from noisediff_tpu_torch.train import checkpoint as pckpt
from noisediff_tpu_torch.train.state import make_optimizer
from noisediff_tpu_torch.weights import (
    adam_state_from_jax, jax_params_to_state_dict, load_jax_opt_npz, load_state_dict_file)
from torch_port_util import ATOL, RTOL, random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, S = 16, 16


def _inputs(rng):
    x = rng.standard_normal((1, S, S, 4)).astype(np.float32)
    cond = {"clean_img": rng.uniform(0, 0.3, (1, S, S, 4)).astype(np.float32),
            "position": rng.uniform(-1, 1, (1, S, S, 2)).astype(np.float32),
            "iso_ratio_idx": np.asarray([24], np.int32)}
    return x, np.asarray([37], np.int32), cond


def _adam_payload(params, rng, weight_decay):
    """One Adam step of the JAX trainer's optimizer from a seeded gradient:
    its state with moments that are not zero, and the trainers' counters."""
    opt = jax_optimizer(weight_decay)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    _, state = opt.update(grads, state, params)
    return {"opt_state": state, "step": jnp.asarray(1, jnp.int32),
            "ema_step": jnp.asarray(1, jnp.int32)}


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """A snapshot directory written by the JAX package (orbax), the same
    trees through `_save_npz` elsewhere, and the converter's output."""
    snap = tmp_path_factory.mktemp("jax_run") / "snapshot"
    flat = tmp_path_factory.mktemp("npz_run")
    rng = np.random.default_rng(0)
    net = JaxNet(dim=DIM)
    x, t, cond = _inputs(rng)
    params = random_params(net, x, t, cond)
    ema = jax.tree.map(lambda p: p * np.float32(0.5), params)
    lsid = JaxLSID(lane_fold=False, base_width=8)
    lsid_params = random_params(lsid, jnp.zeros((1, 32, 32, 4)), seed=1)
    trees = {"net_3": params, "ema_3": ema, "optimizer_G_3": _adam_payload(params, rng, 0.0),
             "optimizer_G_wd_3": _adam_payload(params, rng, 1e-4), "lsid_net_7": lsid_params}
    for tag, tree in trees.items():
        name, epoch = tag.rsplit("_", 1)
        path = jckpt.save_component(str(snap), name, epoch, tree)
        assert os.path.isdir(path)  # orbax, one process
        jckpt._save_npz(str(flat / tag), jckpt._to_numpy_tree(tree))
    errors = {}
    for what, load in (("net", lambda: load_state_dict_file(str(snap / "net_3"))),
                       ("optimizer", lambda: load_jax_opt_npz(str(snap / "optimizer_G_3"))),
                       ("auto", lambda: pckpt.latest_epoch(str(snap)))):
        with pytest.raises(NotImplementedError) as info:
            load()
        errors[what] = str(info.value)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "orbax_to_npz.py"),
                          str(snap)], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(snap=snap, flat=flat, params=params, lsid_params=lsid_params, lsid=lsid,
                net=net, inputs=(x, t, cond), errors=errors, log=out.stdout)


@pytest.mark.parametrize("what", ["net", "optimizer", "auto"])
def test_unconverted_orbax_directories_name_the_converter(snapshots, what):
    assert "orbax_to_npz.py" in snapshots["errors"][what]


@pytest.mark.parametrize("tag", ["net_3", "ema_3", "optimizer_G_3", "optimizer_G_wd_3",
                                 "lsid_net_7"])
def test_converter_writes_what_save_npz_writes(snapshots, tag):
    assert f"{tag} -> " in snapshots["log"]
    with np.load(snapshots["snap"] / f"{tag}.npz") as got, \
            np.load(snapshots["flat"] / f"{tag}.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("tag,scale", [("net_3", 1.0), ("ema_3", 0.5)])
def test_noisediffnet_loads_strictly_and_matches_jax(snapshots, tag, scale):
    x, t, cond = snapshots["inputs"]
    params = jax.tree.map(lambda p: p * np.float32(scale), snapshots["params"])
    want = np.asarray(jax.jit(snapshots["net"].apply)({"params": params}, x, t, cond))
    port = NoiseDiffNet(dim=DIM)
    # the directory's path: the converted .npz beside it is read
    port.load_state_dict(load_state_dict_file(str(snapshots["snap"] / tag)), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(t).long(),
                          {k: torch.from_numpy(v) for k, v in cond.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_lsid_loads_strictly_and_matches_jax(snapshots):
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 4)).astype(np.float32)
    want = np.asarray(snapshots["lsid"].apply({"params": snapshots["lsid_params"]}, x))
    port = LSID(base_width=8)
    port.load_state_dict(load_state_dict_file(str(snapshots["snap"] / "lsid_net_7.npz")),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tag", ["optimizer_G_3", "optimizer_G_wd_3"])
def test_adam_state_comes_through(snapshots, tag):
    mu, nu, count, counters = load_jax_opt_npz(str(snapshots["snap"] / tag))
    assert count == 1 and counters == {"step": 1, "ema_step": 1}
    model = NoiseDiffNet(dim=DIM)
    optimizer = make_optimizer(model.parameters())
    optimizer.load_state_dict(adam_state_from_jax(mu, nu, count, optimizer, model))
    want_mu, want_nu = jax_params_to_state_dict(mu), jax_params_to_state_dict(nu)
    assert any(float(v.abs().max()) > 0 for v in want_mu.values())
    states = optimizer.state_dict()["state"].values()
    for (name, _), state in zip(model.named_parameters(), states):
        assert float(state["step"]) == 1.0
        torch.testing.assert_close(state["exp_avg"], want_mu[name], rtol=0, atol=0)
        torch.testing.assert_close(state["exp_avg_sq"], want_nu[name], rtol=0, atol=0)
