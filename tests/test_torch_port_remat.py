"""--remat and --profile in the port, on the CPU.

  * NoiseDiffNet(remat=True) recomputes exactly the ResnetBlocks the JAX
    model wraps in nn.remat (noisediff_net.py:135): the loss and every
    gradient equal the remat=False model's bit for bit, fp32 and bf16; each
    ResnetBlock runs twice in a training step, the positional
    ResnetBlock2s once; against the JAX NoiseDiffNet(remat=True) the
    gradients agree within test_torch_port_train_model.py's 2e-3 relative
    L2 (loss at rtol 5e-4);
  * define_network passes --remat through;
  * a few-step CLI run with --profile writes a torch.profiler trace of
    steps 5-9 under <save_folder>/<name>/profile.
"""
import glob
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.models.blocks import gn_train_trace
from noisediff_tpu_torch.cli import train_diffusion
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, define_network, is_unread_parameter
from noisediff_tpu_torch.models.blocks import ResnetBlock, ResnetBlock2
from noisediff_tpu_torch.weights import jax_params_to_state_dict
from torch_port_util import RTOL, load_port, random_params

B, S, T = 2, 32, 1000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU; one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    img = (0.05 * rng.standard_normal((B, S, S, 4))).astype(np.float32)
    cond = {"clean_img": rng.uniform(0, 0.3, (B, S, S, 4)).astype(np.float32),
            "position": rng.uniform(0, 1, (B, S, S, 2)).astype(np.float32),
            "iso_ratio_idx": np.array([24, 3], np.int32)}
    t = np.array([421, 37], np.int64)
    noise = rng.standard_normal((B, S, S, 4)).astype(np.float32)
    return img, cond, t, noise


def _port_step(model, img, cond, t, noise):
    """The port's loss on the inputs and each parameter's gradient."""
    model = model.to(memory_format=torch.channels_last).train()
    gd = GaussianDiffusion.create(model, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  device="cpu")
    loss = gd.loss(torch.from_numpy(img), {k: torch.from_numpy(v) for k, v in cond.items()},
                   t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_remat_equals_the_stored_activations(dtype, monkeypatch):
    inputs = _inputs()
    torch.manual_seed(0)
    sd = NoiseDiffNet(dim=16).state_dict()
    calls = {}
    for cls in (ResnetBlock, ResnetBlock2):  # the recompute runs forward, not the module hooks
        def counted(self, *args, _forward=cls.forward, _name=cls.__name__, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _forward(self, *args, **kw)

        monkeypatch.setattr(cls, "forward", counted)

    results = []
    for remat in (False, True):
        model = NoiseDiffNet(dim=16, dtype=dtype, remat=remat)
        model.load_state_dict(sd)
        calls.clear()
        results.append(_port_step(model, *inputs))
        # 20 ResnetBlocks (shot_time, 2 per down and up stage, 2 mid,
        # final_res_block) and 2 positional ResnetBlock2s a forward; remat
        # runs the ResnetBlocks again in the backward
        assert calls == {"ResnetBlock": 20 * (1 + remat), "ResnetBlock2": 2}
    (loss0, g0), (loss1, g1) = results
    assert loss1 == loss0
    for name, g in g0.items():
        if g is None:
            assert is_unread_parameter(name) and g1[name] is None
        else:
            assert torch.equal(g1[name], g), name


def test_remat_gradients_match_jax_remat():
    """The port's remat model against the JAX NoiseDiffNet(remat=True) on
    identical parameters, t and noise (the JAX loss's own draws)."""
    img, cond, _, _ = _inputs()
    jnet = JaxNet(dim=16, remat=True)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    params = random_params(jnet, jnp.asarray(img), jnp.zeros((B,), jnp.int32), jcond, seed=3)
    jd = JaxDiffusion.create(lambda p, x, tt, c: jnet.apply({"params": p}, x, tt, c),
                             image_size=S, timesteps=T, beta_schedule="sigmoid2")
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        with gn_train_trace():
            return jd.loss(p, key, jnp.asarray(img), jcond)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    t = np.array(jax.random.randint(jax.random.fold_in(key, 0), (B,), 0, T), np.int64)
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), img.shape, jnp.float32))
    loss, grads = _port_step(load_port(NoiseDiffNet(dim=16, remat=True), params),
                             img, cond, t, noise)
    np.testing.assert_allclose(loss, float(want_loss), rtol=RTOL)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, want_grads))
    assert want.keys() == grads.keys()
    bad = {}
    for name, w in want.items():
        g = grads[name]
        if is_unread_parameter(name):
            assert g is None and not np.any(w.numpy()), name
            continue
        rel = float(np.linalg.norm(g.numpy() - w.numpy()) / max(np.linalg.norm(w.numpy()), 1e-12))
        if rel > 2e-3:
            bad[name] = rel
    assert not bad, bad


def test_define_network_passes_remat():
    cfg = SimpleNamespace(dim=8, inp_dim=4, remat=True)
    assert define_network("NoiseDiffNet", cfg).remat is True
    assert define_network("NoiseDiffNet", SimpleNamespace(dim=8, inp_dim=4)).remat is False


H_BAYER, W_BAYER = 64, 96


def test_profile_writes_a_trace_of_steps_5_to_9(tmp_path):
    """--profile on a 25-step epoch (100 samples, batch 4): one Chrome
    trace under <save_folder>/<name>/profile with the model's operators,
    and the run's losses as without it."""
    sid = tmp_path / "SID"
    (sid / "Sony" / "short").mkdir(parents=True)
    (sid / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in (1, 2):
        in_fn, gt_fn = f"{i:05d}_00_0.04s.ARW", f"{i:05d}_00_10s.ARW"
        for sub, fn in (("short", in_fn), ("long", gt_fn)):
            np.save(sid / "Sony" / sub / (fn + ".npy"),
                    rng.integers(512, 4096, size=(H_BAYER, W_BAYER)).astype(np.uint16))
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO800 F1.8")
    (sid / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")

    def run(out, *extra):
        return train_diffusion.main([
            "--name", "prof", "--device", "cpu", "--net_name", "NoiseDiffNet", "--dim", "8",
            "--crop_size", "16", "--batch_size", "4", "--max_iter", "1", "--save_epoch_freq",
            "1", "--beta_schedule", "sigmoid2", "--positional_encoding",
            "--with_camera_settings", "--trainset", "SonyTrainDataset", "--sid_folder",
            str(sid), "--num_workers", "1", "--log_freq", "50", "--save_folder", str(out),
            *extra])

    got = run(tmp_path / "p", "--profile")
    assert got["steps"] == 25
    traces = glob.glob(str(tmp_path / "p" / "prof" / "profile" / "*.json"))
    assert [os.path.basename(p) for p in traces] == ["steps_5-9.rank0.pt.trace.json"]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("convolution" in n for n in names) and any("Optimizer.step" in n for n in names)
    assert run(tmp_path / "q")["losses"] == got["losses"]
