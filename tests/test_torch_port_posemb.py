"""The port's UNet_PosEmbV2 family against the JAX package, on the CPU.

Each of the three nets (dim 16, crop 32, batch 2, fp32) gets seeded numpy
weights from `random_params` of the JAX module, handed to the port through
the weight bridge (a strict load, the `.2` placeholders included). The JAX
nets run unfolded on the CPU (their XLA path), the port's through its
kernels' plain versions. Held against JAX: the forward (rtol 5e-4,
PARITY.md:152, with an absolute floor), UNet_PosEmbV2_NoPosition with a
bare clean image and with the trainer's dict, the loss and every gradient
of one training step under gn_train_trace (the loss at rtol 5e-4, each
gradient within 2e-3 relative L2, the bound of
test_torch_port_train_model.py: fp32 reassociation through ~50 layers of
the backward on both sides), a DPM-2 lambda-grid sample and a DDIM eta-0
sample from the same x_T. Then the bf16 forward close to fp32, the dim-48
parameter counts, and the train and generate CLIs with --net_name
UNet_PosEmbV2_CameraCond on a miniature SID tree.
"""
import functools
import glob
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import others as jax_others
from noisediff_tpu.models.blocks import gn_train_trace
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import define_network, is_unread_parameter, others
from noisediff_tpu_torch.weights import jax_params_to_state_dict

from torch_port_util import ATOL, RTOL, load_port, random_params

B, S, DIM = 2, 32, 16
T = 1000
NETS = ("UNet_PosEmbV2", "UNet_PosEmbV2_NoPosition", "UNet_PosEmbV2_CameraCond")
# the JAX package's pinned counts (tests/test_models.py:50-63)
DIM48_PARAMS = {"UNet_PosEmbV2": 19_702_596, "UNet_PosEmbV2_NoPosition": 19_700_308,
                "UNet_PosEmbV2_CameraCond": 21_262_164}
GRAD_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several test workers on one CPU; torch's own
    thread pool in each of them oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, S, 4)).astype(np.float32)
    cond = {
        "clean_img": rng.uniform(0, 0.3, (B, S, S, 4)).astype(np.float32),
        "position": rng.uniform(0, 1, (B, S, S, 2)).astype(np.float32),
        "iso_ratio_idx": np.array([24, 3], np.int32),
    }
    return x, cond


def _jax(cond):
    return {k: jnp.asarray(v) for k, v in cond.items()}


def _torch(cond):
    return {k: torch.from_numpy(v) for k, v in cond.items()}


@functools.lru_cache(maxsize=None)
def _net(name):
    """(JAX module, its seeded params, jitted apply, the port's net)."""
    jnet = getattr(jax_others, name)(dim=DIM)
    x, cond = _inputs()
    params = random_params(jnet, jnp.asarray(x), jnp.zeros((B,), jnp.int32), _jax(cond),
                           seed=NETS.index(name))
    port = load_port(getattr(others, name)(dim=DIM), params)
    apply = jax.jit(lambda p, xx, tt, cc: jnet.apply({"params": p}, xx, tt, cc))
    return jnet, params, apply, port


@pytest.mark.parametrize("name", NETS)
def test_forward_matches_jax(name):
    _, params, apply, port = _net(name)
    x, cond = _inputs()
    t = np.array([999, 37], np.int32)
    want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t), _jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t).long(), _torch(cond)).numpy()
    assert got.shape == (B, S, S, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_no_position_takes_a_bare_clean_image():
    """UNet_PosEmbV2_NoPosition reads only the clean image: the bare tensor
    (others_arch.py:661) and the trainer's dict give the same output, and
    the JAX net's on the bare tensor."""
    _, params, apply, port = _net("UNet_PosEmbV2_NoPosition")
    x, cond = _inputs(4)
    t = np.array([500, 1], np.int32)
    want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(cond["clean_img"])))
    with torch.no_grad():
        tt = torch.from_numpy(t).long()
        bare = port(torch.from_numpy(x), tt, torch.from_numpy(cond["clean_img"]))
        from_dict = port(torch.from_numpy(x), tt, _torch(cond))
    assert torch.equal(bare, from_dict)
    np.testing.assert_allclose(bare.numpy(), want, rtol=RTOL, atol=ATOL)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("name", NETS)
def test_loss_and_gradients_match_jax(name):
    """One training step's loss and every parameter gradient, with the
    timesteps and noise the JAX loss draws from its key handed to the
    port; the parameters the one-token attention never reads get no
    gradient in the port and a zero one in JAX."""
    jnet, params, _, _ = _net(name)
    rng = np.random.default_rng(2)
    img = (0.05 * rng.standard_normal((B, S, S, 4))).astype(np.float32)
    _, cond = _inputs(3)
    jd = JaxDiffusion.create(lambda p, x, t, c: jnet.apply({"params": p}, x, t, c),
                             image_size=S, timesteps=T, beta_schedule="sigmoid2")
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        with gn_train_trace():
            return jd.loss(p, key, jnp.asarray(img), _jax(cond))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    t = np.array(jax.random.randint(jax.random.fold_in(key, 0), (B,), 0, T))
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), img.shape, jnp.float32))

    port = load_port(getattr(others, name)(dim=DIM), params).train()
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  device="cpu")
    loss = pd.loss(torch.from_numpy(img), _torch(cond), t=torch.from_numpy(t).long(),
                   noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)

    want = jax_params_to_state_dict(jax.tree.map(np.asarray, want_grads))
    got = dict(port.named_parameters())
    assert want.keys() == got.keys()
    worst = {}
    unread = 0
    for pname, w in want.items():
        g = got[pname].grad
        if is_unread_parameter(pname):
            unread += 1
            assert g is None and not np.any(w.numpy()), pname
            continue
        assert g is not None and torch.isfinite(g).all(), pname
        worst[pname] = _rel_l2(g.numpy(), w.numpy())
    # 8 AttnBlocks with 4 unread tensors each (norm1 weight and bias, to_q, to_k)
    assert unread == (32 if name.endswith("CameraCond") else 0)
    bad = {k: v for k, v in worst.items() if v > GRAD_REL}
    assert not bad, bad


def _diffusions(name):
    _, params, apply, port = _net(name)
    jd = JaxDiffusion.create(lambda p, xx, tt, cc: apply(p, xx, tt, cc), image_size=S,
                             timesteps=T, beta_schedule="sigmoid2")
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  device="cpu")
    return params, jd, pd


@pytest.mark.parametrize("name", NETS)
def test_dpm_sample_matches_jax(name):
    params, jd, pd = _diffusions(name)
    x, cond = _inputs(5)
    want = np.asarray(jd.dpm_solver_sample(params, jax.random.PRNGKey(0), x.shape, _jax(cond),
                                           sampling_timesteps=2, init_noise=jnp.asarray(x),
                                           step_spacing="lambda"))
    got = pd.dpm_solver_sample(x.shape, _torch(cond), sampling_timesteps=2,
                               init_noise=torch.from_numpy(x), step_spacing="lambda").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NETS)
def test_ddim_eta0_sample_matches_jax(name):
    """DDIM runs unfused: the family has no trunk for the fused tail."""
    params, jd, pd = _diffusions(name)
    assert pd.fused_tail_trunk() is None
    x, cond = _inputs(6)
    want = np.asarray(jd.ddim_sample(params, jax.random.PRNGKey(0), x.shape, _jax(cond),
                                     sampling_timesteps=2, eta=0.0, init_noise=jnp.asarray(x)))
    got = pd.ddim_sample(x.shape, _torch(cond), sampling_timesteps=2, eta=0.0,
                         init_noise=torch.from_numpy(x), trunk_fn=pd.fused_tail_trunk()).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NETS)
def test_forward_bf16_runs_close_to_fp32(name):
    """The bf16 compute path on the CPU: finite, model-dtype output within
    bf16 rounding of the fp32 forward (a smoke check, not a parity bound)."""
    port = _net(name)[3]
    x, cond = _inputs()
    bf = getattr(others, name)(dim=DIM, dtype=torch.bfloat16).eval()
    bf.load_state_dict(port.state_dict())
    t = torch.tensor([500, 3])
    with torch.no_grad():
        ref = port(torch.from_numpy(x), t, _torch(cond))
        got = bf(torch.from_numpy(x), t, _torch(cond))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    rel = (got.float() - ref).norm() / ref.norm()
    assert rel < 5e-2, float(rel)


@pytest.mark.parametrize("name", NETS)
def test_dim48_parameter_counts(name):
    cfg = SimpleNamespace(dim=48, inp_dim=4, cond_dim=4)
    net = define_network(name, cfg)
    assert sum(p.numel() for p in net.parameters()) == DIM48_PARAMS[name]


@pytest.mark.parametrize("name", NETS)
def test_stage_slots_load_strictly(name):
    """Without ISO attention slot .2 of every stage is a parameterless
    nn.Identity, so the bridge's `.3` down / up convs load strictly; a key
    the net lacks, or a missing one, fails the strict load."""
    _, params, _, port = _net(name)
    attn = name.endswith("CameraCond")
    for stage in list(port.downs) + list(port.ups):
        assert isinstance(stage[2], nn.Identity) != attn
        assert attn or not list(stage[2].parameters())
    sd = jax_params_to_state_dict(params)
    assert any(k.startswith("downs.0.3.") for k in sd)
    assert attn == any(k.startswith("downs.0.2.") for k in sd)
    fresh = getattr(others, name)(dim=DIM)
    fresh.load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError):
        fresh.load_state_dict({**sd, "downs.0.2.norm1.weight_x": torch.zeros(1)}, strict=True)
    with pytest.raises(RuntimeError):
        fresh.load_state_dict({k: v for k, v in sd.items() if k != "final_conv.bias"},
                              strict=True)


H_BAYER, W_BAYER = 160, 192  # packed 80 x 96


@pytest.fixture(scope="module")
def sid_tree(tmp_path_factory):
    """2 ISO800 training pairs and 1 further clean frame."""
    root = tmp_path_factory.mktemp("port_posemb") / "SID"
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
    arr = rng.integers(512, 4096, size=(H_BAYER, W_BAYER)).astype(np.uint16)
    np.save(root / "Sony" / "long" / "00003_00_10s.ARW.npy", arr)
    (root / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")
    return root


def test_camera_cond_through_the_clis(sid_tree, tmp_path):
    """--net_name UNet_PosEmbV2_CameraCond through the training CLI (two
    epochs, batch 20 over the 100 rebalanced samples) and the generation
    CLI from its net_final.pth (DPM-2 on the lambda grid and DDIM-2)."""
    from noisediff_tpu_torch.cli import test_diffusion, train_diffusion

    common = ["--net_name", "UNet_PosEmbV2_CameraCond", "--dim", str(DIM), "--crop_size",
              str(S), "--beta_schedule", "sigmoid2", "--positional_encoding",
              "--with_camera_settings", "--generation_result", "noise", "--device", "cpu",
              "--sid_folder", str(sid_tree)]
    summary = train_diffusion.main(common + [
        "--name", "train_diffusion", "--trainset", "SonyTrainDataset", "--batch_size", "20",
        "--max_iter", "2", "--save_epoch_freq", "1", "--num_workers", "1", "--log_freq", "2",
        "--save_folder", str(tmp_path / "weights")])
    assert summary["steps"] == 10 and all(np.isfinite(summary["losses"]))
    snap = tmp_path / "weights" / "train_diffusion" / "snapshot"
    sd = torch.load(snap / "net_final.pth", weights_only=True)
    others.UNet_PosEmbV2_CameraCond(dim=DIM).load_state_dict(sd, strict=True)
    for sampler in (["--sampler", "dpm", "--sampling_timesteps", "2"],
                    ["--sampler", "ddim", "--sampling_timesteps", "2"]):
        out = tmp_path / f"gen_{sampler[1]}"
        g = test_diffusion.main(common + [
            "--name", "ISO800_Ratio250", "--testset", "NoiseImageGenerationDataset",
            "--save_npy", "--batch_size", "4", "--iso", "800", "--ratio", "250",
            "--pretrained_dir", str(tmp_path), "--num_workers", "1",
            "--resume", str(snap / "net_final.pth"), "--save_folder", str(out), *sampler])
        files = glob.glob(os.path.join(g["out_dir"], "*.npy"))
        # the dataset may draw a clean frame twice; its patches share names
        assert 0 < len(files) <= g["generated"]
        for f in files:
            arr = np.load(f)
            assert arr.shape == (4, S, S) and arr.dtype == np.float32
            assert np.isfinite(arr).all()


@pytest.mark.parametrize("name", NETS)
def test_chip_smoke_launch_tables(name, monkeypatch):
    """chip_smoke's posemb phase holds each CLI run's launches to its
    tables: the kernel wrappers a bf16 dim-48 net calls in one evaluation,
    and in one training step on the conv_wgrad route (NOISEDIFF_WGRAD=
    pallas), counted here on the CPU, where the wrappers run their plain
    versions."""
    import chip_smoke
    from noisediff_tpu_torch.models import blocks

    calls = {}

    def counted(fn_name):
        fn = getattr(blocks, fn_name)

        def wrapper(*a, **k):
            calls[fn_name] = calls.get(fn_name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(blocks, fn_name, wrapper)

    for fn_name in ("fused_attn_tail", "fused_groupnorm_film_silu", "gn_stats", "gn_grad_stats",
                    "conv_wgrad"):
        counted(fn_name)
    monkeypatch.setenv("NOISEDIFF_WGRAD", "pallas")
    torch.manual_seed(0)
    net = getattr(others, name)(dim=48, dtype=torch.bfloat16).eval()
    x, cond = _inputs()
    x, t = torch.from_numpy(x[:1, :16, :16]), torch.tensor([10])
    cond = {k: torch.from_numpy(v[:1, :16, :16] if v.ndim == 4 else v[:1]) for k, v in cond.items()}
    with torch.no_grad():
        net(x, t, cond)
    want = {k: v for k, v in chip_smoke.posemb_per_batch(name, 1).items() if v}
    assert calls == want
    calls.clear()
    net.train()
    net(x, t, cond).float().square().mean().backward()
    step = chip_smoke.posemb_per_step(name, wgrad=True)
    # the attn_tail backward runs once for each forward call of the training step
    assert step["fused_attn_tail_bwd"] == step["fused_attn_tail"]
    want = {k: v for k, v in step.items() if v and k != "fused_attn_tail_bwd"}
    assert calls == want
