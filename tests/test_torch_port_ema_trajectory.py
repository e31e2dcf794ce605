"""The training loop's EMA and trajectory against the JAX package's, on the
CPU, at the tiny learning gate's config (scripts/port_learning_gate.py
SCALES["tiny"]; NoiseDiffNet dim 8 where a model is stepped).

The per-step parity tests hand both sides one batch and one draw for a
step; these hold what a whole gate run adds:
  * the EMA mechanics over the tiny gate's 1,920 calls;
  * the EMA through both trainers' own `train()` loops: the tensors, call
    indices and names that reach the lerp and the snapshot, with every
    online parameter set by a known sequence in place of the Adam step;
  * 40 training steps from identical weights with identical batches and
    the JAX trainer's draws, across the EMA's copy phase into its ramp:
    parameters and EMA within TRAJ_RTOL relative L2;
  * the training batches of the gate's first, second and last epochs equal
    the JAX loader's, 12 a epoch, and the epochs differ;
  * the timestep and noise draws of the gate's 1,920 steps have the JAX
    trainer's distribution (the generators differ draw for draw);
  * a step's loss and gradients at the gpu-scale gate's width and T
    (dim 48, T 1000).
"""
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import port_learning_gate as plg  # noqa: E402
from noisediff_tpu.cli import train_diffusion as jax_cli  # noqa: E402
from noisediff_tpu.cli.common import setup_run_dirs as jax_setup  # noqa: E402
from noisediff_tpu.data.datasets import DataPaths as JaxPaths  # noqa: E402
from noisediff_tpu.data.datasets import SonyTrainDataset as JaxSony  # noqa: E402
from noisediff_tpu.data.loader import create_dataloader  # noqa: E402
from noisediff_tpu.train import ema as jax_ema  # noqa: E402
from noisediff_tpu.train.state import TrainState  # noqa: E402
from noisediff_tpu.train.state import set_learning_rate as jax_set_lr  # noqa: E402
from noisediff_tpu.train.trainer_diffusion import Trainer as JaxTrainer  # noqa: E402
from noisediff_tpu_torch.cli import train_diffusion as port_cli  # noqa: E402
from noisediff_tpu_torch.cli.common import setup_run_dirs as port_setup  # noqa: E402
from noisediff_tpu_torch.data.datasets import DataPaths, SonyTrainDataset  # noqa: E402
from noisediff_tpu_torch.data.loader import TrainLoader  # noqa: E402
from noisediff_tpu_torch.train import ema as port_ema  # noqa: E402
from noisediff_tpu_torch.train.ema import HostEma  # noqa: E402
from noisediff_tpu_torch.train.schedules import cosine_epoch_lr  # noqa: E402
from noisediff_tpu_torch.train.state import make_diffusion_train_step  # noqa: E402
from noisediff_tpu_torch.train.state import make_optimizer  # noqa: E402
from noisediff_tpu_torch.train.state import set_learning_rate  # noqa: E402
from noisediff_tpu_torch.train.trainer_diffusion import (  # noqa: E402
    _CONDITION_KEYS, Trainer, step_seed, upload_batch)
from noisediff_tpu_torch.weights import (  # noqa: E402
    jax_params_to_state_dict, load_state_dict_file)

TINY = plg.SCALES["tiny"]
# the tiny gate: 4 pairs rebalanced to 100 samples, batch 8, drop_last
STEPS_PER_EPOCH = 100 // TINY["batch"]
GATE_STEPS = TINY["epochs"] * STEPS_PER_EPOCH
# 40 steps of two fp32 implementations of one step from one state: the
# parameters drift apart by fp32 reassociation alone (~5e-6 after 200 steps
# at dim 16)
TRAJ_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def gate_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ema_traj"))
    return root, plg.build_tree(root, TINY, seed=0)


def _rel(got: dict, want: dict) -> float:
    num = sum(float(np.sum((np.asarray(got[k], np.float64) - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(np.asarray(want[k], np.float64) ** 2)) for k in want)
    return (num / den) ** 0.5


def _numpy_sd(params) -> dict:
    return {k: v.numpy() for k, v in jax_params_to_state_dict(
        jax.tree.map(np.asarray, params)).items()}


def test_host_ema_matches_jax_over_the_tiny_gates_calls():
    """GATE_STEPS calls of a drifting parameter sequence: the port's
    HostEma against the JAX HostEma's ema_apply at call index ema.step - 1."""
    rng = np.random.default_rng(1)
    base = {"a": rng.standard_normal((16, 3, 3, 4)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}

    def online(k):
        return {n: (v + np.float32(0.01 * k) * np.sin(v * (k + 1))).astype(np.float32)
                for n, v in base.items()}

    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, base),
                        opt_state=None, ema=jax_ema.EmaState.create(
                            jax.tree.map(jnp.asarray, base)))
    jhost = jax_ema.HostEma()
    live = {n: torch.from_numpy(v.copy()) for n, v in base.items()}
    phost = HostEma(live.items())
    applied = []
    for k in range(GATE_STEPS):
        new = online(k)
        jstate = jhost.maybe_apply(jstate.replace(params=jax.tree.map(jnp.asarray, new),
                                                  ema=jstate.ema.replace(step=jstate.ema.step + 1)))
        for n in live:
            live[n].copy_(torch.from_numpy(new[n]))
        if phost.maybe_apply(live.values()):
            applied.append(k)
    assert applied == list(range(0, GATE_STEPS, 20)) and phost.calls == GATE_STEPS
    assert port_ema.ema_decay(applied[-1]) == pytest.approx(
        float(jax_ema.ema_decay(jnp.asarray(applied[-1]))), rel=1e-7)
    for n, v in phost.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.ema.params[n]), rtol=1e-6,
                                   atol=1e-7)


def _trainers(root, sid, tag, epochs, dim=8):
    """Both packages' diffusion Trainers on the gate tree with the tiny
    gate's arguments (`epochs` epochs, NoiseDiffNet at `dim`), the port's
    model, Adam and EMA rebuilt from the JAX trainer's initial parameters."""
    cfg = dict(TINY, epochs=epochs, dim=dim)
    argv = plg.train_diffusion_argv(cfg, os.path.join(root, tag), sid, "cpu")
    i = argv.index("--device")
    jargs = jax_cli.build_parser().parse_args(argv[:i] + argv[i + 2:])
    pargs = port_cli.build_parser().parse_args(argv)
    pargs.save_folder += "_port"
    jax_setup(jargs, with_logger=False)
    port_setup(pargs, with_logger=False)
    jt, pt = JaxTrainer(jargs), Trainer(pargs)
    pt.model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                              _numpy_sd(jt.state.params).items()}, strict=True)
    pt.optimizer = make_optimizer(pt.model.parameters(), lr=pargs.lr)
    pt.ema = HostEma(pt.model.named_parameters())
    pt.train_step = make_diffusion_train_step(pt.diffusion, pt.optimizer, "noise")
    return jt, pt


def _start_ema_at(jt, pt, calls: int) -> None:
    jt.state = jt.state.replace(ema=jt.state.ema.replace(step=jnp.asarray(calls, jnp.int32)))
    jt.ema_host.reset(calls)
    pt.ema.calls = calls


@pytest.fixture
def _quiet_root_logger():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in [h for h in root.handlers if h not in handlers]:
        root.removeHandler(h)
        h.close()
    root.setLevel(level)


def test_trainer_ema_is_the_jax_trainers(gate_tree, _quiet_root_logger):
    """Both trainers' own train() over 2 epochs (24 steps) with the EMA's
    call counter at 497 (the copy at 500, the ramp's first lerp at 520), each
    step setting every online parameter to the k-th set of a known
    sequence: the port's EMA, in memory and in ema_final.pth by name,
    equals the JAX trainer's."""
    root, sid = gate_tree
    jt, pt = _trainers(root, sid, "ema_loop", epochs=2)
    base = jax.tree.map(np.asarray, jt.state.params)
    base_sd = _numpy_sd(base)

    def online(v, k):
        return (v + np.float32(0.01 * (k + 1)) * np.sin(v * (k + 2))).astype(np.float32)

    def jax_step(state, batch, rng):
        k = int(state.step)
        params = jax.tree.map(lambda v: jnp.asarray(online(v, k)), base)
        return state.replace(step=state.step + 1, params=params,
                             ema=state.ema.replace(step=state.ema.step + 1)), {
            "diffusion_loss": jnp.zeros(())}

    port_steps = []

    @torch.no_grad()
    def port_step(batch, generator, draws=None):
        k = len(port_steps)
        port_steps.append(k)
        for name, p in pt.model.named_parameters():
            p.copy_(torch.from_numpy(online(base_sd[name], k)))
        return {"diffusion_loss": torch.zeros(()), "grad_norm": torch.zeros(())}

    jt.train_step, pt.train_step = jax_step, port_step
    _start_ema_at(jt, pt, 497)
    jt.train()
    summary = pt.train()
    assert summary["steps"] == len(port_steps) == int(jt.state.step) == 2 * STEPS_PER_EPOCH
    assert pt.ema.calls == int(jt.state.ema.step) == 497 + 2 * STEPS_PER_EPOCH
    want = _numpy_sd(jt.state.ema.params)
    got = {k: v.numpy() for k, v in pt.ema.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    saved = load_state_dict_file(os.path.join(pt.args.snapshot_save_dir, "ema_final.pth"))
    for k in want:
        np.testing.assert_array_equal(saved[k].numpy(), got[k], err_msg=k)
    # the EMA is not the last online set: the ramp's lerp at 520 averaged
    last = {k: online(v, 2 * STEPS_PER_EPOCH - 1) for k, v in base_sd.items()}
    assert _rel(got, last) > 1e-3


def _lockstep(jt, pt, steps: int):
    """`steps` steps of both trainers' own train steps and EMAs on the JAX
    loader's batches, with the JAX trainer's draws (t from fold_in(key, 0),
    the noise from fold_in(key, 1), key = fold_in(fold_in(seed key, 1),
    step)) handed to the port, under the gate's per-epoch LR. Returns each
    step's (port, JAX) loss."""
    rng_train = jax.random.fold_in(jt.rng, 1)
    params = list(pt.model.parameters())
    keys = _CONDITION_KEYS + ("noise",)
    max_iter = jt.args.max_iter
    step, epoch, losses = 0, 0, []
    while step < steps:
        lr = cosine_epoch_lr(jt.args.lr, max_iter, epoch)
        jt.state = jt.state.replace(opt_state=jax_set_lr(jt.state.opt_state, lr))
        set_learning_rate(pt.optimizer, lr)
        jt.train_dataloader.set_epoch(epoch)
        for batch in jt.train_dataloader:
            if step == steps:
                break
            key = jax.random.fold_in(rng_train, step)
            b = batch["noise"].shape[0]
            t = jax.random.randint(jax.random.fold_in(key, 0), (b,), 0, jt.diffusion.num_timesteps)
            noise = jax.random.normal(jax.random.fold_in(key, 1), batch["noise"].shape)
            jt.state, jm = jt.train_step(jt.state, jt._prepare(batch), rng_train)
            jt.state = jt.ema_host.maybe_apply(jt.state)
            pm = pt.train_step(upload_batch(batch, keys, pt.device), None, draws=(
                torch.from_numpy(np.asarray(t)).long(), torch.from_numpy(np.asarray(noise))))
            pt.ema.maybe_apply(params)
            losses.append((float(pm["diffusion_loss"]), float(jm["diffusion_loss"])))
            step += 1
        epoch += 1
    return losses


def test_identical_inputs_track_jax_through_the_ema_window(gate_tree, _quiet_root_logger):
    """From identical weights, 40 steps of both trainers' own steps with
    identical batches and draws (`_lockstep`), the EMA counters at 481: the
    copy at 500, the ramp's first lerp at 520. Losses, parameters and EMA
    stay within TRAJ_RTOL."""
    root, sid = gate_tree
    jt, pt = _trainers(root, sid, "identical", epochs=TINY["epochs"])
    _start_ema_at(jt, pt, 481)
    got_l, want_l = np.array(_lockstep(jt, pt, 40)).T
    np.testing.assert_allclose(got_l, want_l, rtol=TRAJ_RTOL)
    want_p, want_e = _numpy_sd(jt.state.params), _numpy_sd(jt.state.ema.params)
    got_p = {k: v.detach().numpy() for k, v in pt.model.named_parameters()}
    got_e = {k: v.numpy() for k, v in pt.ema.state_dict().items()}
    assert pt.ema.calls == int(jt.state.ema.step) == 521
    assert _rel(got_p, want_p) < TRAJ_RTOL
    assert _rel(got_e, want_e) < TRAJ_RTOL
    # the window was crossed: the EMA lerped at 520 and is not the online set
    assert _rel(want_e, want_p) > 1e-3


@pytest.mark.slow
def test_tiny_gates_ema_models_score_alike_from_identical_draws(gate_tree, _quiet_root_logger):
    """The tiny gate's whole diffusion stage (1,920 steps, dim 16) on tree
    0 through both trainers' steps from identical weights, batches and
    draws (`_lockstep`); each ema_final and net_final scored through the
    port's generation CLI (DDIM-16) and eval_kld: the port's within 1.25x
    of the JAX package's. Held so, the draws alone are left to move one
    gate's EMA KLD (0.44-0.81 across trees and seeds at this scale)."""
    root, sid = gate_tree
    jt, pt = _trainers(root, sid, "whole", epochs=TINY["epochs"], dim=TINY["dim"])
    _lockstep(jt, pt, GATE_STEPS)
    assert pt.ema.calls == int(jt.state.ema.step) == GATE_STEPS
    out = os.path.join(root, "whole_scored")
    os.makedirs(out, exist_ok=True)
    scores = {}
    for name, sd in (("port_ema", pt.ema.state_dict()),
                     ("port_net", {k: v.detach() for k, v in pt.model.named_parameters()}),
                     ("jax_ema", _numpy_sd(jt.state.ema.params)),
                     ("jax_net", _numpy_sd(jt.state.params))):
        path = os.path.join(out, f"{name}.pth")
        torch.save({k: torch.as_tensor(v).clone() for k, v in sd.items()}, path)
        gen = plg.run_generation(TINY, root, sid, f"gen_{name}", path, "cpu")
        scores[name] = plg.run_kld(root, sid, gen)["kld_symmetric"]
    print("tiny gate from identical draws, KLD:", scores)
    for kind in ("ema", "net"):
        ratio = scores[f"port_{kind}"] / scores[f"jax_{kind}"]
        assert 1 / 1.25 <= ratio <= 1.25, scores


def test_gate_width_step_gradients_match_jax():
    """The loss and every parameter gradient at the gpu-scale gate's width
    and diffusion length (NoiseDiffNet dim 48, T 1000, sigmoid2; 32^2,
    batch 2, fp32) from the JAX trainer's initial parameters and the JAX
    loss's draws: the per-step tests' bounds (the loss within 5e-4, each
    gradient within 2e-3 relative L2) at the width the gate trains."""
    from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
    from noisediff_tpu.models import NoiseDiffNet as JaxNet
    from noisediff_tpu.models.blocks import gn_train_trace
    from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter

    b, s, dim, T = 2, 32, plg.SCALES["gpu"]["dim"], plg.SCALES["gpu"]["T"]
    rng = np.random.default_rng(1)
    img = (0.05 * rng.standard_normal((b, s, s, 4))).astype(np.float32)
    cond = {"clean_img": rng.uniform(0, 0.3, (b, s, s, 4)).astype(np.float32),
            "position": rng.uniform(0, 1, (b, s, s, 2)).astype(np.float32),
            "iso_ratio_idx": np.array([24, 3], np.int32)}
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    jnet = JaxNet(dim=dim)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3), jnp.asarray(img),
                                jnp.zeros((b,), jnp.int32), jcond)["params"]
    jd = JaxDiffusion.create(lambda p, x, t, c: jnet.apply({"params": p}, x, t, c),
                             image_size=s, timesteps=T, beta_schedule="sigmoid2")
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        with gn_train_trace():
            return jd.loss(p, key, jnp.asarray(img), jcond)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    t = np.array(jax.random.randint(jax.random.fold_in(key, 0), (b,), 0, T))
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), img.shape, jnp.float32))
    port = NoiseDiffNet(dim=dim)
    port.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in _numpy_sd(params).items()},
                         strict=True)
    pd = GaussianDiffusion.create(port.train(), image_size=s, timesteps=T,
                                  beta_schedule="sigmoid2", device="cpu")
    loss = pd.loss(torch.from_numpy(img), {k: torch.from_numpy(v) for k, v in cond.items()},
                   t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=5e-4)
    want = _numpy_sd(want_grads)
    worst = {}
    for name, p in port.named_parameters():
        if is_unread_parameter(name):
            assert p.grad is None and not np.any(want[name]), name
            continue
        worst[name] = _rel({0: p.grad.numpy()}, {0: want[name]})
    assert len(worst) > 300 and not {k: v for k, v in worst.items() if v > 2e-3}


def test_gate_batches_equal_jax_over_epochs(gate_tree):
    """The tiny gate's loader (seed 0, batch 8): the first, second and last
    epochs batch for batch equal the JAX loader's, 12 batches an epoch,
    and two epochs differ in order and crops."""
    _, sid = gate_tree
    jds = JaxSony(JaxPaths(data_folder=sid), TINY["crop"], seed=0)
    pds = SonyTrainDataset(DataPaths(data_folder=sid), TINY["crop"], seed=0)
    jl = create_dataloader(jds, phase="train", batch_size=TINY["batch"], num_workers=1, seed=0)
    pl = TrainLoader(pds, batch_size=TINY["batch"], num_workers=1, seed=0)
    assert len(pds) == len(jds) == 100
    epochs = {}
    for epoch in (0, 1, TINY["epochs"] - 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(pl) == STEPS_PER_EPOCH
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
        epochs[epoch] = got
    coords = {e: np.concatenate([b["coord"] for b in bs]) for e, bs in epochs.items()}
    assert not np.array_equal(coords[0], coords[1])
    assert all(0.0 <= c.min() and c.max() <= 1.0 for c in coords.values())
    assert {int(i) for bs in epochs.values() for b in bs for i in b["iso_ratio_idx"]} == {
        int(epochs[0][0]["iso_ratio_idx"][0])}


def test_gate_draws_have_the_jax_trainers_distribution():
    """The timesteps and noise the port's step draws over the tiny gate's
    GATE_STEPS steps (its generator seeded by step_seed, t first) beside
    the JAX trainer's (fold_in of the step into fold_in(key, 1)): each
    side's t is uniform over [0, T) and its noise standard normal, and the
    two t histograms agree (two-sample chi-square, 63 degrees of freedom)."""
    b, shape, T = TINY["batch"], (TINY["batch"], TINY["crop"], TINY["crop"], 4), TINY["T"]

    class Recorder:
        num_timesteps, draws = T, []

        def loss(self, img, condition, t, noise):
            self.draws.append((t.clone(), noise.clone()))
            return (w * 0.0).sum()

    w = torch.nn.Parameter(torch.zeros(1))
    rec = Recorder()
    step = make_diffusion_train_step(rec, make_optimizer([w], lr=0.0))
    batch = {"noise": torch.zeros(shape), "clean_img": torch.zeros(shape),
             "iso_ratio_idx": torch.zeros(b, dtype=torch.int32),
             "coord": torch.zeros(shape[:3] + (2,))}
    gen = torch.Generator()
    for k in range(GATE_STEPS):
        gen.manual_seed(step_seed(0, k))
        step(batch, gen)
    pt = torch.cat([t for t, _ in rec.draws]).numpy()
    pn = torch.cat([n.ravel() for _, n in rec.draws]).numpy().astype(np.float64)

    rng_train = jax.random.fold_in(jax.random.PRNGKey(0), 1)

    @jax.jit
    def jax_draws(k):
        key = jax.random.fold_in(rng_train, k)
        return (jax.random.randint(jax.random.fold_in(key, 0), (b,), 0, T),
                jax.random.normal(jax.random.fold_in(key, 1), shape, jnp.float32))

    jt_, jn_ = jax.vmap(jax_draws)(jnp.arange(GATE_STEPS))
    jt, jn = np.asarray(jt_).ravel(), np.asarray(jn_).ravel().astype(np.float64)

    n = GATE_STEPS * b
    expected = n / T
    hp, hj = np.bincount(pt, minlength=T), np.bincount(jt, minlength=T)
    assert len(hp) == len(hj) == T and pt.min() >= 0 and jt.min() >= 0
    # chi-square at 63 degrees of freedom: 63 on average, 106 at p = 1e-3
    assert ((hp - expected) ** 2 / expected).sum() < 106
    assert ((hj - expected) ** 2 / expected).sum() < 106
    assert ((hp - hj) ** 2 / (hp + hj)).sum() < 106
    for x in (pn, jn):
        m = x.size
        assert abs(x.mean()) < 5 / np.sqrt(m)
        assert abs(x.std() - 1.0) < 5 / np.sqrt(2 * m)
        assert abs(((x - x.mean()) ** 4).mean() / x.var() ** 2 - 3.0) < 5 * np.sqrt(24 / m)
