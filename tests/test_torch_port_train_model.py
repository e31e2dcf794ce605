"""The port's training path against the JAX package, on the CPU: the
loss and every parameter gradient of NoiseDiffNet, one Adam step, the EMA
and the LR schedule.

The whole-model test compiles one JAX value_and_grad of the JAX `loss`
(NoiseDiffNet dim 16, 32^2, batch 2, fp32, under gn_train_trace on the
XLA path) and hands its timesteps and noise (the draws the JAX loss makes
from its key) to the port, whose parameters come through
weights.jax_params_to_state_dict. Tolerances: the loss at the port's fp32
bound (rtol 5e-4, PARITY.md:152); each gradient within 2e-3 relative L2 of
JAX's, since it accumulates fp32 reassociation through ~60 layers of the
backward on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.models.blocks import gn_train_trace
from noisediff_tpu.train import ema as jax_ema
from noisediff_tpu.train import schedules as jax_sched
from noisediff_tpu.train.state import TrainState, make_optimizer as jax_make_optimizer
from noisediff_tpu.train.state import set_learning_rate as jax_set_lr
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter
from noisediff_tpu_torch.train import ema as port_ema
from noisediff_tpu_torch.train.schedules import cosine_epoch_lr
from noisediff_tpu_torch.train.state import make_optimizer, set_learning_rate
from noisediff_tpu_torch.weights import adam_state_from_jax, jax_params_to_state_dict

from torch_port_util import RTOL, load_port, random_params

B, S, DIM = 2, 32, 16
T = 1000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several test workers on one CPU; torch's own
    thread pool in each of them oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    img = (0.05 * rng.standard_normal((B, S, S, 4))).astype(np.float32)
    cond = {
        "clean_img": rng.uniform(0, 0.3, (B, S, S, 4)).astype(np.float32),
        "position": rng.uniform(0, 1, (B, S, S, 2)).astype(np.float32),
        "iso_ratio_idx": np.array([24, 3], np.int32),
    }
    return img, cond


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def test_loss_and_gradients_match_jax():
    jnet = JaxNet(dim=DIM)
    img, cond = _batch()
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    params = random_params(jnet, jnp.asarray(img), jnp.zeros((B,), jnp.int32), jcond, seed=3)
    jd = JaxDiffusion.create(lambda p, x, t, c: jnet.apply({"params": p}, x, t, c),
                             image_size=S, timesteps=T, beta_schedule="sigmoid2")
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        with gn_train_trace():
            return jd.loss(p, key, jnp.asarray(img), jcond)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    # the draws the JAX loss makes from its key: t from fold_in(key, 0),
    # the noise (in p_losses) from fold_in(key, 1)
    t = np.array(jax.random.randint(jax.random.fold_in(key, 0), (B,), 0, T))
    noise = np.array(jax.random.normal(jax.random.fold_in(key, 1), img.shape, jnp.float32))

    port = load_port(NoiseDiffNet(dim=DIM), params).train()
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2")
    loss = pd.loss(torch.from_numpy(img), {k: torch.from_numpy(v) for k, v in cond.items()},
                   t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)

    want = jax_params_to_state_dict(jax.tree.map(np.asarray, want_grads))
    got = dict(port.named_parameters())
    assert want.keys() == got.keys()
    worst = {}
    for name, w in want.items():
        g = got[name].grad
        if is_unread_parameter(name):
            assert g is None and not np.any(w.numpy()), name
            continue
        assert g is not None and torch.isfinite(g).all(), name
        worst[name] = _rel_l2(g.numpy(), w.numpy())
    bad = {k: v for k, v in worst.items() if v > 2e-3}
    assert not bad, bad


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_p_losses_objectives_match_jax(objective):
    """p_losses of each objective (target, loss weight, the pred_x0
    intensity term) with the same stand-in model on both sides."""
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.array([0, 321, 999], np.int32)
    key = jax.random.PRNGKey(2)
    jnoise = np.array(jax.random.normal(jax.random.fold_in(key, 1), x0.shape, jnp.float32))
    jd = JaxDiffusion.create(lambda p, x, tt, c: 0.7 * x + 0.1, image_size=4, timesteps=T,
                             beta_schedule="sigmoid2", objective=objective)
    want = float(jd.p_losses(None, key, jnp.asarray(x0), jnp.asarray(t)))
    pd = GaussianDiffusion.create(lambda x, tt, c: 0.7 * x + 0.1, image_size=4, timesteps=T,
                                  beta_schedule="sigmoid2", objective=objective)
    got = float(pd.p_losses(torch.from_numpy(x0), torch.from_numpy(t).long(),
                            noise=torch.from_numpy(jnoise)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the default noise comes from the caller's generator
    a = pd.p_losses(torch.from_numpy(x0), torch.from_numpy(t).long(),
                    generator=torch.Generator().manual_seed(1))
    b = pd.p_losses(torch.from_numpy(x0), torch.from_numpy(t).long(),
                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not np.isclose(float(a), float(
        pd.p_losses(torch.from_numpy(x0), torch.from_numpy(t).long(),
                    noise=torch.from_numpy(noise))))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_adam_step_matches_optax(weight_decay):
    """One Adam step from the same parameters, moments and count, the
    moments carried across by weights.adam_state_from_jax."""
    jnet = JaxNet(dim=8)
    x = jnp.zeros((1, 16, 16, 4))
    cond = {"clean_img": x, "position": jnp.zeros((1, 16, 16, 2)),
            "iso_ratio_idx": jnp.zeros((1,), jnp.int32)}
    params = random_params(jnet, x, jnp.zeros((1,), jnp.int32), cond, seed=11)
    rng = np.random.default_rng(12)
    mu = jax.tree.map(lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32), params)
    nu = jax.tree.map(lambda p: (1e-4 * rng.uniform(0.1, 1, p.shape)).astype(np.float32), params)
    grads = jax.tree.map(lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32),
                         params)
    count, lr = 7, 3e-4

    tx = jax_make_optimizer(weight_decay)
    state = jax_set_lr(tx.init(params), lr)
    adam = next(i for i, s in enumerate(state.inner_state) if hasattr(s, "mu"))
    inner = list(state.inner_state)
    inner[adam] = inner[adam]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu)
    state = state._replace(inner_state=tuple(inner))
    new_params = jax.jit(lambda g, st, p: optax.apply_updates(p, tx.update(g, st, p)[0]))(
        grads, state, params)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, new_params))

    port = load_port(NoiseDiffNet(dim=8), params)
    opt = make_optimizer(port.parameters(), lr=1.0, weight_decay=weight_decay)
    set_learning_rate(opt, lr)
    opt.load_state_dict(adam_state_from_jax(mu, nu, count, opt, port))
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    g_sd = jax_params_to_state_dict(grads)
    for name, p in port.named_parameters():
        p.grad = g_sd[name].clone()
    opt.step()
    # each delta is a difference of fp32 parameters, so besides rtol 1e-4 it
    # carries the rounding of both updated values: two ulps of the parameter
    for name, p in port.named_parameters():
        b = before[name].numpy()
        got, ref = p.detach().numpy() - b, want[name].numpy() - b
        tol = 1e-4 * np.abs(ref) + 2 * np.spacing(np.abs(b).astype(np.float32))
        assert np.all(np.abs(got - ref) <= tol), (name, float(np.abs(got - ref).max()))


def test_ema_decay_and_lr_equal_jax():
    for step in list(range(0, 700)) + [1000, 5000, 10 ** 5]:
        np.testing.assert_allclose(port_ema.ema_decay(step),
                                   float(jax_ema.ema_decay(jnp.asarray(step))), rtol=1e-6,
                                   err_msg=str(step))
    for max_iter in (1, 7, 500):
        for epoch in range(max_iter + 1):
            assert cosine_epoch_lr(1e-4, max_iter, epoch) == \
                jax_sched.cosine_epoch_lr(1e-4, max_iter, epoch)


def test_host_ema_matches_jax_over_1000_calls():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": (7,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, init),
                        opt_state=None, ema=jax_ema.EmaState.create(
                            jax.tree.map(jnp.asarray, init)))
    jhost = jax_ema.HostEma()
    online = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    phost = port_ema.HostEma(online.items())
    for _ in range(1000):
        new = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jstate = jstate.replace(params=jax.tree.map(jnp.asarray, new),
                                ema=jstate.ema.replace(step=jstate.ema.step + 1))
        jstate = jhost.maybe_apply(jstate)
        for k in online:
            online[k].copy_(torch.from_numpy(new[k]))
        phost.maybe_apply(online.values())
    assert phost.calls == int(jstate.ema.step) == 1000
    for k, v in phost.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.ema.params[k]), rtol=1e-6,
                                   atol=1e-7)
