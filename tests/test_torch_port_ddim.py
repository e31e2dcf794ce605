"""The port's DDIM fused tail against the JAX package, on the CPU.

`fused_ddim_head_update` runs its plain version for CPU tensors; it is held
against the JAX Pallas kernel in interpret mode
(ops/pallas/ddim_head.fused_ddim_head_update), and the fused DDIM sampler
(a NoiseDiffNet dim 8, 32^2, batch 2, 4 steps, seeded numpy weights and
init noise) against JAX `ddim_sample` with `trunk_apply_fn` and
`fused_mode="pallas", fused_interpret=True`, and against the port's own
unfused DDIM. fp32 throughout: rtol 5e-4 (PARITY.md:152) with an absolute
floor for values near zero (torch_port_util.ATOL).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.ops.pallas import ddim_head as jax_ddim
from noisediff_tpu_torch.diffusion import gaussian as port_gaussian
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet
from noisediff_tpu_torch.ops.kernels import (
    ddim_step_scalars, fused_ddim_head_update, reference_ddim_head_update)
from noisediff_tpu_torch.train.trainer_diffusion import Trainer

from torch_port_util import ATOL, RTOL, load_port, random_params

B, S, DIM = 2, 32, 8
T = 1000
STEPS = 4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_step_scalars_equal_jax():
    ac = np.linspace(0.999, 1e-4, 7).astype(np.float32)
    an = np.concatenate([ac[1:], [1.0]]).astype(np.float32)
    sig = np.linspace(0.0, 0.3, 7).astype(np.float32)
    c = np.sqrt(np.maximum(1 - an - sig ** 2, 0)).astype(np.float32)
    want = np.asarray(jax_ddim.ddim_step_scalars(jnp.asarray(ac), jnp.asarray(an),
                                                 jnp.asarray(sig), jnp.asarray(c)))
    got = ddim_step_scalars(ac, an, sig, c)
    # the JAX vector's eighth slot is the TPU layout's zero pad
    assert got.dtype == np.float32 and got.shape == (7, 7) and want.shape == (7, 8)
    np.testing.assert_array_equal(want[:, 7], 0)
    np.testing.assert_allclose(got, want[:, :7], rtol=1e-6)
    np.testing.assert_array_equal(ddim_step_scalars(ac[2], an[2], sig[2], c[2]), got[2])


def _head_inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    maps = [rng.standard_normal((2, 4, 8, c)).astype(np.float32) for _ in range(3)]
    xt = rng.standard_normal((2, 4, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 4, 8, 4)).astype(np.float32)
    # JAX layout (in, out) kernels
    p = [rng.standard_normal((c, c)) / np.sqrt(c), 0.1 * rng.standard_normal(c),
         rng.standard_normal((c, 4)) / np.sqrt(c), 0.1 * rng.standard_normal(4),
         rng.standard_normal((c, 4)) / np.sqrt(c), 0.1 * rng.standard_normal(4)]
    return maps, xt, noise, [np.asarray(v, np.float32) for v in p]


@pytest.mark.parametrize("c", [16, 48])
@pytest.mark.parametrize("sigma", [0.0, 0.2])
def test_plain_update_matches_jax_kernel(c, sigma):
    maps, xt, noise, p = _head_inputs(c)
    step = (0.37, 0.52, sigma, np.sqrt(1 - 0.52 - sigma ** 2))
    scal = ddim_step_scalars(*step)
    jscal = jax_ddim.ddim_step_scalars(*map(jnp.float32, step))
    jargs = [jnp.asarray(a) for a in maps + [xt, noise] + p]
    want = np.asarray(jax_ddim.fused_ddim_head_update(*jargs, jscal, interpret=True))
    want_ref = np.asarray(jax_ddim.reference_ddim_head_update(*jargs, jscal))
    tp = [_t(p[0].T), _t(p[1]), _t(p[2].T), _t(p[3]), _t(p[4].T), _t(p[5])]
    # sigma = 0 draws no noise: the port passes None
    got = fused_ddim_head_update(*map(_t, maps), _t(xt), _t(noise) if sigma else None, *tp, scal)
    assert got.dtype == torch.float32 and got.shape == xt.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)
    if not sigma:  # no noise is exactly zero noise
        zero = reference_ddim_head_update(*map(_t, maps), _t(xt), torch.zeros(xt.shape), *tp,
                                          scal)
        np.testing.assert_array_equal(got.numpy(), zero.numpy())


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, S, 4)).astype(np.float32)
    cond = {
        "clean_img": rng.uniform(0, 0.3, (B, S, S, 4)).astype(np.float32),
        "position": rng.uniform(0, 1, (B, S, S, 2)).astype(np.float32),
        "iso_ratio_idx": np.array([24, 3], np.int32),
    }
    return x, cond


@pytest.fixture(scope="module")
def models():
    x, cond = _inputs()
    jnet = JaxNet(dim=DIM)
    params = random_params(jnet, jnp.asarray(x), jnp.zeros((B,), jnp.int32),
                           {k: jnp.asarray(v) for k, v in cond.items()})
    port = load_port(NoiseDiffNet(dim=DIM), params)
    return jnet, params, port


def _trunk_fn(model):
    def fn(x, t, condition):
        return (*model.trunk(x, t, condition), model.head_weights())
    return fn


def test_fused_ddim_matches_jax_and_unfused(models):
    jnet, params, port = models
    x, cond = _inputs()
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    trunk = jnet.clone(trunk_only=True)
    apply = jax.jit(lambda p, xx, tt, cc: jnet.apply({"params": p}, xx, tt, cc))
    jd = JaxDiffusion.create(lambda p, xx, tt, cc: apply(p, xx, tt, cc), image_size=S,
                             timesteps=T, beta_schedule="sigmoid2")
    want = np.asarray(jd.ddim_sample(
        params, jax.random.PRNGKey(0), x.shape, jcond, sampling_timesteps=STEPS, eta=0.0,
        init_noise=jnp.asarray(x),
        trunk_apply_fn=lambda p, xx, tt, cc: trunk.apply({"params": p}, xx, tt, cc),
        fused_mode="pallas", fused_interpret=True))

    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  device="cpu")
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    got = pd.ddim_sample(x.shape, tcond, sampling_timesteps=STEPS, eta=0.0,
                         init_noise=torch.from_numpy(x), trunk_fn=_trunk_fn(port))
    unfused = pd.ddim_sample(x.shape, tcond, sampling_timesteps=STEPS, eta=0.0,
                             init_noise=torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=RTOL, atol=ATOL)


def test_fused_ddim_with_eta_draws_as_the_unfused(models):
    """eta > 0: both branches draw each step's noise from the run's
    generator in the same order, so the same seed gives the same sample."""
    _, _, port = models
    x, cond = _inputs(4)
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  ddim_sampling_eta=1.0, device="cpu")
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    got, unfused = (pd.ddim_sample(x.shape, tcond, sampling_timesteps=3,
                                   generator=torch.Generator().manual_seed(9), trunk_fn=fn)
                    for fn in (_trunk_fn(port), None))
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
def test_fused_ddim_is_pred_v_only(models, objective):
    _, _, port = models
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  objective=objective, device="cpu")
    with pytest.raises(ValueError, match="pred_v"):
        pd.ddim_sample((B, S, S, 4), None, sampling_timesteps=2, trunk_fn=_trunk_fn(port))


@pytest.mark.parametrize("objective,fused", [("pred_v", True), ("pred_noise", False)])
def test_trainer_sampler_takes_the_fused_tail(models, monkeypatch, objective, fused):
    """Trainer.sampler's DDIM runs the fused tail whenever the model has a
    trunk and the objective is pred_v (on the CPU its plain version)."""
    _, _, port = models
    calls = []

    def counting(real):
        def fn(*args):
            calls.append(1)
            return real(*args)
        return fn

    # the fp32 model's head runs the plain tail; a bf16 one the kernel's wrapper
    for name in ("fused_ddim_head_update", "reference_ddim_head_update"):
        monkeypatch.setattr(port_gaussian, name, counting(getattr(port_gaussian, name)))
    trainer = Trainer.__new__(Trainer)
    trainer.model = port
    trainer.args = argparse.Namespace(crop_size=S, sampler="ddim")
    trainer.diffusion = GaussianDiffusion.create(port, image_size=S, timesteps=T,
                                                 beta_schedule="sigmoid2", objective=objective,
                                                 sampling_timesteps=2, device="cpu")
    x, cond = _inputs()
    out = trainer.sampler(B)({k: torch.from_numpy(v) for k, v in cond.items()},
                             torch.Generator().manual_seed(0))
    assert out.shape == (B, S, S, 4) and torch.isfinite(out).all()
    assert len(calls) == (2 if fused else 0)
