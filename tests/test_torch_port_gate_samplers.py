"""The port's samplers against the JAX package's at the learning gate's own
grid, on the CPU.

The gpu-scale gate (scripts/port_learning_gate.py SCALES["gpu"], the JAX
gate's tpu scale) scores DDIM-50 (eta 0) and DPM-Solver++(2M) at 10 steps
on the lambda grid, over T 1000 with the sigmoid2 schedule and the pred_v
objective. Here a NoiseDiffNet dim 8 at 32^2 (batch 2, seeded numpy
weights, fp32) samples from one init_noise through both packages: the
port's DDIM fused (the heads and the update in `fused_ddim_head_update`,
the CLI's default) and unfused, and its DPM-10 lambda, each against JAX
`ddim_sample` / `dpm_solver_sample` (the plain scan the JAX gate runs).
Tolerance: torch_port_util's RTOL 5e-4 with ATOL 5e-5 (PARITY.md:152) on
every element of the sample.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet

from torch_port_util import ATOL, RTOL, load_port, random_params

B, S, DIM = 2, 32, 8
T, DDIM_STEPS, DPM_STEPS = 1000, 50, 10


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, S, 4)).astype(np.float32)
    cond = {
        "clean_img": rng.uniform(0, 0.3, (B, S, S, 4)).astype(np.float32),
        "position": rng.uniform(0, 1, (B, S, S, 2)).astype(np.float32),
        "iso_ratio_idx": np.array([24, 3], np.int32),
    }
    return x, cond


@pytest.fixture(scope="module")
def samplers():
    x, cond = _inputs(0)
    jnet = JaxNet(dim=DIM)
    params = random_params(jnet, jnp.asarray(x), jnp.zeros((B,), jnp.int32),
                           {k: jnp.asarray(v) for k, v in cond.items()})
    port = load_port(NoiseDiffNet(dim=DIM), params)
    apply = jax.jit(lambda p, xx, tt, cc: jnet.apply({"params": p}, xx, tt, cc))
    jd = JaxDiffusion.create(apply, image_size=S, timesteps=T, beta_schedule="sigmoid2")
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2",
                                  device="cpu")
    assert jd.objective == pd.objective == "pred_v"
    return params, jd, pd, port


def _trunk_fn(model):
    def fn(x, t, condition):
        return (*model.trunk(x, t, condition), model.head_weights())
    return fn


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_ddim50_matches_jax_at_the_gates_grid(samplers, fused):
    params, jd, pd, port = samplers
    x, cond = _inputs(1)
    want = np.asarray(jd.ddim_sample(params, jax.random.PRNGKey(0), x.shape,
                                     {k: jnp.asarray(v) for k, v in cond.items()},
                                     sampling_timesteps=DDIM_STEPS, eta=0.0,
                                     init_noise=jnp.asarray(x)))
    with torch.no_grad():
        got = pd.ddim_sample(x.shape, {k: torch.from_numpy(v) for k, v in cond.items()},
                             sampling_timesteps=DDIM_STEPS, eta=0.0,
                             init_noise=torch.from_numpy(x),
                             trunk_fn=_trunk_fn(port) if fused else None).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the sample's spread, the quantity the gate's std reads
    np.testing.assert_allclose(got.std(), want.std(), rtol=RTOL)


def test_dpm10_lambda_matches_jax_at_the_gates_grid(samplers):
    params, jd, pd, _ = samplers
    x, cond = _inputs(2)
    want = np.asarray(jd.dpm_solver_sample(params, jax.random.PRNGKey(0), x.shape,
                                           {k: jnp.asarray(v) for k, v in cond.items()},
                                           sampling_timesteps=DPM_STEPS,
                                           init_noise=jnp.asarray(x), step_spacing="lambda"))
    with torch.no_grad():
        got = pd.dpm_solver_sample(x.shape, {k: torch.from_numpy(v) for k, v in cond.items()},
                                   sampling_timesteps=DPM_STEPS, init_noise=torch.from_numpy(x),
                                   step_spacing="lambda").numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.std(), want.std(), rtol=RTOL)
