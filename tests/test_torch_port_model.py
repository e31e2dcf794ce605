"""The port's NoiseDiffNet and samplers against the JAX package, on the CPU.

One small model (dim 16, crop 16, batch 2) with seeded numpy weights goes
to both sides, the port's through the weight bridge; the JAX model runs
unfolded on the CPU (its XLA path), the port's through its kernels' plain
versions. fp32 throughout: rtol 5e-4 (PARITY.md:152), with an absolute
floor for values near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.diffusion.gaussian import _dpm_step_grid as jax_grid
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.ops.schedules import SCHEDULE_NAMES
from noisediff_tpu.ops.schedules import make_schedule as jax_make_schedule
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion, _dpm_step_grid
from noisediff_tpu_torch.models import NoiseDiffNet
from noisediff_tpu_torch.ops.schedules import make_schedule

from torch_port_util import ATOL, RTOL, load_port, random_params

B, S, DIM = 2, 16, 16
T = 1000


def _inputs(seed=1):
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
    jnet = JaxNet(dim=DIM)
    x, cond = _inputs()
    params = random_params(jnet, jnp.asarray(x), jnp.zeros((B,), jnp.int32),
                           {k: jnp.asarray(v) for k, v in cond.items()})
    port = load_port(NoiseDiffNet(dim=DIM), params)
    apply = jax.jit(lambda p, xx, tt, cc: jnet.apply({"params": p}, xx, tt, cc))
    return jnet, params, apply, port


def _torch_cond(cond):
    return {k: torch.from_numpy(v) for k, v in cond.items()}


def test_forward_matches_jax(models):
    _, params, apply, port = models
    x, cond = _inputs()
    t = np.array([999, 37], np.int32)
    want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t),
                            {k: jnp.asarray(v) for k, v in cond.items()}))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t).long(), _torch_cond(cond)).numpy()
    assert got.shape == (B, S, S, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_forward_bf16_runs_close_to_fp32(models):
    """The bf16 compute path on the CPU: finite, model-dtype output within
    bf16 rounding of the fp32 forward (a smoke check, not a parity bound)."""
    _, _, _, port = models
    x, cond = _inputs()
    bf = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16).eval()
    bf.load_state_dict(port.state_dict())
    t = torch.tensor([500, 3])
    with torch.no_grad():
        ref = port(torch.from_numpy(x), t, _torch_cond(cond))
        got = bf(torch.from_numpy(x), t, _torch_cond(cond))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    rel = (got.float() - ref).norm() / ref.norm()
    assert rel < 5e-2, float(rel)


def _samplers(models, steps):
    _, params, apply, port = models
    jd = JaxDiffusion.create(lambda p, xx, tt, cc: apply(p, xx, tt, cc), image_size=S,
                             timesteps=T, beta_schedule="sigmoid2")
    pd = GaussianDiffusion.create(port, image_size=S, timesteps=T, beta_schedule="sigmoid2")
    return params, jd, pd


@pytest.mark.parametrize("spacing", ["lambda", "time"])
def test_dpm_sample_matches_jax(models, spacing):
    params, jd, pd = _samplers(models, 3)
    x, cond = _inputs(2)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    want = np.asarray(jd.dpm_solver_sample(params, jax.random.PRNGKey(0), x.shape, jcond,
                                           sampling_timesteps=3, init_noise=jnp.asarray(x),
                                           step_spacing=spacing))
    got = pd.dpm_solver_sample(x.shape, _torch_cond(cond), sampling_timesteps=3,
                               init_noise=torch.from_numpy(x), step_spacing=spacing).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ddim_eta0_sample_matches_jax(models):
    params, jd, pd = _samplers(models, 2)
    x, cond = _inputs(3)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    want = np.asarray(jd.ddim_sample(params, jax.random.PRNGKey(0), x.shape, jcond,
                                     sampling_timesteps=2, eta=0.0,
                                     init_noise=jnp.asarray(x)))
    got = pd.ddim_sample(x.shape, _torch_cond(cond), sampling_timesteps=2, eta=0.0,
                         init_noise=torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ddim_eta_and_ddpm_sample_shapes():
    """The stochastic samplers draw from a torch.Generator: finite, the
    right shape, and reproducible from the same seed."""
    def model(x, t, c):
        return 0.5 * x

    pd = GaussianDiffusion.create(model, image_size=4, timesteps=20, beta_schedule="cosine",
                                  ddim_sampling_eta=1.0)
    shape = (2, 4, 4, 4)
    for fn in (lambda g: pd.ddim_sample(shape, None, sampling_timesteps=3, generator=g),
               lambda g: pd.p_sample_loop(shape, None, generator=g)):
        a = fn(torch.Generator().manual_seed(5))
        b = fn(torch.Generator().manual_seed(5))
        assert a.shape == shape and torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", SCHEDULE_NAMES)
def test_schedule_buffers_equal_jax(name):
    js, ps = jax_make_schedule(name, T), make_schedule(name, T)
    for field in ps.__dataclass_fields__:
        want, got = getattr(js, field), getattr(ps, field)
        if field == "num_timesteps":
            assert got == want
        else:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=field)


@pytest.mark.parametrize("name", SCHEDULE_NAMES)
@pytest.mark.parametrize("spacing", ["lambda", "time"])
@pytest.mark.parametrize("steps", [1, 3, 10, 50])
def test_dpm_step_grid_equals_jax(name, spacing, steps):
    ac = np.asarray(jax_make_schedule(name, T).alphas_cumprod, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = jax_grid(ac, steps, spacing)
    if spacing == "lambda" and not np.all(ac > 0):
        with pytest.raises(ValueError):
            _dpm_step_grid(ac, steps, spacing)
        return
    assert _dpm_step_grid(ac, steps, spacing) == want


def test_q_posterior_matches_jax():
    jd = JaxDiffusion.create(lambda *a: None, image_size=4, timesteps=T, beta_schedule="sigmoid2")
    pd = GaussianDiffusion.create(lambda *a: None, image_size=4, timesteps=T,
                                  beta_schedule="sigmoid2")
    rng = np.random.default_rng(4)
    x0, xt = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 17, 999], np.int32)
    want = jd.q_posterior(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(t))
    got = pd.q_posterior(torch.from_numpy(x0), torch.from_numpy(xt), torch.from_numpy(t).long())
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
