"""The port's full-frame generation (`diffusion/fullframe.generate_full_frame`)
against the JAX package's samplers, on the CPU in fp32.

NoiseDiffNet at dim 16 with seeded numpy weights on both sides, a 32 x 48
packed frame (divisible by the UNet's /8), the condition built as the JAX
`generate_full_frame` builds it (the clean frame, make_coord(h, w,
rescale=True), the ISO / ratio index) and the same initial noise on both
sides: DPM-Solver++ and DDIM (eta 0) are deterministic from there; DDPM's
per-step noise is the JAX sampler's own draws (fold_in of the step key),
handed to the port in order. The JAX function itself takes no initial
noise, so its samplers are called with the condition it would build.
Tolerance: rtol 5e-4 / atol 5e-5 (PARITY.md:152)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.ops.coords import make_coord as jax_make_coord
from noisediff_tpu_torch.diffusion import fullframe
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet
from torch_port_util import ATOL, RTOL, load_port, random_params

H, W, DIM, T = 32, 48, 16, 8
ISO_IDX = 24


@pytest.fixture(scope="module")
def setup():
    jnet = JaxNet(dim=DIM)
    rng = np.random.default_rng(0)
    clean = rng.uniform(0, 0.3, (H, W, 4)).astype(np.float32)
    x_t = rng.standard_normal((1, H, W, 4)).astype(np.float32)
    jcond = {  # as noisediff_tpu.diffusion.fullframe.generate_full_frame builds it
        "clean_img": jnp.asarray(clean)[None],
        "position": jnp.asarray(jax_make_coord(H, W, rescale=True), jnp.float32)[None],
        "iso_ratio_idx": jnp.asarray([ISO_IDX], jnp.int32),
    }
    params = random_params(jnet, jnp.asarray(x_t), jnp.zeros((1,), jnp.int32), jcond)
    apply = jax.jit(lambda p, xx, tt, cc: jnet.apply({"params": p}, xx, tt, cc))
    jd = JaxDiffusion.create(lambda p, xx, tt, cc: apply(p, xx, tt, cc), image_size=H,
                             timesteps=T, beta_schedule="sigmoid2", objective="pred_v")
    port = load_port(NoiseDiffNet(dim=DIM), params)
    pd = GaussianDiffusion.create(port, image_size=H, timesteps=T, beta_schedule="sigmoid2",
                                  objective="pred_v", device="cpu")
    return jd, pd, params, jcond, clean, x_t


@pytest.mark.parametrize("sampler,steps", [("dpm", 3), ("ddim", 2)])
def test_generate_full_frame_matches_jax_sampler(setup, sampler, steps):
    jd, pd, params, jcond, clean, x_t = setup
    key = jax.random.PRNGKey(1)
    if sampler == "dpm":
        want = jd.dpm_solver_sample(params, key, x_t.shape, jcond, sampling_timesteps=steps,
                                    init_noise=jnp.asarray(x_t), step_spacing="lambda")
    else:
        want = jd.ddim_sample(params, key, x_t.shape, jcond, sampling_timesteps=steps,
                              init_noise=jnp.asarray(x_t))
    got = fullframe.generate_full_frame(pd, clean, ISO_IDX, sampler=sampler,
                                        sampling_timesteps=steps,
                                        init_noise=torch.from_numpy(x_t))
    assert got.shape == (H, W, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want)[0], rtol=RTOL, atol=ATOL)


def test_generate_full_frame_ddpm_matches_jax_sampler(setup, monkeypatch):
    """Ancestral DDPM over all T steps: the port draws its step noise
    through torch.randn, which here hands out the JAX sampler's draws
    (normal(fold_in(split(key)[1], t))) for t = T-1 .. 1, in order."""
    jd, pd, params, jcond, clean, x_t = setup
    key = jax.random.PRNGKey(2)
    want = jd.p_sample_loop(params, key, x_t.shape, jcond, init_noise=jnp.asarray(x_t))
    steps_key = jax.random.split(key)[1]
    draws = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(steps_key, t), x_t.shape, jnp.float32))) for t in range(T - 1, 0, -1)]
    real_randn = torch.randn

    def randn(*shape, **kw):
        if tuple(shape[0] if len(shape) == 1 else shape) == x_t.shape:
            return draws.pop(0).to(kw.get("device") or "cpu")
        return real_randn(*shape, **kw)

    monkeypatch.setattr(torch, "randn", randn)
    got = fullframe.generate_full_frame(pd, clean, ISO_IDX, sampler="ddpm",
                                        init_noise=torch.from_numpy(x_t))
    assert not draws  # one draw a step with t > 0
    np.testing.assert_allclose(got, np.asarray(want)[0], rtol=RTOL, atol=ATOL)


def test_generate_full_frame_draws_its_noise_from_the_generator(setup):
    """Without init_noise, x_T comes from the caller's generator: the same
    seed gives the same frame, and it is the frame of that noise."""
    _, pd, _, _, clean, _ = setup
    runs = [fullframe.generate_full_frame(pd, clean, ISO_IDX, sampling_timesteps=2,
                                          generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    x = torch.randn((1, H, W, 4), generator=torch.Generator().manual_seed(5))
    want = fullframe.generate_full_frame(pd, clean, ISO_IDX, sampling_timesteps=2, init_noise=x)
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], want)
    assert np.isfinite(runs[0]).all()
