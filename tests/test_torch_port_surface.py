"""The rest of the port's model and diffusion surface against the JAX
package, on the CPU: blocks.LinearAttention, GaussianDiffusion.sample and
.interpolate, ops/mappings.py, and the GAN half of models/losses.py (every
gan_loss case, r1_penalty, gradient_penalty, g_path_regularize and
VGGStyleDiscriminator160 in evaluation and training).

The same seeded numpy inputs and weights go to both sides, the port's
weights through the weight bridge; where JAX draws noise (interpolate,
gradient_penalty, g_path_regularize, sample's x_T) its draws are handed to
the port. fp32 throughout, at rtol 5e-4 with an absolute floor
(tests/torch_port_util.py) unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import blocks as jax_blocks
from noisediff_tpu.models import losses as jax_losses
from noisediff_tpu.ops import mappings as jax_mappings
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import blocks, losses
from noisediff_tpu_torch.ops import mappings
from noisediff_tpu_torch.weights import jax_params_to_state_dict

from torch_port_util import ATOL, RTOL, cl_to_nhwc, load_port, nhwc_to_cl, random_params


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# -- LinearAttention ----------------------------------------------------------

def test_linear_attention_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jmod = jax_blocks.LinearAttention(heads=4, dim_head=32)
    params = random_params(jmod, jnp.asarray(x))
    sd = jax_params_to_state_dict(params)
    # the reference's keys: to_out is Sequential(1x1 conv, RMSNorm)
    assert set(sd) == {"norm.g", "to_qkv.weight", "to_out.0.weight", "to_out.0.bias",
                       "to_out.1.g"}
    port = load_port(blocks.LinearAttention(16, heads=4, dim_head=32), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = cl_to_nhwc(port(nhwc_to_cl(x)))
    _close(got, want)


# -- GaussianDiffusion.sample and .interpolate ----------------------------------

T_SMALL = 16


def _model_pair():
    """The same stand-in denoiser on both sides: depends on x, t and the
    clean image."""
    def jfn(p, x, t, c):
        return 0.1 * x + 0.05 * c["clean_img"] * (t[:, None, None, None] / T_SMALL)

    def pfn(x, t, c):
        return 0.1 * x + 0.05 * c["clean_img"] * (t[:, None, None, None] / T_SMALL)

    return jfn, pfn


def _cond(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 0.3, shape).astype(np.float32)


def test_sample_dispatches_like_jax():
    """sample: DDIM where sampling_timesteps < T (JAX's x_T handed over),
    else ancestral DDPM (the same as p_sample_loop from the same seed)."""
    jfn, pfn = _model_pair()
    b, s = 2, 8
    clean = _cond((b, s, s, 4))
    jd = JaxDiffusion.create(jfn, image_size=s, timesteps=T_SMALL, beta_schedule="sigmoid2",
                             sampling_timesteps=4)
    pd = GaussianDiffusion.create(pfn, image_size=s, timesteps=T_SMALL,
                                  beta_schedule="sigmoid2", sampling_timesteps=4, device="cpu")
    assert pd.is_ddim_sampling
    key = jax.random.PRNGKey(3)
    want = jd.sample(None, key, b, {"clean_img": jnp.asarray(clean)})
    x_t = np.asarray(jax.random.normal(jax.random.split(key)[0], (b, s, s, 4), jnp.float32))
    got = pd.sample(b, {"clean_img": torch.from_numpy(clean)}, init_noise=torch.from_numpy(x_t))
    assert got.shape == (b, s, s, 4)
    _close(got, want)

    ddpm = GaussianDiffusion.create(pfn, image_size=s, timesteps=T_SMALL,
                                    beta_schedule="sigmoid2", device="cpu")
    assert not ddpm.is_ddim_sampling
    cond = {"clean_img": torch.from_numpy(clean)}
    a = ddpm.sample(b, cond, generator=torch.Generator().manual_seed(1))
    ref = ddpm.p_sample_loop((b, s, s, 4), cond, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(a).all() and torch.equal(a, ref)


@pytest.mark.parametrize("t,lam", [(12, 0.3), (T_SMALL - 1, 0.5), (1, 0.8)])
def test_interpolate_matches_jax(t, lam):
    """On JAX's draws: x1's and x2's q_sample noise, then one posterior
    noise per step t-1 .. 1 (jax.random.fold_in of the step key)."""
    jfn, pfn = _model_pair()
    b, s = 2, 8
    rng = np.random.default_rng(1)
    x1, x2 = (rng.uniform(-1, 1, (b, s, s, 4)).astype(np.float32) for _ in range(2))
    clean = _cond((b, s, s, 4), seed=2)
    jd = JaxDiffusion.create(jfn, image_size=s, timesteps=T_SMALL, beta_schedule="sigmoid2")
    pd = GaussianDiffusion.create(pfn, image_size=s, timesteps=T_SMALL,
                                  beta_schedule="sigmoid2", device="cpu")
    key = jax.random.PRNGKey(7)
    want = jd.interpolate(None, key, jnp.asarray(x1), jnp.asarray(x2),
                          {"clean_img": jnp.asarray(clean)}, t=t, lam=lam)
    k1, k2, k_steps = jax.random.split(key, 3)

    def draw(k):
        return torch.from_numpy(np.asarray(jax.random.normal(k, x1.shape, jnp.float32)))

    steps = [draw(jax.random.fold_in(k_steps, i)) for i in range(t - 1, 0, -1)]
    cond = {"clean_img": torch.from_numpy(clean)}
    got = pd.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), cond, t=t, lam=lam,
                         draws=(draw(k1), draw(k2), steps))
    _close(got, want)
    # the generator's draws: finite, the right shape, reproducible
    a, c = (pd.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), cond, t=t, lam=lam,
                           generator=torch.Generator().manual_seed(4)) for _ in range(2))
    assert a.shape == x1.shape and torch.isfinite(a).all() and torch.equal(a, c)
    with pytest.raises(ValueError):
        pd.interpolate(torch.from_numpy(x1), torch.from_numpy(x2), cond, t=t, lam=lam,
                       draws=(draw(k1), draw(k2), steps + [draw(k1)]))


# -- ops/mappings.py ----------------------------------------------------------

@pytest.mark.parametrize("b,temp", [(0.2, 0.1), (0.5, 0.3), (0.05, 0.02)])
def test_mappings_match_jax(b, temp):
    """Forward and inverse over [-1, 1] with the knots at +-b and their
    images, against JAX; the inverse undoes the forward; every lane of the
    inverse is finite, the dropped sigmoid lanes included."""
    x = np.concatenate([np.linspace(-1, 1, 401), [-b, b, -1.0, 1.0, 0.0]]).astype(np.float32)
    xt = torch.from_numpy(x)
    y_want = np.asarray(jax_mappings.piecewise_mapping(jnp.asarray(x), b, temp))
    y = mappings.piecewise_mapping(xt, b, temp)
    _close(y, y_want)
    vb = float(mappings.tempsigmoid(torch.tensor(b, dtype=torch.float32), temp))
    yy = np.concatenate([y_want, [-vb, vb]]).astype(np.float32)
    inv = mappings.inverse_piecewise_mapping(torch.from_numpy(yy), b, temp)
    _close(inv, jax_mappings.inverse_piecewise_mapping(jnp.asarray(yy), b, temp),
           atol=1e-5)
    assert torch.isfinite(inv).all()
    # the round trip: the inverse sigmoid's log(1 - y) turns one fp32
    # rounding of y at the steep knots into ~1e-5 of x
    _close(inv[:len(x)], x, atol=1e-4)
    # the knots: continuous, and +-1 maps to +-1
    _close(mappings.piecewise_mapping(torch.tensor([-b, b]), b, temp), [-vb, vb], atol=1e-6)
    _close(mappings.piecewise_mapping(torch.tensor([-1.0, 1.0]), b, temp), [-1.0, 1.0],
           atol=1e-6)
    z = np.linspace(-0.99, 0.99, 101).astype(np.float32)
    _close(mappings.tempsigmoid(torch.from_numpy(z), temp),
           jax_mappings.tempsigmoid(jnp.asarray(z), temp))
    _close(mappings.inversesigmoid(torch.from_numpy(z), temp),
           jax_mappings.inversesigmoid(jnp.asarray(z), temp))
    with pytest.raises(ValueError):
        mappings.piecewise_mapping(xt, 1.0, temp)


# -- the GAN half of models/losses.py -------------------------------------------

@pytest.mark.parametrize("gan_type", losses.GAN_TYPES)
@pytest.mark.parametrize("is_disc", [False, True])
@pytest.mark.parametrize("target_is_real", [False, True])
def test_gan_loss_matches_jax(gan_type, is_disc, target_is_real):
    pred = np.random.default_rng(3).standard_normal((4, 5, 5, 1)).astype(np.float32) * 2
    kw = dict(gan_type=gan_type, is_disc=is_disc, real_label=0.9, fake_label=0.1,
              loss_weight=2.5)
    want = jax_losses.gan_loss(jnp.asarray(pred), target_is_real, **kw)
    got = losses.gan_loss(torch.from_numpy(pred), target_is_real, **kw)
    _close(got, want)


def test_gan_loss_rejects_unknown_types():
    with pytest.raises(NotImplementedError):
        losses.gan_loss(torch.zeros(2), True, gan_type="relativistic")


def _disc_pair(c=4, seed=4):
    """The same small discriminator on both sides: sum(tanh(x W)) over NHWC."""
    w = np.random.default_rng(seed).standard_normal((c, 3)).astype(np.float32)

    def jfn(x):
        return jnp.sum(jnp.tanh(jnp.einsum("bhwc,cd->bhwd", x, jnp.asarray(w))) ** 2)

    def pfn(x):
        return (torch.tanh(torch.einsum("bhwc,cd->bhwd", x, torch.from_numpy(w))) ** 2).sum()

    return jfn, pfn


def test_r1_penalty_matches_jax():
    jfn, pfn = _disc_pair()
    x = np.random.default_rng(5).standard_normal((3, 6, 6, 4)).astype(np.float32)
    want = jax_losses.r1_penalty(jfn, jnp.asarray(x))
    got = losses.r1_penalty(pfn, torch.from_numpy(x))
    _close(got, want)
    assert got.requires_grad  # a caller can backpropagate through it


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("channel_axis", [-1, 1])
def test_gradient_penalty_matches_jax(weighted, channel_axis):
    """On JAX's alpha (uniform, (B, 1, 1, 1), from the caller's key)."""
    jfn, pfn = _disc_pair()
    rng = np.random.default_rng(6)
    real, fake = (rng.standard_normal((3, 6, 6, 4)).astype(np.float32) for _ in range(2))
    weight = rng.uniform(0.5, 1.5, real.shape).astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(8)
    want = jax_losses.gradient_penalty(
        jfn, jnp.asarray(real), jnp.asarray(fake), key,
        weight=None if weight is None else jnp.asarray(weight), channel_axis=channel_axis)
    alpha = np.asarray(jax.random.uniform(key, (3, 1, 1, 1)))
    got = losses.gradient_penalty(
        pfn, torch.from_numpy(real), torch.from_numpy(fake),
        weight=None if weight is None else torch.from_numpy(weight),
        channel_axis=channel_axis, alpha=torch.from_numpy(alpha))
    _close(got, want)
    a, b = (losses.gradient_penalty(pfn, torch.from_numpy(real), torch.from_numpy(fake),
                                    generator=torch.Generator().manual_seed(2))
            for _ in range(2))
    assert torch.isfinite(a) and torch.equal(a, b)


def test_g_path_regularize_matches_jax():
    """On JAX's probe draw (a standard normal of the images' shape)."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((2, 6, 8 * 8 * 3)).astype(np.float32) * 0.3
    latents = rng.standard_normal((2, 2, 6)).astype(np.float32)

    def jgen(z):
        return jnp.tanh(jnp.einsum("bnd,nde->be", z, jnp.asarray(w))).reshape(2, 8, 8, 3)

    def pgen(z):
        return torch.tanh(torch.einsum("bnd,nde->be", z, torch.from_numpy(w))).reshape(2, 8, 8, 3)

    key = jax.random.PRNGKey(9)
    want = jax_losses.g_path_regularize(jgen, jnp.asarray(latents), 0.7, key, decay=0.05)
    noise = np.asarray(jax.random.normal(key, (2, 8, 8, 3), jnp.float32))
    got = losses.g_path_regularize(pgen, torch.from_numpy(latents), 0.7, decay=0.05,
                                   noise=torch.from_numpy(noise))
    for g, wv in zip(got, want):
        _close(g, wv)
    assert got[0].requires_grad and not got[1].requires_grad and not got[2].requires_grad
    a, b = (losses.g_path_regularize(pgen, torch.from_numpy(latents), 0.7,
                                     generator=torch.Generator().manual_seed(3))[0]
            for _ in range(2))
    assert torch.isfinite(a) and torch.equal(a, b)


@pytest.fixture(scope="module")
def discriminator():
    """JAX VGGStyleDiscriminator160 variables (seeded params and running
    statistics) and the port's module loaded from them strictly."""
    jmod = jax_losses.VGGStyleDiscriminator160()
    x = np.random.default_rng(10).standard_normal((2, 160, 160, 8)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_params(jmod, jnp.asarray(x), seed=11)
    rng = np.random.default_rng(12)
    stats = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
                         shapes["batch_stats"])
    variables = {"params": params, "batch_stats": stats}
    sd = jax_params_to_state_dict(variables)
    assert sum(k.endswith("num_batches_tracked") for k in sd) == 9
    port = losses.VGGStyleDiscriminator160()
    port.load_state_dict(sd, strict=True)
    return jmod, variables, port, x


def test_discriminator_eval_matches_jax(discriminator):
    jmod, variables, port, x = discriminator
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.shape == (2, 1)
    # one logit from 10 convs and 2 linears over 160^2 x 8 inputs: fp32
    # sums in another order, on a logit of order 1
    _close(got, want, atol=1e-4)


def test_discriminator_train_step_matches_jax(discriminator):
    """Training-mode BatchNorm: the output from the batch's statistics, and
    the running statistics after one step (flax momentum 0.9 == torch 0.1,
    the batch's biased variance)."""
    jmod, variables, port, x = discriminator
    want, new = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    net = losses.VGGStyleDiscriminator160()
    net.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        got = net.train()(torch.from_numpy(x))
    _close(got, want, atol=1e-4)
    after = jax_params_to_state_dict({"params": variables["params"], **new})
    sd = net.state_dict()
    for k, v in after.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k], v, atol=1e-5)
        elif k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1
    with pytest.raises(ValueError):
        net(torch.zeros(1, 128, 128, 8))
