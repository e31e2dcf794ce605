"""The JAX package's lane-folded NoiseDiffNet against its unfolded one at the
learning gate's width, on the CPU.

On a TPU at dim 48 and a width divisible by 4 the JAX NoiseDiffNet folds
width into channels (`lane_fold`, `effective_fold` = 2), and its samplers
keep the carry folded (`fold_io` 2, train/trainer_diffusion.py
`_sample_jit`). The port computes the unfolded function, so the JAX gate's
TPU record reads the port's function only if folding is pure layout. Here,
on one parameter tree (NoiseDiffNet dim 48, 32^2, batch 2, T 1000,
sigmoid2, fp32):

  * the training loss and every parameter gradient, under `gn_train_trace`
    as the JAX train step takes them, folded against unfolded: the loss
    within 1e-5 relative, each gradient within 1e-4 relative L2 (fp32
    reassociation; the port is held to JAX's at 2e-3);
  * DDIM-50 (eta 0) from one init_noise: the folded model with `fold_io` 2
    and with `fold_io` 1 against the unfolded model, every element within
    torch_port_util's RTOL 5e-4 / ATOL 5e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.models.blocks import gn_train_trace

from torch_port_util import ATOL, RTOL

B, S, DIM, T = 2, 32, 48, 1000
LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-4


def _inputs():
    rng = np.random.default_rng(1)
    img = (0.05 * rng.standard_normal((B, S, S, 4))).astype(np.float32)
    cond = {"clean_img": jnp.asarray(rng.uniform(0, 0.3, (B, S, S, 4)).astype(np.float32)),
            "position": jnp.asarray(rng.uniform(0, 1, (B, S, S, 2)).astype(np.float32)),
            "iso_ratio_idx": jnp.asarray(np.array([24, 3], np.int32))}
    return jnp.asarray(img), cond


@pytest.fixture(scope="module")
def nets():
    img, cond = _inputs()
    flat, folded = JaxNet(dim=DIM, lane_fold=False), JaxNet(dim=DIM, lane_fold=True)
    assert (flat.effective_fold(S), folded.effective_fold(S)) == (1, 2)
    params = jax.jit(flat.init)(jax.random.PRNGKey(3), img, jnp.zeros((B,), jnp.int32),
                                cond)["params"]
    return flat, folded, params


def _diffusion(net):
    return JaxDiffusion.create(lambda p, x, t, c: net.apply({"params": p}, x, t, c),
                               image_size=S, timesteps=T, beta_schedule="sigmoid2")


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_folded_loss_and_gradients_equal_unfolded(nets):
    flat, folded, params = nets
    img, cond = _inputs()
    key = jax.random.PRNGKey(5)

    def value_and_grad(net):
        jd = _diffusion(net)

        def loss_fn(p):
            with gn_train_trace():
                return jd.loss(p, key, img, cond)

        return jax.jit(jax.value_and_grad(loss_fn))(params)

    want_loss, want = value_and_grad(flat)
    got_loss, got = value_and_grad(folded)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=LOSS_RTOL)
    rel = jax.tree_util.tree_map(_rel_l2, got, want)
    worst = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(rel)}
    assert len(worst) > 300
    assert not {k: v for k, v in worst.items() if v > GRAD_REL_L2}, max(worst.values())


def test_folded_ddim50_equals_unfolded(nets):
    flat, folded, params = nets
    _, cond = _inputs()
    x = np.random.default_rng(2).standard_normal((B, S, S, 4)).astype(np.float32)

    def ddim(net, fold_io):
        fn = jax.jit(lambda p, xx: _diffusion(net).ddim_sample(
            p, jax.random.PRNGKey(0), xx.shape, cond, sampling_timesteps=50, eta=0.0,
            init_noise=xx, fold_io=fold_io))
        return np.asarray(fn(params, jnp.asarray(x)))

    want = ddim(flat, 1)
    for fold_io in (2, 1):
        got = ddim(folded, fold_io)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"fold_io {fold_io}")
