"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy parameters for a flax module, handed to both sides
(to the port through noisediff_tpu_torch.weights)."""
import jax
import numpy as np
import torch

from noisediff_tpu_torch.weights import jax_params_to_state_dict

# fp32 agreement with the JAX package (PARITY.md:152)
RTOL = 5e-4
ATOL = 5e-5


def random_params(module, *init_args, seed: int = 0):
    """Numpy parameters of the shapes `module.init` makes, drawn from a
    numpy seed: kernels ~ N(0, 1/fan_in), biases and norm offsets small,
    norm scales around 1, embeddings N(0, 1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf == "embedding":
            return rng.standard_normal(s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def load_port(module: torch.nn.Module, params, rename=None):
    """Load a JAX param tree into a port module through the bridge
    (strict); `rename` maps bridge keys to a standalone module's keys."""
    sd = jax_params_to_state_dict(params)
    if rename:
        sd = {rename(k): v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nhwc_to_cl(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW channels-last torch view."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def cl_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().float().numpy()
