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


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, timeout: float = 120.0, env=None):
    """Run `code` (python -c) as `world` processes with torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a
    free local port), one torch thread each; returns each rank's last
    stdout line parsed as JSON, by rank. Each child gets at most `timeout`
    seconds; every child still running is killed on the way out."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    procs = []
    try:
        for rank in range(world):
            child = dict(os.environ, **(env or {}))
            child.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                         PYTHONPATH=os.pathsep.join(
                             [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=root, env=child,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        outs = []
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{err[-4000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
