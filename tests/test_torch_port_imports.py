"""The port stands alone: nothing in noisediff_tpu_torch/ or chip_smoke.py
imports JAX, flax or the JAX package, and importing the port loads none of
them."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "noisediff_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "noisediff_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


# the evaluation half and full-frame generation: modules with a JAX
# counterpart of the same relative path, held by test_no_jax_imports too
EVALUATION_MODULES = ("ops/metrics.py", "ops/noise_estimation.py", "cli/test_denoising.py",
                      "cli/eval_kld.py", "diffusion/fullframe.py", "data/manifest.py",
                      "data/raw_host.py")


@pytest.mark.parametrize("rel", EVALUATION_MODULES)
def test_evaluation_modules_are_ported_and_stand_alone(rel):
    path = os.path.join(ROOT, "noisediff_tpu_torch", rel)
    assert path in _port_files()
    assert os.path.exists(os.path.join(ROOT, "noisediff_tpu", rel))
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


# multi-process data parallelism: the samplers and the process group / DDP
# layer, counterparts of the JAX modules of the same relative path
DISTRIBUTED_MODULES = ("data/sampler.py", "parallel/__init__.py", "parallel/mesh.py")


@pytest.mark.parametrize("rel", DISTRIBUTED_MODULES)
def test_distributed_modules_are_ported_and_stand_alone(rel):
    path = os.path.join(ROOT, "noisediff_tpu_torch", rel)
    assert path in _port_files()
    assert os.path.exists(os.path.join(ROOT, "noisediff_tpu", rel))
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    mods = [
        "noisediff_tpu_torch." + os.path.relpath(p, os.path.join(ROOT, "noisediff_tpu_torch"))
        [:-3].replace(os.sep, ".").replace(".__init__", "")
        for p in _port_files() if "noisediff_tpu_torch" in p
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "import chip_smoke\n"
        + f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        + "assert not bad, bad\n"
        + "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
