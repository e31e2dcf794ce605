"""The port's grid (`parallel/mesh.py`: make_mesh's shape and coordinates,
the process groups, param_sharding_rules, shard_parameters, gather_params)
and the diffusion train step on it (`train/state.py`), against the JAX
package's mesh and train step (tests/test_sharding.py's checks).

In process: the mesh shapes, -1 inference and the mismatch error
(test_sharding.py:31-39) through the pure functions; each rank's
coordinates against the JAX mesh's device layout on the 8 virtual CPU
devices; `param_sharding_rules` leaf by leaf against the JAX rule on
`jax.eval_shape` parameter shapes (NoiseDiffNet dim 48: 78 of 416 leaves,
19,387,392 parameters, at model 2 and 4; dim 16).

gloo spawns (`torch_port_util.run_ranks`): one train step at
test_sharding.py's `_setup` size (NoiseDiffNet dim 16, 16 x 16, global
batch 4, fp32) on {spatial 2}, {model 2} and {data 2, spatial 2, model 2}
(8 ranks, the counterpart of test_full_3d_mesh_train_step), with the JAX
step's t and noise: the loss, grad norm and gathered gradients against the
JAX single-device `make_diffusion_train_step` on the same weights (rtol
5e-4, PARITY.md:152; gradients by relative L2) and against the port's own
one-process step (1e-5; gradients by relative L2 over all of them, and
5e-5 a tensor: the reassociation of the net's ~60 layers forward and
back). The steps update by SGD, whose update is the gradient itself, so
the gathered parameters after it are held at the same bound; Adam's first
update would turn the rounding noise of near-zero gradients into steps of
+-lr (chip_smoke's train_sharded phase holds Adam). In bf16 the {model 2}
step is held against the JAX package's own {model 2} distance from its
single-device step (`test_model_axis_bf16_distance_is_the_references`)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.parallel import make_mesh as jax_make_mesh
from noisediff_tpu.parallel import param_sharding_rules as jax_rules
from noisediff_tpu.parallel import replicated as jax_replicated
from noisediff_tpu.train.state import create_train_state
from noisediff_tpu.train.state import make_diffusion_train_step as jax_train_step
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter
from noisediff_tpu_torch.ops.schedules import make_schedule
from noisediff_tpu_torch.parallel import mesh
from noisediff_tpu_torch.train.state import make_diffusion_train_step
from noisediff_tpu_torch.weights import jax_params_to_state_dict, torch_key
from torch_port_util import RTOL, random_params, run_ranks

S, GB, DIM, T = 16, 4, 16, 1000
LR = 1e-2
ONE_PROCESS_TOL = 1e-5
TENSOR_TOL = 5e-5
# the port's {model 2} bf16 gradients may be this many times farther from its
# one-process bf16 gradients than the JAX package's {model 2} bf16 gradients
# are from its single-device bf16 gradients
MODEL_AXIS_BF16_RATIO = 1.5
GRIDS = {"spatial2": {"spatial": 2}, "model2": {"model": 2},
         "data2_spatial2_model2": {"data": 2, "spatial": 2, "model": 2}}

# one rank: the step on its part of the global batch; rank 0 saves the
# gathered gradients and parameters, every rank prints what it holds
RANK_CODE = r'''
import json, os
import numpy as np
import torch
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, is_unread_parameter
from noisediff_tpu_torch.ops.schedules import make_schedule
from noisediff_tpu_torch.parallel import mesh
from noisediff_tpu_torch.train.state import make_diffusion_train_step

torch.set_num_threads(1)
CPU = torch.device("cpu")
cfg = json.loads(os.environ["ND_TEST_CFG"])
mesh.setup(CPU)
grid = mesh.make_mesh(cfg["axes"])
d = np.load(cfg["inputs"])
model = NoiseDiffNet(dim=cfg["dim"], dtype=torch.bfloat16 if cfg.get("bf16") else None)
model.load_state_dict(torch.load(cfg["state"], weights_only=True), strict=True)
model = model.to(memory_format=torch.channels_last).train()
whole = sum(p.numel() for p in model.parameters())
rules = mesh.shard_parameters(model, grid.model)
net = mesh.wrap(model, CPU, is_unread_parameter, grid.replica_group)
opt = torch.optim.SGD(model.parameters(), lr=cfg["lr"])
gd = GaussianDiffusion(net, make_schedule("sigmoid2", cfg["T"]), image_size=cfg["S"], device=CPU)
step = make_diffusion_train_step(gd, opt, grid=grid)
batch = grid.local({k: torch.from_numpy(d[k]) for k in ("noise", "clean_img", "coord",
                                                        "iso_ratio_idx")})
m = step(batch, None, draws=(torch.from_numpy(d["t"]), torch.from_numpy(d["draw"])))
grads = mesh.gather_params(model, grads=True)
params = mesh.gather_params(model)
if grid.rank == 0:
    torch.save({"grads": {k: v for k, v in grads.items() if v is not None}, "params": params},
               cfg["out"])
out = {"rank": grid.rank, "coords": grid.coords, "batch_rows": list(batch["noise"].shape),
       "loss": float(m["diffusion_loss"]), "grad_norm": float(m["grad_norm"]),
       "split": sum(v is not None for v in rules.values()),
       "held": sum(p.numel() for p in model.parameters()), "whole": whole}
mesh.teardown()
print(json.dumps(out))
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU; one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the grid's shape and coordinates
# ---------------------------------------------------------------------------

def test_make_mesh_shapes():
    """test_sharding.py:31-39 on the pure shape function, and make_mesh on
    one process."""
    assert mesh.mesh_shape(None, 8) == {"data": 8, "spatial": 1, "model": 1}
    assert mesh.mesh_shape({"data": 2, "spatial": 2, "model": -1}, 8) == {
        "data": 2, "spatial": 2, "model": 2}
    with pytest.raises(ValueError):
        mesh.mesh_shape({"data": 3}, 8)
    assert mesh.make_mesh().shape == {"data": 1, "spatial": 1, "model": 1}
    with pytest.raises(ValueError):
        mesh.make_mesh({"data": 2})


@pytest.mark.parametrize("axes", [{"model": 2, "data": 4}, {"data": -1, "model": -1},
                                  {"pipeline": 8}, {"data": 0, "model": 8}])
def test_mesh_shape_refuses(axes):
    with pytest.raises(ValueError):
        mesh.mesh_shape(axes, 8)


@pytest.mark.parametrize("axes", [{"data": 2, "spatial": 2, "model": 2}, {"data": 4, "model": 2},
                                  {"spatial": 4, "model": 2}, {"data": 8}])
def test_coordinates_are_the_jax_device_layout(axes):
    """Rank r sits where the JAX mesh over the 8 virtual devices puts
    device r; each line of an axis is the devices along it, and a replica
    line the devices at one model coordinate."""
    jm = jax_make_mesh(axes)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    shape = mesh.mesh_shape(axes, 8)
    full = ids.reshape([shape[a] for a in mesh.AXES])
    for pos, rank in np.ndenumerate(full):
        assert mesh.grid_coords(shape, int(rank)) == dict(zip(mesh.AXES, pos))
    for i, axis in enumerate(mesh.AXES):
        want = sorted(map(list, np.moveaxis(full, i, -1).reshape(-1, shape[axis]).tolist()))
        assert sorted(mesh.axis_lines(shape, axis)) == want
    replicas = mesh.replica_lines(shape)
    assert len(replicas) == shape["model"]
    for m, line in enumerate(replicas):
        assert sorted(line) == sorted(full[..., m].flatten().tolist())


# ---------------------------------------------------------------------------
# the model axis's rule
# ---------------------------------------------------------------------------

def _jax_split(dim: int, model: int):
    """{torch key: whether the JAX rule splits the leaf} for NoiseDiffNet
    at `dim` on a {data, model} mesh of the 8 virtual devices."""
    s = 16
    cond = {"clean_img": jnp.zeros((1, s, s, 4)), "position": jnp.zeros((1, s, s, 2)),
            "iso_ratio_idx": jnp.zeros((1,), jnp.int32)}
    shapes = jax.eval_shape(JaxNet(dim=dim).init, jax.random.PRNGKey(0), jnp.zeros((1, s, s, 4)),
                            jnp.zeros((1,), jnp.int32), cond)["params"]
    jm = jax_make_mesh({"data": -1, "model": model})
    rules = jax_rules(jm, shapes)
    flat = jax.tree_util.tree_flatten_with_path(rules)[0]
    sizes = {torch_key(tuple(k.key for k in path)): int(np.prod(leaf.shape)) for path, leaf in
             jax.tree_util.tree_flatten_with_path(shapes)[0]}
    return {torch_key(tuple(k.key for k in path)): sh.spec != P() for path, sh in flat}, sizes


@pytest.mark.parametrize("dim,model,leaves,numel", [(48, 2, 78, 19_387_392),
                                                    (48, 4, 78, 19_387_392),
                                                    (16, 2, None, None)])
def test_param_sharding_rules_match_jax(dim, model, leaves, numel):
    """The port's rule picks exactly the JAX rule's leaves, on the dim of
    the torch layout that holds their output channels."""
    want, sizes = _jax_split(dim, model)
    with torch.device("meta"):
        net = NoiseDiffNet(dim=dim)
    rules = mesh.param_sharding_rules({"data": 8 // model, "model": model}, net)
    assert rules.keys() == want.keys() and len(rules) == 416
    assert {k for k, v in rules.items() if v is not None} == {k for k, v in want.items() if v}
    params = dict(net.named_parameters())
    for k, d in rules.items():
        if d is not None:
            assert d == 0 and params[k].shape[0] % model == 0 and params[k].shape[0] >= 128, k
    split = [k for k, v in rules.items() if v is not None]
    assert sum(sizes[k] for k in split) == sum(params[k].numel() for k in split)
    if leaves is not None:
        assert len(split) == leaves and sum(sizes[k] for k in split) == numel
    assert not any(mesh.param_sharding_rules({"model": 1}, net).values())


def test_shard_parameters_keeps_this_ranks_block():
    """Rank 1 of a model line of 2 holds the second half of each split
    parameter's output channels, flagged with its ModelShard, and its
    module computes column-parallel; the rest stay whole."""
    torch.manual_seed(0)
    net = NoiseDiffNet(dim=16)
    whole = {k: v.clone() for k, v in net.state_dict().items()}
    tp = mesh.ModelShard(1, 2)
    rules = mesh.shard_parameters(net, tp)
    modules = dict(net.named_modules())
    for name, p in net.named_parameters():
        if rules[name] is None:
            assert torch.equal(p, whole[name]) and mesh.model_shard_of(p) is None
            continue
        n = whole[name].shape[0] // 2
        assert torch.equal(p, whole[name][n:]) and mesh.model_shard_of(p) == tp
        assert modules[name.rsplit(".", 1)[0]].tp == tp
    assert mesh.shard_parameters(net, None) == {}


# ---------------------------------------------------------------------------
# the train step on the grids
# ---------------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(100)
    return {"noise": (0.05 * rng.standard_normal((GB, S, S, 4))).astype(np.float32),
            "clean_img": rng.uniform(0, 0.3, (GB, S, S, 4)).astype(np.float32),
            "coord": rng.uniform(0, 1, (GB, S, S, 2)).astype(np.float32),
            "iso_ratio_idx": np.array([24, 3, 24, 7], np.int64)}


def _capture_grads() -> optax.GradientTransformation:
    """An optax transformation whose state is the last gradients and whose
    update is zero: the JAX step's gradients, read off its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (jax.tree.map(jnp.zeros_like, updates), updates))


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """The JAX single-device step on seeded numpy weights (saved for the
    ranks) with its own draws (saved too): its loss, grad norm and
    gradients in the torch layout."""
    d = tmp_path_factory.mktemp("grid")
    batch = _batch()
    jnet = JaxNet(dim=DIM)
    cond = {"clean_img": jnp.asarray(batch["clean_img"]), "position": jnp.asarray(batch["coord"]),
            "iso_ratio_idx": jnp.asarray(batch["iso_ratio_idx"], jnp.int32)}
    params = random_params(jnet, jnp.asarray(batch["noise"]), jnp.zeros((GB,), jnp.int32), cond,
                           seed=3)
    jd = JaxDiffusion.create(lambda p, x, t, c: jnet.apply({"params": p}, x, t, c),
                             image_size=S, timesteps=T, beta_schedule="sigmoid2")
    opt = _capture_grads()
    step = jax_train_step(jd, opt, donate=False)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "iso_ratio_idx" else None)
              for k, v in batch.items()}
    state, metrics = step(create_train_state(params, opt, with_ema=False), jbatch, key)
    # the step's draws: its key folded with the step (0), then t from
    # fold_in(., 0) and the noise from fold_in(., 1) (gaussian.loss)
    rng = jax.random.fold_in(key, 0)
    t = np.array(jax.random.randint(jax.random.fold_in(rng, 0), (GB,), 0, T), np.int64)
    noise = np.array(jax.random.normal(jax.random.fold_in(rng, 1), (GB, S, S, 4), jnp.float32))
    np.savez(d / "inputs.npz", t=t, draw=noise, **batch)
    state_dict = jax_params_to_state_dict(jax.tree.map(np.array, params))
    torch.save(state_dict, d / "net.pth")
    grads = jax_params_to_state_dict(jax.tree.map(np.array, state.opt_state))
    return d, {"loss": float(metrics["diffusion_loss"]),
               "grad_norm": float(metrics["grad_norm"]), "grads": grads}


@pytest.fixture(scope="module")
def one_process(jax_step):
    """The port's one-process step on the whole batch with the same draws."""
    d, _ = jax_step
    model = NoiseDiffNet(dim=DIM)
    model.load_state_dict(torch.load(d / "net.pth", weights_only=True), strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    gd = GaussianDiffusion(model, make_schedule("sigmoid2", T), image_size=S, device="cpu")
    inputs = np.load(d / "inputs.npz")
    batch = {k: torch.from_numpy(inputs[k]) for k in ("noise", "clean_img", "coord",
                                                      "iso_ratio_idx")}
    m = make_diffusion_train_step(gd, opt)(
        batch, None, draws=(torch.from_numpy(inputs["t"]), torch.from_numpy(inputs["draw"])))
    return {"loss": float(m["diffusion_loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def grids(jax_step):
    """{grid: (each rank's result, rank 0's gathered gradients and
    parameters)}."""
    d, _ = jax_step
    out = {}
    for name, axes in GRIDS.items():
        world = int(np.prod(list(axes.values())))
        cfg = {"axes": axes, "inputs": str(d / "inputs.npz"), "state": str(d / "net.pth"),
               "out": str(d / f"{name}.pt"), "dim": DIM, "S": S, "T": T, "lr": LR}
        ranks = run_ranks(RANK_CODE, world, env={"ND_TEST_CFG": json.dumps(cfg)})
        out[name] = (ranks, torch.load(d / f"{name}.pt", weights_only=True))
    return out


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def _all_rel(got, want) -> float:
    names = sorted(want)
    return _rel(torch.cat([got[n].flatten() for n in names]),
                torch.cat([want[n].flatten() for n in names]))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_places_every_rank(grids, name):
    """Every rank sits at its coordinates, holds its rows of the batch and
    of the frame, and only its block of the split parameters; all ranks log
    one loss and one grad norm."""
    ranks, _ = grids[name]
    shape = mesh.mesh_shape(GRIDS[name], len(ranks))
    assert [r["coords"] for r in ranks] == [mesh.grid_coords(shape, i) for i in range(len(ranks))]
    rows = [GB // shape["data"], S // shape["spatial"], S, 4]
    assert all(r["batch_rows"] == rows for r in ranks)
    assert len({(r["loss"], r["grad_norm"]) for r in ranks}) == 1
    for r in ranks:
        if shape["model"] == 1:
            assert r["split"] == 0 and r["held"] == r["whole"]
        else:
            assert r["split"] > 0 and r["held"] < r["whole"]


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_step_matches_one_process(grids, one_process, name):
    ranks, saved = grids[name]
    ref = one_process
    np.testing.assert_allclose(ranks[0]["loss"], ref["loss"], rtol=ONE_PROCESS_TOL)
    np.testing.assert_allclose(ranks[0]["grad_norm"], ref["grad_norm"], rtol=ONE_PROCESS_TOL)
    assert saved["grads"].keys() == ref["grads"].keys()
    assert not any(is_unread_parameter(n) for n in saved["grads"])
    assert _all_rel(saved["grads"], ref["grads"]) <= ONE_PROCESS_TOL
    worst = max((_rel(g, ref["grads"][n]), n) for n, g in saved["grads"].items())
    assert worst[0] <= TENSOR_TOL, worst
    assert saved["params"].keys() == ref["params"].keys()
    for n, p in saved["params"].items():
        assert p.shape == ref["params"][n].shape, n
    assert _all_rel(saved["params"], ref["params"]) <= ONE_PROCESS_TOL


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_step_matches_jax(grids, jax_step, name):
    """The grid's step against the JAX single-device step on the same
    weights and draws: loss, grad norm, every gathered gradient."""
    _, want = jax_step
    ranks, saved = grids[name]
    np.testing.assert_allclose(ranks[0]["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(ranks[0]["grad_norm"], want["grad_norm"], rtol=RTOL)
    for n, w in want["grads"].items():
        if is_unread_parameter(n):
            assert n not in saved["grads"] and not w.any(), n
            continue
        assert _rel(saved["grads"][n], w) <= RTOL, n


def _jax_bf16_grads(model_axis: bool):
    """The JAX step of `jax_step` with a bf16 NoiseDiffNet (fp32
    parameters) on one device, or with its parameters split by
    param_sharding_rules over a {model 2} mesh of two virtual devices (XLA
    partitions the step): every gradient but the unread ones, torch
    layout."""
    batch = _batch()
    jnet = JaxNet(dim=DIM, dtype=jnp.bfloat16)
    cond = {"clean_img": jnp.asarray(batch["clean_img"]), "position": jnp.asarray(batch["coord"]),
            "iso_ratio_idx": jnp.asarray(batch["iso_ratio_idx"], jnp.int32)}
    params = random_params(JaxNet(dim=DIM), jnp.asarray(batch["noise"]),
                           jnp.zeros((GB,), jnp.int32), cond, seed=3)
    jd = JaxDiffusion.create(lambda p, x, t, c: jnet.apply({"params": p}, x, t, c),
                             image_size=S, timesteps=T, beta_schedule="sigmoid2")
    opt = _capture_grads()
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "iso_ratio_idx" else None)
              for k, v in batch.items()}
    if model_axis:
        grid = jax_make_mesh({"model": 2}, devices=jax.devices()[:2])
        params = jax.tree.map(jax.device_put, params, jax_rules(grid, params))
        jbatch = jax.device_put(jbatch, jax_replicated(grid))
    state, _ = jax_train_step(jd, opt, donate=False)(
        create_train_state(params, opt, with_ema=False), jbatch, jax.random.PRNGKey(5))
    grads = jax_params_to_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                  state.opt_state))
    return {n: torch.from_numpy(np.asarray(g)) for n, g in grads.items()
            if not is_unread_parameter(n)}


@pytest.fixture(scope="module")
def bf16_model_axis(jax_step):
    """{package: ({model 2} bf16 gradients, one device's bf16 gradients)}
    on jax_step's weights and draws."""
    d, _ = jax_step
    model = NoiseDiffNet(dim=DIM, dtype=torch.bfloat16)
    model.load_state_dict(torch.load(d / "net.pth", weights_only=True), strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    gd = GaussianDiffusion(model, make_schedule("sigmoid2", T), image_size=S, device="cpu")
    inputs = np.load(d / "inputs.npz")
    batch = {k: torch.from_numpy(inputs[k]) for k in ("noise", "clean_img", "coord",
                                                      "iso_ratio_idx")}
    make_diffusion_train_step(gd, torch.optim.SGD(model.parameters(), lr=LR))(
        batch, None, draws=(torch.from_numpy(inputs["t"]), torch.from_numpy(inputs["draw"])))
    one = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    cfg = {"axes": {"model": 2}, "inputs": str(d / "inputs.npz"), "state": str(d / "net.pth"),
           "out": str(d / "model2_bf16.pt"), "dim": DIM, "S": S, "T": T, "lr": LR, "bf16": True}
    run_ranks(RANK_CODE, 2, env={"ND_TEST_CFG": json.dumps(cfg)})
    split = torch.load(d / "model2_bf16.pt", weights_only=True)["grads"]
    return {"jax": (_jax_bf16_grads(True), _jax_bf16_grads(False)), "port": (split, one)}


def test_model_axis_bf16_distance_is_the_references(bf16_model_axis):
    """The model axis's bf16 gradients against one process's bf16 ones, the
    port beside the JAX package on the same weights and draws (NoiseDiffNet
    dim 16, 16 x 16, global batch 4; the 128-wide layers split): the JAX
    package read 0.01072 rel L2 over all gradients, the port 0.006275
    (0.59x). The port is held within MODEL_AXIS_BF16_RATIO (1.5) times the
    JAX distance: a layer that rounds its split output or its input
    gradient's sum once more than the reference's partitioned step would
    exceed it. Both distances are those of bf16 sums in another order,
    above zero: the axis splits the layers."""
    jax_split, jax_one = bf16_model_axis["jax"]
    port_split, port_one = bf16_model_axis["port"]
    assert port_split.keys() == port_one.keys() == jax_one.keys()
    jax_rel = _all_rel(jax_split, jax_one)
    port_rel = _all_rel(port_split, port_one)
    assert 0.0 < jax_rel < 0.05 and 0.0 < port_rel, (jax_rel, port_rel)
    assert port_rel <= MODEL_AXIS_BF16_RATIO * jax_rel, (port_rel, jax_rel)
