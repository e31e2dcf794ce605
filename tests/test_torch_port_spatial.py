"""The spatial axis of the port (`parallel/mesh.py`: SpatialShard, activate,
halo_rows, all_reduce_sum, gather_rows): a frame's rows split over the
ranks of a gloo process group on the CPU.

Each spawn (`torch_port_util.run_ranks`) runs several checks: the halo
convs (3x3, 7x7), Upsample, Downsample, GroupNorm (no FiLM, per-sample and
per-pixel FiLM, the bf16 kernel route) and a bf16 Block on every rank's
rows against the one-process module, on 40 rows (24 / 16 over 2 ranks,
16 / 16 / 8 over 3); then `generate_full_frame` split over the ranks
against the JAX sampler (NoiseDiffNet dim 16, 32 x 48, DPM-3 and DDIM-2,
as tests/test_torch_port_fullframe.py sets it up) and ancestral DDPM from
a generator against one process. Tolerances: fp32 modules 1e-5 abs + rel
(sums in another order); bf16 2e-2 abs + rel, a bf16 rounding flip (the
sharded Block keeps its conv bias on the conv, the one-process one folds
it into the kernel's route); the full frame rtol 5e-4 / atol 5e-5
(PARITY.md:152)."""
import json
import os

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
from noisediff_tpu_torch.models import NoiseDiffNet, UNet_PosEmbV2_CameraCond
from noisediff_tpu_torch.parallel import mesh
from torch_port_util import ATOL, RTOL, load_port, random_params, run_ranks

H, W, DIM, T = 32, 48, 16, 8
ISO_IDX = 24
MODULE_H = 40  # the module checks' frame: an uneven split over 2 and 3 ranks
FP32_TOL = 1e-5
BF16_TOL = 2e-2
MODULE_CHECKS = {  # name: tolerance (abs and rel)
    "conv3": FP32_TOL, "conv7": FP32_TOL, "upsample": FP32_TOL, "downsample": FP32_TOL,
    "gn_plain": FP32_TOL, "gn_film": FP32_TOL, "gn_pixel_film": FP32_TOL,
    "gn_bf16_film": BF16_TOL, "gn_bf16_pixel_film": BF16_TOL, "block_bf16": BF16_TOL,
}

# one rank of a spawn: the module checks, then (SPATIAL_DIR set) the full
# frame; rank 0 saves the frames, every rank prints its module results
CONSTANTS = (f"MODULE_H, DIM, H, W, T, ISO_IDX = {MODULE_H}, {DIM}, {H}, {W}, {T}, "
             f"{ISO_IDX}\n")
CHILD = CONSTANTS + r'''
import json, os
import numpy as np
import torch
from noisediff_tpu_torch.diffusion import fullframe
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet, blocks
from noisediff_tpu_torch.parallel import mesh

torch.manual_seed(0)
shard0, _ = mesh.setup(torch.device("cpu"))
out = {"world": shard0.world}
g = torch.Generator().manual_seed(1)


def rn(*s):
    return torch.randn(s, generator=g)


def cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def check(name, module, x, scale=1, out_scale=1, dtype=torch.float32, extra=()):
    """module on this rank's rows of x (x at 1 / scale of the frame's
    height, the output at 1 / out_scale) against its rows of the
    one-process output: (max |err| - tol |want|, tolerance ratio)."""
    shard = mesh.SpatialShard(shard0.rank, shard0.world, MODULE_H)
    r0, r1 = shard.bounds
    module = module.eval()

    def rows(e, f):
        if isinstance(e, tuple):
            return tuple(rows(t, f) for t in e)
        return cl(e[:, :, r0 // f: r1 // f]) if e.shape[2] > 1 else e

    x = cl(x.to(dtype))
    extra = tuple(tuple(t.to(dtype) for t in e) for e in extra)
    with torch.no_grad():
        want = rows(module(x, *extra), out_scale).float()
        with mesh.activate(shard):
            got = module(rows(x, scale), *rows(extra, scale)).float()
    err = (got - want).abs()
    out[name] = {"shape": list(got.shape), "max_err": float(err.max()),
                 "worst": float((err / (1.0 + want.abs())).max())}


check("conv3", blocks.Conv2d(8, 12, 3), rn(2, 8, MODULE_H, 24))
check("conv7", blocks.Conv2d(4, 8, 7), rn(1, 4, MODULE_H, 24))
check("upsample", blocks.Upsample(8, 6), rn(2, 8, MODULE_H // 2, 12), scale=2)
check("downsample", blocks.Downsample(8, 16), rn(2, 8, MODULE_H, 24), out_scale=2)
gn = blocks.GroupNorm(16, 8)
with torch.no_grad():
    gn.weight.copy_(1 + 0.1 * rn(16))
    gn.bias.copy_(0.1 * rn(16))
x = rn(2, 16, MODULE_H, 24) * 1.5 + 0.3
film = (0.2 * rn(2, 16, 1, 1), 0.2 * rn(2, 16, 1, 1))
pixel = (0.2 * rn(2, 16, MODULE_H, 24), 0.2 * rn(2, 16, MODULE_H, 24))
check("gn_plain", gn, x)
check("gn_film", gn, x, extra=(film,))
check("gn_pixel_film", gn, x, extra=(pixel,))
gnb = blocks.GroupNorm(16, 8, dtype=torch.bfloat16)
gnb.load_state_dict(gn.state_dict())
assert gnb.kernels
check("gn_bf16_film", gnb, x, dtype=torch.bfloat16, extra=(film,))
check("gn_bf16_pixel_film", gnb, x, dtype=torch.bfloat16, extra=(pixel,))
check("block_bf16", blocks.Block(8, 16, 8, dtype=torch.bfloat16), rn(2, 8, MODULE_H, 24),
      dtype=torch.bfloat16, extra=(film,))

d = os.environ.get("SPATIAL_DIR")
if d:
    model = NoiseDiffNet(dim=DIM)
    model.load_state_dict(torch.load(os.path.join(d, "net.pt")), strict=True)
    gd = GaussianDiffusion.create(model.eval(), image_size=H, timesteps=T,
                                  beta_schedule="sigmoid2", objective="pred_v", device="cpu")
    clean = np.load(os.path.join(d, "clean.npy"))
    x_t = torch.from_numpy(np.load(os.path.join(d, "x_t.npy")))
    frames = {}
    for sampler, steps in (("dpm", 3), ("ddim", 2)):
        frames[sampler] = fullframe.generate_full_frame(gd, clean, ISO_IDX, sampler=sampler,
                                                        sampling_timesteps=steps, init_noise=x_t)
    frames["ddpm"] = fullframe.generate_full_frame(gd, clean, ISO_IDX, sampler="ddpm",
                                                   generator=torch.Generator().manual_seed(7))
    try:
        fullframe.generate_full_frame(gd, clean, ISO_IDX, sampler="ddpm")
        out["refuses_no_generator"] = False
    except ValueError:
        out["refuses_no_generator"] = True
    out["rank0_frames"] = all(f is not None for f in frames.values())
    out["other_ranks_none"] = all(f is None for f in frames.values())
    if shard0.rank == 0:
        np.savez(os.path.join(d, f"frames{shard0.world}.npz"), **frames)
mesh.teardown()
print(json.dumps(out))
'''

# one process under a launcher's environment of world 1: generate_full_frame
# before and after joining the group, and the direct sampler call that
# generate_full_frame makes at world 1
WORLD1 = CONSTANTS + r'''
import json, os
import numpy as np
import torch
from noisediff_tpu_torch.diffusion import fullframe
from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import NoiseDiffNet
from noisediff_tpu_torch.ops.coords import make_coord
from noisediff_tpu_torch.parallel import mesh

d = os.environ["SPATIAL_DIR"]
model = NoiseDiffNet(dim=DIM)
model.load_state_dict(torch.load(os.path.join(d, "net.pt")), strict=True)
gd = GaussianDiffusion.create(model.eval(), image_size=H, timesteps=T,
                              beta_schedule="sigmoid2", objective="pred_v", device="cpu")
clean = np.load(os.path.join(d, "clean.npy"))
x_t = torch.from_numpy(np.load(os.path.join(d, "x_t.npy")))
cond = {"clean_img": torch.from_numpy(clean)[None],
        "position": torch.from_numpy(make_coord(H, W, rescale=True))[None],
        "iso_ratio_idx": torch.tensor([ISO_IDX])}
direct = gd.dpm_solver_sample(x_t.shape, cond, sampling_timesteps=3, init_noise=x_t)[0].numpy()
alone = fullframe.generate_full_frame(gd, clean, ISO_IDX, sampling_timesteps=3, init_noise=x_t)
shard, _ = mesh.setup(torch.device("cpu"))
grouped = fullframe.generate_full_frame(gd, clean, ISO_IDX, sampling_timesteps=3,
                                        init_noise=x_t)
out = {"world": shard.world, "no_spatial_shard": mesh.spatial_shard(H) is None,
       "alone_is_direct": bool(np.array_equal(alone, direct)),
       "grouped_is_alone": bool(np.array_equal(grouped, alone))}
mesh.teardown()
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """The dim-16 NoiseDiffNet's seeded weights (saved for the ranks), the
    clean frame and x_T, the JAX samplers' DPM-3 and DDIM-2 frames, and the
    port's one-process DDPM frame from a seeded generator."""
    d = tmp_path_factory.mktemp("spatial")
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
    key = jax.random.PRNGKey(1)
    want = {
        "dpm": np.asarray(jd.dpm_solver_sample(params, key, x_t.shape, jcond,
                                               sampling_timesteps=3, init_noise=jnp.asarray(x_t),
                                               step_spacing="lambda"))[0],
        "ddim": np.asarray(jd.ddim_sample(params, key, x_t.shape, jcond, sampling_timesteps=2,
                                          init_noise=jnp.asarray(x_t)))[0],
    }
    port = load_port(NoiseDiffNet(dim=DIM), params)
    torch.save(port.state_dict(), d / "net.pt")
    np.save(d / "clean.npy", clean)
    np.save(d / "x_t.npy", x_t)
    pd = GaussianDiffusion.create(port, image_size=H, timesteps=T, beta_schedule="sigmoid2",
                                  objective="pred_v", device="cpu")
    want["ddpm"] = fullframe.generate_full_frame(pd, clean, ISO_IDX, sampler="ddpm",
                                                 generator=torch.Generator().manual_seed(7))
    return d, want


@pytest.fixture(scope="module")
def spawned(frame):
    """{world: (each rank's results, rank 0's frames)} for 2 and 3 gloo ranks."""
    d, _ = frame
    out = {}
    for world in (2, 3):
        ranks = run_ranks(CHILD, world, env={"SPATIAL_DIR": str(d)})
        with np.load(d / f"frames{world}.npz") as f:
            out[world] = (ranks, {k: f[k] for k in f.files})
    return out


@pytest.mark.parametrize("height,world,sizes", [
    (1424, 2, [712, 712]), (1424, 4, [360, 360, 352, 352]), (40, 2, [24, 16]),
    (40, 3, [16, 16, 8]), (32, 3, [16, 8, 8]), (8, 1, [8])])
def test_split_rows(height, world, sizes):
    assert mesh.split_rows(height, world) == sizes
    bounds = [mesh.SpatialShard(r, world, height).bounds for r in range(world)]
    assert bounds[0][0] == 0 and bounds[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("height,world", [(1420, 2), (8, 2), (40, 6), (0, 1)])
def test_split_rows_raises(height, world):
    with pytest.raises(ValueError):
        mesh.split_rows(height, world)
    with pytest.raises(ValueError):
        mesh.SpatialShard(0, world, height)


def test_shard_scales_and_rows():
    """Rank 1 of 4 over 1424 rows holds [360, 720): 45 rows from row 45
    at the /8 stage of the frame's 178; a map of any other height is not
    its rows at any scale."""
    shard = mesh.SpatialShard(1, 4, 1424)
    assert shard.bounds == (360, 720)
    assert shard.at_scale(360) == (360, 1424)
    assert shard.at_scale(45) == (45, 178)
    assert shard.at_scale(720) == (720, 2848)
    assert shard.sizes(45) == [45, 45, 44, 44]
    with pytest.raises(ValueError):
        shard.at_scale(7)
    x = torch.arange(1424.0).view(1, 1424, 1, 1)
    assert shard.rows(x).flatten().tolist() == list(range(360, 720))
    with pytest.raises(ValueError):
        shard.rows(x[:, :1000])


def test_activate_world_one_is_a_no_op():
    with mesh.activate(mesh.SpatialShard(0, 1, 32)), torch.no_grad():
        assert mesh.spatial() is None
    with mesh.activate(None):
        assert mesh.spatial() is None
    assert mesh.spatial_shard(32) is None  # no process group


def test_sharded_forward_refuses_autograd():
    """The sharded forward has no backward: under a shard with autograd on,
    the blocks raise and name ROADMAP."""
    shard = mesh.SpatialShard(0, 2, 32)
    with mesh.activate(shard):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mesh.spatial()
        with torch.no_grad():
            assert mesh.spatial() == shard
    assert mesh.spatial() is None


def test_posemb_family_refuses_a_shard():
    net = UNet_PosEmbV2_CameraCond(dim=16).eval()
    x = torch.zeros(1, 16, 16, 4)
    cond = {"clean_img": x, "position": torch.zeros(1, 16, 16, 2),
            "iso_ratio_idx": torch.zeros(1, dtype=torch.long)}
    with mesh.activate(mesh.SpatialShard(0, 2, 32)), torch.no_grad():
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            net(x, torch.zeros(1, dtype=torch.long), cond)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(MODULE_CHECKS))
def test_sharded_module_matches_one_process(spawned, world, name):
    ranks, _ = spawned[world]
    heights = [r[name]["shape"][2] for r in ranks]
    scale = {"upsample": 1, "downsample": 2}.get(name, 1)
    assert heights == [n // scale for n in mesh.split_rows(MODULE_H, world)]
    for r in ranks:
        assert r[name]["worst"] <= MODULE_CHECKS[name], (r["world"], name, r[name])


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("sampler", ["dpm", "ddim"])
def test_generate_full_frame_split_matches_jax_sampler(frame, spawned, world, sampler):
    _, want = frame
    ranks, frames = spawned[world]
    assert ranks[0]["rank0_frames"] and all(r["other_ranks_none"] for r in ranks[1:])
    assert frames[sampler].shape == (H, W, 4) and frames[sampler].dtype == np.float32
    np.testing.assert_allclose(frames[sampler], want[sampler], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", [2, 3])
def test_generate_full_frame_split_ddpm_draws_as_one_process(frame, spawned, world):
    """x_T and every step's noise are drawn for the whole frame from the
    generator and sliced: the split frame is the one-process frame; without
    a generator the split run refuses to draw."""
    _, want = frame
    ranks, frames = spawned[world]
    assert all(r["refuses_no_generator"] for r in ranks)
    np.testing.assert_allclose(frames["ddpm"], want["ddpm"], rtol=RTOL, atol=ATOL)


def test_generate_full_frame_world_one_is_unchanged(frame):
    """At world 1 (a launcher's environment, the group joined) the frame is
    bit-equal to the one without a group, which is the sampler's own call
    on the condition generate_full_frame builds."""
    d, _ = frame
    out, = run_ranks(WORLD1, 1, env={"SPATIAL_DIR": str(d)})
    assert out == {"world": 1, "no_spatial_shard": True, "alone_is_direct": True,
                   "grouped_is_alone": True}
