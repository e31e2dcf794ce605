"""The spatial axis of the port in training (`parallel/mesh.py`: the halo's
and the all-reduce's adjoints; `models/blocks.py`: the sharded GroupNorm
training route, the conv_wgrad refusal; `models/others.py`: the
UNet_PosEmbV2 family under a shard): a frame's rows split over the ranks of
a gloo process group on the CPU, held against one process.

The model axis's column-parallel layers (`Conv2d` 3x3 and 1x1, `Linear`,
`Downsample`, `AttnBlock`'s gathered whole weights, a bf16 conv on the
conv_wgrad route) on a model line of the same ranks, split below the
shipped 128-channel floor, against the whole layer.

One spawn of 2 ranks and one of 3 (`torch_port_util.run_ranks`, the grid
{spatial: world}, then {model: world}) run every check: each module in training mode on its
rows of a seeded input, its output against its rows of the one-process
output, and the gradients of sum(output * R) (R a seeded map of the
output's shape): the input's (and a per-pixel FiLM's) rows against their
rows of the one-process gradient, a parameter's (and a per-sample FiLM's)
summed over the ranks against the one-process one. The maps have 40 rows
(24 / 16 over 2 ranks, 16 / 16 / 8 over 3) and the family's frame 32 (16 /
16, 16 / 8 / 8). Each tensor is held by its relative L2 distance: fp32
modules 1e-5, the sums run in another order; the family's nets 5e-5, the
reassociation of ~60 layers forward and back (their worst tensor read 9e-6
when this was written); the bf16 plain route 2e-2, a bf16 rounding flip."""
import pytest
import torch

from noisediff_tpu_torch.models import blocks
from noisediff_tpu_torch.parallel import mesh
from torch_port_util import run_ranks

FP32_TOL = 1e-5
NET_TOL = 5e-5
BF16_TOL = 2e-2
CHECKS = {  # name: tolerance
    "conv3": FP32_TOL, "conv7": FP32_TOL, "upsample": FP32_TOL, "downsample": FP32_TOL,
    "gn_plain": FP32_TOL, "gn_film": FP32_TOL, "gn_pixel_film": FP32_TOL,
    "gn_bf16_film": BF16_TOL, "gn_bf16_pixel_film": BF16_TOL,
    "posemb_camera": NET_TOL, "posemb_noposition": NET_TOL,
    "tp_conv3": FP32_TOL, "tp_conv1": FP32_TOL, "tp_linear": FP32_TOL, "tp_downsample": FP32_TOL,
    "tp_attn": FP32_TOL, "tp_conv3_wgrad_bf16": BF16_TOL,
}

CHILD = r'''
import json, os
import torch
from noisediff_tpu_torch.models import UNet_PosEmbV2_CameraCond, UNet_PosEmbV2_NoPosition, blocks
from noisediff_tpu_torch.parallel import mesh

torch.set_num_threads(1)
CPU = torch.device("cpu")
MODULE_H, FAMILY_H = 40, 32
shard0, _ = mesh.setup(CPU)
grid = mesh.make_mesh({"spatial": shard0.world})
out = {"world": shard0.world, "coords": grid.coords}
g = torch.Generator().manual_seed(1)


def rn(*s):
    return torch.randn(s, generator=g)


def cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def worst(got, want):
    return float((got - want).norm() / want.norm())


def run(module, x, extra, call):
    """module's output and the gradients of sum(out * R) as leaves."""
    x = x.clone().requires_grad_(True)
    extra = [e.clone().requires_grad_(True) for e in extra]
    module.zero_grad(set_to_none=True)
    y = call(module, x, extra)
    return y, x, extra


def check(name, module, x, height, extra=(), per_pixel=(), dtype=torch.float32, scale=1,
          out_scale=1, call=None, rows_dim=2):
    """module (training mode) on this rank's rows against one process: its
    output rows, the input's and per-pixel extras' gradient rows, and every
    parameter's and per-sample extra's gradient summed over the ranks."""
    call = call or (lambda m, x, e: m(x, *e))
    shard = grid.spatial(height)
    r0, r1 = shard.bounds
    module = module.train()

    def rows(t, f):
        return t.narrow(rows_dim, r0 // f, (r1 - r0) // f)

    x = cl(x.to(dtype)) if rows_dim == 2 else x
    extra = [e.to(dtype) for e in extra]
    y, xw, ew = run(module, x, extra, call)
    r = torch.randn(y.shape, generator=torch.Generator().manual_seed(7)).to(dtype)
    (y.float() * r.float()).sum().backward()
    want = {"y": rows(y.detach().float(), out_scale), "x": rows(xw.grad.float(), scale)}
    for i, e in enumerate(ew):
        want[f"e{i}"] = rows(e.grad.float(), scale) if i in per_pixel else e.grad.float()
    pw = {n: p.grad.float().clone() for n, p in module.named_parameters() if p.grad is not None}

    local_x = cl(rows(x, scale)) if rows_dim == 2 else rows(x, scale)
    local_e = [rows(e, scale) if i in per_pixel else e for i, e in enumerate(extra)]
    with mesh.activate(shard):
        y, xw, ew = run(module, local_x, local_e, call)
    (y.float() * rows(r, out_scale).float()).sum().backward()
    got = {"y": y.detach().float(), "x": xw.grad.float()}
    for i, e in enumerate(ew):
        got[f"e{i}"] = e.grad.float()
        if i not in per_pixel:
            got[f"e{i}"] = mesh.all_reduce_sum(got[f"e{i}"], shard.group)
    res = {k: worst(got[k], want[k]) for k in want}
    for n, p in module.named_parameters():
        if n in pw:
            res["param " + n] = worst(mesh.all_reduce_sum(p.grad.float(), shard.group), pw[n])
    out[name] = {"shape": list(y.shape), "worst": max(res.values()),
                 "where": max(res, key=res.get), "n": len(res)}


H = MODULE_H
torch.manual_seed(0)  # every rank's modules alike (joining the group draws from its generator)
check("conv3", blocks.Conv2d(8, 12, 3), rn(2, 8, H, 24), H)
check("conv7", blocks.Conv2d(4, 8, 7), rn(1, 4, H, 24), H)
check("upsample", blocks.Upsample(8, 6), rn(2, 8, H // 2, 12), H, scale=2)
check("downsample", blocks.Downsample(8, 16), rn(2, 8, H, 24), H, out_scale=2)
gn = blocks.GroupNorm(16, 8)
with torch.no_grad():
    gn.weight.copy_(1 + 0.1 * rn(16))
    gn.bias.copy_(0.1 * rn(16))
x = rn(2, 16, H, 24) * 1.5 + 0.3
film = [0.2 * rn(2, 16, 1, 1), 0.2 * rn(2, 16, 1, 1)]
pixel = [0.2 * rn(2, 16, H, 24), 0.2 * rn(2, 16, H, 24)]
check("gn_plain", gn, x, H)
check("gn_film", gn, x, H, extra=film, call=lambda m, x, e: m(x, tuple(e)))
check("gn_pixel_film", gn, x, H, extra=pixel, per_pixel=(0, 1),
      call=lambda m, x, e: m(x, tuple(e)))
gnb = blocks.GroupNorm(16, 8, dtype=torch.bfloat16)  # the kernels' route: plain on the CPU
gnb.load_state_dict(gn.state_dict())
assert gnb.kernels
check("gn_bf16_film", gnb, x, H, extra=film, dtype=torch.bfloat16,
      call=lambda m, x, e: m(x, tuple(e)))
check("gn_bf16_pixel_film", gnb, x, H, extra=pixel, per_pixel=(0, 1), dtype=torch.bfloat16,
      call=lambda m, x, e: m(x, tuple(e)))

# the UNet_PosEmbV2 family: NHWC inputs, the condition's maps split too
F = FAMILY_H
for name, net in (("posemb_camera", UNet_PosEmbV2_CameraCond),
                  ("posemb_noposition", UNet_PosEmbV2_NoPosition)):
    torch.manual_seed(0)
    model = net(dim=16).to(memory_format=torch.channels_last)
    xs, clean, pos = rn(2, F, 24, 4), 0.3 * rn(2, F, 24, 4), torch.rand(2, F, 24, 2, generator=g)
    t, iso = torch.tensor([3, 500]), torch.tensor([24, 7])
    if name == "posemb_camera":
        fn = lambda m, x, e: m(x, t, {"clean_img": e[0], "position": e[1], "iso_ratio_idx": iso})
        check(name, model, xs, F, extra=[clean, pos], per_pixel=(0, 1), call=fn, rows_dim=1)
    else:
        check(name, model, xs, F, extra=[clean], per_pixel=(0,), rows_dim=1,
              call=lambda m, x, e: m(x, t, e[0]))

# the model axis: each column-parallel layer on a model line of `world` ranks
# (min_width 16 splits these narrow ones) against the whole layer; every
# rank computes the whole output, so its input gradient and the gathered
# parameter gradients are the one-process ones as they are
gm = mesh.make_mesh({"model": shard0.world})


def check_tp(name, build, x, extra=(), dtype=torch.float32, call=None):
    call = call or (lambda m, x, e: m(x, *e))
    torch.manual_seed(0)
    whole = build().train()
    torch.manual_seed(0)
    part = build().train()
    mesh.shard_parameters(part, gm.model, min_width=16)
    x = (cl(x) if x.ndim == 4 else x).to(dtype)
    res = {}
    for m in (whole, part):
        y, xw, _ = run(m, x, [e.to(dtype) for e in extra], call)
        r = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
        (y.float() * r).sum().backward()
        res[m is part] = (y.detach().float(), xw.grad.float(), mesh.gather_params(m, grads=True))
    (y1, x1, g1), (y2, x2, g2) = res[False], res[True]
    errs = {"y": worst(y2, y1), "x": worst(x2, x1)}
    errs.update({"param " + n: worst(g2[n].float(), g1[n].float())
                 for n in g1 if g1[n] is not None})
    assert all((g1[n] is None) == (g2[n] is None) for n in g1)
    split = sum(mesh.model_shard_of(p) is not None for p in part.parameters())
    out[name] = {"shape": list(y2.shape), "worst": max(errs.values()),
                 "where": max(errs, key=errs.get), "n": len(errs) * (split > 0)}


ctx = rn(2, 1, 16)
check_tp("tp_conv3", lambda: blocks.Conv2d(32, 48, 3), rn(2, 32, 16, 16))
check_tp("tp_conv1", lambda: blocks.Conv2d(32, 48, 1), rn(2, 32, 16, 16))
check_tp("tp_linear", lambda: blocks.Linear(32, 48), rn(4, 32))
check_tp("tp_downsample", lambda: blocks.Downsample(16, 48), rn(2, 16, 16, 16))
check_tp("tp_attn", lambda: blocks.AttnBlock(48), rn(2, 48, 8, 8), extra=[ctx])
os.environ["NOISEDIFF_WGRAD"] = "pallas"  # the conv_wgrad route on this rank's block
check_tp("tp_conv3_wgrad_bf16", lambda: blocks.Conv2d(32, 96, 3), rn(2, 32, 16, 16),
         dtype=torch.bfloat16)
os.environ.pop("NOISEDIFF_WGRAD")

# NOISEDIFF_WGRAD=pallas under a shard raises (a 3x3 and a 1x1 conv at widths the
# kernel takes), and the same convs train on cuDNN's wgrad without it
shard = grid.spatial(H)
refused = {}
for ks in (3, 1):
    conv = blocks.Conv2d(32, 32, ks).train()
    xb = cl(rn(1, 32, H, 16).to(torch.bfloat16))
    for flag in ("pallas", "xla"):
        os.environ["NOISEDIFF_WGRAD"] = flag
        try:
            with mesh.activate(shard):
                conv(shard.rows(xb, 2)).float().sum().backward()
            refused[f"{ks}_{flag}"] = None
        except ValueError as exc:
            refused[f"{ks}_{flag}"] = str(exc)
        with mesh.activate(shard), torch.no_grad():  # generation reads no wgrad route
            conv(shard.rows(xb, 2))
os.environ.pop("NOISEDIFF_WGRAD")
out["wgrad"] = refused
mesh.teardown()
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def spawned():
    """Each rank's results, by world (2 and 3)."""
    return {world: run_ranks(CHILD, world) for world in (2, 3)}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(CHECKS))
def test_sharded_training_matches_one_process(spawned, world, name):
    """Outputs, input and parameter gradients of every module on a frame
    split over `world` ranks, or (tp_*) with its output channels split over
    a model line of `world` ranks."""
    ranks = spawned[world]
    assert [r["coords"]["spatial"] for r in ranks] == list(range(world))
    for r in ranks:
        assert r[name]["n"] >= 2, r[name]
        assert r[name]["worst"] <= CHECKS[name], (world, r["coords"], name, r[name])


@pytest.mark.parametrize("world", [2, 3])
def test_wgrad_route_refuses_a_shard(spawned, world):
    """NOISEDIFF_WGRAD=pallas in training under a shard raises the JAX
    conv_wgrad_p message, for a 3x3 and a 1x1 conv; with the flag off they
    train on cuDNN's wgrad."""
    for r in spawned[world]:
        got = r["wgrad"]
        assert got["3_xla"] is None and got["1_xla"] is None
        assert got["3_pallas"] == got["1_pallas"] == blocks.WGRAD_SPATIAL_ERROR


def test_halo_rows_adjoint_without_neighbours():
    """A shard of world 1 has no neighbour: the halo is zero rows, and its
    backward drops their gradient and returns the rows' own."""
    shard = mesh.SpatialShard(0, 1, 8)
    x = torch.randn(2, 3, 8, 5).contiguous(memory_format=torch.channels_last).requires_grad_()
    y = mesh.halo_rows(x, 2, shard)
    assert y.shape == (2, 3, 12, 5) and not y[:, :, :2].any() and not y[:, :, 10:].any()
    g = torch.randn(y.shape)
    y.backward(g)
    torch.testing.assert_close(x.grad, g[:, :, 2:10], rtol=0, atol=0)
