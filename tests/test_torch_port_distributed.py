"""Multi-process data parallelism of the port on the CPU: two processes with
torchrun's environment on the gloo backend, as tests/test_multihost.py and
tests/test_multihost_generation.py hold the JAX package under
jax.distributed.

  * the train steps: a 2-rank DDP step (NoiseDiffNet dim 8 with the shipped
    dim_mults at crop 16, global batch 4, fp32; LSID width 8 with SNA)
    gives both ranks the same loss and grad norm and bit-equal parameters,
    and after 2 steps the parameters of the one-process step on the
    concatenated batch with the same draws (rtol 1e-5); the diffusion step
    on JAX's own t and noise gives the JAX step's loss and grad norm
    (rtol 5e-4 and 2e-3, the training parity tolerances of
    test_torch_port_train_model.py);
  * the four CLIs under --launcher pytorch: train_diffusion saves
    snapshots on rank 0 only, which load strictly (no `module.` prefix);
    test_diffusion writes disjoint shards whose union is the one-process
    set; train_denoising and test_denoising run;
  * --launcher none / pytorch / jax without a launcher's WORLD_SIZE run one
    process with rank -1, as the JAX package does.

Each child has at most 120 s (torch_port_util.run_ranks) and is killed on
failure.
"""
import glob
import json
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisediff_tpu.diffusion.gaussian import GaussianDiffusion as JaxDiffusion
from noisediff_tpu.models import NoiseDiffNet as JaxNet
from noisediff_tpu.train.state import create_train_state
from noisediff_tpu.train.state import make_diffusion_train_step as jax_train_step
from noisediff_tpu.train.state import make_optimizer as jax_optimizer
from noisediff_tpu_torch.cli import common
from noisediff_tpu_torch.cli import test_diffusion as td
from noisediff_tpu_torch.models import LSID, NoiseDiffNet, is_unread_parameter
from noisediff_tpu_torch.parallel import mesh
from noisediff_tpu_torch.weights import jax_params_to_state_dict
from test_torch_port_eval import _sid_tree
from torch_port_util import RTOL, random_params, run_ranks

# what a rank runs, and (exec'd below) the one-process reference: the
# models from seed 0, each step's global batch from a numpy seed, the
# port's train step on this rank's rows of it. The steps take SGD, whose
# update is the all-reduced gradient itself: Adam's normalised update would
# turn the rounding noise of gradients that are zero in exact arithmetic
# (a conv bias ahead of a one-channel GroupNorm group) into steps of +-lr,
# in the one-process run as in the two-rank one.
STEP_CODE = r'''
import json, os
import numpy as np
import torch

from noisediff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from noisediff_tpu_torch.models import LSID, NoiseDiffNet, is_unread_parameter
from noisediff_tpu_torch.ops.schedules import make_schedule
from noisediff_tpu_torch.parallel import mesh
from noisediff_tpu_torch.train.state import make_denoising_train_step, make_diffusion_train_step

CPU = torch.device("cpu")
S, GB = 16, 4


def diffusion_batch(step):
    rng = np.random.default_rng(100 + step)
    return {"noise": (0.05 * rng.standard_normal((GB, S, S, 4))).astype(np.float32),
            "clean_img": rng.uniform(0, 0.3, (GB, S, S, 4)).astype(np.float32),
            "coord": rng.uniform(0, 1, (GB, S, S, 2)).astype(np.float32),
            "iso_ratio_idx": np.array([24, 3, 24, 7], np.int64)}


def denoise_batch(step):
    rng = np.random.default_rng(200 + step)
    clean = rng.uniform(0, 0.3, (GB, S, S, 4)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.02, clean.shape), 0, 1).astype(np.float32)
    return {"clean_img": clean, "noisy_img": noisy,
            "iso": np.array([800, 3200, 100, 800], np.float32),
            "ratio": np.array([250.0, 100.0, 300.0, 250.0], np.float32)}


def train(shard, kind, steps, state=None, draws=None):
    """The model after `steps` train steps on this rank's rows, and each
    step's metrics; `state` a state dict to start from (default seed 0's
    model), `draws` the global batch's (t, noise) for the first step."""
    torch.manual_seed(0)
    model = NoiseDiffNet(dim=8) if kind == "diffusion" else LSID(base_width=8)
    if state is not None:
        model.load_state_dict(state)
    model = model.to(memory_format=torch.channels_last).train()
    net = mesh.wrap(model, CPU, is_unread_parameter)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    if kind == "diffusion":
        gd = GaussianDiffusion(net, make_schedule("sigmoid2", 1000), image_size=S, device=CPU)
        step, batch_of = make_diffusion_train_step(gd, opt, shard=shard), diffusion_batch
    else:
        step = make_denoising_train_step(net, opt, use_sna=True, shard=shard)
        batch_of = denoise_batch
    g = torch.Generator()
    metrics = []
    for i in range(steps):
        batch = {k: shard.rows(torch.from_numpy(v)) for k, v in batch_of(i).items()}
        g.manual_seed(1000 + i)
        kw = {}
        if draws is not None and i == 0:
            kw = {"draws": draws}
        metrics.append({k: float(v) for k, v in step(batch, g, **kw).items()})
    return model, metrics
'''

RANK_CODE = STEP_CODE + r'''
torch.set_num_threads(1)
cfg = json.loads(os.environ["ND_TEST_CFG"])
shard, _ = mesh.setup(CPU)
state = torch.load(cfg["state"], weights_only=True) if cfg.get("state") else None
draws = None
if cfg.get("draws"):
    d = np.load(cfg["draws"])
    draws = (torch.from_numpy(d["t"]), torch.from_numpy(d["noise"]))
model, metrics = train(shard, cfg["kind"], cfg["steps"], state, draws)
torch.save(model.state_dict(), cfg["out"] % shard.rank)
mesh.teardown()
print(json.dumps({"rank": shard.rank, "world": shard.world, "metrics": metrics}))
'''

_REF = {}
exec(STEP_CODE, _REF)

# a CLI's main on every rank, its summary's JSON-able part on the last line
CLI_CODE = r'''
import json, os
import torch
torch.set_num_threads(1)
from noisediff_tpu_torch import cli
import noisediff_tpu_torch.cli.test_denoising, noisediff_tpu_torch.cli.test_diffusion
import noisediff_tpu_torch.cli.train_denoising, noisediff_tpu_torch.cli.train_diffusion
cfg = json.loads(os.environ["ND_TEST_CFG"])
rank = int(os.environ["RANK"])
argv = [a.replace("{rank}", str(rank)) for a in cfg["argv"]]
out = getattr(cli, cfg["cli"]).main(argv)
keep = {k: v for k, v in out.items() if k in ("steps", "losses", "generated", "batches",
                                              "out_dir", "snapshots", "PSNR", "SSIM", "n")}
print(json.dumps(dict(keep, rank=rank)))
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the CPU; one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _two_ranks(tmp_path, kind, steps, **files):
    cfg = dict(kind=kind, steps=steps, out=str(tmp_path / "rank%d.pth"), **files)
    outs = run_ranks(RANK_CODE, 2, env={"ND_TEST_CFG": json.dumps(cfg)})
    assert [(o["rank"], o["world"]) for o in outs] == [(0, 2), (1, 2)]
    sds = [torch.load(tmp_path / f"rank{r}.pth", weights_only=True) for r in (0, 1)]
    return outs, sds


def _cli(cli, argv, world=2):
    cfg = {"cli": cli, "argv": [str(a) for a in argv]}
    return run_ranks(CLI_CODE, world, env={"ND_TEST_CFG": json.dumps(cfg)})


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["diffusion", "denoise"])
def test_two_rank_step_equals_one_process(tmp_path, kind):
    """Both ranks log the same losses and grad norm, end bit-equal, and
    after 2 steps hold the one-process run's parameters on the
    concatenated batch with the same draws, within 1e-5 relative to each
    element and to the largest of its tensor (an element near zero is the
    sum of the tensor's scale and an update of its scale); parameters never
    read keep their initial values."""
    (r0, r1), (sd0, sd1) = _two_ranks(tmp_path, kind, 2)
    assert r0["metrics"] == r1["metrics"]
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    model, want = _REF["train"](mesh.SINGLE, kind, 2)
    for got, ref in zip(r0["metrics"], want):
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    ref_sd = model.state_dict()
    torch.manual_seed(0)
    init = (NoiseDiffNet(dim=8) if kind == "diffusion" else LSID(base_width=8)).state_dict()
    moved = 0
    for k, v in ref_sd.items():
        want = v.numpy()
        np.testing.assert_allclose(sd0[k].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=k)
        if is_unread_parameter(k):
            assert torch.equal(sd0[k], init[k]), k
        else:
            moved += not torch.equal(sd0[k], init[k])
    assert moved > len(ref_sd) // 2  # the steps moved the model


def test_sna_draws_do_not_depend_on_the_split():
    """apply_sna over a batch of 4 equals apply_sna over its halves, each
    given its rows of the jitter and its first index, bit for bit; and
    two samples of equal means draw different Poisson noise."""
    from noisediff_tpu_torch.ops import sna

    rng = np.random.default_rng(3)
    clean = torch.from_numpy(rng.uniform(0, 0.3, (4, 8, 8, 4)).astype(np.float32))
    clean[1] = clean[0]
    noisy = clean + 0.01
    iso = torch.tensor([800.0, 800.0, 3200.0, 100.0])
    ratio = torch.tensor([250.0, 250.0, 100.0, 300.0])
    g = torch.Generator().manual_seed(11)
    aug_wb, jitter = sna.sample_aug_wb(g, 4), sna.draw_jitter(g, 4)
    aug_wb[1] = aug_wb[0]
    jitter[1] = jitter[0]
    whole = sna.apply_sna(g, noisy, clean, iso, ratio, aug_wb, jitter)
    halves = [sna.apply_sna(g, noisy[r], clean[r], iso[r], ratio[r], aug_wb[r], jitter[r],
                            first=r.start) for r in (slice(0, 2), slice(2, 4))]
    for i in range(2):
        assert torch.equal(whole[i], torch.cat([h[i] for h in halves]))
    assert not torch.equal(whole[0][0], whole[0][1])


def test_two_rank_diffusion_step_matches_jax(tmp_path):
    """The global batch, with the t and noise the JAX step draws from its
    key, through 2 ranks: the JAX make_diffusion_train_step loss (rtol
    5e-4) and grad norm (2e-3)."""
    S, GB, T = 16, 4, 1000
    batch = _REF["diffusion_batch"](0)
    jnet = JaxNet(dim=8)
    cond = {"clean_img": jnp.asarray(batch["clean_img"]), "position": jnp.asarray(batch["coord"]),
            "iso_ratio_idx": jnp.asarray(batch["iso_ratio_idx"], jnp.int32)}
    params = random_params(jnet, jnp.asarray(batch["noise"]), jnp.zeros((GB,), jnp.int32), cond,
                           seed=3)
    jd = JaxDiffusion.create(lambda p, x, t, c: jnet.apply({"params": p}, x, t, c),
                             image_size=S, timesteps=T, beta_schedule="sigmoid2")
    opt = jax_optimizer()
    step = jax_train_step(jd, opt, donate=False)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "iso_ratio_idx" else None)
              for k, v in batch.items()}
    _, want = step(create_train_state(params, opt, with_ema=True), jbatch, key)
    # the draws of the JAX step: its key folded with the step (0), then t
    # from fold_in(., 0) and the noise from fold_in(., 1) (gaussian.loss)
    rng = jax.random.fold_in(key, 0)
    t = np.array(jax.random.randint(jax.random.fold_in(rng, 0), (GB,), 0, T), np.int64)
    noise = np.array(jax.random.normal(jax.random.fold_in(rng, 1), (GB, S, S, 4), jnp.float32))
    np.savez(tmp_path / "draws.npz", t=t, noise=noise)
    torch.save(jax_params_to_state_dict(jax.tree.map(np.asarray, params)), tmp_path / "jax.pth")
    (r0, r1), _ = _two_ranks(tmp_path, "diffusion", 1, state=str(tmp_path / "jax.pth"),
                             draws=str(tmp_path / "draws.npz"))
    assert r0["metrics"] == r1["metrics"]
    got = r0["metrics"][0]
    np.testing.assert_allclose(got["diffusion_loss"], float(want["diffusion_loss"]), rtol=RTOL)
    np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]), rtol=2e-3)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

H_BAYER, W_BAYER = 64, 96


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 ISO800 x250 training pairs at 64 x 96 Bayer (the JAX multi-host
    tests' size), PMN resources at that size, a noise profile, seeded
    NoiseDiffNet dim-8 weights, and the one-process generation of the
    patch grid (DDIM-2, crop 16), linked in as the denoiser's synthetic
    noise."""
    root = tmp_path_factory.mktemp("port_dist")
    sid = root / "SID"
    (sid / "Sony" / "short").mkdir(parents=True)
    (sid / "Sony" / "long").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in (1, 2):
        in_fn, gt_fn = f"{i:05d}_00_0.04s.ARW", f"{i:05d}_00_10s.ARW"
        for sub, fn in (("short", in_fn), ("long", gt_fn)):
            arr = rng.integers(512, 4096, size=(H_BAYER, W_BAYER)).astype(np.uint16)
            np.save(sid / "Sony" / sub / (fn + ".npy"), arr)
        lines.append(f"./Sony/short/{in_fn} ./Sony/long/{gt_fn} ISO800 F1.8")
    (sid / "Sony_train_list.txt").write_text("\n".join(lines) + "\n")
    res = root / "resources"
    res.mkdir()
    for band in ("low", "high"):
        np.save(res / f"darkshading_{band}ISO_k.npy",
                rng.normal(0, 1e-3, (H_BAYER, W_BAYER)).astype(np.float32))
        np.save(res / f"darkshading_{band}ISO_b.npy",
                rng.normal(0, 2.0, (H_BAYER, W_BAYER)).astype(np.float32))
    with open(res / "darkshading_BLE.pkl", "wb") as f:
        pickle.dump({800: 0.5}, f)
    with open(root / "noise_profile_all.pkl", "wb") as f:
        pickle.dump({800: (0.77, 3.5)}, f)
    torch.manual_seed(0)
    torch.save(NoiseDiffNet(dim=8).state_dict(), root / "net.pth")
    gen = td.main(_gen_argv(root, root / "gen_one") + ["--device", "cpu"])
    synth = root / "synthetic" / "ISO800_Ratio250"
    synth.mkdir(parents=True)
    for p in glob.glob(os.path.join(gen["out_dir"], "*.npy")):
        os.link(p, synth / os.path.basename(p))
    return SimpleNamespace(root=root, sid=sid, res=res, gen=gen)


def _gen_argv(root, out):
    return ["--name", "ISO800_Ratio250", "--testset", "NoiseImageGenerationDataset",
            "--net_name", "NoiseDiffNet", "--beta_schedule", "sigmoid2", "--positional_encoding",
            "--with_camera_settings", "--save_npy", "--dim", "8", "--crop_size", "16",
            "--batch_size", "2", "--diffusion_steps", "8", "--sampling_timesteps", "2",
            "--iso", "800", "--ratio", "250", "--no_mixed_precision", "--num_workers", "1",
            "--sid_folder", str(root / "SID"), "--pretrained_dir", str(root),
            "--resume", str(root / "net.pth"), "--save_folder", str(out)]


def test_test_diffusion_two_ranks_write_disjoint_shards(tree, tmp_path):
    """Each rank generates its strided shard of the patch grid: the two
    sets of names are disjoint, their union is the one-process run's, and
    each patch is finite in the reference CHW layout."""
    want = {os.path.basename(p) for p in glob.glob(os.path.join(tree.gen["out_dir"], "*.npy"))}
    outs = _cli("test_diffusion", _gen_argv(tree.root, tmp_path / "rank{rank}")
                + ["--device", "cpu", "--launcher", "pytorch"])
    names = [{os.path.basename(p) for p in glob.glob(os.path.join(o["out_dir"], "*.npy"))}
             for o in outs]
    assert names[0] and names[1] and not names[0] & names[1]
    assert names[0] | names[1] == want
    assert abs(len(names[0]) - len(names[1])) <= 2  # strided: batches of 2 alternate
    assert [o["generated"] for o in outs] == [len(n) for n in names]
    for o, ns in zip(outs, names):
        for n in ns:
            arr = np.load(os.path.join(o["out_dir"], n))
            assert arr.shape == (4, 16, 16) and np.isfinite(arr).all()


def test_train_diffusion_two_ranks_snapshots_on_rank0(tree, tmp_path):
    """Both ranks train on their halves of each global batch of 4 and log
    the same losses; only rank 0 creates the run directories, the scalar
    log and the snapshots, which load strictly into NoiseDiffNet."""
    argv = ["--name", "mp_train", "--launcher", "pytorch", "--device", "cpu",
            "--net_name", "NoiseDiffNet", "--trainset", "SonyTrainDataset",
            "--beta_schedule", "sigmoid2", "--positional_encoding", "--with_camera_settings",
            "--dim", "8", "--crop_size", "16", "--batch_size", "4", "--max_iter", "1",
            "--save_epoch_freq", "1", "--log_freq", "5", "--use_tb_logger",
            "--num_workers", "1", "--sid_folder", tree.sid, "--pretrained_dir", tree.root,
            "--save_folder", tmp_path / "rank{rank}" / "weights"]
    r0, r1 = _cli("train_diffusion", argv)
    assert r0["steps"] == r1["steps"] > 0 and r0["losses"] == r1["losses"]
    assert r1["snapshots"] == [] and len(r0["snapshots"]) == 5
    run0 = tmp_path / "rank0" / "weights" / "mp_train"
    assert sorted(os.listdir(run0 / "snapshot")) == sorted(
        f"{c}_{e}.pth" for c, e in [("net", 0), ("ema", 0), ("optimizer_G", 0),
                                    ("net", "final"), ("ema", "final")])
    assert (tmp_path / "rank0" / "tb_logger" / "mp_train" / "scalars.jsonl").exists()
    assert not (tmp_path / "rank1").exists()
    for c in ("net", "ema"):
        sd = torch.load(run0 / "snapshot" / f"{c}_final.pth", weights_only=True)
        assert not any(k.startswith("module.") for k in sd)
        NoiseDiffNet(dim=8).load_state_dict(sd, strict=True)


def test_denoising_clis_two_ranks(tree, tmp_path):
    """train_denoising (LSID width 8, SNA, dark shading) under --launcher
    pytorch: equal losses on both ranks, net_final on rank 0 only, loading
    strictly into LSID; then test_denoising with it on both ranks, each
    evaluating every frame, as the JAX CLI does."""
    argv = ["--name", "mp_denoise", "--launcher", "pytorch", "--device", "cpu",
            "--net_name", "LSID", "--lsid_width", "8", "--loss_l1", "--use_sna",
            "--sub_darkshading", "--trainset", "SyntheticNoisDiffDenoisingDataset",
            "--crop_size", "16", "--batch_size", "4", "--max_iter", "1", "--save_epoch_freq", "1",
            "--log_freq", "3", "--num_workers", "1", "--sid_folder", tree.sid,
            "--synthetic_folder", tree.root / "synthetic", "--resources_path", tree.res,
            "--pretrained_dir", tree.root, "--save_folder", tmp_path / "rank{rank}" / "weights"]
    r0, r1 = _cli("train_denoising", argv)
    assert r0["steps"] == r1["steps"] > 0 and r0["losses"] == r1["losses"]
    assert r1["snapshots"] == [] and r0["snapshots"]
    net = tmp_path / "rank0" / "weights" / "mp_denoise" / "snapshot" / "net_final.pth"
    LSID(base_width=8).load_state_dict(torch.load(net, weights_only=True), strict=True)
    assert not (tmp_path / "rank1").exists()

    sid, res = _sid_tree(tmp_path / "eval", 64, 96, seed=4)
    e0, e1 = _cli("test_denoising", [
        "--launcher", "pytorch", "--device", "cpu", "--net_name", "LSID", "--lsid_width", "8",
        "--ratio", "250", "--correct_illum", "--sid_folder", sid, "--resources_path", res,
        "--resume", net, "--save_folder", tmp_path / "eval_out"])
    assert e0["n"] == e1["n"] > 0
    assert (e0["PSNR"], e0["SSIM"]) == (e1["PSNR"], e1["SSIM"])
    assert np.isfinite([e0["PSNR"], e0["SSIM"]]).all()


@pytest.mark.parametrize("launcher", ["none", "pytorch", "jax"])
def test_launcher_without_a_world_runs_one_process(monkeypatch, launcher):
    """Without a launcher's WORLD_SIZE every launcher runs one process,
    rank -1, world size 1, on the device asked for; nothing is set up."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    args = SimpleNamespace(launcher=launcher, device="cpu")
    common.init_distributed(args)
    assert (args.dist, args.rank, args.world_size, args.device) == (False, -1, 1, "cpu")
    assert not torch.distributed.is_initialized()
