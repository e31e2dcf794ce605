"""Stage-1 trainer: training the noise model, and bulk noise generation.

Port of noisediff_tpu/train/trainer_diffusion.py (reference
`models/trainer_diffusion.py` Trainer :33-364): dataset by name, network by
--net_name, GaussianDiffusion(crop_size, T, schedule, objective).

`.train()` (reference :176-236): Adam with the per-epoch cosine LR, bf16
compute over fp32 parameters, the EMA (beta .995, copy phase to call 500,
every 20th call), logging every --log_freq steps, with --use_tb_logger the
loss and LR every --vis_step_freq steps to `scalars.jsonl` (and
tensorboardX) under save_folder with 'weights' replaced by 'tb_logger',
snapshots at
--save_epoch_freq and 'final' in the reference's .pth format
(train/checkpoint.py). Each step draws its timesteps and noise from a
torch.Generator seeded from (random_seed, global step), and the optimizer
snapshot carries the step and EMA counters, so --resume auto continues a
run exactly as the uninterrupted run would have.

`.test()` (reference :240-325) writes one CHW float32 .npy per patch under
deterministic 'clean+noisy+x_y.npy' names, through a background writer
thread with tmp + os.replace writes. Each batch draws its noise from its
own torch.Generator seeded from (random_seed, batch index), so
--skip_existing can resume a run and a regenerated batch equals the one an
uninterrupted run wrote.

Multi-process runs (`cli.common.init_distributed`, the JAX trainer's
:66-108, :127-145): training wraps the model in DDP (parallel.wrap), each
rank loads its ShardedIterSampler shard at batch_size / world per step and
draws its rows of the global batch's timesteps and noise; rank 0 alone
logs, writes the scalar log and saves snapshots, of the unwrapped module
(the reference's keys, no `module.` prefix). Generation walks each rank's
StridedShardSampler shard, batch index and generator seed rank-local as in
JAX, and writes a disjoint set of patches. --remat recomputes the
ResnetBlocks in the backward (models/noisediff_net.py); --profile writes a
torch.profiler trace of steps 5-9 of the first epoch under
<save_folder>/profile, as the JAX trainer does with jax.profiler.
"""
from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..cli.common import resolve_device, set_precision_flags
from ..config import paths_from_args
from ..data.datasets import DATASETS
from ..data.loader import create_train_loader, generation_loader
from ..data.manifest import npy_patch_name
from ..data.sampler import StridedShardSampler
from ..diffusion.gaussian import GaussianDiffusion, default_dpm_steps
from ..models import define_network, is_unread_parameter
from ..ops.kernels.int8_conv import int8_enabled
from ..ops.schedules import make_schedule
from ..parallel import mesh
from ..utils.logging import ScalarLogger
from ..weights import adam_state_from_jax, load_into, load_jax_opt_npz
from . import checkpoint as ckpt
from .ema import HostEma
from .schedules import cosine_epoch_lr
from .state import TARGET_KEYS, make_diffusion_train_step, make_optimizer, set_learning_rate

# salts of the generator seeds (the JAX trainer folds 999 into its sampling
# key and 1 into its training key)
_SAMPLE_STREAM = 999
_TRAIN_STREAM = 1
# --profile traces steps PROFILE_FIRST .. PROFILE_FIRST + PROFILE_STEPS - 1 of
# the first epoch (the JAX trainer's 5-9)
PROFILE_FIRST, PROFILE_STEPS = 5, 5
# condition tensors of a training batch; the step also takes its target
_CONDITION_KEYS = ("clean_img", "coord", "iso_ratio_idx")


def _stream_seed(random_seed: int, stream: int, index: int) -> int:
    seq = np.random.SeedSequence([int(random_seed), stream, int(index)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def batch_seed(random_seed: int, batch_index: int) -> int:
    """Seed of batch `batch_index`'s generator: a pure function of the run
    seed and the batch, independent of which batches were skipped."""
    return _stream_seed(random_seed, _SAMPLE_STREAM, batch_index)


def step_seed(random_seed: int, step: int) -> int:
    """Seed of training step `step`'s generator (timesteps and noise): a
    pure function of the run seed and the global step."""
    return _stream_seed(random_seed, _TRAIN_STREAM, step)


def _cpu_state(sd):
    return {k: v.detach().cpu() for k, v in sd.items()}


def run_shard(args) -> mesh.Shard:
    """The run's Shard from init_distributed's args (one process without)."""
    if getattr(args, "dist", False):
        return mesh.Shard(args.rank, args.world_size)
    return mesh.SINGLE


def rank_logger(shard: mesh.Shard):
    """logging.info on rank 0 (or the one process); a no-op elsewhere."""
    return logging.info if shard.rank == 0 else (lambda *a, **k: None)


class StepProfiler:
    """--profile: a torch.profiler trace of the first epoch's steps
    PROFILE_FIRST .. PROFILE_FIRST + PROFILE_STEPS - 1, written as a Chrome
    trace to <save_folder>/profile/steps_5-9.rank<r>.pt.trace.json. `step(j)`
    is called before step j of the first epoch, `close()` after it (a
    shorter epoch ends the trace early)."""

    def __init__(self, folder: str, device: torch.device, rank: int):
        self.path = os.path.join(
            folder, "profile",
            f"steps_{PROFILE_FIRST}-{PROFILE_FIRST + PROFILE_STEPS - 1}.rank{rank}.pt.trace.json")
        self.device = device
        self.prof = None

    def step(self, j: int) -> None:
        if j == PROFILE_FIRST:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.device)
            self.prof = torch.profiler.profile(activities=acts, acc_events=True)
            self.prof.start()
        elif j == PROFILE_FIRST + PROFILE_STEPS:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None


def upload_batch(batch, keys, device: torch.device) -> Dict[str, torch.Tensor]:
    """batch[k] for k in keys as tensors on `device`. On the card the host
    arrays are pinned first, so the upload is queued behind the running
    step instead of waiting for it."""
    out = {}
    for k in keys:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class _DeviceClock:
    """Timestamps on the device's own timeline: CUDA events on the card,
    which cost no host synchronisation until they are read, and the host
    clock on the CPU, where every operation is synchronous."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, start, end) -> float:
        """end - start; on the card only after both events have completed."""
        return start.elapsed_time(end) / 1e3 if self.cuda else end - start


# the JAX trainers' message (train/trainer_diffusion.py:59-62 there)
INT8_TRAIN_ERROR = ("NOISEDIFF_INT8 is inference-only (round/clip has zero gradient a.e.); "
                    "unset it to train.")


def refuse_int8(args) -> None:
    """Both trainers refuse the int8 route (NOISEDIFF_INT8=1) in the train
    phase, as the JAX trainers do."""
    if args.phase == "train" and int8_enabled():
        raise RuntimeError(INT8_TRAIN_ERROR)


class Trainer:
    # DDIM takes the fused tail where the model has one (`sampler`); a
    # caller sets False to sample it unfused from the same draws
    fused_tail = True

    def __init__(self, args):
        if args.phase not in ("train", "test"):
            raise ValueError(f"--phase must be train or test, got {args.phase!r}")
        refuse_int8(args)
        self.args = args
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self.shard = run_shard(args)
        info = self._info = rank_logger(self.shard)
        set_precision_flags()
        self.paths = paths_from_args(args)
        seed = getattr(args, "random_seed", 0)
        self.seed = seed
        mixed = getattr(args, "mixed_precision", True)
        self.compute_dtype = torch.bfloat16 if mixed else None

        if args.phase == "train":
            self.train_dataset = DATASETS[args.trainset](self.paths, args.crop_size, seed=seed)
            self.train_dataloader = create_train_loader(
                self.train_dataset, args.batch_size, getattr(args, "num_workers", 2), seed=seed,
                world_size=self.shard.world, rank=self.shard.rank)
        else:
            ds_cls = DATASETS[args.testset]
            kwargs = {}
            if args.testset == "NoiseImageGenerationDataset":
                kwargs = dict(iso_value=args.iso_value, ratio_value=args.ratio_value)
            self.test_dataset = ds_cls(self.paths, args.crop_size, seed=seed, **kwargs)
            sampler = None
            if self.shard.world > 1:  # each rank writes a disjoint strided shard of the grid
                sampler = StridedShardSampler(len(self.test_dataset), self.shard.world,
                                              self.shard.rank)
            self.test_dataloader = generation_loader(
                self.test_dataset, args.batch_size, getattr(args, "num_workers", 0), sampler)

        # initial weights from the run seed, without touching the global RNG
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = define_network(args.net_name, args, dtype=self.compute_dtype)
        self._auto_tag = None
        if args.phase == "train" and args.resume == "auto":
            # crash recovery: the newest snapshot of this run's directory
            self._auto_tag = ckpt.latest_epoch(args.snapshot_save_dir)
            if self._auto_tag is not None:
                load_into(model, ckpt.component_path(args.snapshot_save_dir, "net",
                                                     self._auto_tag))
                if self._auto_tag.isdigit():
                    args.start_iter = max(args.start_iter, int(self._auto_tag) + 1)
                info("auto-resumed from net_%s", self._auto_tag)
            else:
                info("auto-resume: no snapshot found, starting fresh")
        elif args.resume and args.resume != ".":
            # "." is the reference CLI's default (test_diffusion.py:73): no checkpoint
            load_into(model, args.resume)  # .pth/.pt or a JAX .npz snapshot, strict
        self.model = model.to(self.device, memory_format=torch.channels_last)
        info("generator parameters: %f", sum(p.numel() for p in self.model.parameters()) / 1e6)
        # the model the training step calls: DDP over self.model in a
        # multi-process run (snapshots and the EMA read self.model itself)
        self.net = self.model
        if args.phase == "train":
            self.net = mesh.wrap(self.model, self.device, is_unread_parameter)
        self.diffusion = GaussianDiffusion(
            self.net,
            make_schedule(args.beta_schedule, args.diffusion_steps),
            image_size=args.crop_size,
            objective=args.diffusion_objective,
            sampling_timesteps=getattr(args, "sampling_timesteps", None),
            auto_normalize=getattr(args, "auto_normalize", False),
            device=self.device,
        )
        if args.phase == "train":
            self._init_training(args)
        else:
            self.model.eval()
            self.model.requires_grad_(False)

    def _init_training(self, args) -> None:
        """Optimizer, EMA and train step; restores them on --resume auto and
        --resume_optim (reference :168-189, :262-284)."""
        self.model.train()
        self.optimizer = make_optimizer(self.model.parameters(), lr=args.lr,
                                        weight_decay=getattr(args, "weight_decay", 0.0))
        self.ema = HostEma(self.model.named_parameters())
        self.step = 0
        self.train_step = make_diffusion_train_step(
            self.diffusion, self.optimizer, getattr(args, "generation_result", "noise"),
            shard=self.shard)
        if self._auto_tag is not None:
            snap, tag = args.snapshot_save_dir, self._auto_tag
            ema_path = ckpt.component_path(snap, "ema", tag)
            if os.path.exists(ema_path):
                self.ema.load_state_dict(ckpt.load_component(ema_path))
            opt_path = ckpt.component_path(snap, "optimizer_G", tag)
            if os.path.exists(opt_path):
                self._load_optimizer(opt_path)
                self._info("auto-resumed ema/optimizer state from %s (step %d)", opt_path,
                           self.step)
        if getattr(args, "resume_optim", ""):
            self._load_optimizer(args.resume_optim)

    def _load_optimizer(self, path: str) -> None:
        """An optimizer_G snapshot: the port's .pth payload, or a JAX run's
        flat .npz (its Adam moments through the weight bridge)."""
        if path.endswith((".pth", ".pt")):
            payload = ckpt.load_component(path)
            self.optimizer.load_state_dict(payload["optimizer"])
            counters = payload
        else:
            mu, nu, count, counters = load_jax_opt_npz(path)
            self.optimizer.load_state_dict(
                adam_state_from_jax(mu, nu, count, self.optimizer, self.model))
        if "step" in counters:
            self.step = int(counters["step"])
        if "ema_step" in counters:
            self.ema.calls = int(counters["ema_step"])

    def save_networks(self, name: str, epoch) -> str:
        snap = self.args.snapshot_save_dir
        if name == "net":
            obj = _cpu_state(self.model.state_dict())
        elif name == "ema":
            # like the reference, the EMA snapshot is the averaged model itself
            obj = _cpu_state(self.ema.state_dict())
        elif name == "optimizer_G":
            obj = {"optimizer": self.optimizer.state_dict(), "step": self.step,
                   "ema_step": self.ema.calls}
        else:
            raise ValueError(name)
        return ckpt.save_component(snap, name, epoch, obj)

    def train(self) -> Dict[str, object]:
        """Run epochs start_iter .. max_iter - 1 and return what was done:
        {'steps', 'losses', 'snapshots', 'step_seconds', 'step_end_seconds',
        'epoch_seconds', 'loader_wait_seconds'}; losses are the global
        batch's (their mean over the ranks), snapshots rank 0's.

        Nothing waits for the device inside an epoch, except the loss reads
        every --log_freq steps (as in the reference). The times are on the
        device's timeline (CUDA events on the card): step_seconds from a
        step's start, before its upload, to its end; step_end_seconds each
        step's end since its epoch's first start, so a gap the loader leaves
        shows as a later end. epoch_seconds is each epoch's host wall time
        until the device has finished it, loader waits included;
        loader_wait_seconds the host time of each epoch spent waiting for
        the loader."""
        args = self.args
        dev = self.device
        info, rank0 = self._info, self.shard.rank == 0
        info("training on %s", args.trainset)
        info("%d training samples", len(self.train_dataset))
        info("the init lr: %f", args.lr)
        # the JAX trainer's scalar log (trainer_diffusion.py:319-321, :368-372), rank 0's
        tb = None
        if getattr(args, "use_tb_logger", False) and rank0:
            tb = ScalarLogger(args.save_folder.replace("weights", "tb_logger"))
        profiler = None
        if getattr(args, "profile", False):
            profiler = StepProfiler(args.save_folder, dev, self.shard.rank)
        params = list(self.model.parameters())
        generator = torch.Generator(device=dev)
        clock = _DeviceClock(dev)
        # the tensors the step reads
        keys = _CONDITION_KEYS + (TARGET_KEYS[getattr(args, "generation_result", "noise")],)
        steps = 0
        losses: List[float] = []
        step_seconds: List[float] = []
        step_end_seconds: List[float] = []
        epoch_seconds: List[float] = []
        loader_wait_seconds: List[float] = []
        snapshots: List[str] = []
        for epoch in range(args.start_iter, args.max_iter):
            lr = cosine_epoch_lr(args.lr, args.max_iter, epoch)
            set_learning_rate(self.optimizer, lr)
            info("current_lr: %f", lr)
            self.train_dataloader.set_epoch(epoch)
            t_epoch = t_log = time.perf_counter()
            waited = 0.0
            marks = []  # (start, end) of each step
            unread: List[torch.Tensor] = []  # device losses not read yet
            batches = iter(self.train_dataloader)
            for j in itertools.count():
                t_wait = time.perf_counter()
                batch = next(batches, None)
                waited += time.perf_counter() - t_wait
                if batch is None:
                    break
                if profiler is not None and epoch == args.start_iter:
                    profiler.step(j)
                start = clock.mark()
                device_batch = upload_batch(batch, keys, dev)
                generator.manual_seed(step_seed(self.seed, self.step))
                metrics = self.train_step(device_batch, generator)
                self.ema.maybe_apply(params)
                marks.append((start, clock.mark()))
                unread.append(metrics["diffusion_loss"])
                self.step += 1
                if tb is not None and steps % args.vis_step_freq == 0:
                    tb.add_scalar("diffusion_loss", float(metrics["diffusion_loss"]), steps)
                    tb.add_scalar("lr", lr, steps)
                steps += 1
                if j % args.log_freq == 0:
                    losses += torch.stack(unread).tolist()  # waits for this step
                    unread = []
                    now = time.perf_counter()
                    info("epoch:%03d step:%04d  diffusion_loss:%.06f loss_sum:%f %4.6fs/batch",
                         epoch, j, losses[-1], losses[-1],
                         (now - t_log) / (args.log_freq if j else 1))
                    t_log = now
            if profiler is not None:
                profiler.close()
            if unread:
                losses += torch.stack(unread).tolist()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            epoch_seconds.append(time.perf_counter() - t_epoch)
            loader_wait_seconds.append(waited)
            step_seconds += [clock.seconds(s, e) for s, e in marks]
            step_end_seconds += [clock.seconds(marks[0][0], e) for _, e in marks]
            if epoch % args.save_epoch_freq == 0 and rank0:
                info("Saving state, epoch: %d iter:0", epoch)
                snapshots += [self.save_networks(n, epoch) for n in ("net", "ema", "optimizer_G")]
        if rank0:
            snapshots += [self.save_networks(n, "final") for n in ("net", "ema")]
        if self.shard.world > 1:  # every rank returns once rank 0's snapshots are written
            mesh.barrier()
        if tb is not None:
            tb.close()
        info("The training stage is over!!!")
        return {"steps": steps, "losses": losses, "snapshots": snapshots,
                "step_seconds": step_seconds, "step_end_seconds": step_end_seconds,
                "epoch_seconds": epoch_seconds, "loader_wait_seconds": loader_wait_seconds}

    def sampler(self, batch_size: int) -> Callable:
        """The sampler --sampler selects (trainer_diffusion.py:389-441):
        dpm -> DPM-Solver++(2M) on --dpm_spacing; ddim, or auto with fewer
        sampling steps than T -> DDIM; otherwise ancestral DDPM.

        DDIM takes the fused tail (the ddim_head kernel on the card, its
        plain version on the CPU) whenever the model has a trunk and the
        objective is pred_v. The JAX package gates it behind
        NOISEDIFF_FUSED_TAIL; the port turns on by default every inference
        kernel that computes the same function as the unfused path.
        `fused_tail = False` on the trainer samples DDIM unfused (trunk_fn
        None) from the same draws, for a caller that holds one against the
        other."""
        gd = self.diffusion
        shape = (batch_size, self.args.crop_size, self.args.crop_size, 4)
        kind = getattr(self.args, "sampler", "auto")
        spacing = getattr(self.args, "dpm_spacing", "lambda")
        if kind == "dpm":  # resolved (and reported) once per run, not per batch
            dpm_steps = gd.sampling_timesteps or default_dpm_steps(spacing, warn=True)
        trunk_fn = gd.fused_tail_trunk() if self.fused_tail else None

        def fn(condition, generator):
            if kind == "dpm":
                return gd.dpm_solver_sample(shape, condition, sampling_timesteps=dpm_steps,
                                            step_spacing=spacing, generator=generator)
            if kind == "ddim" or (kind == "auto" and gd.is_ddim_sampling):
                return gd.ddim_sample(shape, condition, generator=generator, trunk_fn=trunk_fn)
            return gd.p_sample_loop(shape, condition, generator=generator)

        return fn

    def _names(self, batch, npy_num: int) -> List[str]:
        """Output names, a pure function of the grid walk (:490-506)."""
        args = self.args
        names = []
        if not getattr(args, "save_npy", False):
            return names
        for i in range(len(batch["image_coord"])):
            image_coord = batch["image_coord"][i]
            if not getattr(args, "dark_frame", False):
                clean_name = batch["clean_name"][i].split(".ARW")[0].split(".npy")[0]
                noisy_name = batch.get("noisy_name", batch["clean_name"])[i]
                noisy_name = noisy_name.split(".ARW")[0].split(".npy")[0]
                x, y = image_coord.split("_")
                names.append(npy_patch_name(clean_name, noisy_name, int(x), int(y)))
            else:
                iso_i, ratio_i = int(batch["iso"][i]), int(batch["ratio"][i])
                names.append(f"{npy_num + i:05d}_{iso_i}_{ratio_i}+{image_coord}.npy")
        return names

    def test(self) -> Dict[str, object]:
        """Generate every batch, write the npy files, and return what was
        done: {'generated', 'skipped', 'batches', 'batch_seconds', 'out_dir'};
        batch_seconds holds each sampled batch's time, synchronised with the
        device."""
        args = self.args
        out_dir = os.path.join(args.save_folder, "npy", "generated")
        os.makedirs(out_dir, exist_ok=True)

        # background npy writer: disk IO overlaps the next batch
        write_q: "queue.Queue" = queue.Queue(maxsize=64)
        write_errors: List[BaseException] = []

        def writer():
            while True:
                item = write_q.get()
                if item is None:
                    return
                name, arr = item
                dst = os.path.join(out_dir, name)
                tmp = dst + ".tmp.npy"  # .npy suffix stops np.save renaming it
                try:
                    np.save(tmp, arr)
                    os.replace(tmp, dst)  # a preemption never leaves a partial .npy
                except OSError as exc:
                    write_errors.append(exc)

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()

        bs = args.batch_size
        sample_fn = self.sampler(bs)
        npy_num = n_skipped = n_batches = 0
        batch_seconds: List[float] = []
        t0 = time.time()
        try:
            for bidx, batch in enumerate(self.test_dataloader):
                n = batch["coord"].shape[0]
                names = self._names(batch, npy_num)
                if (names and getattr(args, "skip_existing", False)
                        and all(os.path.exists(os.path.join(out_dir, nm)) for nm in names)):
                    npy_num += n
                    n_skipped += n
                    continue

                def pad(x):
                    if x.shape[0] == bs:
                        return x
                    return np.concatenate([x] + [x[-1:]] * (bs - x.shape[0]), axis=0)

                coord = pad(batch["coord"])
                if getattr(args, "dark_frame", False) or "clean_img" not in batch:
                    clean = np.zeros(coord.shape[:3] + (4,), np.float32)
                else:
                    clean = pad(batch["clean_img"])
                if not getattr(args, "positional_encoding", True):
                    coord = np.zeros_like(coord)
                dev = self.device
                condition = {
                    "clean_img": torch.from_numpy(clean).to(dev),
                    "position": torch.from_numpy(coord).to(dev),
                    "iso_ratio_idx": torch.from_numpy(pad(batch["iso_ratio_idx"])).to(dev),
                }
                generator = torch.Generator(device=dev)
                generator.manual_seed(batch_seed(self.seed, bidx))
                tb = time.perf_counter()
                output = sample_fn(condition, generator)
                output = output[:n].float().cpu().numpy()  # waits for the device
                batch_seconds.append(time.perf_counter() - tb)
                n_batches += 1
                for i, save_name in enumerate(names):
                    # reference-compatible CHW layout (trainer_diffusion.py:317)
                    write_q.put((save_name, output[i].transpose(2, 0, 1)))
                npy_num += len(names)
        finally:
            write_q.put(None)
            wt.join()
        if write_errors:
            raise write_errors[0]
        self._info("generated %d patches in %.1fs (%d already on disk, skipped)",
                   npy_num - n_skipped, time.time() - t0, n_skipped)
        return {
            "generated": npy_num - n_skipped,
            "skipped": n_skipped,
            "batches": n_batches,
            "batch_seconds": batch_seconds,
            "out_dir": out_dir,
        }
