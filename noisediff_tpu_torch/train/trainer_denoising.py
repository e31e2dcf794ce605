"""Stage-2 trainer: the LSID denoiser on generated, real or
Poisson-Gaussian data.

Port of noisediff_tpu/train/trainer_denoising.py (reference
`models/trainer_denoising.py` Trainer :29-344): dataset by --trainset,
network by --net_name, L1 and / or MSE losses, the per-epoch LR staircase
(/2 after 50% of the epochs, 1e-5 after 80%), a random flip along height
and Shot-Noise Augmentation on the card (`train/state.
make_denoising_train_step`), bf16 compute over fp32 parameters.

With --phase test it builds --testset's loader instead (in order, not
shuffled) and `.test()` runs the network over it.

`.train()` logs every --log_freq steps and, with --use_tb_logger, the
losses every --vis_step_freq steps to `scalars.jsonl` under save_folder
with 'weights' replaced by 'tb_logger'; writes a noisy | clean | output
strip every --vis_freq epochs when PIL is installed (and skips it
otherwise, as the JAX trainer does); saves net_{epoch} and
optimizer_G_{epoch} every --save_epoch_freq epochs and net_final, in the
reference's .pth format (train/checkpoint.py). Each step draws its flip
and augmentation from a torch.Generator seeded from (random_seed, global
step), and the optimizer snapshot carries the step, so --resume auto
continues the augmentation stream of the uninterrupted run.

Multi-process runs (`cli.common.init_distributed`; the JAX trainer's
:49-115): LSID under DDP, each rank's ShardedIterSampler shard at
batch_size / world per step with its rows of the global batch's
augmentation draws, rank 0 alone logging, writing the scalar log, the
visualisations and the snapshots (of the unwrapped module). --phase test
runs the whole test loader on every rank, as the JAX trainer does.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..cli.common import resolve_device, set_precision_flags
from ..config import paths_from_args
from ..data.datasets import DATASETS
from ..data.loader import create_train_loader, generation_loader
from ..models import define_network
from ..parallel import mesh
from ..utils.logging import ScalarLogger
from ..weights import adam_state_from_jax, load_into, load_jax_opt_npz
from . import checkpoint as ckpt
from .schedules import denoising_staircase_lr
from .state import make_denoising_train_step, make_optimizer, set_learning_rate
from .trainer_diffusion import (
    _cpu_state, _DeviceClock, rank_logger, refuse_int8, run_shard, step_seed, upload_batch)

# the tensors a denoising step reads
BATCH_KEYS = ("noisy_img", "clean_img", "iso", "ratio")
LOSS_KEYS = ("mse_loss", "l1_loss")
# trainsets whose items can lose the PMN dark shading
_DARKSHADING_SETS = ("SyntheticNoisDiffDenoisingDataset", "RealSonyDenoisingDataset")


class Trainer:
    def __init__(self, args):
        refuse_int8(args)
        self.args = args
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self.shard = run_shard(args)
        info = self._info = rank_logger(self.shard)
        set_precision_flags()
        self.paths = paths_from_args(args)
        self.seed = getattr(args, "random_seed", 0)
        mixed = getattr(args, "mixed_precision", True)
        self.compute_dtype = torch.bfloat16 if mixed else None

        if args.phase == "train":
            kwargs = {}
            if args.trainset in _DARKSHADING_SETS:
                kwargs["sub_darkshading"] = getattr(args, "sub_darkshading", False)
            self.train_dataset = DATASETS[args.trainset](self.paths, args.crop_size,
                                                         seed=self.seed, **kwargs)
            self.train_dataloader = create_train_loader(
                self.train_dataset, args.batch_size, getattr(args, "num_workers", 2),
                seed=self.seed, world_size=self.shard.world, rank=self.shard.rank)
        else:  # --testset in order, unshuffled, the last batch short (trainer_denoising.py:74-80)
            if args.testset not in DATASETS:
                raise ValueError(f"--testset {args.testset!r} is not one of {sorted(DATASETS)}")
            self.test_dataset = DATASETS[args.testset](self.paths, args.crop_size,
                                                       seed=self.seed)
            self.test_dataloader = generation_loader(self.test_dataset, args.batch_size,
                                                     getattr(args, "num_workers", 0))

        # initial weights from the run seed, without touching the global RNG
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            model = define_network(args.net_name, args, dtype=self.compute_dtype)
        auto_tag = None
        if args.resume == "auto":
            auto_tag = ckpt.latest_epoch(args.snapshot_save_dir)
            if auto_tag is not None:
                load_into(model, ckpt.component_path(args.snapshot_save_dir, "net", auto_tag))
                if auto_tag.isdigit() and args.phase == "train":
                    args.start_iter = max(args.start_iter, int(auto_tag) + 1)
                info("auto-resumed from net_%s", auto_tag)
            else:
                info("auto-resume: no snapshot found, starting fresh")
        elif args.resume and args.resume != ".":
            load_into(model, args.resume)  # .pth/.pt or a JAX .npz snapshot, strict
        self.model = model.to(self.device, memory_format=torch.channels_last)
        info("----- generator parameters: %f -----",
             sum(p.numel() for p in self.model.parameters()) / 1e6)
        if args.phase != "train":
            self.model.eval().requires_grad_(False)
            return
        self.model.train()
        # the model the step calls: DDP over self.model in a multi-process run
        self.net = mesh.wrap(self.model, self.device)

        if getattr(args, "loss_mse", False):
            info("  using mse loss...")
        if getattr(args, "loss_l1", False):
            info("  using l1 loss...")
        self.optimizer = make_optimizer(self.model.parameters(), lr=args.lr,
                                        weight_decay=getattr(args, "weight_decay", 0.0))
        self.step = 0
        self.train_step = make_denoising_train_step(
            self.net, self.optimizer,
            loss_l1=getattr(args, "loss_l1", False), loss_mse=getattr(args, "loss_mse", False),
            lambda_l1=getattr(args, "lambda_l1", 1.0), lambda_mse=getattr(args, "lambda_mse", 1.0),
            use_sna=getattr(args, "use_sna", False), shard=self.shard)
        if auto_tag is not None:
            opt_path = ckpt.component_path(args.snapshot_save_dir, "optimizer_G", auto_tag)
            if os.path.exists(opt_path):
                self._load_optimizer(opt_path)
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

    def save_networks(self, name: str, epoch) -> str:
        if name == "net":
            obj = _cpu_state(self.model.state_dict())
        elif name == "optimizer_G":
            obj = {"optimizer": self.optimizer.state_dict(), "step": self.step}
        else:
            raise ValueError(name)
        return ckpt.save_component(self.args.snapshot_save_dir, name, epoch, obj)

    def _host_batch(self, batch) -> dict:
        """The step's arrays; the Poisson-Gaussian set has no iso or ratio
        (SNA is off there), so they are zeros."""
        out = {k: batch[k] for k in ("noisy_img", "clean_img")}
        zeros = np.zeros(batch["noisy_img"].shape[0], np.float32)
        for k in ("iso", "ratio"):
            out[k] = batch[k] if k in batch else zeros
        return out

    def train(self) -> Dict[str, object]:
        """Run epochs start_iter .. max_iter - 1 and return what was done:
        {'steps', 'losses', 'snapshots', 'step_seconds', 'step_end_seconds',
        'epoch_seconds', 'loader_wait_seconds'}, with the same meanings as
        the diffusion trainer's (`trainer_diffusion.Trainer.train`); 'losses'
        holds each step's loss_sum (the mean over the ranks). Nothing waits for the device inside an
        epoch except the loss reads every --log_freq steps (and the
        --use_tb_logger scalars every --vis_step_freq)."""
        args = self.args
        dev = self.device
        info, rank0 = self._info, self.shard.rank == 0
        info("training on %s", args.trainset)
        info("%d training samples", len(self.train_dataset))
        info("the init lr: %f", args.lr)
        tb = None
        if getattr(args, "use_tb_logger", False) and rank0:
            tb = ScalarLogger(args.save_folder.replace("weights", "tb_logger"))
        generator = torch.Generator(device=dev)
        clock = _DeviceClock(dev)
        steps = 0
        losses: List[float] = []
        step_seconds: List[float] = []
        step_end_seconds: List[float] = []
        epoch_seconds: List[float] = []
        loader_wait_seconds: List[float] = []
        snapshots: List[str] = []
        last_batch = None
        for epoch in range(args.start_iter, args.max_iter):
            lr = denoising_staircase_lr(args.lr, args.max_iter, epoch)
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
                start = clock.mark()
                device_batch = upload_batch(self._host_batch(batch), BATCH_KEYS, dev)
                generator.manual_seed(step_seed(self.seed, self.step))
                metrics = self.train_step(device_batch, generator)
                marks.append((start, clock.mark()))
                unread.append(metrics["loss_sum"])
                self.step += 1
                last_batch = batch
                if tb is not None and steps % args.vis_step_freq == 0:
                    for k in LOSS_KEYS:
                        if k in metrics:
                            tb.add_scalar(k, float(metrics[k]), steps)
                steps += 1
                if j % args.log_freq == 0:
                    losses += torch.stack(unread).tolist()  # waits for this step
                    unread = []
                    now = time.perf_counter()
                    parts = [f"epoch:{epoch:03d} step:{j:04d} "]
                    parts += [f"{k}:{float(metrics[k]):.06f} " for k in LOSS_KEYS if k in metrics]
                    parts.append(f"loss_sum:{losses[-1]:f} ")
                    parts.append(f"{(now - t_log) / (args.log_freq if j else 1):4.6f}s/batch")
                    info("".join(parts))
                    t_log = now
            if unread:
                losses += torch.stack(unread).tolist()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            epoch_seconds.append(time.perf_counter() - t_epoch)
            loader_wait_seconds.append(waited)
            step_seconds += [clock.seconds(s, e) for s, e in marks]
            if marks:
                step_end_seconds += [clock.seconds(marks[0][0], e) for _, e in marks]
            if epoch % getattr(args, "vis_freq", 100) == 0 and rank0:
                self._vis(epoch, last_batch)
            if epoch % args.save_epoch_freq == 0 and rank0:
                info("Saving state, epoch: %d iter:0", epoch)
                snapshots += [self.save_networks(n, epoch) for n in ("net", "optimizer_G")]
        if rank0:
            snapshots.append(self.save_networks("net", "final"))
        if self.shard.world > 1:  # every rank returns once rank 0's snapshots are written
            mesh.barrier()
        if tb is not None:
            tb.close()
        info("The training stage is over!!!")
        return {"steps": steps, "losses": losses, "snapshots": snapshots,
                "step_seconds": step_seconds, "step_end_seconds": step_end_seconds,
                "epoch_seconds": epoch_seconds, "loader_wait_seconds": loader_wait_seconds}

    def test(self) -> int:
        """The forward over the test loader under no_grad, as the JAX
        trainer's vestigial test (trainer_denoising.py:267-273; the
        evaluation proper is the test_denoising CLI); returns the batches
        run."""
        batches = 0
        with torch.no_grad():
            for batch in self.test_dataloader:
                noisy = torch.from_numpy(np.ascontiguousarray(batch["noisy_img"]))
                self.model(noisy.to(self.device))
                batches += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return batches

    def _vis(self, epoch: int, batch) -> None:
        """noisy | clean | output strip of the batch's first sample, channels
        0..2 of the packed image (trainer_denoising.py:263-277), through
        PIL; nothing without PIL."""
        if batch is None:
            return
        try:
            from PIL import Image
        except ImportError:
            return
        noisy, clean = batch["noisy_img"][0], batch["clean_img"][0]
        with torch.no_grad():
            out = self.model(torch.from_numpy(np.ascontiguousarray(noisy[None])).to(self.device))
        out = out[0].float().cpu().numpy()
        strip = np.concatenate([np.clip(x[..., :3], 0, 1) for x in (noisy, clean, out)], axis=1)
        os.makedirs(self.args.vis_save_dir, exist_ok=True)
        Image.fromarray((strip * 255).astype(np.uint8)).save(
            os.path.join(self.args.vis_save_dir, f"vis_{epoch}.jpg"))
