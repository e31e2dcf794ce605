"""Shared CLI plumbing: seeding, device selection, the device flags, the
run directories.

Port of noisediff_tpu/cli/common.py. Entry points run on CUDA unless the
caller passes `--device cpu`; asking for CUDA on a machine without it is an
error, never a silent CPU run. `init_distributed` joins the process group a
launcher such as `torchrun` describes (`--launcher pytorch`, or its alias
`jax`), one process per card.
"""
from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from ..parallel import mesh
from ..utils.logging import print_args, setup_logger


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs. Device randomness goes through explicit
    torch.Generators (one per generated batch), not global state."""
    random.seed(seed)
    np.random.seed(seed)


def add_device_flags(parser) -> None:
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (default cuda; pass cpu explicitly "
                             "to run without a GPU)")
    parser.add_argument("--gpu_ids", type=str, default="0",
                        help="accepted for reference-CLI compatibility; --device selects "
                             "the card")
    parser.add_argument("--launcher", choices=["none", "pytorch", "jax"], default="none",
                        help="job launcher: 'pytorch' (or its alias 'jax') joins the process "
                             "group torchrun's environment names (RANK, WORLD_SIZE, "
                             "LOCAL_RANK, MASTER_ADDR, MASTER_PORT), one process per card")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--mixed_precision", action="store_true", default=True,
                        help="bf16 compute with an fp32 sample carry (default)")
    parser.add_argument("--no_mixed_precision", dest="mixed_precision", action="store_false")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of training steps 5-9 of the first "
                             "epoch under <save_folder>/profile")


def resolve_device(name: str) -> torch.device:
    """The run's device; raises for CUDA on a machine without it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda asked for, but torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU"
        )
    return device


def init_distributed(args) -> None:
    """Set args.dist, args.rank and args.world_size (JAX
    cli/common.init_distributed): `--launcher none` runs one process (dist
    False, rank -1, world size 1); 'pytorch' and its alias 'jax' join the
    process group a launcher's environment names (parallel.mesh.setup) and
    run one process without one, as the JAX package does without a
    coordinator. dist and the rank follow JAX: dist where the world is
    larger than 1, rank -1 otherwise; a world of 1 under torchrun still
    trains through DDP on its one-rank group. On the card each rank takes
    card LOCAL_RANK (modulo the cards present) as its current device and
    args.device; the backend is NCCL on the card and gloo on the CPU."""
    if args.launcher == "none":
        args.dist, args.rank, args.world_size = False, -1, 1
        print("Disabled distributed training.")
        return
    shard, device = mesh.setup(resolve_device(args.device))
    args.dist = shard.world > 1
    args.world_size = shard.world
    args.rank = shard.rank if args.dist else -1
    args.device = str(device)


def set_precision_flags() -> None:
    """fp32 products stay fp32 on the card: TF32 off for both matmuls and
    cuDNN convolutions (cuDNN's default is on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def setup_run_dirs(args, with_logger: bool = True) -> None:
    """<save_folder>/<name> with its vis/ and snapshot/ directories
    (args.vis_save_dir, args.snapshot_save_dir), and on rank 0 (or the one
    process) a timestamped log file there that, with stdout, receives this
    run's log records (`utils.logging.setup_logger`); then logs the
    arguments, as the JAX package's setup_run_dirs does."""
    args.save_folder = os.path.join(args.save_folder, args.name)
    args.vis_save_dir = os.path.join(args.save_folder, "vis")
    args.snapshot_save_dir = os.path.join(args.save_folder, "snapshot")
    if getattr(args, "rank", -1) <= 0:
        os.makedirs(args.vis_save_dir, exist_ok=True)
        os.makedirs(args.snapshot_save_dir, exist_ok=True)
        if with_logger:
            setup_logger(os.path.join(args.save_folder,
                                      time.strftime("%Y%m%d_%H%M%S") + ".log"))
    print_args(args)
