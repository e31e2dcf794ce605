"""Shared CLI plumbing: seeding, device selection, the device flags, the
run directories.

Port of the parts of noisediff_tpu/cli/common.py the generation and
training CLIs need.
Entry points run on CUDA unless the caller passes `--device cpu`; asking
for CUDA on a machine without it is an error, never a silent CPU run.
"""
from __future__ import annotations

import logging
import os
import random
import time

import numpy as np
import torch


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
                        help="job launcher; only 'none' is ported (multi-process "
                             "generation waits, see ROADMAP.md)")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--mixed_precision", action="store_true", default=True,
                        help="bf16 compute with an fp32 sample carry (default)")
    parser.add_argument("--no_mixed_precision", dest="mixed_precision", action="store_false")
    parser.add_argument("--profile", action="store_true",
                        help="accepted for JAX-CLI compatibility; step traces are not ported "
                             "yet (ROADMAP.md)")


def resolve_device(name: str) -> torch.device:
    """The run's device; raises for CUDA on a machine without it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda asked for, but torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU"
        )
    return device


def set_precision_flags() -> None:
    """fp32 products stay fp32 on the card: TF32 off for both matmuls and
    cuDNN convolutions (cuDNN's default is on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def print_args(args) -> None:
    for arg in vars(args):
        logging.info("%s:%s", arg, getattr(args, arg))


_RUN_LOG = "noisediff_tpu_torch.run_log"


def setup_run_dirs(args, with_logger: bool = True) -> None:
    """<save_folder>/<name> with its vis/ and snapshot/ directories
    (args.vis_save_dir, args.snapshot_save_dir), and a timestamped log file
    there that receives this run's log records."""
    args.save_folder = os.path.join(args.save_folder, args.name)
    args.vis_save_dir = os.path.join(args.save_folder, "vis")
    args.snapshot_save_dir = os.path.join(args.save_folder, "snapshot")
    os.makedirs(args.vis_save_dir, exist_ok=True)
    os.makedirs(args.snapshot_save_dir, exist_ok=True)
    if with_logger:
        root = logging.getLogger()
        for h in [h for h in root.handlers if getattr(h, "name", "") == _RUN_LOG]:
            root.removeHandler(h)
            h.close()
        handler = logging.FileHandler(
            os.path.join(args.save_folder, time.strftime("%Y%m%d_%H%M%S") + ".log"))
        handler.name = _RUN_LOG
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        root.addHandler(handler)
        if root.level > logging.INFO:
            root.setLevel(logging.INFO)
    print_args(args)
