"""Shared CLI plumbing: seeding, device selection, the device flags.

Port of the parts of noisediff_tpu/cli/common.py the generation CLI needs.
Entry points run on CUDA unless the caller passes `--device cpu`; asking
for CUDA on a machine without it is an error, never a silent CPU run.
"""
from __future__ import annotations

import logging
import random

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
