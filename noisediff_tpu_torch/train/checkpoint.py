"""Snapshots in the reference's own format.

Port of noisediff_tpu/train/checkpoint.py's component-file semantics
(reference trainer_diffusion.py:333-364): one file per component per epoch
under the snapshot directory,

    net_{epoch}.pth          the online model's state_dict (reference keys)
    ema_{epoch}.pth          the EMA model's state_dict (the averaged model)
    optimizer_G_{epoch}.pth  {'optimizer': Adam state_dict, 'step', 'ema_step'}

so the port's generation CLI and the JAX package's train/torch_import.py
both load net and ema files. Each file is written to a temporary name and
renamed, so a preempted save never leaves a partial snapshot. A JAX run's
orbax directories `{name}_{epoch}` are not snapshots of this format:
`latest_epoch` raises on them (weights.orbax_error) instead of passing
them over.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

from ..weights import orbax_error


def component_path(snapshot_dir: str, name: str, epoch) -> str:
    return os.path.join(snapshot_dir, f"{name}_{epoch}.pth")


def save_component(snapshot_dir: str, name: str, epoch, obj: Any) -> str:
    """Save one component ('net', 'ema', 'optimizer_G') for `epoch`."""
    os.makedirs(snapshot_dir, exist_ok=True)
    path = component_path(snapshot_dir, name, epoch)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def load_component(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_epoch(snapshot_dir: str, name: str = "net") -> Optional[str]:
    """Newest '{name}_{epoch}.pth' tag ('final' outranks any number).
    Raises on a '{name}_{epoch}' directory: a JAX run's orbax snapshot,
    which `--resume auto` cannot continue from (weights.orbax_error)."""
    if not os.path.isdir(snapshot_dir):
        return None
    entries = [e for e in os.listdir(snapshot_dir) if e.startswith(name + "_")]
    orbax = sorted(e for e in entries if os.path.isdir(os.path.join(snapshot_dir, e)))
    if orbax:
        raise orbax_error(os.path.join(snapshot_dir, orbax[-1]))
    tags = [entry[len(name) + 1:-4] for entry in entries if entry.endswith(".pth")]
    tags = [t for t in tags if t == "final" or t.isdigit()]
    if not tags:
        return None
    return max(tags, key=lambda t: (t == "final", int(t) if t.isdigit() else -1))
