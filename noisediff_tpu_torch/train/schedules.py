"""Learning-rate schedule of the diffusion trainer.

Port of noisediff_tpu/train/schedules.py (`cosine_epoch_lr`): Adam +
CosineAnnealingLR(T_max=max_iter) stepped once per EPOCH, with one extra
step before the first epoch (reference trainer_diffusion.py:94-95,153-157),
so during 0-based epoch e the LR is the closed-form cosine at t = e + 1.
The reference's 'max_iter means epochs' quirk is kept.
"""
from __future__ import annotations

import math


def cosine_epoch_lr(base_lr: float, max_iter: int, epoch: int) -> float:
    """LR in effect during 0-based `epoch` (torch CosineAnnealingLR closed
    form at t = epoch + 1, eta_min = 0)."""
    t = epoch + 1
    return 0.5 * base_lr * (1.0 + math.cos(math.pi * t / max_iter))
