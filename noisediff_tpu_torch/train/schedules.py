"""Learning-rate schedules of the two trainers, per epoch.

Port of noisediff_tpu/train/schedules.py:
  * diffusion (`cosine_epoch_lr`): Adam + CosineAnnealingLR(T_max=max_iter)
    stepped once per EPOCH, with one extra step before the first epoch
    (reference trainer_diffusion.py:94-95,153-157), so during 0-based epoch
    e the LR is the closed-form cosine at t = e + 1. The reference's
    'max_iter means epochs' quirk is kept.
  * denoiser (`denoising_staircase_lr`): lr / 2 after 50% of the epochs,
    1e-5 after 80% (trainer_denoising.py:184-188, strict '>' comparisons).
"""
from __future__ import annotations

import math


def cosine_epoch_lr(base_lr: float, max_iter: int, epoch: int) -> float:
    """LR in effect during 0-based `epoch` (torch CosineAnnealingLR closed
    form at t = epoch + 1, eta_min = 0)."""
    t = epoch + 1
    return 0.5 * base_lr * (1.0 + math.cos(math.pi * t / max_iter))


def denoising_staircase_lr(base_lr: float, max_iter: int, epoch: int) -> float:
    """LR in effect during 0-based `epoch` of the denoising trainer."""
    lr = base_lr
    if epoch > max_iter // 2:
        lr = base_lr / 2.0
    if epoch > int(max_iter * 0.8):
        lr = 1e-5
    return lr
