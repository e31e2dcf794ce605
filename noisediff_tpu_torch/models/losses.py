"""Pixel losses of the denoiser.

Port of the pixel-loss half of noisediff_tpu/models/losses.py (reference
`models/losses.py`): L1, MSE, Charbonnier and weighted total variation,
pure functions over NHWC tensors with the reference's `weight` (an
elementwise weight, multiplied in before the reduction) and `reduction`
('none' | 'mean' | 'sum') arguments. The denoising trainer uses L1 and
MSE (trainer_denoising.py:66-79). The GAN losses and penalties, which no
trainer of the JAX package calls, are not ported yet (ROADMAP.md,
Queue 1 item 4).
"""
from __future__ import annotations

from typing import Optional

import torch

_REDUCTIONS = ("none", "mean", "sum")


def _reduce(loss: torch.Tensor, weight: Optional[torch.Tensor], reduction: str) -> torch.Tensor:
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be one of {_REDUCTIONS}")
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.mean()


def l1_loss(pred, target, weight=None, reduction="mean", loss_weight=1.0):
    return loss_weight * _reduce((pred - target).abs(), weight, reduction)


def mse_loss(pred, target, weight=None, reduction="mean", loss_weight=1.0):
    return loss_weight * _reduce((pred - target) ** 2, weight, reduction)


def charbonnier_loss(pred, target, weight=None, reduction="mean", loss_weight=1.0, eps=1e-12):
    """Differentiable L1 variant: sqrt(diff^2 + eps)."""
    return loss_weight * _reduce(torch.sqrt((pred - target) ** 2 + eps), weight, reduction)


def weighted_tv_loss(pred, weight=None, loss_weight=1.0):
    """Total variation as the L1 of forward differences along H and W (NHWC)."""
    wy = weight[:, :-1, :, :] if weight is not None else None
    wx = weight[:, :, :-1, :] if weight is not None else None
    y = l1_loss(pred[:, :-1, :, :], pred[:, 1:, :, :], weight=wy)
    x = l1_loss(pred[:, :, :-1, :], pred[:, :, 1:, :], weight=wx)
    return loss_weight * (x + y)
