"""The loss library.

Port of noisediff_tpu/models/losses.py (reference `models/losses.py`).
The pixel losses: L1, MSE, Charbonnier and weighted total variation, pure
functions over NHWC tensors with the reference's `weight` (an elementwise
weight, multiplied in before the reduction) and `reduction` ('none' |
'mean' | 'sum') arguments; the denoising trainer uses L1 and MSE
(trainer_denoising.py:66-79). The GAN half, which no trainer calls:
`gan_loss` (five objectives), the R1 and WGAN-GP gradient penalties, the
StyleGAN2 path-length regulariser and `VGGStyleDiscriminator160`. The
penalties take their gradients with `torch.autograd.grad(...,
create_graph=True)` where the JAX package takes `jax.grad` / `jax.vjp`, so
a caller can backpropagate through them; their random draws come from a
`torch.Generator`, or are handed over by the caller.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

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


# ---------------------------------------------------------------------------
# GAN losses (reference losses.py:243-411)
# ---------------------------------------------------------------------------

GAN_TYPES = ("vanilla", "lsgan", "wgan", "wgan_softplus", "hinge")


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_type: str = "vanilla",
             is_disc: bool = False, real_label: float = 1.0, fake_label: float = 0.0,
             loss_weight: float = 1.0) -> torch.Tensor:
    """The generator's or the discriminator's objective of a GAN variant;
    loss_weight scales the generator's only."""
    if gan_type in ("vanilla", "lsgan"):
        label = torch.full_like(pred, real_label if target_is_real else fake_label)
        if gan_type == "vanilla":
            loss = optax_sigmoid_bce(pred, label).mean()
        else:
            loss = ((pred - label) ** 2).mean()
    elif gan_type == "wgan":
        loss = -pred.mean() if target_is_real else pred.mean()
    elif gan_type == "wgan_softplus":
        loss = F.softplus(-pred).mean() if target_is_real else F.softplus(pred).mean()
    elif gan_type == "hinge":
        if is_disc:
            loss = F.relu(1.0 + (-pred if target_is_real else pred)).mean()
        else:
            loss = -pred.mean()
    else:
        raise NotImplementedError(f"GAN type {gan_type} is not implemented")
    return loss if is_disc else loss * loss_weight


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits in its stable form (nn.BCEWithLogitsLoss)."""
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _input(x: torch.Tensor) -> torch.Tensor:
    """x as an input gradients are taken with respect to."""
    return x if x.requires_grad else x.detach().requires_grad_(True)


def r1_penalty(real_pred_sum_fn: Callable[[torch.Tensor], torch.Tensor],
               real_img: torch.Tensor) -> torch.Tensor:
    """R1 gradient penalty: the batch mean of ||d sum D(x) / dx||^2."""
    x = _input(real_img)
    (grad,) = torch.autograd.grad(real_pred_sum_fn(x), x, create_graph=True)
    return (grad ** 2).sum(dim=tuple(range(1, grad.ndim))).mean()


def gradient_penalty(disc_sum_fn: Callable[[torch.Tensor], torch.Tensor],
                     real_img: torch.Tensor, fake_img: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     weight: Optional[torch.Tensor] = None, channel_axis: int = -1,
                     alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP penalty at points between the real and the fake images
    (losses.py:377-411). The gradient's norm is over `channel_axis` only
    (the reference norms dim 1 of its NCHW tensors; the default -1 is the
    channel axis of NHWC), the spatial axes stay in the mean. `alpha` (B,
    1, ..., 1), uniform in [0, 1), is drawn from `generator` unless given."""
    if alpha is None:
        alpha = torch.rand((real_img.shape[0],) + (1,) * (real_img.ndim - 1),
                           generator=generator, device=real_img.device)
    interp = (alpha * real_img + (1 - alpha) * fake_img).detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(disc_sum_fn(interp), interp, create_graph=True)
    if weight is not None:
        grad = grad * weight
    norm = torch.sqrt((grad ** 2).sum(dim=channel_axis) + 1e-12)
    out = ((norm - 1) ** 2).mean()
    if weight is not None:
        out = out / weight.mean()
    return out


def g_path_regularize(gen_fn: Callable[[torch.Tensor], torch.Tensor], latents: torch.Tensor,
                      mean_path_length, generator: Optional[torch.Generator] = None,
                      decay: float = 0.01, noise: Optional[torch.Tensor] = None):
    """StyleGAN2 path-length regulariser (losses.py:362-374). `gen_fn`
    maps latents (B, n_latents, latent_dim) to NHWC images; the probe is a
    standard normal draw of the images' shape from `generator` (or
    `noise`) over sqrt(H W). Returns (path_penalty, mean(path_lengths),
    new_mean_path_length); the penalty's gradient flows through the running
    mean too, as in the reference, the other two are detached."""
    latents = _input(latents)
    fake = gen_fn(latents)
    if noise is None:
        noise = torch.randn(fake.shape, generator=generator, device=fake.device,
                            dtype=fake.dtype)
    noise = noise / math.sqrt(fake.shape[1] * fake.shape[2])
    (grad,) = torch.autograd.grad((fake * noise).sum(), latents, create_graph=True)
    path_lengths = torch.sqrt((grad ** 2).sum(2).mean(1))
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    path_penalty = ((path_lengths - path_mean) ** 2).mean()
    return path_penalty, path_lengths.mean().detach(), path_mean.detach()


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running statistics: in training the batch's
    biased variance goes into running_var (torch's own layer keeps the
    unbiased one), both by torch's momentum 0.1 (flax's 0.9); evaluation
    is torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        with torch.no_grad():
            self.running_mean.lerp_(x.mean(dims), self.momentum)
            self.running_var.lerp_(x.var(dims, unbiased=False), self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class VGGStyleDiscriminator160(nn.Module):
    """VGG-style discriminator for 160x160 inputs (reference
    losses.py:414-492): five stride-2 stages 160 -> 5, BatchNorm after
    every conv but conv0_0, LeakyReLU(0.2), two linears 512 * 5 * 5 -> 100
    -> 1. NHWC in, as the JAX module; (B, 1) out. The flatten before
    linear1 is in NCHW order, the reference's."""

    def __init__(self, num_in_ch: int = 4 * 2, num_feat: int = 64):
        super().__init__()
        nf = num_feat
        widths = [(num_in_ch, nf), (nf, nf), (nf, nf * 2), (nf * 2, nf * 2), (nf * 2, nf * 4),
                  (nf * 4, nf * 4), (nf * 4, nf * 8), (nf * 8, nf * 8), (nf * 8, nf * 8),
                  (nf * 8, nf * 8)]
        for i, (cin, cout) in enumerate(widths):
            name = f"{i // 2}_{i % 2}"
            stride_2 = i % 2 == 1
            setattr(self, f"conv{name}", nn.Conv2d(cin, cout, 4 if stride_2 else 3,
                                                   2 if stride_2 else 1, 1, bias=i == 0))
            if i:
                setattr(self, f"bn{name}", BatchNorm2d(cout, eps=1e-5, momentum=0.1))
        self.linear1 = nn.Linear(nf * 8 * 5 * 5, 100)
        self.linear2 = nn.Linear(100, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != 160 or x.shape[2] != 160:
            raise ValueError(f"Input spatial size must be 160x160, but received {tuple(x.shape)}.")
        feat = x.permute(0, 3, 1, 2)
        for i in range(10):
            name = f"{i // 2}_{i % 2}"
            feat = getattr(self, f"conv{name}")(feat)
            if i:
                feat = getattr(self, f"bn{name}")(feat)
            feat = F.leaky_relu(feat, 0.2)
        feat = F.leaky_relu(self.linear1(feat.flatten(1)), 0.2)
        return self.linear2(feat)
