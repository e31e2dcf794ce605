"""Diffusion beta schedules and derived buffers.

Port of noisediff_tpu/ops/schedules.py: the five schedules of the reference
(`denoising_diffusion_pytorch.py:96-164`) and the derived buffers
(`:220-286`), computed on the host in float64 and cast to float32 numpy
arrays. `GaussianDiffusion` moves the buffers it needs to its device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "linear_beta_schedule",
    "cosine_beta_schedule",
    "sigmoid_beta_schedule",
    "make_beta_schedule",
    "DiffusionSchedule",
    "make_schedule",
    "SCHEDULE_NAMES",
]


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Original-DDPM linear schedule, scaled so T=1000 spans [1e-4, 0.02]."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Improved-DDPM cosine schedule (Nichol & Dhariwal)."""
    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3.0, end: float = 3.0, tau: float = 1.0
) -> np.ndarray:
    """Sigmoid schedule (arXiv:2212.11972 fig. 8), parameterised by (start, end, tau)."""

    def _sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    # The endpoint sigmoids are evaluated in float32, as the reference does
    # (torch.tensor(start/tau).sigmoid() defaults to float32,
    # denoising_diffusion_pytorch.py:127-128); the last beta of sigmoid1
    # lands just below the 0.999 clip only under this rounding.
    v_start = np.float64(_sigmoid(np.float32(start / tau)).astype(np.float32))
    v_end = np.float64(_sigmoid(np.float32(end / tau)).astype(np.float32))
    alphas_cumprod = (-_sigmoid((t * (end - start) + start) / tau) + v_end) / (
        v_end - v_start
    )
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


# The reference's CLI names: sigmoid1/2/3 are fixed (start, end, tau) triples;
# 'sigmoid' is an alias of sigmoid1 (the CLI default string).
_SIGMOID_VARIANTS = {
    "sigmoid": (-3.0, 3.0, 0.5),
    "sigmoid1": (-3.0, 3.0, 0.5),
    "sigmoid2": (-7.0, 3.0, 0.7),
    "sigmoid3": (-10.0, 3.0, 0.7),
}

SCHEDULE_NAMES = ("linear", "cosine", "sigmoid1", "sigmoid2", "sigmoid3")


def make_beta_schedule(name: str, timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_beta_schedule(timesteps)
    if name == "cosine":
        return cosine_beta_schedule(timesteps)
    if name in _SIGMOID_VARIANTS:
        start, end, tau = _SIGMOID_VARIANTS[name]
        return sigmoid_beta_schedule(timesteps, start, end, tau)
    raise ValueError(f"unknown beta schedule {name!r}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep buffers of sampling and training: float32 numpy
    arrays of shape (T,)."""

    num_timesteps: int
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    snr: np.ndarray
    loss_weight_pred_noise: np.ndarray
    loss_weight_pred_x0: np.ndarray
    loss_weight_pred_v: np.ndarray

    def loss_weight(self, objective: str) -> np.ndarray:
        """Per-timestep training-loss weight of an objective (reference
        :279-286): 1 for pred_noise, snr for pred_x0, snr / (snr + 1) for
        pred_v."""
        try:
            return getattr(self, f"loss_weight_{objective}")
        except AttributeError:
            raise ValueError(f"unknown objective {objective!r}") from None


def make_schedule(name: str, timesteps: int) -> DiffusionSchedule:
    betas = make_beta_schedule(name, timesteps)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    snr = alphas_cumprod / (1.0 - alphas_cumprod)

    def f32(x):
        return np.asarray(x, dtype=np.float32)

    return DiffusionSchedule(
        num_timesteps=int(timesteps),
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.clip(posterior_variance, 1e-20, None))
        ),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        snr=f32(snr),
        loss_weight_pred_noise=f32(np.ones_like(snr)),
        loss_weight_pred_x0=f32(snr),
        loss_weight_pred_v=f32(snr / (snr + 1.0)),
    )
