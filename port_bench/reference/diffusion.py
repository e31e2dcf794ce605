"""Gaussian diffusion in plain NumPy / PyTorch: the sigmoid beta schedules
(the reference's `denoising_diffusion_pytorch.py:96-164`), the pred_v
training loss with its snr / (snr + 1) weight, and DPM-Solver++(2M)
(Lu et al., arXiv:2211.01095), data prediction, on the grid uniform in
half-log-SNR, with x0 clipped to [-1, 1].
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

SIGMOIDS = {"sigmoid1": (-3.0, 3.0, 0.5), "sigmoid2": (-7.0, 3.0, 0.7),
            "sigmoid3": (-10.0, 3.0, 0.7)}


def alphas_cumprod(schedule: str, timesteps: int) -> np.ndarray:
    """Cumulative alphas of a sigmoid schedule, computed in float64 with the
    end sigmoids in float32, as torch evaluates them in the reference."""
    start, end, tau = SIGMOIDS[schedule]

    def sig(x):
        return 1.0 / (1.0 + np.exp(-x))

    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v0 = np.float64(np.float32(sig(np.float32(start / tau))))
    v1 = np.float64(np.float32(sig(np.float32(end / tau))))
    ac = (-sig((t * (end - start) + start) / tau) + v1) / (v1 - v0)
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0.0, 0.999)
    # kept as float32, as the reference registers its buffers
    return np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)


def lambda_grid(ac: np.ndarray, steps: int) -> list:
    """Knots [T-1, ..., -1] uniform in half-log-SNR, snapped to the
    nearest discrete t and kept strictly decreasing."""
    lam = 0.5 * np.log(ac / (1.0 - ac))
    total = len(ac)
    times = [total - 1]
    for target in np.linspace(lam[-1], lam[0], steps + 1)[1:-1]:
        k = max(min(int(np.argmin(np.abs(lam - target))), times[-1] - 1), 0)
        if k < times[-1]:
            times.append(k)
    return times + [-1]


def half_log_snr(ac: np.ndarray, t: int) -> float:
    return 60.0 if t < 0 else 0.5 * np.log(ac[t] / (1.0 - ac[t]))


def dpm_update(x: torch.Tensor, v: torch.Tensor, t: int, t_next: int, ac: np.ndarray,
               prev=None):
    """One DPM-Solver++(2M) step from x at t to t_next for a pred_v output
    v: returns (x at t_next, (x0, h)), the second to pass as `prev` to the
    next step (the first step is Euler's)."""
    a_t, s_t = np.sqrt(ac[t]), np.sqrt(1.0 - ac[t])
    x0 = (float(a_t) * x - float(s_t) * v.float()).clamp(-1.0, 1.0)
    h = half_log_snr(ac, t_next) - half_log_snr(ac, t)
    d = x0
    if prev is not None:
        r = prev[1] / h
        d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * prev[0]
    if t_next < 0:
        return x0, (x0, h)
    a_n, s_n = np.sqrt(ac[t_next]), np.sqrt(1.0 - ac[t_next])
    return float(s_n / s_t) * x - float(a_n * np.expm1(-h)) * d, (x0, h)


def dpm_solver_2m(model_fn: Callable, x: torch.Tensor, ac: np.ndarray, steps: int
                  ) -> torch.Tensor:
    """DPM-Solver++(2M) from x_T = x for a pred_v model_fn(x, t) -> v."""
    times = lambda_grid(ac, steps)
    prev = None
    for t, t_next in zip(times[:-1], times[1:]):
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        x, prev = dpm_update(x, model_fn(x, tb), t, t_next, ac, prev)
    return x


def pred_v_loss(model_fn: Callable, x_start: torch.Tensor, t: torch.Tensor,
                noise: torch.Tensor, ac: np.ndarray) -> torch.Tensor:
    """Mean over the batch of snr/(snr+1)[t] times each sample's mean
    squared error of v."""
    act = torch.as_tensor(ac, dtype=torch.float64, device=x_start.device)[t]
    a = act.sqrt().float()[:, None, None, None]
    s = (1.0 - act).sqrt().float()[:, None, None, None]
    x_t = a * x_start + s * noise
    target = a * noise - s * x_start
    out = model_fn(x_t, t).float()
    weight = (act / (1.0 - act)) / (act / (1.0 - act) + 1.0)
    per = (out - target).square().mean(dim=(1, 2, 3))
    return (per * weight.float()).mean()
