"""Noise-parameter estimation: the sigma-vs-mu regressions and the KL
divergence.

Port of noisediff_tpu/ops/noise_estimation.py (reference
`utils/raw_util.py:161-322`):
  sliding_window                       :161-166  3x3 unfold, pad 1
  compute_poisson_lambda_by_patch      :169-189  per-(B, C) OLS of std vs mean
  compute_poisson_lambda_by_patch_single_image :214-232 the Theil-Sen variant
  kl_divergence                        :237-244  softmax KLDivLoss
  get_poisson_lambda (value-based)     :248-280
  get_poisson_lambda_all_images        :284-322

The window statistics and the KL divergence are tensor functions on the
input's device; the regressions are numpy / scipy on the host, as in the
JAX package (small inputs, and Theil-Sen is a sequential median).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sliding_window_stats(x: torch.Tensor,
                         kernel_size: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window (std, mean) over kernel_size^2 neighbourhoods with zero
    padding, same-size output (F.unfold(padding=1) semantics: the window
    population is always k^2, the pad zeros included; the unbiased
    estimator of torch.std_mean).

    x: (B, H, W, C) -> std, mean, each (B, H * W, C). Box sums instead of
    the reference's (B, C, k * k, N) patch tensor."""
    b, h, w, c = x.shape
    k = kernel_size
    pad = k // 2
    ones = torch.ones((c, 1, k, k), dtype=x.dtype, device=x.device)

    def box(v):
        return F.conv2d(v.permute(0, 3, 1, 2), ones, padding=pad, groups=c).permute(0, 2, 3, 1)

    n = float(k * k)
    mean = box(x) / n
    var = torch.clamp((box(x * x) - n * mean * mean) / (n - 1.0), min=0.0)
    std = torch.sqrt(var)
    return std.reshape(b, h * w, c), mean.reshape(b, h * w, c)


def compute_poisson_lambda_by_patch(x: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """OLS slope and intercept of std vs mean per (batch, channel).

    x: (B, H, W, C); returns (lambda, intercept), each (B, C) (raw_util.py:
    169-189 loops an sklearn LinearRegression per row; this is one closed
    form)."""
    std, mean = sliding_window_stats(x)
    std = std.detach().cpu().numpy().astype(np.float64)
    mean = mean.detach().cpu().numpy().astype(np.float64)
    mx = mean.mean(axis=1)  # (B, C)
    my = std.mean(axis=1)
    cov = ((mean - mx[:, None]) * (std - my[:, None])).sum(axis=1)
    var = ((mean - mx[:, None]) ** 2).sum(axis=1)
    slope = cov / np.where(var == 0, 1.0, var)
    intercept = my - slope * mx
    return slope, intercept


def theil_sen(x: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
    """Robust slope and intercept (scipy.stats.theilslopes)."""
    from scipy.stats import theilslopes

    slope, intercept, _, _ = theilslopes(y, x)
    return float(slope), float(intercept)


def compute_poisson_lambda_single_image(x: torch.Tensor) -> Tuple[float, float]:
    """Theil-Sen std-vs-mean fit over all channels of one (H, W, C) image
    (raw_util.py:214-232). Above 20000 windows, 20000 of them are drawn by
    np.random.default_rng(0), without replacement, as in the JAX package."""
    std, mean = sliding_window_stats(x[None])
    std = std.detach().cpu().numpy().astype(np.float64).reshape(-1)
    mean = mean.detach().cpu().numpy().astype(np.float64).reshape(-1)
    if len(std) > 20000:
        idx = np.random.default_rng(0).choice(len(std), 20000, replace=False)
        std, mean = std[idx], mean[idx]
    return theil_sen(mean, std)


def kl_divergence(input_arr: torch.Tensor, target_arr: torch.Tensor) -> torch.Tensor:
    """Softmax KL between two flattened arrays (raw_util.py:237-244):
    KLDivLoss(reduction='mean') of log_softmax(input) against
    softmax(target), the mean over elements of q * (log q - log p), with
    q log q = 0 where q underflows to 0."""
    p_log = torch.log_softmax(input_arr.reshape(-1).float(), dim=0)
    q = torch.softmax(target_arr.reshape(-1).float(), dim=0)
    safe_log_q = torch.where(q > 0, torch.log(torch.clamp(q, min=1e-38)), torch.zeros_like(q))
    return torch.mean(q * (safe_log_q - p_log))


def get_poisson_lambda(clean: np.ndarray, noisy: np.ndarray,
                       atol: float = 1e-6) -> Tuple[float, float]:
    """Value-based estimate (raw_util.py:248-280): for each unique clean
    value at or below the median, the std of noisy at those positions;
    Theil-Sen of std against the value."""
    values = np.unique(clean)
    median = np.median(values)
    means, stds = [], []
    for v in values:
        if v <= median:
            pts = noisy[np.abs(clean - v) < atol]
            if len(pts) > 1:
                s = pts.std(ddof=1)
                if not np.isnan(s):
                    means.append(v)
                    stds.append(s)
    if not means:
        return 0.0, 0.0
    return theil_sen(np.asarray(means), np.asarray(stds))


def accumulate_value_stats(clean: np.ndarray, noisy: np.ndarray, acc: Dict[float, list],
                           atol: float = 1e-6) -> Dict[float, list]:
    """The multi-image accumulator (raw_util.py:284-300)."""
    for v in np.unique(clean):
        acc.setdefault(float(v), []).extend(noisy[np.abs(clean - v) < atol].tolist())
    return acc


def regress_value_stats(acc: Dict[float, list]) -> Tuple[float, float]:
    """The final Theil-Sen over the accumulated per-value stds
    (raw_util.py:303-322)."""
    means, stds = [], []
    for v, pts in acc.items():
        if len(pts) > 1:
            s = np.std(pts, ddof=1)
            if not np.isnan(s):
                means.append(v)
                stds.append(s)
    return theil_sen(np.asarray(means), np.asarray(stds))
