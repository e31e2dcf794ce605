"""Quality metrics: PSNR, SSIM (skimage and MATLAB protocols), illuminance
correction, and the KLD noise-realism histograms.

Port of noisediff_tpu/ops/metrics.py:
  quality_assess           test_denoising.py:220-229 (skimage PSNR and
                           SSIM(channel_axis=2): a uniform 7x7 window)
  MATLAB PSNR / SSIM       utils/calculate_PSNR_SSIM.py:38-90 (an 11x11
                           gaussian window, sigma 1.5)
  KLD histogram protocol   utils/util.py:188-227 (noise_flow's)
  IlluminanceCorrect       test_denoising.py:232-263 (a least-squares scale
                           over the pixels where the source is not 1)

PSNR, SSIM and the illuminance correction take tensors and compute in
float32 on the tensor's device, so a full frame is evaluated where it lies;
the depthwise VALID filter is `F.conv2d` with one group per channel. The
image converters and the KLD helpers are numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# PSNR
# ---------------------------------------------------------------------------

def psnr(estimate: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak SNR, matching skimage.peak_signal_noise_ratio; a 0-d tensor."""
    err = torch.mean((estimate.float() - target.float()) ** 2)
    return 10.0 * torch.log10((data_range ** 2) / err)


# ---------------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------------

def _filter_valid(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """'valid' 2-D filter applied per channel of (H, W, C): a depthwise
    cross-correlation, as lax.conv with feature_group_count = C."""
    c = x.shape[-1]
    k = kernel2d.to(device=x.device, dtype=x.dtype)[None, None].expand(c, 1, *kernel2d.shape)
    return F.conv2d(x.permute(2, 0, 1)[None], k, groups=c)[0].permute(1, 2, 0)


def ssim(estimate: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """skimage structural_similarity for float (H, W, C) images: a uniform
    win_size window, unbiased covariance (N / (N - 1)), the mean over the
    valid (border-cropped) region and over the channels; a 0-d tensor."""
    x = estimate.float()
    y = target.float()
    kernel = torch.full((win_size, win_size), 1.0 / (win_size * win_size))

    ux = _filter_valid(x, kernel)
    uy = _filter_valid(y, kernel)
    uxx = _filter_valid(x * x, kernel)
    uyy = _filter_valid(y * y, kernel)
    uxy = _filter_valid(x * y, kernel)

    n = win_size * win_size
    cov_norm = n / (n - 1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean()


def psnr_matlab(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-protocol PSNR over [0, 255] images, inf on identical inputs
    (utils/calculate_PSNR_SSIM.py:38-47)."""
    a = np.asarray(img1, np.float64)
    b = np.asarray(img2, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR -> YCbCr with the ITU-R BT.601 MATLAB coefficients
    (utils/calculate_PSNR_SSIM.py:93-114): uint8 in [0, 255] or float in
    [0, 1], the output in the input's type and range."""
    in_type = img.dtype
    x = img.astype(np.float32)
    if in_type != np.uint8:
        x = x * 255.0
    if only_y:
        out = x @ np.array([24.966, 128.553, 65.481], np.float32) / 255.0 + 16.0
    else:
        out = x @ np.array(
            [[24.966, 112.0, -18.214],
             [128.553, -74.203, -93.786],
             [65.481, -37.797, 112.0]], np.float32,
        ) / 255.0 + np.array([16, 128, 128], np.float32)
    if in_type == np.uint8:
        out = out.round()
    else:
        out = out / 255.0
    return out.astype(in_type)


def tensor2img(arr, out_type=np.uint8, min_max=(0.0, 1.0)) -> np.ndarray:
    """CHW (or a BCHW grid, or HW) array -> HWC image, as the reference's
    tensor2img (utils/calculate_PSNR_SSIM.py:13-35): clamp to min_max,
    rescale to [0, 1], RGB -> BGR, optional uint8 rounding. 4-D inputs are
    tiled as torchvision make_grid(nrow=int(sqrt(n)), padding=0) tiles them
    (the reference's call, :25): nrow images to a row, no borders."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().float().cpu().numpy()
    x = np.asarray(arr, np.float32)
    x = np.squeeze(x)
    x = np.clip(x, *min_max)
    x = (x - min_max[0]) / (min_max[1] - min_max[0])
    if x.ndim == 4:  # (B, C, H, W) -> make_grid(nrow=int(sqrt(n)), padding=0)
        n, c, h, w = x.shape
        xmaps = max(min(int(np.sqrt(n)), n), 1)  # images per row
        ymaps = int(np.ceil(n / xmaps))
        grid = np.zeros((c, ymaps * h, xmaps * w), np.float32)
        for i in range(n):
            r, col = divmod(i, xmaps)
            grid[:, r * h: r * h + h, col * w: col * w + w] = x[i]
        x = grid
    if x.ndim == 3:
        x = np.transpose(x[[2, 1, 0], :, :], (1, 2, 0))  # CHW RGB -> HWC BGR
    if out_type == np.uint8:
        x = (x * 255.0).round()
    return x.astype(out_type)


def tensor2im(arr, visualize: bool = False, video: bool = False) -> np.ndarray:
    """BCHW array -> HWC (BHWC with video) float image scaled to [0, 255],
    as the reference's tensor2im (utils/metric_util.py:9-24): visualize
    keeps the first 3 channels; video keeps the batch axis, otherwise image
    0 is taken; values clipped to [0, 255]."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().float().cpu().numpy()
    x = np.asarray(arr, np.float32)
    if visualize:
        x = x[:, 0:3, ...]
    if not video:
        out = np.transpose(x[0], (1, 2, 0)) * 255.0
    else:
        out = np.transpose(x, (0, 2, 3, 1)) * 255.0
    return np.clip(out, 0, 255)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    half = size // 2
    coords = torch.arange(-half, half + 1, dtype=torch.float32)
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim_matlab(estimate: torch.Tensor, target: torch.Tensor,
                data_range: float = 255.0) -> torch.Tensor:
    """MATLAB-protocol SSIM (utils/calculate_PSNR_SSIM.py:61-90): an 11x11
    gaussian window of sigma 1.5, biased (population) covariance, the valid
    region; (H, W) or (H, W, C) images."""
    x = estimate.float()
    y = target.float()
    if x.ndim == 2:
        x = x[..., None]
        y = y[..., None]
    kernel = _gaussian_kernel(11, 1.5)

    mu1 = _filter_valid(x, kernel)
    mu2 = _filter_valid(y, kernel)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter_valid(x * x, kernel) - mu1_sq
    sigma2_sq = _filter_valid(y * y, kernel) - mu2_sq
    sigma12 = _filter_valid(x * y, kernel) - mu12

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return s.mean()


def quality_assess(estimate: np.ndarray, target: np.ndarray,
                   data_range: float = 1.0) -> Dict[str, float]:
    """PSNR and SSIM of an (H, W, C) pair (test_denoising.py:220-229; the
    argument order there is (X = estimate, Y = correct))."""
    if estimate.ndim != 3:
        raise NotImplementedError("quality_assess expects (H, W, C) images")
    e, t = torch.as_tensor(np.asarray(estimate)), torch.as_tensor(np.asarray(target))
    return {"PSNR": float(psnr(e, t, data_range)), "SSIM": float(ssim(e, t, data_range))}


# ---------------------------------------------------------------------------
# Illuminance correction (test_denoising.py:232-263)
# ---------------------------------------------------------------------------

def illuminance_correct(predict: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Least-squares brightness alignment: scale = <p, s> / <p, p> over the
    pixels where source != 1 (saturated pixels excluded), applied to the
    clamped prediction. (H, W, C) inputs, or batched (B, H, W, C) ones with
    one scale a sample (a source of batch 1 serves every sample)."""
    pred = predict.float().clamp(0.0, 1.0)
    src = source.float()
    if pred.ndim == 4 and src.shape[0] == 1 and pred.shape[0] != 1:
        src = src.expand_as(pred)
    mask = (src != 1.0).float()
    dims = tuple(range(pred.ndim - 3, pred.ndim))
    num = torch.sum(pred * src * mask, dim=dims, keepdim=True)
    den = torch.sum(pred * pred * mask, dim=dims, keepdim=True)
    return num / den * pred


# ---------------------------------------------------------------------------
# KLD noise-realism protocol (utils/util.py:188-227)
# ---------------------------------------------------------------------------

def get_histogram(data: np.ndarray, bin_edges: np.ndarray | None = None,
                  left_edge: float = 0.0, right_edge: float = 1.0,
                  n_bins: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    data_range = right_edge - left_edge
    bin_width = data_range / n_bins
    if bin_edges is None:
        bin_edges = np.arange(left_edge, right_edge + bin_width, bin_width)
    bin_centers = bin_edges[:-1] + bin_width / 2.0
    n = np.prod(data.shape)
    hist, _ = np.histogram(data, bin_edges)
    return hist / n, bin_centers


def _valid_pq(p, q):
    idx = ~(np.isnan(p) | np.isinf(p) | np.isnan(q) | np.isinf(q))
    p, q = p[idx], q[idx]
    idx = (p > 0) & (q > 0)
    return p[idx], q[idx]


def kl_div_forward(p: np.ndarray, q: np.ndarray) -> float:
    p, q = _valid_pq(p, q)
    return float(np.sum(p * np.log(p / q)))


def kl_div_inverse(p: np.ndarray, q: np.ndarray) -> float:
    p, q = _valid_pq(p, q)
    return float(np.sum(q * np.log(q / p)))


def kl_div_3(p: np.ndarray, q: np.ndarray) -> Tuple[float, float, float]:
    fwd = kl_div_forward(p, q)
    inv = kl_div_inverse(p, q)
    return fwd, inv, (fwd + inv) / 2.0


def noise_kld(real_noise: np.ndarray, synth_noise: np.ndarray, n_bins: int = 1000,
              left_edge: float = -0.1, right_edge: float = 0.1) -> Tuple[float, float, float]:
    """Forward, inverse and symmetric KLD between the real and synthetic
    noise histograms over one binning (the reference's evaluation)."""
    edges = np.linspace(left_edge, right_edge, n_bins + 1)
    edges = np.concatenate([[-1000.0], edges, [1000.0]])
    p, _ = get_histogram(real_noise, bin_edges=edges)
    q, _ = get_histogram(synth_noise, bin_edges=edges)
    return kl_div_3(p, q)
