"""GroupNorm statistics of the training path: hand-written Hopper kernels
(`csrc/gn_stats.cu`) and their plain PyTorch versions.

    gn_stats(x)          -> (sum_hw x, sum_hw x^2)     fp32 (B, C)
    gn_grad_stats(g, x)  -> (sum_hw g, sum_hw g * x)   fp32 (B, C)

for channels-last (B, H, W, C) maps. The first gives the GroupNorm
coefficients of the forward (models/blocks._gn_coeffs), the second the
gradients of the per-(sample, channel) affine y = x * a + bb
(models/blocks._gn_apply). Counterparts of
noisediff_tpu/ops/pallas/gn_stats.py (`gn_stats`, `gn_grad_stats`); its
`custom_partitioning` wrappers are multi-chip plumbing and wait for the
distributed slice.

Bound on the H100: memory (one read of x, or of g and x). The kernels split
each sample's rows over about 4 blocks per SM and sum the per-block
partials in a second, fixed-order pass (see the .cu file).

On a CPU tensor each function runs its plain version; on a CUDA tensor it
launches its kernel or raises. `gn_stats.launches` and
`gn_grad_stats.launches` count kernel launches. Neither is differentiable:
the model's autograd Functions call them inside forward and backward.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_SIGNATURES = {
    "nd_gn_stats": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "nd_gn_grad_stats": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_BLOCKS_PER_SM = 4
_MAX_C = 2048

Pair = Tuple[torch.Tensor, torch.Tensor]


def reference_gn_stats(x: torch.Tensor) -> Pair:
    """Plain version: fp32 per-(sample, channel) sums over H, W."""
    xf = x.float()
    return xf.sum((1, 2)), (xf * xf).sum((1, 2))


def reference_gn_grad_stats(g: torch.Tensor, x: torch.Tensor) -> Pair:
    """Plain version: fp32 (sum_hw g, sum_hw g * x)."""
    gf = g.float()
    return gf.sum((1, 2)), (gf * x.float()).sum((1, 2))


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel is built for bfloat16, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} kernel takes a contiguous, 16-byte aligned (B, H, W, C) tensor")
    c = t.shape[-1]
    if c % 8 or c > _MAX_C:
        raise ValueError(f"{what} kernel needs C % 8 == 0 and C <= {_MAX_C}, got C={c}")


def _launch(fn_name: str, tensors, what: str) -> Pair:
    x = tensors[-1]
    b, h, w, c = x.shape
    n = h * w
    dev = x.device
    splits = max(1, min(n, -(-_BLOCKS_PER_SM * _build.sm_count(dev) // b)))
    rows_per_split = -(-n // splits)
    splits = -(-n // rows_per_split)
    part = torch.empty((b, splits, 2, c), device=dev, dtype=torch.float32)
    s1 = torch.empty((b, c), device=dev, dtype=torch.float32)
    s2 = torch.empty_like(s1)
    lib = _build.library("gn_stats", _SIGNATURES)
    code = getattr(lib, fn_name)(
        *(_build.ptr(t) for t in tensors), _build.ptr(part), _build.ptr(s1), _build.ptr(s2),
        b, n, c, splits, rows_per_split, _build.stream_ptr(dev))
    _build.check(lib, code, what)
    return s1, s2


def gn_stats(x: torch.Tensor) -> Pair:
    """x: (B, H, W, C) -> fp32 (sum_hw x, sum_hw x^2), each (B, C)."""
    if x.device.type == "cpu":
        return reference_gn_stats(x)
    _check(x, "gn_stats")
    out = _launch("nd_gn_stats", (x,), "gn_stats")
    gn_stats.launches += 1
    return out


def gn_grad_stats(g: torch.Tensor, x: torch.Tensor) -> Pair:
    """g, x: (B, H, W, C) -> fp32 (sum_hw g, sum_hw g * x), each (B, C)."""
    if g.device.type == "cpu":
        return reference_gn_grad_stats(g, x)
    _check(g, "gn_grad_stats")
    _check(x, "gn_grad_stats")
    if g.shape != x.shape:
        raise ValueError(f"gn_grad_stats: g {tuple(g.shape)} and x {tuple(x.shape)} differ")
    out = _launch("nd_gn_grad_stats", (g, x), "gn_grad_stats")
    gn_grad_stats.launches += 1
    return out


gn_stats.launches = 0
gn_grad_stats.launches = 0
