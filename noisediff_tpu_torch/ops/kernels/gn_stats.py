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

Bound on the H100: memory (one read of x, or of g and x). One launch a
call: each sample's rows are split over `plan`'s S blocks, and the block
that arrives last sums the sample's S partials in a fixed order (see the
.cu file). The two sums come back as the two views of one (2, B, C)
tensor.

On a CPU tensor each function runs its plain version; on a CUDA tensor it
launches its kernel or raises. `gn_stats.launches` and
`gn_grad_stats.launches` count kernel launches. Neither is differentiable:
the model's autograd Functions call them inside forward and backward.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import torch

from . import _build

_SIGNATURES = {
    "nd_gn_stats": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "nd_gn_grad_stats": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}
_MAX_C = 2048
# the kernel's block: up to THREADS threads, a whole number of rows of C / 8
# sixteen-byte pieces each
THREADS = 512
# blocks a sample's rows go to: one per SLAB_BYTES of the sample (of each
# input), and no more than fill the card BLOCKS_PER_SM deep (the blocks an
# SM holds at once: registers)
SLAB_BYTES = 128 * 1024
BLOCKS_PER_SM = 2

Pair = Tuple[torch.Tensor, torch.Tensor]


@lru_cache(maxsize=256)
def plan(b: int, n: int, c: int, sms: int) -> dict:
    """The kernel's launch for (b, n, c) maps on a card of `sms` SMs: grid
    (splits, b) of `threads` threads; block (s, j) sums rows [s * rows,
    min(n, (s + 1) * rows)) of sample j. Scratch: `part` fp32 partials
    (b, splits, 2c) and `counters` arrival words (b); `smem`: the block's
    dynamic shared memory in bytes, which the kernel is launched with:
    [rows in flight][2c] fp32 sums and the slices of their reduction (at
    most one float a thread)."""
    lanes = c // 8
    rif = max(1, THREADS // lanes)  # rows in flight
    fill = -(-BLOCKS_PER_SM * sms // b)
    by_bytes = -(-n * c * 2 // SLAB_BYTES)
    splits = max(1, min(n, fill, by_bytes))
    rows = max(1, -(-n // splits))
    splits = max(1, -(-n // rows))
    threads = rif * lanes
    return dict(splits=splits, rows=rows, threads=threads, smem=(rif * 2 * c + threads) * 4,
                part=b * splits * 2 * c, counters=b)


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


class _Scratch:
    """The kernel's partials and per-sample arrival counters for one (card,
    stream), grown as calls need. The counters start at zero and every call
    leaves them at zero."""

    def __init__(self, dev, parts: int, samples: int):
        self.part = torch.empty(parts, device=dev, dtype=torch.float32)
        self.count = torch.zeros(samples, device=dev, dtype=torch.int32)


_SCRATCH = {}
_KERNEL = {}  # (card index, C entry point name) -> (the entry point, its library, SM count)


def _kernel(dev, fn_name: str):
    k = _KERNEL.get((dev.index, fn_name))
    if k is None:
        lib = _build.library("gn_stats", _SIGNATURES)
        k = _KERNEL[dev.index, fn_name] = (getattr(lib, fn_name), lib, _build.sm_count(dev))
    return k


def _launch(fn_name: str, tensors, what: str) -> Pair:
    x = tensors[-1]
    b, h, w, c = x.shape
    n = h * w
    dev = x.device
    fn, lib, sms = _kernel(dev, fn_name)
    p = plan(b, n, c, sms)
    # the raw handle of the current stream: torch.cuda.current_stream builds
    # a Stream object a call, a large share of the wrapper's host time
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    key = (dev.index, stream)
    s = _SCRATCH.get(key)
    if s is None or s.part.numel() < p["part"] or s.count.numel() < p["counters"]:
        s = _SCRATCH[key] = _Scratch(dev, max(p["part"], 1 << 16), max(p["counters"], 64))
    out = torch.empty((2, b, c), device=dev, dtype=torch.float32)
    code = _build.launch(dev, fn, *(t.data_ptr() for t in tensors), s.part.data_ptr(),
                         s.count.data_ptr(), out.data_ptr(), b, n, c, p["splits"], p["rows"],
                         p["threads"], p["smem"], stream)
    _build.check(lib, code, what)
    return out.unbind(0)


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
