"""The w8a8 int8 convolution of the inference route (NOISEDIFF_INT8=1):
hand-written Hopper kernels (`csrc/int8_conv.cu`) and their plain PyTorch
versions.

    absmax(x)                                -> fp32 (1,): max |x|
    int8_conv(x, kq, sw, amax, padding, bias=None, into=None)
        -> (B, Ho, Wo, Co) in x's dtype

The math of the JAX package's `blocks._quantized_conv`
(noisediff_tpu/models/blocks.py:196-216), which XLA lowers; there is no
Pallas kernel behind it:

    sw = max(max|w| over (kh, kw, ci) / 127, 1e-12)   per output channel,
                                                      of the fp32 weight
    kq = clip(round(w / sw), -127, 127)               int8
    sx = max(max|x| / 127, 1e-12)                     one fp32 scalar over
                                                      the whole tensor
    xq = clip(round(float32(x) * (1 / sx)), -127, 127)
    y  = float32(sum kq * xq, int32) * (sx * sw)      rounded to x's dtype

Rounding is half to even throughout. `quantize_weight` makes (kq, sw) once
per weight (the model caches them, `blocks.Conv2d`); `absmax` gives max|x|
on the device, where the kernel reads it: no scale goes to the host. A
convolution of a channel concat runs as one call per part, each part with
its own scales: `into` is the previous part's output, to which this part's
is added in x's dtype, and `bias` (the fp32 parameter, rounded to x's
dtype) is added after the last part, as the JAX module adds them
(blocks.py:518-548).

kq is laid out (Co, kh, kw, Cip): the int8 kernel K-major per output
channel, Ci zero-padded to Cip, a multiple of the kernel's depth step of 32
(`K_STEP`), so the kernel's weight loads are whole 16-byte pieces.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises on what the kernel does not take: stride 1
only (a padding may differ along H and W), kh = kw in {1, 3}, Ci >= 16;
x bf16 or fp32, NHWC and contiguous. `int8_conv.launches` and
`absmax.launches` count kernel launches. Neither is differentiable: the
route serves inference only, and the trainers refuse the flag.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# the JAX package's `_INT8_MIN_CHANNELS`: narrower convs keep the compute dtype
MIN_CHANNELS = 16
# the kernel's depth step: one m16n8k32 product
K_STEP = 32
KERNEL_SIZES = (1, 3)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "nd_absmax": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "nd_int8_conv": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 10 + [ctypes.c_void_p],
}
# absmax's grid: at most ABSMAX_BLOCKS blocks of ABSMAX_THREADS threads,
# each thread at least ABSMAX_PER_THREAD 16-byte pieces
ABSMAX_THREADS = 256
ABSMAX_BLOCKS = 1024
ABSMAX_PER_THREAD = 8


def int8_enabled() -> bool:
    """The JAX package's `_int8_enabled` (NOISEDIFF_INT8=1). Read where a
    model is built: each `Conv2d` decides at construction."""
    return os.environ.get("NOISEDIFF_INT8", "0") == "1"


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division: PyTorch divides a CUDA tensor by a
    Python number as a multiplication by its reciprocal, which can differ
    in the last bit."""
    return t / torch.full_like(t, 127.0)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 weight (Co, Ci, kh, kw) -> (kq int8 (Co, kh, kw, Cip), sw fp32
    (Co,)), on w's device; Cip is Ci rounded up to `K_STEP`, zero-filled."""
    w = w.detach().float()
    sw = torch.clamp_min(_over_127(w.abs().amax(dim=(1, 2, 3))), 1e-12)
    kq = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127).to(torch.int8)
    kq = kq.permute(0, 2, 3, 1)
    ci = kq.shape[-1]
    return F.pad(kq, (0, -ci % K_STEP)).contiguous(), sw.contiguous()


def reference_absmax(x: torch.Tensor) -> torch.Tensor:
    """Plain version: max |x| as fp32, shape (1,)."""
    return x.abs().amax().float().reshape(1)


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """sx = max(amax / 127, 1e-12), fp32."""
    return torch.clamp_min(_over_127(amax.float()), 1e-12)


def out_size(x_shape, kq_shape, padding) -> Tuple[int, int]:
    """(Ho, Wo) of a stride-1 conv of an (B, H, W, Ci) map with padding (ph, pw)."""
    (ph, pw), kh, kw = padding, kq_shape[1], kq_shape[2]
    return x_shape[1] + 2 * ph - kh + 1, x_shape[2] + 2 * pw - kw + 1


def reference_int8_conv(x: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor,
                        amax: torch.Tensor, padding: Tuple[int, int],
                        bias: Optional[torch.Tensor] = None,
                        into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version with the kernel's arithmetic. x (B, H, W, Ci) NHWC;
    kq, sw from `quantize_weight`; amax fp32 (1,) (`absmax`, or its maximum
    over a spatial line); returns (B, Ho, Wo, Co) in x's dtype. The integer
    sum is a float64 convolution of the int8 values, exact below 2^53 (an
    fp32 one is not: 9 * 384 * 127^2 > 2^24), converted to fp32 as XLA
    converts the int32 sum."""
    dt = x.dtype
    ci = x.shape[-1]
    sx = activation_scale(amax)
    xq = torch.clamp(torch.round(x.float() * torch.reciprocal(sx)), -127, 127)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), kq[..., :ci].permute(0, 3, 1, 2).double(),
                   padding=tuple(padding))
    y = (acc.permute(0, 2, 3, 1).float() * (sx * sw)).to(dt)
    if into is not None:
        y = into + y
    if bias is not None:
        y = y + bias.to(dt)
    return y.contiguous()


def _check(x, kq, sw, amax, padding, bias, into):
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_conv kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("int8_conv kernel takes a contiguous (B, H, W, Ci) tensor")
    b, h, w, ci = x.shape
    if kq.dim() != 4 or kq.dtype != torch.int8 or not kq.is_contiguous():
        raise ValueError("int8_conv kernel takes kq as contiguous int8 (Co, kh, kw, Cip)")
    co, kh, kw, cip = kq.shape
    if kh != kw or kh not in KERNEL_SIZES:
        raise ValueError(f"int8_conv kernel takes kh = kw in {KERNEL_SIZES}, got {kh}x{kw}")
    if ci < MIN_CHANNELS or cip != ci + (-ci % K_STEP):
        raise ValueError(f"int8_conv kernel needs Ci >= {MIN_CHANNELS} and kq padded to a "
                         f"multiple of {K_STEP}: Ci={ci}, Cip={cip}")
    ph, pw = padding
    if not (0 <= ph < kh and 0 <= pw < kw):
        raise ValueError(f"int8_conv kernel takes a padding below the kernel size, got {padding}")
    ho, wo = out_size(x.shape, kq.shape, padding)
    if b * ho * wo == 0:
        raise ValueError(f"int8_conv kernel: an empty output ({b}, {ho}, {wo})")
    for t, n, what in ((sw, co, "sw"), (amax, 1, "amax"), (bias, co, "bias")):
        if t is not None and (t.dtype != torch.float32 or t.numel() != n
                              or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"int8_conv kernel takes {what} as {n} contiguous fp32 values "
                             f"on {x.device}")
    if into is not None and (into.shape != (b, ho, wo, co) or into.dtype != x.dtype
                             or not into.is_contiguous() or into.device != x.device):
        raise ValueError("int8_conv kernel takes `into` as the output's contiguous map")
    return b, h, w, ci, cip, co, kh, ho, wo


_KERNEL = {}  # (card index, entry point name) -> (the entry point, its library)


def _kernel(dev, fn_name: str):
    k = _KERNEL.get((dev.index, fn_name))
    if k is None:
        lib = _build.library("int8_conv", _SIGNATURES)
        k = _KERNEL[dev.index, fn_name] = (getattr(lib, fn_name), lib)
    return k


def int8_conv(x: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor, amax: torch.Tensor,
              padding: Tuple[int, int], bias: Optional[torch.Tensor] = None,
              into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The quantized stride-1 conv of one part; see `reference_int8_conv`
    for the arguments. On the card the sum with `into` is written into
    `into` itself, which is returned."""
    if x.device.type == "cpu":
        return reference_int8_conv(x, kq, sw, amax, padding, bias, into)
    if bias is not None:
        bias = _build.on_device(bias, x.device, torch.float32)
    b, h, w, ci, cip, co, k, ho, wo = _check(x, kq, sw, amax, padding, bias, into)
    dev = x.device
    fn, lib = _kernel(dev, "nd_int8_conv")
    out = into if into is not None else torch.empty((b, ho, wo, co), device=dev, dtype=x.dtype)
    code = _build.launch(
        dev, fn, x.data_ptr(), _DTYPES[x.dtype], kq.data_ptr(), sw.data_ptr(), amax.data_ptr(),
        None if bias is None else bias.data_ptr(), None if into is None else into.data_ptr(),
        out.data_ptr(), b, h, w, ci, cip, co, k, padding[0], padding[1], int(x.data_ptr() % 16 == 0),
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, code, "int8_conv")
    int8_conv.launches += 1
    return out


class _Scratch:
    """absmax's per-block maxima and its arrival counter for one (card,
    stream). The counter starts at zero and every call leaves it at zero."""

    def __init__(self, dev):
        self.part = torch.empty(ABSMAX_BLOCKS, device=dev, dtype=torch.float32)
        self.count = torch.zeros(1, device=dev, dtype=torch.int32)


_SCRATCH = {}


def absmax_blocks(n: int) -> int:
    """absmax's grid for n elements: a block per ABSMAX_THREADS *
    ABSMAX_PER_THREAD 8-element pieces, at most ABSMAX_BLOCKS."""
    per_block = ABSMAX_THREADS * ABSMAX_PER_THREAD * 8
    return max(1, min(ABSMAX_BLOCKS, -(-n // per_block)))


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| of a bf16 or fp32 tensor as fp32 (1,), on x's device."""
    if x.device.type == "cpu":
        return reference_absmax(x)
    if x.dtype not in _DTYPES or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"absmax kernel takes a contiguous, non-empty bf16 or fp32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    dev = x.device
    fn, lib = _kernel(dev, "nd_absmax")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    s = _SCRATCH.get((dev.index, stream))
    if s is None:
        s = _SCRATCH[dev.index, stream] = _Scratch(dev)
    out = torch.empty(1, device=dev, dtype=torch.float32)
    code = _build.launch(dev, fn, x.data_ptr(), _DTYPES[x.dtype], x.numel(), s.part.data_ptr(),
                         s.count.data_ptr(), out.data_ptr(), absmax_blocks(x.numel()), stream)
    _build.check(lib, code, "absmax")
    absmax.launches += 1
    return out


int8_conv.launches = 0
absmax.launches = 0
