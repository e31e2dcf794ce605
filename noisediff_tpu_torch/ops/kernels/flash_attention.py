"""Non-causal attention with an online softmax: a hand-written Hopper kernel
(`csrc/flash_attention.cu`) and its plain PyTorch version.

    flash_attention(q, k, v) = softmax(q k^T scale) v,   scale = 1 / sqrt(D)

q (B, H, Nq, D), k and v (B, H, Nk, D), as the JAX package lays them out.
Counterpart of noisediff_tpu/ops/pallas/flash_attention.py
(`flash_attention`, `_flash_forward`). The JAX function runs its jnp
reference for lengths its tiles do not divide; the kernel masks the ragged
tail itself, so on the card every length runs through it.

On the card the wrapper is a torch.autograd.Function: the forward is the
kernel; the backward is autograd of `reference_flash_attention`,
recomputed from the saved inputs. That is the JAX package's own design
(flash_attention.py:124-132, a custom_vjp whose backward is the jnp
reference), not a fallback.

`flash_attention` runs the plain version for a tensor on the CPU and the
kernel for a tensor on the card; anything the kernel does not take raises.
`flash_attention.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_SIGNATURES = {
    "nd_flash_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
}
_HEAD_DIMS = (32, 64)


def reference_flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain version (`_attention_reference` of the JAX package): logits in
    the inputs' dtype, then fp32 times the scale; softmax in fp32; the
    weights cast to v's dtype for the product with v."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def _launch(q, k, v, scale: float):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs a CUDA tensor, got {q.device}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel is built for bfloat16, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError("flash_attention kernel takes contiguous (B, H, N, D) tensors")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel is built for D in {_HEAD_DIMS}, got {d}")
    if k.shape != (b, h, nk, d) or v.shape != k.shape or nq < 1 or nk < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match")
    if not scale > 0:
        raise ValueError(f"flash_attention kernel takes a positive scale, got {scale}")
    dev = q.device
    out = torch.empty_like(q)
    lib = _build.library("flash_attention", _SIGNATURES)
    code = lib.nd_flash_attention(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                                  b * h, nq, nk, d, float(scale), _build.stream_ptr(dev))
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed (the JAX custom_vjp's jnp backward)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = reference_flash_attention(*inputs, ctx.scale)
            return (*torch.autograd.grad(out, inputs, g), None)


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Nq, D) x (B, H, Nk, D) -> (B, H, Nq, D), softmax(q k^T scale) v
    with scale 1 / sqrt(D) by default. Differentiable on both devices."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return reference_flash_attention(q, k, v, scale)
    return _FlashAttention.apply(q, k, v, scale)


flash_attention.launches = 0
