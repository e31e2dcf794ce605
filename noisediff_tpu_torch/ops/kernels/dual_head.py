"""NoiseDiffNet's dual output head: a hand-written Hopper kernel
(`csrc/dual_head.cu`) and its plain PyTorch version.

    out = fc2(gelu(fc1(shot_a + shot_b))) + conv1x1(x)     (fp32)

shot_mlp3 (fc1 C -> C, fc2 C -> 4) on the shot branch plus final_conv
(C -> 4) on the trunk. Counterpart of noisediff_tpu/ops/pallas/dual_head.py
(`fused_dual_head`).

`fused_dual_head` runs the plain version for a tensor on the CPU and the
CUDA kernel for a tensor on the card; anything the kernel does not take
raises. `fused_dual_head.launches` counts kernel launches.

On the card the wrapper is a torch.autograd.Function: the forward is the
kernel; the backward is autograd of `reference_dual_head`, recomputed from
the saved inputs. That is the JAX package's own design
(ops/pallas/dual_head.py:119-131, a custom_vjp whose backward is the jnp
reference): the JAX package has no Pallas backward for this kernel, so this
plain backward on the card is its counterpart, not a fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .attn_tail import _linear, gelu

_SIGNATURES = {
    "nd_dual_head": [ctypes.c_void_p] * 10
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
_KERNEL_WIDTHS = (16, 32, 48, 64)
_BLOCKS_PER_SM = 8


def reference_dual_head(x, shot_a, shot_b, w1, b1, w2, b2, wr, br):
    """Plain version with the kernel's arithmetic. x, shot_a, shot_b:
    (B, H, W, C); w1 (C, C), w2 (4, C), wr (4, C) in PyTorch (out, in)
    layout; returns (B, H, W, 4) fp32. shot_a + shot_b and the fc1 output
    are stored in the input dtype, the 4-wide products sum in fp32."""
    h = gelu(_linear(shot_a + shot_b, w1, b1).to(x.dtype))
    return _linear(h, w2, b2) + _linear(x, wr, br)


def _launch(x, shot_a, shot_b, w1, b1, w2, b2, wr, br):
    if x.device.type != "cuda":
        raise ValueError(f"dual_head kernel needs a CUDA tensor, got {x.device}")
    for t in (x, shot_a, shot_b):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"dual_head kernel is built for bfloat16, got {t.dtype}")
        if t.shape != x.shape or t.dim() != 4 or not t.is_contiguous():
            raise ValueError("dual_head kernel takes three contiguous (B, H, W, C) tensors")
    b, h, w, c = x.shape
    if c not in _KERNEL_WIDTHS:
        raise ValueError(f"dual_head kernel is built for C in {_KERNEL_WIDTHS}, got {c}")
    if tuple(w1.shape) != (c, c) or tuple(w2.shape) != (4, c) or tuple(wr.shape) != (4, c):
        raise ValueError("dual_head kernel: head shapes must be (C, C), (4, C), (4, C)")
    dev = x.device

    def w_rounded(t):  # the products take bf16 weights, held as fp32
        return _build.on_device(t, dev, torch.bfloat16).float()

    def f32(t):
        return _build.on_device(t, dev, torch.float32)

    args = (w_rounded(w1), f32(b1), w_rounded(w2), f32(b2), w_rounded(wr), f32(br))
    p = b * h * w
    out = torch.empty((b, h, w, 4), device=dev, dtype=torch.float32)
    lib = _build.library("dual_head", _SIGNATURES)
    code = lib.nd_dual_head(
        _build.ptr(x), _build.ptr(shot_a), _build.ptr(shot_b),
        *(_build.ptr(a) for a in args), _build.ptr(out),
        p, c, max(1, min(-(-p // 128), _BLOCKS_PER_SM * _build.sm_count(dev))),
        _build.stream_ptr(dev),
    )
    _build.check(lib, code, "dual_head")
    fused_dual_head.launches += 1
    return out


class _DualHead(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed (the JAX custom_vjp's jnp backward)."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        return _launch(*inputs)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = reference_dual_head(*inputs)
            return torch.autograd.grad(out, inputs, g)


def fused_dual_head(x, shot_a, shot_b, w1, b1, w2, b2, wr, br) -> torch.Tensor:
    """Both heads in one pass; see `reference_dual_head` for the arguments.
    Differentiable on both devices."""
    if x.device.type == "cpu":
        return reference_dual_head(x, shot_a, shot_b, w1, b1, w2, b2, wr, br)
    return _DualHead.apply(x, shot_a, shot_b, w1, b1, w2, b2, wr, br)


fused_dual_head.launches = 0
