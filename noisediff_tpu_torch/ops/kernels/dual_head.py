"""NoiseDiffNet's dual output head: a hand-written Hopper kernel
(`csrc/dual_head.cu`) and its plain PyTorch version.

    out = fc2(gelu(fc1(shot_a + shot_b))) + conv1x1(x)     (fp32)

shot_mlp3 (fc1 C -> C, fc2 C -> 4) on the shot branch plus final_conv
(C -> 4) on the trunk. Counterpart of noisediff_tpu/ops/pallas/dual_head.py
(`fused_dual_head`).

`fused_dual_head` runs the plain version for a tensor on the CPU and the
CUDA kernel for a tensor on the card; anything the kernel does not take
raises. `fused_dual_head.launches` counts kernel launches.

Where a gradient is wanted on the card the wrapper is a
torch.autograd.Function: the forward is the kernel; the backward is
autograd of `reference_dual_head`, recomputed from the saved inputs. That
is the JAX package's own design (ops/pallas/dual_head.py:119-131, a
custom_vjp whose backward is the jnp reference): the JAX package has no
Pallas backward for this kernel, so this plain backward on the card is its
counterpart, not a fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .attn_tail import _linear, gelu

# the library also holds the DDIM tail's entry point (ddim_head.py)
_SIGNATURES = {
    "nd_dual_head": [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "nd_ddim_head": [ctypes.c_void_p] * 12
    + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 7 + [ctypes.c_void_p],
}
_KERNEL_WIDTHS = (16, 32, 48, 64)


def reference_dual_head(x, shot_a, shot_b, w1, b1, w2, b2, wr, br):
    """Plain version with the kernel's arithmetic. x, shot_a, shot_b:
    (B, H, W, C); w1 (C, C), w2 (4, C), wr (4, C) in PyTorch (out, in)
    layout; returns (B, H, W, 4) fp32. shot_a + shot_b and the fc1 output
    are stored in the input dtype, the 4-wide products sum in fp32."""
    h = gelu(_linear(shot_a + shot_b, w1, b1).to(x.dtype))
    return _linear(h, w2, b2) + _linear(x, wr, br)


def head_params(w1, b1, w2, b2, wr, br, dev):
    """The head parameters as the kernel reads them: fp32, contiguous, on
    `dev`; each is the tensor itself when it already is (the model's fp32
    parameters: nothing is cast per call; the kernel rounds the weights to
    bf16 while staging them)."""
    return tuple(_build.on_device(t, dev, torch.float32) for t in (w1, b1, w2, b2, wr, br))


def head_args(x, shot_a, shot_b, w1, b1, w2, b2, wr, br, what: str):
    """Check the kernel's inputs and return the head parameters as the
    kernel takes them (`head_params`) with the pixel count. Shared with the
    DDIM tail."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    for t in (x, shot_a, shot_b):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel is built for bfloat16, got {t.dtype}")
        if t.shape != x.shape or t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{what} kernel takes three contiguous (B, H, W, C) tensors")
    b, h, w, c = x.shape
    if c not in _KERNEL_WIDTHS:
        raise ValueError(f"{what} kernel is built for C in {_KERNEL_WIDTHS}, got {c}")
    if tuple(w1.shape) != (c, c) or tuple(w2.shape) != (4, c) or tuple(wr.shape) != (4, c):
        raise ValueError(f"{what} kernel: head shapes must be (C, C), (4, C), (4, C)")
    return head_params(w1, b1, w2, b2, wr, br, x.device), b * h * w


def _launch(x, shot_a, shot_b, w1, b1, w2, b2, wr, br):
    params, p = head_args(x, shot_a, shot_b, w1, b1, w2, b2, wr, br, "dual_head")
    dev = x.device
    out = torch.empty(x.shape[:3] + (4,), device=dev, dtype=torch.float32)
    lib = _build.library("dual_head", _SIGNATURES)
    code = lib.nd_dual_head(
        x.data_ptr(), shot_a.data_ptr(), shot_b.data_ptr(), *(a.data_ptr() for a in params),
        out.data_ptr(), p, x.shape[-1], torch.cuda.current_stream(dev).cuda_stream,
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
    args = (x, shot_a, shot_b, w1, b1, w2, b2, wr, br)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _DualHead.apply(*args)
    return _launch(*args)


fused_dual_head.launches = 0
