"""AttnBlock tail for a single-token context: a hand-written Hopper kernel
(`csrc/attn_tail.cu`) and its plain PyTorch version.

NoiseDiffNet's AttnBlocks attend to one ISO token, so the attention output
`tok` is a per-sample vector that does not depend on x, and the block is
the channel-local chain

    tok2 = x + tok
    out  = proj(FF(LN2(tok2)) + tok2) + x

Counterpart of noisediff_tpu/ops/pallas/attn_tail.py (`fused_attn_tail`,
forward; the backward waits for the training slice).

`fused_attn_tail` runs the plain version for a tensor on the CPU and the
CUDA kernel for a tensor on the card; anything the kernel does not take
raises. `fused_attn_tail.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    "nd_attn_tail": [ctypes.c_void_p] * 11
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in the dtype of x: tanh form for bf16, exact erf form otherwise
    (the JAX package's `_gelu`), evaluated in fp32 and rounded once."""
    approx = "tanh" if x.dtype == torch.bfloat16 else "none"
    return F.gelu(x.float(), approximate=approx).to(x.dtype)


def _linear(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ w.T + b with a and w in a's dtype, products and sums in fp32."""
    return F.linear(a.float(), w.to(a.dtype).float(), b.float())


def reference_attn_tail(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps: float = 1e-5):
    """Plain version with the kernel's arithmetic. x: (B, H, W, C); tok:
    (B, C); w1 (2C, C), w2 (C, 2C), wp (C, C) in PyTorch (out, in) layout;
    vectors fp32. Intermediates are stored in x's dtype where the TPU
    kernel's `_tile_chain` stores them: n, the FF1 output and GELU's, f,
    f + tok2, the proj output and the result."""
    dt = x.dtype
    tok2 = x + tok[:, None, None, :].to(dt)
    t = tok2.float()
    mean = t.mean(-1, keepdim=True)
    d = t - mean
    var = (d * d).mean(-1, keepdim=True)
    n = (d * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(dt)
    h = gelu(_linear(n, w1, b1).to(dt))
    t2 = _linear(h, w2, b2).to(dt) + tok2
    return _linear(t2, wp, bp).to(dt) + x


def _launch(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps):
    if x.device.type != "cuda":
        raise ValueError(f"attn_tail kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"attn_tail kernel is built for bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("attn_tail kernel takes a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    p = b * h * w
    if c % 16 or p % 16:
        raise ValueError(f"attn_tail kernel needs C and B*H*W divisible by 16, got C={c}, B*H*W={p}")
    if tuple(tok.shape) != (b, c) or tuple(w1.shape) != (2 * c, c) or \
            tuple(w2.shape) != (c, 2 * c) or tuple(wp.shape) != (c, c):
        raise ValueError("attn_tail kernel: parameter shapes do not match x")
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    args = [_build.on_device(t, dev, dt) for t, dt in (
        (tok, bf), (ln_scale, f32), (ln_bias, f32), (w1, bf), (b1, f32), (w2, bf), (b2, f32),
        (wp, bf), (bp, f32))]
    out = torch.empty_like(x)
    lib = _build.library("attn_tail", _SIGNATURES)
    code = lib.nd_attn_tail(
        _build.ptr(x), *(_build.ptr(a) for a in args), _build.ptr(out),
        p, h * w, c, float(eps), _build.stream_ptr(dev),
    )
    _build.check(lib, code, "attn_tail")
    fused_attn_tail.launches += 1
    return out


def fused_attn_tail(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps: float = 1e-5):
    """One pass over x: (B, H, W, C) in, same shape and dtype out. See
    `reference_attn_tail` for the arguments."""
    if x.device.type == "cpu":
        return reference_attn_tail(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps)
    return _launch(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps)


fused_attn_tail.launches = 0
