"""AttnBlock tail for a single-token context: hand-written Hopper kernels
for its forward and backward (`csrc/attn_tail.cu`) and their plain PyTorch
versions.

NoiseDiffNet's AttnBlocks attend to one ISO token, so the attention output
`tok` is a per-sample vector that does not depend on x, and the block is
the channel-local chain

    tok2 = x + tok
    out  = proj(FF(LN2(tok2)) + tok2) + x

Counterpart of noisediff_tpu/ops/pallas/attn_tail.py: `fused_attn_tail`
(forward, `_forward`) with its custom VJP (`_pallas_bwd`, a tile recompute
plus the VJP in the kernel). Here `fused_attn_tail` is a
torch.autograd.Function on the card: its forward is the forward kernel and
saves the inputs, not the output; its backward is the backward kernel
(`fused_attn_tail_bwd`), which recomputes the chain and returns the
gradients of x, tok and all eight parameters. The plain backward,
`reference_attn_tail_bwd`, is autograd of `reference_attn_tail`.

Each wrapper runs the plain version for a tensor on the CPU and its CUDA
kernel for a tensor on the card; anything the kernel does not take raises.
`fused_attn_tail.launches` and `fused_attn_tail_bwd.launches` count kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    "nd_attn_tail": [ctypes.c_void_p] * 11
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "nd_attn_tail_bwd_warps": [ctypes.c_int],
    "nd_attn_tail_bwd": [ctypes.c_void_p] * 19
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p],
}
# blocks per SM the split-K weight-gradient products aim for
_WGRAD_BLOCKS_PER_SM = 2
_WGRAD_TILE = 64


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


def reference_attn_tail_bwd(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, g,
                            eps: float = 1e-5):
    """Plain version of the backward: autograd of `reference_attn_tail`,
    recomputed, for the upstream gradient g. Returns the gradients of (x,
    tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp), each in its input's
    dtype."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True)
                  for t in (x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp)]
        out = reference_attn_tail(*inputs, eps=eps)
        return torch.autograd.grad(out, inputs, g.to(out.dtype))


def _check(x, tok, w1, w2, wp, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel is built for bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    p = b * h * w
    if c % 16 or p % 16:
        raise ValueError(f"{what} kernel needs C and B*H*W divisible by 16, got C={c}, B*H*W={p}")
    if tuple(tok.shape) != (b, c) or tuple(w1.shape) != (2 * c, c) or \
            tuple(w2.shape) != (c, 2 * c) or tuple(wp.shape) != (c, c):
        raise ValueError(f"{what} kernel: parameter shapes do not match x")


def _launch(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps):
    _check(x, tok, w1, w2, wp, "attn_tail")
    b, h, w, c = x.shape
    p = b * h * w
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


def _launch_bwd(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, g, eps):
    _check(x, tok, w1, w2, wp, "attn_tail backward")
    b, h, w, c = x.shape
    hw, p = h * w, b * h * w
    if hw % 16:
        raise ValueError(f"attn_tail backward kernel needs H*W divisible by 16, got {hw}")
    if g.shape != x.shape:
        raise ValueError(f"attn_tail backward: g {tuple(g.shape)} does not match x")
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    args = [_build.on_device(t, dev, dt) for t, dt in (
        (tok, bf), (g, bf), (ln_scale, f32), (ln_bias, f32), (w1, bf), (b1, f32), (w2, bf),
        (b2, f32), (wp, bf))]
    lib = _build.library("attn_tail", _SIGNATURES)
    warps = lib.nd_attn_tail_bwd_warps(c)
    blocks_per_sample = -(-(hw // 16) // warps)
    # split the pixels of the weight-gradient products so that the smallest
    # (C x C, ceil(C / 64)^2 output tiles) still fills the card
    tiles = (-(-c // _WGRAD_TILE)) ** 2
    splits = max(1, min(p // 16, -(-_WGRAD_BLOCKS_PER_SM * _build.sm_count(dev) // tiles)))
    rows_per_split = -(-p // splits)
    rows_per_split = -(-rows_per_split // 16) * 16  # each split starts on a strip
    splits = -(-p // rows_per_split)

    dx = torch.empty_like(x)
    vec = torch.empty(6 * c, device=dev, dtype=f32)
    dtok = torch.empty((b, c), device=dev, dtype=f32)
    dw1 = torch.empty((2 * c, c), device=dev, dtype=f32)
    dw2 = torch.empty((c, 2 * c), device=dev, dtype=f32)
    dwp = torch.empty((c, c), device=dev, dtype=f32)
    ops = torch.empty(p * 7 * c, device=dev, dtype=bf)
    vec_part = torch.empty(b * blocks_per_sample * 7 * c, device=dev, dtype=f32)
    wpart = torch.empty(max(splits * 2 * c * c, b * 7 * c), device=dev, dtype=f32)
    code = lib.nd_attn_tail_bwd(
        _build.ptr(x), *(_build.ptr(a) for a in args),
        *(_build.ptr(t) for t in (dx, vec, dtok, dw1, dw2, dwp, ops, vec_part, wpart)),
        b, hw, c, blocks_per_sample, splits, rows_per_split, float(eps),
        _build.stream_ptr(dev),
    )
    _build.check(lib, code, "attn_tail backward")
    fused_attn_tail_bwd.launches += 1
    dbp, db2, db1, dlnw, dlnb = vec.split([c, c, 2 * c, c, c])
    return (dx, dtok.to(tok.dtype), dlnw.to(ln_scale.dtype), dlnb.to(ln_bias.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype),
            dwp.to(wp.dtype), dbp.to(bp.dtype))


def fused_attn_tail_bwd(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, g,
                        eps: float = 1e-5):
    """The backward of `fused_attn_tail` for the upstream gradient g (x's
    shape): the gradients of (x, tok, ln_scale, ln_bias, w1, b1, w2, b2,
    wp, bp), each in its input's dtype. The parameter and tok gradients are
    sums over every pixel, fp32 on the card."""
    if x.device.type == "cpu":
        return reference_attn_tail_bwd(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, g,
                                       eps)
    return _launch_bwd(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, g, eps)


class _AttnTail(torch.autograd.Function):
    """The kernel pair under autograd: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp)
        return _launch(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps)

    @staticmethod
    def backward(ctx, g):
        return (*fused_attn_tail_bwd(*ctx.saved_tensors, g.contiguous(), ctx.eps), None)


def fused_attn_tail(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps: float = 1e-5):
    """One pass over x: (B, H, W, C) in, same shape and dtype out. See
    `reference_attn_tail` for the arguments. Differentiable on both
    devices: autograd of the plain version on the CPU, the backward kernel
    on the card."""
    if x.device.type == "cpu":
        return reference_attn_tail(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps)
    return _AttnTail.apply(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps)


fused_attn_tail.launches = 0
fused_attn_tail_bwd.launches = 0
