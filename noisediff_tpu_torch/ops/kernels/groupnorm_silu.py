"""GroupNorm -> affine -> per-sample FiLM -> SiLU: a hand-written Hopper
kernel (`csrc/groupnorm_silu.cu`) and its plain PyTorch version.

The body of every ResnetBlock `Block` whose FiLM is absent or per-sample.
Counterpart of noisediff_tpu/ops/pallas/groupnorm_silu.py
(`fused_groupnorm_film_silu`). The statistics follow the path the JAX model
runs (blocks._gn_coeffs_primal): fp32 per-channel sums, biased uncentered
variance, eps inside the rsqrt, the FiLM folded into the per-(sample,
channel) affine (blocks._film_fold).

`fused_groupnorm_film_silu` runs the plain version for a tensor on the CPU
and the CUDA kernel for a tensor on the card; anything the kernel does not
take raises. `fused_groupnorm_film_silu.launches` counts kernel launches.

On the card the wrapper is a torch.autograd.Function whose backward is
autograd of `reference_groupnorm_film_silu`, recomputed from the saved
inputs, as the JAX custom_vjp's backward is the jnp reference
(ops/pallas/groupnorm_silu.py:167-186). The training path does not call it:
the model's GroupNorm takes the gn_stats route in training, as the JAX
model does under gn_train_trace.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_SIGNATURES = {
    "nd_groupnorm_silu": [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
}

# blocks per SM that the statistics and the apply pass aim for
_STATS_BLOCKS_PER_SM = 4
_APPLY_BLOCKS_PER_SM = 8


def gn_coefficients(x, gamma, beta, film_scale, film_shift, groups: int, eps: float):
    """Per-(sample, channel) fp32 (a, bb) with GroupNorm + affine + FiLM ==
    x * a + bb. x: (B, N, C); film_*: (B, C) or None."""
    b, n, c = x.shape
    xf = x.float()
    s_c = xf.sum(1)
    sq_c = (xf * xf).sum(1)
    cnt = n * (c // groups)
    mean_g = s_c.view(b, groups, -1).sum(-1) / cnt
    var_g = sq_c.view(b, groups, -1).sum(-1) / cnt - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(c // groups, dim=1)
    inv_c = inv_g.repeat_interleave(c // groups, dim=1)
    a = inv_c * gamma.float()[None, :]
    bb = beta.float()[None, :] - mean_c * a
    if film_scale is not None:
        s1 = film_scale.float() + 1.0
        a = a * s1
        bb = bb * s1 + film_shift.float()
    return a, bb


def reference_groupnorm_film_silu(x, gamma, beta, film_scale=None, film_shift=None,
                                  groups: int = 8, eps: float = 1e-5):
    """Plain version with the kernel's arithmetic: y = silu(x * a + bb) in
    fp32, rounded once to x's dtype. x: (B, N, C)."""
    a, bb = gn_coefficients(x, gamma, beta, film_scale, film_shift, groups, eps)
    y = x.float() * a[:, None, :] + bb[:, None, :]
    return torch.nn.functional.silu(y).to(x.dtype)


def _launch(x, gamma, beta, film_scale, film_shift, groups, eps):
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"groupnorm_silu kernel is built for bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("groupnorm_silu kernel takes a contiguous (B, N, C) tensor")
    b, n, c = x.shape
    if c % 8 or c > 1024 or c % groups:
        raise ValueError(f"groupnorm_silu kernel needs C % 8 == 0, C <= 1024 and "
                         f"C % groups == 0, got C={c}, groups={groups}")
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift come together")
    dev = x.device

    def f32(t):
        return _build.on_device(t, dev, torch.float32)

    gamma_f, beta_f = f32(gamma), f32(beta)
    fs = fsh = None
    if film_scale is not None:
        fs, fsh = f32(film_scale), f32(film_shift)
        if tuple(fs.shape) != (b, c) or tuple(fsh.shape) != (b, c):
            raise ValueError("groupnorm_silu kernel: FiLM must be (B, C) per sample")
    sms = _build.sm_count(dev)
    splits = max(1, min(n, -(-_STATS_BLOCKS_PER_SM * sms // b)))
    rows_per_split = -(-n // splits)
    n_vec = b * n * c // 8
    apply_blocks = max(1, min(-(-n_vec // 256), _APPLY_BLOCKS_PER_SM * sms))
    part = torch.empty((b, splits, 2, c), device=dev, dtype=torch.float32)
    coef = torch.empty((b, 2, c), device=dev, dtype=torch.float32)
    y = torch.empty_like(x)
    null = ctypes.c_void_p(None)
    lib = _build.library("groupnorm_silu", _SIGNATURES)
    code = lib.nd_groupnorm_silu(
        _build.ptr(x), _build.ptr(gamma_f), _build.ptr(beta_f),
        _build.ptr(fs) if fs is not None else null,
        _build.ptr(fsh) if fsh is not None else null,
        _build.ptr(part), _build.ptr(coef), _build.ptr(y),
        b, n, c, groups, splits, rows_per_split, apply_blocks, float(eps),
        _build.stream_ptr(dev),
    )
    _build.check(lib, code, "groupnorm_silu")
    fused_groupnorm_film_silu.launches += 1
    return y


def fused_groupnorm_film_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                              film_scale: Optional[torch.Tensor] = None,
                              film_shift: Optional[torch.Tensor] = None,
                              groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """x: (B, N, C); gamma, beta: (C,); film_*: (B, C) or None. Returns
    silu(FiLM(GroupNorm(x) * gamma + beta)) in x's dtype."""
    if x.device.type == "cpu":
        return reference_groupnorm_film_silu(x, gamma, beta, film_scale, film_shift,
                                             groups, eps)
    return _GroupNormSilu.apply(x, gamma, beta, film_scale, film_shift, groups, eps)


class _GroupNormSilu(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed (the JAX custom_vjp's jnp backward)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, film_scale, film_shift, groups, eps):
        ctx.groups, ctx.eps = groups, eps
        ctx.film = film_scale is not None
        saved = (x, gamma, beta) + ((film_scale, film_shift) if ctx.film else ())
        ctx.save_for_backward(*saved)
        return _launch(x, gamma, beta, film_scale, film_shift, groups, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            film = inputs[3:] if ctx.film else [None, None]
            out = reference_groupnorm_film_silu(*inputs[:3], *film, ctx.groups, ctx.eps)
            grads = torch.autograd.grad(out, inputs, g)
        film_grads = grads[3:] if ctx.film else (None, None)
        return (*grads[:3], *film_grads, None, None)


fused_groupnorm_film_silu.launches = 0
