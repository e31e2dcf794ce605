"""[conv bias ->] GroupNorm -> affine -> per-sample FiLM -> SiLU: a
hand-written Hopper kernel (`csrc/groupnorm_silu.cu`) and its plain PyTorch
version.

The body of every ResnetBlock `Block` whose FiLM is absent or per-sample.
Counterpart of noisediff_tpu/ops/pallas/groupnorm_silu.py
(`fused_groupnorm_film_silu`). The statistics follow the path the JAX model
runs (blocks._gn_coeffs_primal): fp32 per-channel sums, biased uncentered
variance, eps inside the rsqrt, the FiLM folded into the per-(sample,
channel) affine (blocks._film_fold). `conv_bias` is the bias of the conv
that made x, which the model's Block leaves to this function in evaluation:
x + conv_bias is rounded to x's dtype, as the conv's own bias add stores
it, before anything else reads it.

`fused_groupnorm_film_silu` runs the plain version for a tensor on the CPU
and the CUDA kernel for a tensor on the card; anything the kernel does not
take raises. `fused_groupnorm_film_silu.launches` counts kernel launches
(one per call).

Where a gradient is wanted on the card the wrapper is a
torch.autograd.Function whose backward is autograd of
`reference_groupnorm_film_silu`, recomputed from the saved inputs, as the
JAX custom_vjp's backward is the jnp reference
(ops/pallas/groupnorm_silu.py:167-186). The training path does not call it:
the model's GroupNorm takes the gn_stats route in training, as the JAX
model does under gn_train_trace.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from . import _build

_SIGNATURES = {
    "nd_groupnorm_silu": [ctypes.c_void_p] * 9
    + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 9
    + [ctypes.c_uint, ctypes.c_float, ctypes.c_void_p],
    "nd_groupnorm_silu_smem_limit": [],
}

# the kernel's block: up to MAX_THREADS threads, a whole number of rows of
# C / 8 sixteen-byte pieces each
MAX_THREADS = 512
# a block per this many bytes of x, up to one block per SM
GRID_BYTES = 16 * 1024
# the kernel's bulk-copy chunks (one mbarrier each) per slab
NCH = 16


@lru_cache(maxsize=256)
def plan(b: int, n: int, c: int, sms: int, smem_limit: int) -> dict:
    """The kernel's launch for x (b, n, c) on a card of `sms` SMs whose
    blocks may take `smem_limit` bytes of shared memory (the kernel's
    layout: res_rows rows of x in bf16, NCH mbarriers, then fp32 [rows in
    flight][2C] + [2C] + [16] + 3 x [2C]). grid: co-resident blocks, one
    per SM at most; spr: samples per round (the most whose slabs fit, each
    sample on grid // spr blocks); res_rows: the rows of a slab kept on
    chip (the rest, in `reread` mode, read twice)."""
    lanes = c // 8
    rif = MAX_THREADS // lanes
    fixed = NCH * 8 + (rif * 2 * c + 8 * c + 16) * 4
    cap_rows = (smem_limit - fixed) // (2 * c)
    if cap_rows < 1:
        raise ValueError(f"groupnorm_silu kernel: C={c} leaves no shared memory for rows")
    grid = max(1, min(sms, -(-b * n * c * 2 // GRID_BYTES)))
    spr = 1
    for s in range(min(b, grid), 0, -1):
        if -(-n // (grid // s)) <= cap_rows:
            spr = s
            break
    rows = -(-n // (grid // spr))  # the largest slab (the full rounds)
    res_rows = min(cap_rows, rows)
    return dict(grid=grid, threads=lanes * rif, spr=spr, rounds=-(-b // spr), rows=rows,
                res_rows=res_rows, smem=res_rows * 2 * c + fixed, reread=rows > cap_rows)


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
                                  groups: int = 8, eps: float = 1e-5, conv_bias=None):
    """Plain version with the kernel's arithmetic: x + conv_bias rounded to
    x's dtype, then y = silu(x * a + bb) in fp32, rounded once to x's
    dtype. x: (B, N, C); conv_bias: (C,) or None."""
    if conv_bias is not None:
        x = x + conv_bias.to(x.dtype)
    a, bb = gn_coefficients(x, gamma, beta, film_scale, film_shift, groups, eps)
    y = x.float() * a[:, None, :] + bb[:, None, :]
    return torch.nn.functional.silu(y).to(x.dtype)


class _Scratch:
    """The kernel's per-block group sums and per-sample arrival words for
    one (card, stream), grown as calls need, with the epoch of its last
    call. The words start at zero, the epochs at 1 and grow by one a call
    (the kernel lifts a word to its call's epoch with an atomic max)."""

    def __init__(self, dev, parts: int, samples: int):
        self.part = torch.empty(parts, device=dev, dtype=torch.float32)
        self.bar = torch.zeros(samples, device=dev, dtype=torch.int64)
        self.epoch = 0


_SCRATCH = {}
_KERNEL = {}  # card index -> (the C entry point, its library, SM count, shared-memory limit)


def _kernel(dev):
    k = _KERNEL.get(dev.index)
    if k is None:
        lib = _build.library("groupnorm_silu", _SIGNATURES)
        limit = _build.launch(dev, lib.nd_groupnorm_silu_smem_limit)
        if limit <= 0:
            raise RuntimeError("groupnorm_silu: could not read the card's shared-memory limit")
        k = _KERNEL[dev.index] = (lib.nd_groupnorm_silu, lib, _build.sm_count(dev), limit)
    return k


def _film(film_scale, film_shift, b, c, dev):
    """The FiLM as the kernel reads it: (B, C) views with unit column
    stride and one row stride, both bf16 or both fp32 (no copy when they
    are), e.g. the two halves of the time-MLP's bf16 output."""
    if film_scale is None and film_shift is None:
        return None, None
    if film_scale is None or film_shift is None:
        raise ValueError("film_scale and film_shift come together")
    if tuple(film_scale.shape) != (b, c) or tuple(film_shift.shape) != (b, c):
        raise ValueError("groupnorm_silu kernel: FiLM must be (B, C) per sample")
    fs, fsh = film_scale, film_shift
    ok = (fs.dtype == fsh.dtype and fs.dtype in (torch.bfloat16, torch.float32)
          and fs.device == dev and fsh.device == dev and fs.stride() == fsh.stride()
          and fs.stride(1) == 1)
    if not ok:
        fs, fsh = (_build.on_device(t, dev, torch.float32) for t in (fs, fsh))
    return fs, fsh


def _launch(x, gamma, beta, film_scale, film_shift, groups, eps, conv_bias):
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"groupnorm_silu kernel is built for bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("groupnorm_silu kernel takes a contiguous, 16-byte aligned (B, N, C) "
                         "tensor")
    b, n, c = x.shape
    if c % 8 or c > 1024 or c % groups or groups > 8:
        raise ValueError(f"groupnorm_silu kernel needs C % 8 == 0, C <= 1024, "
                         f"C % groups == 0 and groups <= 8, got C={c}, groups={groups}")
    dev = x.device
    fn, lib, sms, limit = _kernel(dev)
    fs, fsh = _film(film_scale, film_shift, b, c, dev)
    # held until the launch: a converted operand's memory must not go back
    # to the allocator before the kernel reads it
    f32 = torch.float32
    gamma, beta = _build.on_device(gamma, dev, f32), _build.on_device(beta, dev, f32)
    bias = None if conv_bias is None else _build.on_device(conv_bias, dev, f32)
    p = plan(b, n, c, sms, limit)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    s = _SCRATCH.get(key)
    if (s is None or s.part.numel() < b * p["grid"] * 16 or s.bar.numel() < b
            or s.epoch == 0xFFFFFFFF):  # the epochs must grow: fresh words at the last one
        s = _SCRATCH[key] = _Scratch(dev, max(b * p["grid"] * 16, 1 << 14), max(b, 64))
    s.epoch += 1
    y = torch.empty_like(x)
    code = _build.launch(
        dev, fn, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if fs is None else fs.data_ptr(), None if fsh is None else fsh.data_ptr(),
        y.data_ptr(), s.part.data_ptr(), s.bar.data_ptr(),
        b, n, c, groups, 0 if fs is None else fs.stride(0),
        int(fs is not None and fs.dtype == torch.bfloat16),
        p["grid"], p["threads"], p["spr"], p["res_rows"], p["smem"], s.epoch, float(eps),
        stream,
    )
    _build.check(lib, code, "groupnorm_silu")
    fused_groupnorm_film_silu.launches += 1
    return y


def fused_groupnorm_film_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                              film_scale: Optional[torch.Tensor] = None,
                              film_shift: Optional[torch.Tensor] = None,
                              groups: int = 8, eps: float = 1e-5,
                              conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, N, C); gamma, beta, conv_bias: (C,) (conv_bias may be None);
    film_*: (B, C) or None. Returns silu(FiLM(GroupNorm(x + conv_bias) *
    gamma + beta)) in x's dtype."""
    if x.device.type == "cpu":
        return reference_groupnorm_film_silu(x, gamma, beta, film_scale, film_shift, groups,
                                             eps, conv_bias)
    args = (x, gamma, beta, film_scale, film_shift, conv_bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _GroupNormSilu.apply(x, gamma, beta, film_scale, film_shift, conv_bias, groups,
                                    eps)
    return _launch(x, gamma, beta, film_scale, film_shift, groups, eps, conv_bias)


class _GroupNormSilu(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed (the JAX custom_vjp's jnp backward)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, film_scale, film_shift, conv_bias, groups, eps):
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, gamma, beta, film_scale, film_shift, conv_bias)
        return _launch(x, gamma, beta, film_scale, film_shift, groups, eps, conv_bias)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            x, gamma, beta, fs, fsh, bias = inputs
            out = reference_groupnorm_film_silu(x, gamma, beta, fs, fsh, ctx.groups, ctx.eps,
                                                bias)
            leaves = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(out, leaves, g))
        return (*(None if t is None else next(grads) for t in inputs), None, None)


fused_groupnorm_film_silu.launches = 0
