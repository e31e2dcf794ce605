"""Building blocks of NoiseDiffNet and the UNet_PosEmbV2 family in PyTorch.

Port of noisediff_tpu/models/blocks.py
(reference `models/archs/Diffusion_arch.py`). Module and parameter names
follow the reference torch state_dict, so a reference `.pth` loads with a
strict key match (`Sequential` slots reproduce indices such as
`time_mlp.1`, `mlp.1`, `ff.net.0.0`, `to_out.0`, `downs.i.3.1`).

Activations are NCHW tensors in `torch.channels_last` memory, which is the
JAX package's NHWC layout physically: the kernels see each map as a
row-major (pixels, C) matrix through `.permute(0, 2, 3, 1)`, a view.
Parameters stay fp32 and are cast to the activation dtype where they are
used, as the JAX modules do.

Every block that holds a kernel decides once, at construction, whether it
runs the kernel or the kernel's plain version (`runs_kernel`, the port's
`_fused_kernel_ok`): the kernels are built for the bf16 compute dtype, so a
model of any other dtype (`dtype=None` is fp32, the reference-faithful
`--no_mixed_precision` mode) runs every block on its plain version, on the
card as on the CPU; a bf16 block runs its kernel where its channel width is
one the kernel takes. The kernels take every pixel count. A wrapper given
a CUDA tensor launches its kernel or raises; nothing falls back per call.

Under a spatial shard (`parallel.mesh.activate`, the frame's rows split
over the ranks of a spatial line) every conv wider than 1x1 takes its
halo rows from the neighbouring ranks before it convolves, and every
GroupNorm all-reduces its statistics over the ranks; the per-pixel blocks
(the attention tail, the 1x1 convs, the heads) need nothing. Each of those
collectives has its backward, so a shard trains. On the model axis
(`mesh.shard_parameters`) a `Conv2d`, `Linear` or `Downsample` whose
weight holds a block of its output channels computes those channels and
all-gathers the rest (`_column_parallel`); the kernels that read a whole
weight (the attention tail's FF and projection, the heads) get it
all-gathered (`whole_weight`).

Stride-1 SAME convolutions can take their weight gradient from the
conv_wgrad kernel instead of cuDNN, under the JAX package's variables
(`wgrad_kernel_on`), where the input is bf16 and the widths are ones the
kernel takes (`Conv2d.wgrad_route`). `RMSNorm`, `Attention` (full
self-attention through the flash_attention kernel) and `LinearAttention`
are defined, as in the reference, but no shipped model uses them.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import (
    conv_wgrad, flash_attention, fused_attn_tail, fused_groupnorm_film_silu, gn_grad_stats,
    gn_stats, groupnorm_silu_apply, reference_attn_tail, reference_flash_attention,
    reference_gn_grad_stats, reference_gn_stats, reference_groupnorm_film_silu,
    reference_groupnorm_silu_apply)
from ..ops.kernels.attn_tail import TILED_MAX_C as ATTN_TAIL_MAX_C
from ..ops.kernels.attn_tail import gelu
from ..ops.kernels.dual_head import _KERNEL_WIDTHS as HEAD_WIDTHS
from ..ops.kernels.flash_attention import _HEAD_DIMS as FLASH_HEAD_DIMS
from ..parallel import mesh

CL = torch.channels_last
Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]

# channel widths each kernel family takes, beside the bf16 dtype: the head
# kernels (dual_head, ddim_head) C in HEAD_WIDTHS; attn_tail (forward and
# backward) C % 16 == 0 up to ATTN_TAIL_MAX_C;
# the GroupNorm kernels (groupnorm_silu, gn_stats, gn_grad_stats)
# C % 8 == 0 up to 1024; flash_attention a head width in FLASH_HEAD_DIMS
_WIDTH_OK = {
    "attn_tail": lambda c: c % 16 == 0 and c <= ATTN_TAIL_MAX_C,
    "heads": lambda c: c in HEAD_WIDTHS,
    "groupnorm": lambda c: c % 8 == 0 and c <= 1024,
    "flash": lambda c: c in FLASH_HEAD_DIMS,
}


def runs_kernel(kernel: str, dtype: Optional[torch.dtype], channels: int) -> bool:
    """Whether a block of compute dtype `dtype` (None: fp32) whose kernel
    family `kernel` ('attn_tail', 'heads', 'groupnorm', 'flash') sees
    `channels` channels (head width for 'flash') runs the kernel, or else
    its plain version. The rule: bf16, and a width the kernel takes. It is
    the port's `_fused_kernel_ok` (blocks.py of the JAX package), which
    also keeps fp32 off every kernel; the JAX size floor is not carried
    over, since the kernels here take any pixel count."""
    return dtype == torch.bfloat16 and _WIDTH_OK[kernel](channels)



def weight_view(w: torch.Tensor, size, stride) -> torch.Tensor:
    """`w`'s elements seen as `size` with `stride` (a view of its storage).
    Its gradient comes back in w's own strides, where a select or a view
    would return it contiguous: a channels-last (O, I, 1, 1) weight has
    strides (I, 1, I, I), and DDP's gradient buckets, laid out like the
    parameters, would take a contiguous gradient only through a restride."""
    return w.as_strided(size, stride)


def weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """The (O, I) matrix of a 1x1 conv weight (O, I, 1, 1) (`weight_view`)."""
    return weight_view(w, w.shape[:2], w.stride()[:2])

def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels-last) -> contiguous NHWC; a view when x is channels-last."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW channels-last view."""
    return x.permute(0, 3, 1, 2)


def cat_channels(x: Tensors) -> torch.Tensor:
    """A map, or the channel concat of a tuple of maps (skip joins)."""
    if isinstance(x, (list, tuple)):
        return torch.cat(list(x), dim=1).contiguous(memory_format=CL)
    return x


class GELU(nn.Module):
    """GELU in the activation dtype: tanh form in bf16, erf form otherwise."""

    def forward(self, x):
        return gelu(x)


def wgrad_kernel_on(x: torch.Tensor, training: bool) -> bool:
    """Whether a stride-1 SAME conv of input x takes its weight gradient
    from the conv_wgrad kernel: the port's `_wgrad_pallas_mode`
    (blocks.py:304-339 of the JAX package), with the same variables.
    NOISEDIFF_WGRAD=pallas: always; =auto: in training only, where the
    input's H * W is at least NOISEDIFF_WGRAD_MIN_HW (default 4096); unset
    or =xla: never (cuDNN's wgrad). Opt-in, as in the JAX package, until
    measurements decide a default (PERF.md). The caller also applies the
    channel gate (`wgrad_channels_ok`)."""
    flag = os.environ.get("NOISEDIFF_WGRAD", "xla")
    min_hw = int(os.environ.get("NOISEDIFF_WGRAD_MIN_HW", "4096"))
    if flag == "pallas":
        return True
    return flag == "auto" and training and x.shape[-2] * x.shape[-1] >= min_hw


def wgrad_channels_ok(ci: int, co: int) -> bool:
    """Narrow convs stay on cuDNN's wgrad (`_wgrad_channels_ok`)."""
    return ci >= 32 and co >= 32


# conv_wgrad sums its taps over one shard's rows: the JAX conv_wgrad_p
# refuses spatially sharded activations with this message
# (conv_wgrad.py:200-204), and so does the port
WGRAD_SPATIAL_ERROR = (
    "conv_wgrad: spatially-sharded activations are not supported in the training graph "
    "(halo taps would drop cross-shard pairs); shard the batch axis only, or set "
    "NOISEDIFF_WGRAD=xla")


def _column_parallel(tp, x, compute, bias, dim: int):
    """A column-parallel layer of the model axis: compute(x) on this
    rank's block of the output channels (no bias), every model rank's
    channels all-gathered along `dim` (1: C of a channels-last map; -1:
    the last dim),
    then the whole bias (a replicated parameter) added. The gradient of x
    is summed over the model line, its output's kept to this rank's
    block."""
    y = mesh.tp_output(compute(mesh.tp_input(x, tp)), tp, dim)
    if bias is None:
        return y
    b = bias.to(y.dtype)
    return y + (b[:, None, None] if dim == 1 else b)


def whole_weight(module: nn.Module) -> torch.Tensor:
    """`module.weight`, all-gathered where the model axis split it, for a
    kernel that reads the whole weight."""
    return mesh.tp_weight(module.weight, module.tp)


class _ConvWgrad(torch.autograd.Function):
    """A stride-1 SAME conv whose forward is F.conv2d and whose backward
    takes dx from PyTorch's conv input gradient (as the JAX package keeps
    XLA's dgrad, blocks.py:383-385), dW from the conv_wgrad kernel in fp32
    and db as a sum (blocks._conv_same_pallas_wgrad). x is channels-last
    NCHW; weight and bias are the fp32 parameters, cast to x's dtype for
    the forward, and get fp32 gradients, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding: int):
        w = weight.to(x.dtype)
        ctx.padding = padding
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, None if bias is None else bias.to(x.dtype), 1, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        kh, kw = w.shape[2:]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [ctx.padding] * 2, [1, 1], False, [0, 0], 1,
                [True, False, False])[0]
        dw = conv_wgrad(to_nhwc(g), to_nhwc(x), kh, kw).permute(3, 2, 0, 1).contiguous()
        # an fp32 sum of the bf16 gradient, without an fp32 copy of it
        db = g.sum((0, 2, 3), dtype=torch.float32) if ctx.has_bias else None
        return dx, dw, db, None


class Conv2d(nn.Conv2d):
    """Conv with SAME padding for odd kernels, run in the input's dtype.
    A stride-1 1x1 or 3x3 conv takes the conv_wgrad route where
    `wgrad_route` allows it, except under a spatial shard, where that
    raises (`WGRAD_SPATIAL_ERROR`). Under a spatial shard a k x k conv
    (k > 1) takes k // 2 rows from each neighbouring rank
    (`mesh.halo_rows`) and pads only along W. With `tp` set
    (`mesh.shard_parameters`) the weight is this rank's block of the
    output channels and the conv is column-parallel."""

    tp = None  # the model axis's ModelShard where the weight is a block

    def __init__(self, cin: int, cout: int, ks: int, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True):
        super().__init__(cin, cout, ks, stride=stride,
                         padding=ks // 2 if padding is None else padding, bias=bias)

    def wgrad_route(self, x: torch.Tensor) -> bool:
        """Only where a weight gradient will be taken (generation reads no
        environment variable per conv), and only where the kernel takes the
        conv, decided before the call as `runs_kernel` decides for the other
        blocks: bf16 input and Ci, Co divisible by 16 beside the JAX gate
        (`wgrad_channels_ok`, `wgrad_kernel_on`). Anything else, fp32
        (`--no_mixed_precision`) included, takes PyTorch's wgrad on either
        device, where the JAX package computes too."""
        if not (torch.is_grad_enabled() and self.weight.requires_grad):
            return False
        ks = self.kernel_size[0]
        co, ci = self.weight.shape[:2]  # this rank's block on the model axis
        return (self.stride == (1, 1) and ks in (1, 3) and self.padding == (ks // 2, ks // 2)
                and x.dtype == torch.bfloat16 and ci % 16 == 0 and co % 16 == 0
                and wgrad_channels_ok(ci, co) and wgrad_kernel_on(x, self.training))

    def forward(self, x, with_bias: bool = True):
        """with_bias False: the conv without its bias, which the caller
        adds (Block folds it into the groupnorm_silu kernel)."""
        bias = self.bias if with_bias else None
        shard = mesh.spatial()
        wgrad = self.wgrad_route(x)
        if wgrad and shard is not None:
            raise ValueError(WGRAD_SPATIAL_ERROR)

        def conv(x, bias=None):
            if shard is not None and self.kernel_size[0] > 1:
                return self._sharded(x, bias, shard)
            if wgrad:
                return _ConvWgrad.apply(x, self.weight, bias, self.padding[0])
            b = None if bias is None else bias.to(x.dtype)
            return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)

        if self.tp is not None:
            return _column_parallel(self.tp, x, conv, bias, 1)
        return conv(x, bias)

    def _sharded(self, x, bias, shard):
        """This rank's rows of the conv: the rows with their halo, padded
        along W only."""
        kh, kw = self.kernel_size
        if self.stride != (1, 1) or self.padding != (kh // 2, kw // 2):
            raise NotImplementedError("a spatially sharded conv is a stride-1 SAME conv")
        b = None if bias is None else bias.to(x.dtype)
        return F.conv2d(mesh.halo_rows(x, kh // 2, shard), self.weight.to(x.dtype), b, 1,
                        (0, kw // 2))


class Linear(nn.Linear):
    """Linear run in the input's dtype; column-parallel with `tp` set, as
    `Conv2d`."""

    tp = None

    def forward(self, x):
        if self.tp is not None:
            return _column_parallel(self.tp, x, lambda x: F.linear(x, self.weight.to(x.dtype)),
                                    self.bias, -1)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class SinusoidalPosEmb(nn.Module):
    """Transformer-style timestep embedding (:94-107), fp32."""

    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.theta = theta

    def forward(self, t):
        half = self.dim // 2
        scale = math.log(self.theta) / (half - 1)
        freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32) * -scale)
        emb = t.float()[:, None] * freqs[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class TimeMlp(nn.Sequential):
    """SinusoidalPosEmb -> Linear -> GELU -> Linear (Diffusion_arch.py:502-507).
    The fourier features are fp32; the MLP runs in `dtype`."""

    def __init__(self, fourier_dim: int, time_dim: int):
        super().__init__(SinusoidalPosEmb(fourier_dim), Linear(fourier_dim, time_dim), GELU(),
                         Linear(time_dim, time_dim))

    def forward(self, t, dtype: torch.dtype = torch.float32):
        h = self[0](t).to(dtype)
        return self[3](self[2](self[1](h)))


class LearnedSinusoidalPosEmb(nn.Module):
    """Coordinate fourier features: 1x1 conv then [x, sin, cos] (:322-337)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.weights = Conv2d(in_dim, hidden_dim, 1)

    def forward(self, coords):
        x = self.weights(coords)
        freqs = x * (2 * math.pi)
        return torch.cat([x, freqs.sin(), freqs.cos()], dim=1)


class Mlp(nn.Module):
    """1x1-conv MLP: fc1 -> GELU -> fc2 (:340-356)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Conv2d(in_features, hidden_features, 1)
        self.fc2 = Conv2d(hidden_features, out_features, 1)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


def _group_stats(s_c, sq_c, groups: int, cnt: int, eps: float):
    """Per-channel fp32 sums (B, C) -> per-channel mean and 1/std of their
    groups (torch GroupNorm: biased, uncentered variance, eps inside the
    rsqrt), with the per-group values."""
    b = s_c.shape[0]
    mean_g = s_c.view(b, groups, -1).sum(-1) / cnt
    var_g = sq_c.view(b, groups, -1).sum(-1) / cnt - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    per = s_c.shape[1] // groups
    return (mean_g.repeat_interleave(per, dim=1), inv_g.repeat_interleave(per, dim=1),
            mean_g, inv_g)


def _coefficients(s_c, sq_c, scale, bias, groups: int, cnt: int, eps: float):
    """GroupNorm + affine as fp32 (B, C) (a, bb), x a + bb, from the fp32
    per-channel sums over `cnt` elements a group."""
    mean_c, inv_c, _, _ = _group_stats(s_c, sq_c, groups, cnt, eps)
    a = inv_c * scale[None, :]
    return a, bias[None, :] - mean_c * a


class _GNCoeffs(torch.autograd.Function):
    """GroupNorm affine coefficients (a, bb), fp32 (B, C), with
    normalise + scale + bias == x * a + bb, from the gn_stats sums
    (blocks._gn_coeffs_primal of the JAX package). The backward is the
    closed form of the JAX `_gnc_bwd`: dx = ds_c + 2 x dsq_c in x's dtype,
    every other tensor (B, C)-sized, so autograd never materialises an
    activation-sized fp32 chain. x: (B, H, W, C).

    Under a spatial shard x is this rank's rows and the statistics are the
    frame's: with s_r, sq_r this rank's gn_stats sums (one launch on its
    rows), S = sum_r s_r and SQ = sum_r sq_r (one all-reduce of the
    stacked pair over the spatial line) give (a, bb) on every rank with the
    frame's count. Every rank's a and bb are used on its own rows, so the
    gradient of S is the sum over the ranks of each rank's (dS_r, dSQ_r)
    from its (da, dbb); since dS / ds_r = 1, ds_r = dS = sum_r dS_r (one
    all-reduce in the backward, the JAX psum of gn_grad_stats_p), and
    dx_r = ds_r + 2 x_r dsq_r. The scale's and bias's gradients are this
    rank's share; DDP sums the shares."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, stats, shard):
        b, h, w, c = x.shape
        s_c, sq_c = stats(x)
        if shard is not None:
            s_c, sq_c = mesh.all_reduce_sum(torch.stack([s_c, sq_c]), shard.group).unbind()
            h = shard.at_scale(h)[1]  # the whole frame's rows
        ctx.groups, ctx.eps, ctx.cnt, ctx.shard = groups, eps, h * w * (c // groups), shard
        ctx.save_for_backward(x, scale, s_c, sq_c)
        return _coefficients(s_c, sq_c, scale, bias, groups, ctx.cnt, eps)

    @staticmethod
    def backward(ctx, da, dbb):
        x, scale, s_c, sq_c = ctx.saved_tensors
        da = torch.zeros_like(s_c) if da is None else da
        dbb = torch.zeros_like(s_c) if dbb is None else dbb
        b, groups, cnt = x.shape[0], ctx.groups, ctx.cnt
        mean_c, inv_c, mean_g, inv_g = _group_stats(s_c, sq_c, groups, cnt, ctx.eps)
        # parameter grads:  a = inv_c scale,  bb = bias - mean_c inv_c scale
        dscale = (inv_c * da - mean_c * inv_c * dbb).sum(0)
        dbias = dbb.sum(0)
        # chain to the sums: d inv_c, d mean_c -> group sums -> s_c, sq_c
        dinv_g = (scale[None, :] * (da - mean_c * dbb)).view(b, groups, -1).sum(-1)
        dmean_g = (-inv_c * scale[None, :] * dbb).view(b, groups, -1).sum(-1)
        dvar_g = -0.5 * inv_g ** 3 * dinv_g
        dmean_g = dmean_g - 2.0 * mean_g * dvar_g
        per = s_c.shape[1] // groups
        ds_c = (dmean_g / cnt).repeat_interleave(per, dim=1)
        dsq_c = (dvar_g / cnt).repeat_interleave(per, dim=1)
        if ctx.shard is not None:
            ds_c, dsq_c = mesh.all_reduce_sum(torch.stack([ds_c, dsq_c]),
                                              ctx.shard.group).unbind()
        dt = x.dtype
        dx = x * (2.0 * dsq_c)[:, None, None, :].to(dt) + ds_c[:, None, None, :].to(dt)
        return dx, dscale, dbias, None, None, None, None


class _GNApply(torch.autograd.Function):
    """y = x * a + bb with fp32 (B, C) coefficients cast to x's dtype
    (blocks._gn_apply of the JAX package). Backward: (dbb, da) =
    grad_stats(g, x) (gn_grad_stats or its plain version) and dx = g * a.
    x: (B, H, W, C)."""

    @staticmethod
    def forward(ctx, x, a, bb, grad_stats):
        ctx.grad_stats = grad_stats
        ctx.save_for_backward(x, a)
        dt = x.dtype
        return x * a[:, None, None, :].to(dt) + bb[:, None, None, :].to(dt)

    @staticmethod
    def backward(ctx, g):
        x, a = ctx.saved_tensors
        g = g.contiguous()
        dbb, da = ctx.grad_stats(g, x)
        return g * a[:, None, None, :].to(g.dtype), da, dbb, None


def _film_fold(a, bb, scale_shift):
    """Fold a per-sample FiLM y (s + 1) + sh into the (B, C) coefficients:
    (x a + bb)(s + 1) + sh == x [a (s + 1)] + [bb (s + 1) + sh], in fp32
    (blocks._film_fold)."""
    s, sh = scale_shift
    s1 = s.reshape(s.shape[0], -1).float() + 1.0
    return a * s1, bb * s1 + sh.reshape(sh.shape[0], -1).float()


def _per_pixel(scale_shift) -> bool:
    """A FiLM whose maps vary over pixels (ResnetBlock2's), not (B, C, 1, 1)."""
    return scale_shift is not None and scale_shift[0].shape[-2:] != (1, 1)


class GroupNorm(nn.Module):
    """Block's norm + FiLM + SiLU tail.

    Training (`self.training`, the counterpart of the JAX model's
    gn_train_trace): every GroupNorm takes the gn_stats route of the JAX
    training step, each a pair of autograd Functions: coefficients from the
    gn_stats sums, a per-sample FiLM folded into them, the affine applied in
    x's dtype with the gn_grad_stats backward; then a per-pixel FiLM
    (ResnetBlock2's maps) and SiLU as plain torch ops. Evaluation: a FiLM
    that is absent or per-sample goes through the groupnorm_silu kernel; a
    per-pixel FiLM stays in plain torch, as in the JAX package. Where
    `runs_kernel('groupnorm', dtype, channels)` is false, both routes call
    the kernels' plain versions. On the kernel's route the caller may hand
    over the bias of the conv that made x (`folds_bias`), which the kernel
    adds where it reads x.

    Under a spatial shard (`mesh.spatial`) x is this rank's rows of the
    frame: the fp32 per-channel sums of the shard (the gn_stats kernel, or
    its plain version), all-reduced over the ranks, give the coefficients
    with the whole frame's pixel count. Training takes the training route
    above with those statistics (`_GNCoeffs`, whose backward all-reduces
    the sums' gradient; gn_grad_stats sums this rank's rows). Evaluation
    folds the per-sample FiLM into them and runs the groupnorm_silu_apply
    kernel, or the per-pixel FiLM and SiLU in x's dtype. The conv bias
    stays on the conv there."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.kernels = runs_kernel("groupnorm", dtype, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def folds_bias(self, scale_shift) -> bool:
        """Whether this call runs the groupnorm_silu kernel, which can add
        the bias of the conv before it: evaluation, the kernel's route, and
        a FiLM that is absent or per-sample."""
        return (self.kernels and not self.training and not _per_pixel(scale_shift)
                and mesh.spatial() is None)

    def forward(self, x, scale_shift=None, conv_bias=None):
        b, c, h, w = x.shape
        per_pixel = _per_pixel(scale_shift)
        if conv_bias is not None and not self.folds_bias(scale_shift):
            raise ValueError("GroupNorm adds a conv bias only on the groupnorm_silu kernel's "
                             "route (folds_bias)")
        shard = mesh.spatial()
        if self.training:
            return self._train_forward(x, scale_shift, per_pixel, shard)
        if shard is not None:
            return self._sharded(x, scale_shift, per_pixel, shard)
        if per_pixel:
            return self._per_pixel_film(x, scale_shift)
        fs = fsh = None
        if scale_shift is not None:  # the kernel reads the FiLM in its own dtype
            fs = scale_shift[0].reshape(b, c)
            fsh = scale_shift[1].reshape(b, c)
        fn = fused_groupnorm_film_silu if self.kernels else reference_groupnorm_film_silu
        y = fn(to_nhwc(x).view(b, h * w, c), self.weight, self.bias, fs, fsh, self.groups,
               self.eps, conv_bias)
        return to_nchw(y.view(b, h, w, c))

    def _train_forward(self, x, scale_shift, per_pixel: bool, shard):
        xh = to_nhwc(x)
        stats, grad_stats = ((gn_stats, gn_grad_stats) if self.kernels
                             else (reference_gn_stats, reference_gn_grad_stats))
        a, bb = _GNCoeffs.apply(xh, self.weight, self.bias, self.groups, self.eps, stats, shard)
        if scale_shift is not None and not per_pixel:
            a, bb = _film_fold(a, bb, scale_shift)
        y = to_nchw(_GNApply.apply(xh, a, bb, grad_stats))
        if per_pixel:
            s, sh = scale_shift
            y = y * (s + 1.0) + sh
        return F.silu(y)

    def _sharded(self, x, scale_shift, per_pixel: bool, shard):
        """x: this rank's rows; statistics over every rank's rows."""
        b, c, h, w = x.shape
        xh = to_nhwc(x)
        stats = gn_stats if self.kernels else reference_gn_stats
        s_c, sq_c = mesh.all_reduce_sum(torch.stack(stats(xh)), shard.group)
        cnt = shard.at_scale(h)[1] * w * (c // self.groups)  # the whole frame's rows
        a, bb = _coefficients(s_c, sq_c, self.weight.float(), self.bias.float(), self.groups, cnt,
                              self.eps)
        if per_pixel:
            dt = x.dtype
            y = x * a[:, :, None, None].to(dt) + bb[:, :, None, None].to(dt)
            s, sh = scale_shift
            return F.silu(y * (s + 1.0) + sh)
        if scale_shift is not None:
            a, bb = _film_fold(a, bb, scale_shift)
        apply = groupnorm_silu_apply if self.kernels else reference_groupnorm_silu_apply
        return to_nchw(apply(xh.view(b, h * w, c), a, bb).view(b, h, w, c))

    def _per_pixel_film(self, x, scale_shift):
        """GN affine in fp32 coefficients applied in x's dtype, then the
        per-pixel FiLM and SiLU in x's dtype (blocks._GNParams)."""
        from ..ops.kernels.groupnorm_silu import gn_coefficients

        b, c, h, w = x.shape
        a, bb = gn_coefficients(to_nhwc(x).view(b, h * w, c), self.weight, self.bias, None,
                                None, self.groups, self.eps)
        dt = x.dtype
        y = x * a[:, :, None, None].to(dt) + bb[:, :, None, None].to(dt)
        s, sh = scale_shift
        return F.silu(y * (s + 1.0) + sh)


class Block(nn.Module):
    """conv3x3 -> GroupNorm -> (optional FiLM) -> SiLU (:128-144). Where
    the norm runs the groupnorm_silu kernel (`GroupNorm.folds_bias`), the
    conv runs without its bias and the kernel adds it: the same bf16
    values, one broadcast add less. Training, the per-pixel FiLM and the
    plain routes keep the bias on the conv."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Conv2d(dim_in, dim_out, 3)
        self.norm = GroupNorm(dim_out, groups, dtype=dtype)

    def forward(self, x, scale_shift=None):
        if self.norm.folds_bias(scale_shift):
            return self.norm(self.proj(x, with_bias=False), scale_shift, self.proj.bias)
        return self.norm(self.proj(x), scale_shift)


class ResnetBlock(nn.Module):
    """Two FiLM blocks + residual 1x1 (:146-170), time-FiLM per sample.

    Reference quirk (Diffusion_arch.py:154-155): the constructor's ks is
    ignored and Block is always 3x3, so `shot_time` runs 3x3 convs too."""

    def __init__(self, dim_in: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim_in, dim_out, groups, dtype)
        self.block2 = Block(dim_out, dim_out, groups, dtype)
        self.res_conv = Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else nn.Identity()

    def forward(self, x: Tensors, time_emb=None):
        x = cat_channels(x)
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            t = self.mlp(time_emb)[:, :, None, None]
            scale_shift = t.chunk(2, dim=1)
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + self.res_conv(x)


class ResnetBlock2(nn.Module):
    """ResnetBlock with a per-pixel FiLM from the positional embedding map
    (:173-196): SiLU -> 1x1 conv (pos_dim -> 2 dim_out)."""

    def __init__(self, dim_in: int, dim_out: int, pos_emb_dim: Optional[int] = None,
                 groups: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), Conv2d(pos_emb_dim, dim_out * 2, 1))
                    if pos_emb_dim is not None else None)
        self.block1 = Block(dim_in, dim_out, groups, dtype)
        self.block2 = Block(dim_out, dim_out, groups, dtype)
        self.res_conv = Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else nn.Identity()

    def forward(self, x, pos_emb=None):
        scale_shift = None
        if self.mlp is not None and pos_emb is not None:
            scale_shift = self.mlp(pos_emb).chunk(2, dim=1)
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + self.res_conv(x)


class CrossAttention(nn.Module):
    """Cross attention (:361-402) through the exact one-token path: with a
    single context token the softmax is identically 1, so the output is
    to_out(to_v(context)) broadcast over the pixels, independent of the
    queries (blocks.py:1614-1636). to_q and to_k exist for the checkpoint."""

    def __init__(self, query_dim: int, context_dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        inner = heads * dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def token(self, context: torch.Tensor) -> torch.Tensor:
        """context (B, 1, Cc) -> the per-sample output token (B, C)."""
        if context.shape[1] != 1:
            raise NotImplementedError("multi-token cross attention is not on NoiseDiffNet's path")
        return self.to_out(self.to_v(context[:, 0]))


class FeedForward(nn.Module):
    """Linear -> GELU -> Linear with mult=2 (:405-422)."""

    def __init__(self, dim: int, mult: int = 2):
        super().__init__()
        self.net = nn.Sequential(nn.Sequential(Linear(dim, dim * mult), GELU()), nn.Dropout(0.0),
                                 Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class AttnBlock(nn.Module):
    """LN -> cross-attn (+res) -> LN -> FF (+res) -> 1x1 proj, + outer
    residual (:425-443). With a one-token context the whole block after the
    token is the attn_tail kernel's chain, or its plain version where
    `runs_kernel('attn_tail', dtype, dim)` is false."""

    def __init__(self, dim: int, context_dim: int = 16, heads: int = 4, dim_head: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = runs_kernel("attn_tail", dtype, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)
        self.proj_out = Conv2d(dim, dim, 1)

    def forward(self, x, context):
        tok = self.attn.token(context.to(x.dtype))
        ff1, ff2 = self.ff.net[0][0], self.ff.net[2]
        tail = fused_attn_tail if self.kernel else reference_attn_tail
        out = tail(
            to_nhwc(x), tok, self.norm2.weight, self.norm2.bias, whole_weight(ff1), ff1.bias,
            whole_weight(ff2), ff2.bias, weight_matrix(whole_weight(self.proj_out)),
            self.proj_out.bias, self.norm2.eps,
        )
        return to_nchw(out)


class RMSNorm(nn.Module):
    """Channelwise RMS norm: F.normalize(x, dim=C) * g * sqrt(C) (:84-90),
    F.normalize's eps 1e-12 (blocks.RMSNorm of the JAX package). g has the
    reference's (1, C, 1, 1) shape. The norm is fp32; the division and
    the scale run in x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        c = x.shape[1]
        norm = x.float().norm(dim=1, keepdim=True).clamp_min(1e-12)
        return x / norm.to(x.dtype) * self.g.to(x.dtype) * (c ** 0.5)


class Attention(nn.Module):
    """Full self-attention over the pixels (:237-266): RMSNorm, a 1x1 qkv
    conv, softmax attention per head, a 1x1 output conv (blocks.Attention of
    the JAX package). The attention is the flash_attention kernel at every
    token count where `runs_kernel('flash', dtype, dim_head)`, else its
    plain version; the channels of qkv are (3, heads, dim_head) as in the
    reference."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = runs_kernel("flash", dtype, dim_head)
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = to_nhwc(self.to_qkv(self.norm(x))).view(b, h * w, 3, self.heads, self.dim_head)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))  # (B, H, N, D)
        attend = flash_attention if self.kernel else reference_flash_attention
        out = attend(q, k, v).transpose(1, 2).reshape(b, h, w, -1)
        return self.to_out(to_nchw(out))


class LinearAttention(nn.Module):
    """Softmax-kernel linear attention (:198-235; blocks.LinearAttention of
    the JAX package): RMSNorm, a 1x1 qkv conv without bias, q softmaxed
    over its head channels and scaled by dim_head^-0.5, k softmaxed over
    the pixels, ctx = k v^T per head, out = ctx^T q, then `to_out`, the
    reference's Sequential(1x1 conv, RMSNorm). Computed in x's dtype; no
    shipped model runs it, and it has no kernel."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(Conv2d(hidden, dim, 1), RMSNorm(dim))

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = to_nhwc(self.to_qkv(self.norm(x))).view(b, h * w, 3, self.heads, self.dim_head)
        q, k, v = (qkv[:, :, i].permute(0, 2, 3, 1) for i in range(3))  # (B, heads, D, N)
        q = q.softmax(dim=-2) * (self.dim_head ** -0.5)
        k = k.softmax(dim=-1)
        ctx = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", ctx, q)
        out = out.permute(0, 3, 1, 2).reshape(b, h, w, -1)
        return self.to_out(to_nchw(out.contiguous()))


class Downsample(nn.Sequential):
    """space-to-depth ((c, p1, p2) channel order) + 1x1 conv (:78-82).

    Run as the equal 2x2 stride-2 conv: input channel c*4 + p1*2 + p2 of
    the 1x1 kernel is tap (p1, p2) of channel c, so the (O, 4C, 1, 1)
    weight viewed as (O, C, 2, 2) is that conv's kernel; the rearranged
    tensor is never made."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__(nn.Identity(), Conv2d(dim_in * 4, dim_out, 1))

    def forward(self, x):
        conv = self[1]
        shard = mesh.spatial()
        if shard is not None:
            # no halo: every shard is a multiple of 8 of the frame's rows
            # (mesh.split_rows), so at each Downsample of the /8 UNet it
            # starts on an even row and holds an even number of them
            first = shard.at_scale(x.shape[2])[0]
            if first % 2 or x.shape[2] % 2:
                raise ValueError(f"Downsample of {x.shape[2]} rows from row {first}: a 2x2 "
                                 "stride-2 conv of this shard would need its neighbour's rows")
        o, c4 = conv.weight.shape[:2]
        w = weight_view(conv.weight, (o, c4 // 4, 2, 2), (conv.weight.stride(0), 4, 2, 1))
        w = w.to(x.dtype)
        if conv.tp is not None:
            return _column_parallel(conv.tp, x, lambda x: F.conv2d(x, w, None, stride=2),
                                    conv.bias, 1)
        return F.conv2d(x, w, conv.bias.to(x.dtype), stride=2)


class Upsample(nn.Sequential):
    """nearest x2 + 3x3 conv (:72-76)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"), Conv2d(dim_in, dim_out, 3))

    def forward(self, x):
        y = F.interpolate(x, scale_factor=2, mode="nearest").contiguous(memory_format=CL)
        return self[1](y)
