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
x bf16 or fp32, NHWC and contiguous. Neither is differentiable: the route
serves inference only, and the trainers refuse the flag.

The conv has two kernels, and `route` picks one by shape and alignment
before the launch (nothing is caught, no failure leads to the other):
the tiled route (`nd_int8_conv`: persistent blocks, activations by TMA,
wgmma s8; its tile and pipeline numbers are `plan`) takes every call
whose x and kq are 16-byte aligned, whose row of Ci is a multiple of 16
bytes and whose Co is even, which is every call of NoiseDiffNet's and
LSID's int8 forwards; the small route (`nd_int8_conv_small`, the first
design, through its own wrapper `int8_conv_small`) takes the rest.
`int8_conv.launches` counts the tiled kernel's launches,
`int8_conv_small.launches` the small kernel's, `absmax.launches` absmax's.
"""
from __future__ import annotations

import ctypes
import functools
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
    "nd_int8_conv": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 15 + [ctypes.c_void_p],
    "nd_int8_conv_small": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 10 + [ctypes.c_void_p],
}
# the tiled route (mirrored by csrc/int8_conv.cu): 8 x 16-pixel tiles (an
# 8 x 8 M-block a warpgroup), N tiles of these widths (wgmma's N), two
# blocks an SM where the N tile is at most TWO_BLOCKS_MAX_NT (registers)
TILE = (8, 16)
N_TILES = (16, 32, 48, 64, 96, 128, 192, 256)
TWO_BLOCKS_MAX_NT = 96
# a block's shared memory; an SM's, of which each resident block costs 1 KB more
SMEM_BLOCK = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
SMS = 132  # the H100's SMs: the CPU tests' default; the card's own count is read
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


def _align(n: int, a: int = 128) -> int:
    return -(-n // a) * a


def smem_layout(k: int, nt: int, ckg: int, stages: int, resident: bool, itemsize: int,
                n_co: int = 1) -> int:
    """The tiled route's shared bytes a block (csrc/int8_conv.cu
    `layout_of`): `stages` stages of a chunk's activation box (8 + k - 1
    rows x 16 + k - 1 columns x 16 ckg channels) and, when the weights
    stream, the chunk's weights (k * k * ckg pieces of nt x 16 bytes); the
    quantized buffers (two with resident weights, else three); the resident
    weights with a zero piece after them; each of the two warpgroups' output
    staging (64 pixels x a round's channels + 8); sx * sw and the rounded
    bias of the n_co N tiles' channels (fp32); the mbarriers."""
    hr, hc = TILE[0] + k - 1, TILE[1] + k - 1
    bchunk = k * k * ckg * nt * 16
    stage = _align(hr * hc * 16 * ckg * itemsize) + (0 if resident else _align(bchunk))
    q = _align(ckg * hr * hc * 16 + 128)
    bres = _align(bchunk + nt * 16) if resident else 0
    staging = _align(64 * (min(nt, 128 // itemsize) + 8) * itemsize)
    scales = _align(2 * n_co * nt * 4)
    return (stages * stage + (2 if resident else 3) * q + bres + 2 * staging + scales
            + 8 * (2 * stages + 1))


def takes_tiled(ci: int, co: int, itemsize: int, aligned: bool) -> bool:
    """The route rule: the tiled kernel takes a call whose x, kq and `into`
    are 16-byte aligned (TMA's and the epilogue's rule), whose row of Ci
    is a multiple of 16 bytes (TMA's stride rule) and whose Co is even
    (the epilogue writes channel pairs); the small kernel takes the rest."""
    return aligned and ci * itemsize % 16 == 0 and co % 2 == 0


def route(x: torch.Tensor, kq: torch.Tensor, into: Optional[torch.Tensor] = None) -> str:
    """"tiled" or "small": which kernel `int8_conv` launches for a call."""
    aligned = all(t is None or t.data_ptr() % 16 == 0 for t in (x, kq, into))
    return "tiled" if takes_tiled(x.shape[-1], kq.shape[0], x.element_size(), aligned) else "small"


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, ci: int, co: int, k: int, padding: Tuple[int, int],
         itemsize: int, sms: int = SMS) -> dict:
    """The tiled route's launch plan for one call shape: the N tile `nt`
    (Co whole up to 256, else split evenly; where that does not fit a
    block, the narrower tile that pads Co least), the 8 x 16-pixel tiles,
    the units (N tiles x pixel tiles, which blocks walk with stride
    `grid`), the 16-channel groups a chunk `ckg` and the chunks a unit, the
    stages and whether the weights stay resident (one chunk and one N tile:
    loaded once a block) or stream through the ring, the shared bytes and
    the blocks an SM. Resident weights come first; then two blocks an SM
    where the N tile (registers) and the shared memory allow; then the most
    channels a chunk and the most stages."""
    ph, pw = padding
    ho, wo = h + 2 * ph - k + 1, w + 2 * pw - k + 1
    tiles_h, tiles_w = -(-ho // TILE[0]), -(-wo // TILE[1])
    groups = -(-ci // 16)
    kq_groups = (ci + (-ci % K_STEP)) // 16
    first = min(n for n in N_TILES if n >= -(-co // -(-co // 256)))
    # the N tiles to try: the even split first, then the least padded
    # width (N tiles x nt), widest first
    tiles = sorted((n for n in N_TILES if n <= first),
                   key=lambda n: (n != first, -(-co // n) * n, -n))
    for nt in tiles:
        n_co = -(-co // nt)
        resident = [(groups, st, True) for st in (4, 3, 2)] if n_co == 1 and groups <= 16 else []
        streamed = [(ckg, st, False) for ckg in (16, 8, 4, 2) if ckg <= kq_groups
                    for st in (4, 3, 2)]
        budgets = [(1, SMEM_BLOCK)]
        if nt <= TWO_BLOCKS_MAX_NT:
            budgets.insert(0, (2, SMEM_SM // 2 - SMEM_RESERVED))
        for options in (resident, streamed):
            for bps, budget in budgets:
                for ckg, stages, res in options:
                    smem = smem_layout(k, nt, ckg, stages, res, itemsize, n_co)
                    if smem > budget:
                        continue
                    units = n_co * b * tiles_h * tiles_w
                    return dict(nt=nt, n_co=n_co, ho=ho, wo=wo, tiles_h=tiles_h, tiles_w=tiles_w,
                                units=units, ckg=ckg, chunks=-(-groups // ckg), stages=stages,
                                resident=res, smem=smem, blocks_per_sm=bps,
                                grid=min(units, bps * sms))
    raise ValueError(f"int8_conv: no tiled plan fits ({b}, {h}, {w}, {ci}) x {co}x{k}x{k}")


def streamed_weights(kq: torch.Tensor, nt: int, ckg: int) -> torch.Tensor:
    """kq (Co, kh, kw, Cip) laid out as the tiled kernel's stages take
    streamed weights: (N tile, chunk, tap, group of the chunk, channel of
    the N tile, 16 bytes), zero past Co and past kq's groups, so that a
    chunk is one linear copy. Made once per (kq, nt, ckg) and kept on kq:
    a kq is never changed in place (`quantize_weight` makes a new one, and
    the model's weight cache a new one when the weight changes)."""
    cache = kq.__dict__.setdefault("_int8_streamed", {})
    ks = cache.get((nt, ckg))
    if ks is None:
        co, kh, kw, cip = kq.shape
        n_co, chunks = -(-co // nt), -(-cip // (16 * ckg))
        padded = F.pad(kq.reshape(co, kh * kw, cip),
                       (0, chunks * ckg * 16 - cip, 0, 0, 0, n_co * nt - co))
        ks = cache[nt, ckg] = padded.reshape(n_co, nt, kh * kw, chunks, ckg, 16).permute(
            0, 3, 2, 4, 1, 5).contiguous()
    return ks


_KERNEL = {}  # (card index, entry point name) -> (the entry point, its library)


def _kernel(dev, fn_name: str):
    k = _KERNEL.get((dev.index, fn_name))
    if k is None:
        lib = _build.library("int8_conv", _SIGNATURES)
        k = _KERNEL[dev.index, fn_name] = (getattr(lib, fn_name), lib)
    return k


def _launch_args(x, kq, sw, amax, padding, bias, into):
    """(the checked shape, the output, the arguments both entry points take
    after x, dtype and kq, the stream)."""
    shape = _check(x, kq, sw, amax, padding, bias, into)
    b, h, w, ci, cip, co, k, ho, wo = shape
    out = into if into is not None else torch.empty((b, ho, wo, co), device=x.device,
                                                    dtype=x.dtype)
    args = (sw.data_ptr(), amax.data_ptr(), None if bias is None else bias.data_ptr(),
            None if into is None else into.data_ptr(), out.data_ptr(), b, h, w, ci, cip, co, k,
            padding[0], padding[1])
    return shape, out, args, torch._C._cuda_getCurrentRawStream(x.device.index)


def int8_conv(x: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor, amax: torch.Tensor,
              padding: Tuple[int, int], bias: Optional[torch.Tensor] = None,
              into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The quantized stride-1 conv of one part; see `reference_int8_conv`
    for the arguments. On the card the sum with `into` is written into
    `into` itself, which is returned. The tiled kernel runs what `route`
    gives it; the rest goes to `int8_conv_small`."""
    if x.device.type == "cpu":
        return reference_int8_conv(x, kq, sw, amax, padding, bias, into)
    if route(x, kq, into) == "small":
        return int8_conv_small(x, kq, sw, amax, padding, bias, into)
    if bias is not None:
        bias = _build.on_device(bias, x.device, torch.float32)
    (b, h, w, ci, _, co, k, _, _), out, args, stream = _launch_args(x, kq, sw, amax, padding,
                                                                     bias, into)
    dev = x.device
    p = plan(b, h, w, ci, co, k, tuple(padding), x.element_size(), _build.sm_count(dev))
    ks = None if p["resident"] else streamed_weights(kq, p["nt"], p["ckg"]).data_ptr()
    fn, lib = _kernel(dev, "nd_int8_conv")
    code = _build.launch(dev, fn, x.data_ptr(), _DTYPES[x.dtype], kq.data_ptr(), ks, *args,
                         p["nt"], p["ckg"], p["stages"], int(p["resident"]), p["grid"],
                         p["smem"], stream)
    _build.check(lib, code, "int8_conv")
    int8_conv.launches += 1
    return out


def int8_conv_small(x: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor, amax: torch.Tensor,
                    padding: Tuple[int, int], bias: Optional[torch.Tensor] = None,
                    into: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same conv through the small kernel (the first design), which
    takes every call `int8_conv` does: `int8_conv` sends it what the tiled
    kernel does not take, and the card checks time it beside the tiled
    kernel at one shape."""
    if x.device.type == "cpu":
        return reference_int8_conv(x, kq, sw, amax, padding, bias, into)
    if bias is not None:
        bias = _build.on_device(bias, x.device, torch.float32)
    _, out, args, stream = _launch_args(x, kq, sw, amax, padding, bias, into)
    fn, lib = _kernel(x.device, "nd_int8_conv_small")
    code = _build.launch(x.device, fn, x.data_ptr(), _DTYPES[x.dtype], kq.data_ptr(), *args,
                         int(x.data_ptr() % 16 == 0), stream)
    _build.check(lib, code, "int8_conv_small")
    int8_conv_small.launches += 1
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
int8_conv_small.launches = 0
absmax.launches = 0
