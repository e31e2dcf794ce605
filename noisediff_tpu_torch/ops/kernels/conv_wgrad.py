"""Weight gradient of a stride-1 SAME convolution: a hand-written Hopper
kernel (`csrc/conv_wgrad.cu`) and its plain PyTorch version.

    dW[ih, iw, ci, co] = sum_{b,h,w} x[b, h+ih-ph, w+iw-pw, ci] g[b, h, w, co]

for channels-last x (B, H, W, Ci) and g (B, H, W, Co), zero outside the
image, (ph, pw) = ((kh - 1) / 2, (kw - 1) / 2), kh, kw in {1, 3}; fp32
(kh, kw, Ci, Co) out, the JAX layout (callers permute to PyTorch's (Co,
Ci, kh, kw)). Counterpart of noisediff_tpu/ops/pallas/conv_wgrad.py
(`conv_wgrad`); its width fold (kwf = 2) is a TPU layout device and its
`custom_partitioning` wrapper waits for the distributed slice.

`conv_wgrad` runs the plain version for a tensor on the CPU and the kernel
for a tensor on the card; anything the kernel does not take raises. It is
not differentiable: models/blocks.py's stride-1 SAME conv Function calls it
in its backward. `conv_wgrad.launches` counts kernel launches. `plan` is
the kernel's work split, in plain Python so the CPU tests can hold it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from . import _build

_SIGNATURES = {
    "nd_conv_wgrad": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
}
_KERNEL_TAPS = (1, 3)
_TILE = 48  # channels of a ci or co tile's products; partial tiles are _TILE x _TILE
# taps -> (image rows, image columns) of a pixel tile (csrc/conv_wgrad.cu, Geo)
_PIXEL_TILE = {9: (8, 32), 3: (3, 32), 1: (3, 48)}


def reference_conv_wgrad(g: torch.Tensor, x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Plain version: the tap sum in fp32 (tests/test_conv_wgrad.py:22).
    g (B, H, W, Co), x (B, H, W, Ci) -> (kh, kw, Ci, Co) fp32."""
    b, h, w, ci = x.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    xp = torch.zeros((b, h + kh - 1, w + kw - 1, ci), device=x.device, dtype=torch.float32)
    xp[:, ph:ph + h, pw:pw + w] = x.float()
    gf = g.float().reshape(-1, g.shape[-1])
    taps = [xp[:, i:i + h, j:j + w].reshape(-1, ci).T @ gf
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps).reshape(kh, kw, ci, g.shape[-1])


def _tiles(c: int) -> int:
    """16-channel sub-tiles per channel tile: 3 (48), 2 or 1."""
    return 3 if c % 48 == 0 else 2 if c % 32 == 0 else 1


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, ci: int, co: int, kh: int, kw: int, sms: int) -> Dict[str, int]:
    """The kernel's work split. The pixels are cut into tiles of `rows` x
    `cols`; a unit is one pixel tile of one (ci tile, co tile) pair, and the
    `units` are numbered pair-major (tile index: column fastest, then band,
    then image). Block k of the `grid` (at most one per SM, never more
    than the units) takes units [units k / grid, units (k + 1) / grid).
    Each block writes one partial per pair it touches, into slot k + pair
    (`segments`), one 48 x 48 tile per tap; `part_floats` is the scratch
    those slots take. Cached per shape (a training step asks for the same
    21 every step); callers do not change the dict."""
    rows, cols = _PIXEL_TILE[kh * kw]
    mt, nt = _tiles(ci), _tiles(co)
    ctiles, bands = -(-w // cols), -(-h // rows)
    tpp = b * bands * ctiles
    pairs = (ci // (16 * mt)) * (co // (16 * nt))
    units = pairs * tpp
    grid = max(1, min(sms, units))
    return dict(mt=mt, nt=nt, rows=rows, cols=cols, ctiles=ctiles, bands=bands, tpp=tpp,
                pairs=pairs, units=units, grid=grid,
                part_floats=(grid + pairs) * kh * kw * _TILE * _TILE)


def block_of(u: int, units: int, grid: int) -> int:
    """The block whose run holds unit u (`block_of` in csrc/conv_wgrad.cu)."""
    return ((u + 1) * grid - 1) // units


def segments(p: Dict[str, int]) -> List[Tuple[int, int, int, int, int]]:
    """(block, pair, first unit, end unit, slot) of every partial the kernel
    writes, in block order."""
    out = []
    for k in range(p["grid"]):
        u, end = p["units"] * k // p["grid"], p["units"] * (k + 1) // p["grid"]
        while u < end:
            pair = u // p["tpp"]
            stop = min(end, (pair + 1) * p["tpp"])
            out.append((k, pair, u, stop, k + pair))
            u = stop
    return out


def reduce_slots(p: Dict[str, int], pair: int) -> List[int]:
    """The slots the second pass adds for one pair, in its order: the
    blocks from the one holding the pair's first unit to the one holding
    its last (`conv_wgrad_reduce`)."""
    first = block_of(pair * p["tpp"], p["units"], p["grid"])
    last = block_of((pair + 1) * p["tpp"] - 1, p["units"], p["grid"])
    return [k + pair for k in range(first, last + 1)]


def _launch(g, x, kh, kw):
    if x.device.type != "cuda":
        raise ValueError(f"conv_wgrad kernel needs a CUDA tensor, got {x.device}")
    for t in (x, g):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"conv_wgrad kernel is built for bfloat16, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv_wgrad kernel takes contiguous, 16-byte aligned "
                             "(B, H, W, C) tensors")
    b, h, w, ci = x.shape
    co = g.shape[-1]
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"conv_wgrad: g {tuple(g.shape)} and x {tuple(x.shape)} differ in B, H, W")
    if kh not in _KERNEL_TAPS or kw not in _KERNEL_TAPS:
        raise ValueError(f"conv_wgrad kernel is built for kh, kw in {_KERNEL_TAPS}, got {kh}, {kw}")
    if ci % 16 or co % 16:
        raise ValueError(f"conv_wgrad kernel needs Ci and Co divisible by 16, got {ci}, {co}")
    dev = x.device
    p = plan(b, h, w, ci, co, kh, kw, _build.sm_count(dev))
    lib = _build.library("conv_wgrad", _SIGNATURES)
    part = torch.empty(p["part_floats"], device=dev, dtype=torch.float32)
    out = torch.empty((kh, kw, ci, co), device=dev, dtype=torch.float32)
    code = lib.nd_conv_wgrad(
        _build.ptr(x), _build.ptr(g), _build.ptr(part), _build.ptr(out),
        b, h, w, ci, co, kh, kw, p["mt"], p["nt"], p["ctiles"], p["bands"], p["grid"],
        _build.stream_ptr(dev),
    )
    _build.check(lib, code, "conv_wgrad")
    conv_wgrad.launches += 1
    return out


def conv_wgrad(g: torch.Tensor, x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """The weight gradient of a stride-1 SAME conv with a (kh, kw) kernel
    for the upstream gradient g; see `reference_conv_wgrad`."""
    if x.device.type == "cpu":
        return reference_conv_wgrad(g, x, kh, kw)
    return _launch(g, x, kh, kw)


conv_wgrad.launches = 0
