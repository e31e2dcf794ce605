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
in its backward. `conv_wgrad.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_SIGNATURES = {
    "nd_conv_wgrad_partials_per_split": [ctypes.c_int] * 3,
    "nd_conv_wgrad": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
    + [ctypes.c_longlong, ctypes.c_void_p],
}
_KERNEL_TAPS = (1, 3)
_MAX_COLS = 64  # image columns of a pixel tile
_ROWS = 2       # image rows of a pixel tile
# blocks per SM the grid aims for (over all channel tiles)
_BLOCKS_PER_SM = 2


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
    """WMMA tiles of 16 channels per channel tile: 3 (48), 2 or 1."""
    return 3 if c % 48 == 0 else 2 if c % 32 == 0 else 1


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
    mt, nt = _tiles(ci), _tiles(co)
    cols = min(_MAX_COLS, -(-w // 16) * 16)
    tiles = b * -(-h // _ROWS) * -(-w // cols)
    channel_tiles = (ci // (16 * mt)) * (co // (16 * nt))
    splits = max(1, min(tiles, -(-_BLOCKS_PER_SM * _build.sm_count(dev) // channel_tiles)))
    per_split = -(-tiles // splits)
    splits = -(-tiles // per_split)
    lib = _build.library("conv_wgrad", _SIGNATURES)
    parts = splits * lib.nd_conv_wgrad_partials_per_split(kh, kw, mt)
    part = torch.empty(parts * kh * kw * ci * co, device=dev, dtype=torch.float32)
    out = torch.empty((kh, kw, ci, co), device=dev, dtype=torch.float32)
    code = lib.nd_conv_wgrad(
        _build.ptr(x), _build.ptr(g), _build.ptr(part), _build.ptr(out),
        b, h, w, ci, co, kh, kw, mt, nt, cols, splits, per_split, _build.stream_ptr(dev),
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
