"""The chip's peaks and the least time each hand-written kernel call of the
port could take, from its shapes alone.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them,
3.35 TB/s of HBM. A call's bound is the larger of its operations over the
peak that serves them and its bytes over the memory peak, each input byte
read once and each output byte written once.

The calls of a NoiseDiffNet evaluation are listed
from the configuration (each block's width and resolution), as the port
makes them today: a later change that fuses or replaces a kernel is held
to the same work.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16, FP32 = 2, 4


def peak_flops(cfg: dict) -> float:
    """The peak that serves the configuration's compute dtype (fp32 with
    TF32 off runs outside the tensor cores)."""
    return {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_FLOPS}[cfg["compute_dtype"]]


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / peak_flops)


def attn_tail(b: int, h: int, w: int, c: int) -> float:
    """Forward: x read, the output written, the token, the weights (bf16)
    and vectors read; 10 C^2 operations a pixel on the tensor cores."""
    x = b * h * w * c * BF16
    moved = 2 * x + b * c * BF16 + 5 * c * c * BF16 + 6 * c * FP32
    return bound_s(moved, 10 * b * h * w * c * c, PEAK_BF16_FLOPS)


def attn_tail_bwd(b: int, h: int, w: int, c: int) -> float:
    """Backward: x and g read, dx written, the weights and vectors read,
    their gradients written (fp32); 30 C^2 operations a pixel."""
    x = b * h * w * c * BF16
    moved = (3 * x + b * c * BF16 + 5 * c * c * BF16 + 6 * c * FP32 + b * c * FP32
             + (5 * c * c + 6 * c) * FP32)
    return bound_s(moved, 30 * b * h * w * c * c, PEAK_BF16_FLOPS)


def groupnorm_silu(b: int, n: int, c: int, film: bool) -> float:
    """x read and y written (bf16), scale, shift and conv bias (fp32), the
    FiLM's two (B, C) halves (bf16); 8 operations an element."""
    moved = 2 * b * n * c * BF16 + 3 * c * FP32 + (2 * b * c * BF16 if film else 0)
    return bound_s(moved, 8 * b * n * c, PEAK_FP32_FLOPS)


def dual_head(b: int, h: int, w: int, c: int) -> float:
    """x and the shot branch's two maps read (bf16), 4 fp32 channels
    written, the head parameters read (fp32)."""
    pix = b * h * w
    moved = 3 * pix * c * BF16 + pix * 4 * FP32 + (c * c + 8 * c + c + 8) * FP32
    return bound_s(moved, 2 * pix * (c * c + 8 * c), PEAK_BF16_FLOPS)


def gn_stats(b: int, n: int, c: int) -> float:
    """x read, two fp32 (B, C) sums written; 3 operations an element."""
    return bound_s(b * n * c * BF16 + 2 * b * c * FP32, 3 * b * n * c, PEAK_FP32_FLOPS)


def gn_grad_stats(b: int, n: int, c: int) -> float:
    """g and x read, two fp32 (B, C) sums written."""
    return bound_s(2 * b * n * c * BF16 + 2 * b * c * FP32, 3 * b * n * c, PEAK_FP32_FLOPS)


def noisediffnet_calls(cfg: dict, b: int, h: int, w: int) -> List[Tuple[str, tuple]]:
    """(kernel, shape) of every call one NoiseDiffNet evaluation makes on
    the fused route: 'attn' (b, h, w, c) for each attention block; 'gn'
    (b, pixels, c, time FiLM) for each GroupNorm but the positional
    blocks' per-pixel FiLM ones, which stay outside the kernel; 'gn_pixel'
    (b, pixels, c) for those; 'head' (b, h, w, dim) once."""
    dim = cfg["dim"]
    dims = [dim] + [dim * m for m in cfg["dim_mults"]]
    top = len(cfg["dim_mults"]) - 1
    calls: List[Tuple[str, tuple]] = []

    def res(s):
        return h >> s, w >> s

    def resnet(s, c):
        hh, ww = res(s)
        calls.append(("gn", (b, hh * ww, c, True)))
        calls.append(("gn", (b, hh * ww, c, False)))

    def attn(s, c):
        calls.append(("attn", (b, *res(s), c)))

    attn(0, dim)  # shot_attn
    resnet(0, dim)  # shot_time
    for _ in range(2):  # pos_block1 / 2
        calls.append(("gn_pixel", (b, h * w, dim)))
        calls.append(("gn", (b, h * w, dim, False)))
    for s in range(top + 1):  # down stages: two ResnetBlocks and attention at dims[s]
        resnet(s, dims[s])
        resnet(s, dims[s])
        attn(s, dims[s])
    resnet(top, dims[-1])  # mid blocks
    resnet(top, dims[-1])
    for s in range(top, -1, -1):  # up stages at dims[s + 1]
        resnet(s, dims[s + 1])
        resnet(s, dims[s + 1])
        attn(s, dims[s + 1])
    resnet(0, dim)  # final_res_block
    calls.append(("head", (b, h, w, dim)))
    return calls


def noisediffnet_eval_bounds(cfg: dict, b: int, h: int, w: int) -> Dict[str, float]:
    """Bound seconds of one evaluation's hand-written kernel calls, by
    kernel: attn_tail, groupnorm_silu, dual_head."""
    out = {"attn_tail": 0.0, "groupnorm_silu": 0.0, "dual_head": 0.0}
    for kind, shape in noisediffnet_calls(cfg, b, h, w):
        if kind == "attn":
            out["attn_tail"] += attn_tail(*shape)
        elif kind == "gn":
            out["groupnorm_silu"] += groupnorm_silu(*shape)
        elif kind == "head":
            out["dual_head"] += dual_head(*shape)
    return out

