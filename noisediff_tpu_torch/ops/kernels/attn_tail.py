"""AttnBlock tail for a single-token context: hand-written Hopper kernels
for its forward (`csrc/attn_tail.cu`) and backward (`csrc/attn_tail_bwd.cu`)
and their plain PyTorch versions.

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
Both kernels take any pixel count (a ragged last tile is masked) and
C % 16 == 0 up to 768. `fused_attn_tail.launches` and
`fused_attn_tail_bwd.launches` count wrapper calls that launch.

Both directions have routes by C: a fused one (one persistent kernel
with the weights resident in shared memory) at the narrow widths (the
forward's also at C = 192 with its weights streamed), a tiled one (a
chain of tiled products over all pixels) at the wide ones; the two share
their device code (`csrc/attn_tail_chain.cuh`). The work splits are
`fwd_plan` and `bwd_plan`, plain Python so that the CPU tests hold them:
pixel strips, groups or tiles walked by persistent blocks, and on the
tiled routes the grids of the row and product kernels (and, for the
backward's weight gradients, the pixel splits of those products).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    "nd_attn_tail_occupancy": [ctypes.c_int],
    "nd_attn_tail_smem": [ctypes.c_int],
    "nd_attn_tail_fused": [ctypes.c_void_p] * 11
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p],
    "nd_attn_tail_streamed": [ctypes.c_void_p] * 12
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p],
    "nd_attn_tail_tiled": [ctypes.c_void_p] * 12
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "nd_attn_tail_bwd_occupancy": [ctypes.c_int],
    "nd_attn_tail_bwd_smem": [ctypes.c_int],
    "nd_attn_tail_bwd_fused": [ctypes.c_void_p] * 15
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p],
    "nd_attn_tail_bwd_tiled": [ctypes.c_void_p] * 18
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
       ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p],
}

# The backward's plan; the constants mirror csrc/attn_tail_bwd.cu.
FUSED_WIDTHS = (16, 32, 48)  # the fused route: weight gradients summed in registers
FUSED_TILE_ROWS = 64         # its pixel tile rows
FUSED_THREADS = 256
TILED_MAX_C = 768            # the tiled route: 64 <= C <= 768
_PAD = 8
_WG_BM, _WG_BN, _WG_BK = 128, 128, 32
_GEMM_ROWS = 128  # the products' row tile: db1 has one partial per tile
_WGRAD_BLOCKS_PER_SM = 2
_LN_BLOCKS_PER_SM = 2


def bwd_smem_bytes(c: int) -> int:
    """Shared memory of the fused route's kernel (`smem_plan` in the .cu):
    the three weights, the tile's buffers (tok2, n, u, h, g, t2, dn, d), row
    statistics, column-sum partials, the block's running sums."""
    m, threads = FUSED_TILE_ROWS, FUSED_THREADS
    ldc, ld2 = c + _PAD, 2 * c + _PAD
    o = 2 * c * ldc + c * ld2 + c * ldc + m * (5 * ldc + 3 * ld2)
    q, q1 = min(threads // (c // 2), 8), min(threads // c, 8)
    return 2 * o + 3 * m * 4 + (q * 5 * c + q1 * 2 * c) * 4 + 7 * c * 4


def bwd_route(c: int) -> str:
    """'fused' for C in FUSED_WIDTHS, 'tiled' for 64 <= C <= 768; C % 16 == 0."""
    if c % 16 == 0 and c in FUSED_WIDTHS:
        return "fused"
    if c % 16 == 0 and 64 <= c <= TILED_MAX_C:
        return "tiled"
    raise ValueError(f"attn_tail backward kernel is built for C % 16 == 0 and C <= "
                     f"{TILED_MAX_C}, got C={c}")


def _splits(n: int, want: int, align: int = 1) -> Tuple[int, int]:
    """(count, rows) splitting n rows into about `want` ranges of `rows`
    rows, a multiple of `align`."""
    count = max(1, min(-(-n // align), want))
    rows = -(-n // count)
    rows = -(-rows // align) * align
    return -(-n // rows), rows


def bwd_plan(b: int, hw: int, c: int, sms: int, blocks_per_sm: int = 1) -> Dict[str, object]:
    """The backward's work split for x of (b, H, W, c), hw = H * W, on a
    card of `sms` SMs (`blocks_per_sm`: the fused kernel's occupancy).

    fused: P = b * hw pixel rows in `tiles` tiles of M rows, the last holding
    `last_rows`; `grid` persistent blocks, block k walking the tiles of
    `block_tiles(plan)[k]` in order; a tile across a sample boundary
    (`tile_samples`) sums dtok per sample. Its partials are summed in block
    order.
    tiled: the products run over all P rows in `row_tiles` tiles of 128
    (db1 sums per tile); the LayerNorm backward over `ln_splits` ranges of
    `ln_rows` rows of each sample (`ln_ranges`), so no range crosses a
    sample; the weight gradients over `splits` pixel ranges of
    `rows_per_split` rows (`split_ranges`). Every partial is summed in
    order."""
    if b < 1 or hw < 1:
        raise ValueError(f"attn_tail backward needs B, H * W >= 1, got {b}, {hw}")
    route = bwd_route(c)
    p = b * hw
    plan = {"route": route, "B": b, "HW": hw, "C": c, "P": p}
    if route == "fused":
        m = FUSED_TILE_ROWS
        tiles = -(-p // m)
        plan.update(M=m, tiles=tiles, last_rows=p - (tiles - 1) * m,
                    grid=max(1, min(tiles, sms * max(1, blocks_per_sm))),
                    smem=bwd_smem_bytes(c))
        return plan
    ln_s, ln_r = _splits(hw, -(-_LN_BLOCKS_PER_SM * sms // b))
    shapes = ((2 * c, c), (c, 2 * c), (c, c))  # dW1, dW2, dWp
    wtiles = sum(-(-mm // _WG_BM) * -(-nn // _WG_BN) for mm, nn in shapes)
    splits, rows = _splits(p, -(-_WGRAD_BLOCKS_PER_SM * sms // wtiles), _WG_BK)
    plan.update(row_tiles=-(-p // _GEMM_ROWS), ln_splits=ln_s, ln_rows=ln_r,
                wgrad_blocks=wtiles, splits=splits, rows_per_split=rows)
    return plan


def block_tiles(plan) -> List[Tuple[int, int]]:
    """Fused route: [first, end) tile of each block, k T / G .. (k + 1) T / G."""
    t, g = plan["tiles"], plan["grid"]
    return [(k * t // g, (k + 1) * t // g) for k in range(g)]


def warp_tiles(plan, block: int, warp: int) -> range:
    """Fused forward: the strips warp `warp` of block `block` takes, in order."""
    first, end = block_tiles(plan)[block]
    return range(first + warp, end, plan["warps"])


def tile_rows(plan, tile: int) -> Tuple[int, int]:
    """Fused route: the pixel rows [first, end) of a tile; the last may be ragged."""
    return tile * plan["M"], min(plan["P"], (tile + 1) * plan["M"])


def tile_samples(plan, tile: int) -> Tuple[int, int]:
    """Fused route: the first and last sample of a tile's rows."""
    r0, r1 = tile_rows(plan, tile)
    return r0 // plan["HW"], (r1 - 1) // plan["HW"]


def split_ranges(plan) -> List[Tuple[int, int]]:
    """Tiled route: the pixel rows of each weight-gradient split, in summation order."""
    rows, p = plan["rows_per_split"], plan["P"]
    return [(s * rows, min(p, (s + 1) * rows)) for s in range(plan["splits"])]


def ln_ranges(plan) -> List[Tuple[int, int]]:
    """Tiled route: the pixel rows of each LayerNorm-backward partial, in
    summation order: sample by sample, each sample's splits in order."""
    hw, count, rows = plan["HW"], plan["ln_splits"], plan["ln_rows"]
    return [(bi * hw + k * rows, bi * hw + min(hw, (k + 1) * rows))
            for bi in range(plan["B"]) for k in range(count)]


# The forward's plan; the constants mirror csrc/attn_tail.cu.
FWD_FUSED_WIDTHS = (16, 32, 48, 96)  # the fused route (at 96 it beats the tiled one)
FWD_STREAMED_WIDTHS = (192,)         # the fused route, its weights streamed
FWD_STRIP_ROWS = 16                  # a warp's pixel strip
_SW_WARPS, _SW_STAGES = 8, 3         # the streamed kernel: warps (one strip each), ring slots
_GEMM_SMEM = 81920                   # gemm_rows_body: the 4-stage ring of 128 x 32 tiles


def fwd_warps(c: int) -> int:
    """Warps per block of the fused forward kernel (`FwdCfg` in the .cu)."""
    return 8 if c <= 48 else 16


def fwd_smem_bytes(c: int) -> int:
    """Shared memory of the fused forward kernel (`fwd_smem_plan` in the
    .cu): the three weights in bf16 with padded rows, each warp's two x
    strip buffers, the six fp32 vectors; at the streamed widths
    (`sw_smem_plan`) a ring of weight slots (W1 rows and W2 columns of a
    16-wide hidden chunk, or 16 WP rows) in place of the weights."""
    ldc, ld2 = c + _PAD, 2 * c + _PAD
    if c in FWD_STREAMED_WIDTHS:
        strips = _SW_WARPS * 2 * FWD_STRIP_ROWS * ldc
        slot = 16 * ldc + c * (16 + _PAD)
        return 2 * (strips + _SW_STAGES * slot) + 6 * c * 4
    strips = fwd_warps(c) * 2 * FWD_STRIP_ROWS * ldc
    return 2 * (2 * c * ldc + c * ld2 + c * ldc + strips) + 6 * c * 4


def fwd_route(c: int) -> str:
    """'fused' for C in FWD_FUSED_WIDTHS, 'streamed' for C in
    FWD_STREAMED_WIDTHS, else 'tiled' for C % 16 == 0 up to 768."""
    if c in FWD_FUSED_WIDTHS:
        return "fused"
    if c in FWD_STREAMED_WIDTHS:
        return "streamed"
    if c % 16 == 0 and 16 <= c <= TILED_MAX_C:
        return "tiled"
    raise ValueError(f"attn_tail kernel is built for C % 16 == 0 and C <= {TILED_MAX_C}, "
                     f"got C={c}")


def fwd_plan(b: int, hw: int, c: int, sms: int, blocks_per_sm: int = 1,
             route: Optional[str] = None) -> Dict[str, object]:
    """The forward's work split for x of (b, H, W, c), hw = H * W, on a card
    of `sms` SMs (`blocks_per_sm`: the fused kernel's occupancy), on
    `route` (default `fwd_route(c)`; the other route is for measuring).

    fused: P = b * hw pixel rows in `tiles` strips of M = 16 rows, the last
    holding `last_rows`; `grid` persistent blocks of `warps` warps, block k
    taking the strips of `block_tiles(plan)[k]`, its warp w the strips
    `warp_tiles(plan, k, w)` (`tile_samples` gives the samples a strip's
    rows read their token from); one launch.
    streamed: the same over `tiles` groups of M = 128 rows (a strip per
    warp), block k taking the groups of `block_tiles(plan)[k]`; `scratch`
    bf16 elements for the rounded weights; two launches (the rounding, the
    kernel).
    tiled: the LayerNorm over `ln_blocks` blocks of `ln_rows` rows, then
    `cast_blocks` more that round the weights; three products over
    `row_tiles` tiles of 128 rows, `gemm_grids` their (row, column) tile
    grids; `scratch` bf16 elements (the rounded weights, n, h, t2); four
    launches."""
    if b < 1 or hw < 1:
        raise ValueError(f"attn_tail needs B, H * W >= 1, got {b}, {hw}")
    route = route or fwd_route(c)
    if not (route == "fused" and c in FWD_FUSED_WIDTHS
            or route == "streamed" and c in FWD_STREAMED_WIDTHS
            or route == "tiled" and c % 16 == 0 and 16 <= c <= TILED_MAX_C):
        raise ValueError(f"attn_tail {route} route does not take C={c}")
    p = b * hw
    plan = {"route": route, "B": b, "HW": hw, "C": c, "P": p}
    if route == "fused":
        m, nw = FWD_STRIP_ROWS, fwd_warps(c)
        tiles = -(-p // m)
        plan.update(M=m, tiles=tiles, last_rows=p - (tiles - 1) * m, warps=nw,
                    grid=max(1, min(-(-tiles // nw), sms * max(1, blocks_per_sm))),
                    smem=fwd_smem_bytes(c), launches=1)
        return plan
    if route == "streamed":
        m = _SW_WARPS * FWD_STRIP_ROWS
        tiles = -(-p // m)
        plan.update(M=m, tiles=tiles, last_rows=p - (tiles - 1) * m, warps=_SW_WARPS,
                    grid=max(1, min(tiles, sms * max(1, blocks_per_sm))),
                    smem=fwd_smem_bytes(c), scratch=5 * c * c, launches=2)
        return plan
    lanes = 16 if c <= 128 else 32
    ln_rows = FUSED_THREADS // 32 * (32 // lanes)
    row_tiles = -(-p // _GEMM_ROWS)
    plan.update(ln_rows=ln_rows, ln_blocks=-(-p // ln_rows),
                cast_blocks=-(-(5 * c * c // 8) // FUSED_THREADS), row_tiles=row_tiles,
                gemm_grids=[(row_tiles, -(-n // _GEMM_ROWS)) for n in (2 * c, c, c)],
                smem=_GEMM_SMEM, scratch=5 * c * c + 4 * c * p, launches=4)
    return plan


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
    if c % 16 or b * h * w == 0:
        raise ValueError(f"{what} kernel needs C % 16 == 0 and pixels, got C={c}, "
                         f"B*H*W={b * h * w}")
    if tuple(tok.shape) != (b, c) or tuple(w1.shape) != (2 * c, c) or \
            tuple(w2.shape) != (c, 2 * c) or tuple(wp.shape) != (c, c):
        raise ValueError(f"{what} kernel: parameter shapes do not match x")


# fused (or streamed) forward blocks per SM, by (card index, C)
_FWD_OCCUPANCY: Dict[Tuple[int, int], int] = {}


def _launch(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, eps, route=None):
    """Launch the forward on `route` (default `fwd_route(C)`). The weights
    go to the kernel as the fp32 parameters; the kernel rounds them."""
    _check(x, tok, w1, w2, wp, "attn_tail")
    b, h, w, c = x.shape
    dev = x.device
    lib = _build.library("attn_tail", _SIGNATURES)
    route = route or fwd_route(c)
    bps = 1
    if route != "tiled":
        if (dev.index, c) not in _FWD_OCCUPANCY:
            _FWD_OCCUPANCY[dev.index, c] = _build.launch(dev, lib.nd_attn_tail_occupancy, c)
        bps = _FWD_OCCUPANCY[dev.index, c]
    plan = fwd_plan(b, h * w, c, _build.sm_count(dev), bps, route)
    # held until the launch: a converted operand's memory must not go back
    # to the allocator (and to `out`) before the kernel reads it; the fp32
    # parameters and the bf16 token pass through with no copy
    args = [x, _build.on_device(tok, dev, torch.bfloat16)] + [
        _build.on_device(t, dev, torch.float32)
        for t in (ln_scale, ln_bias, w1, b1, w2, b2, wp, bp)]
    ptrs = [_build.ptr(t) for t in args]
    out = torch.empty_like(x)
    if route == "fused":
        code = _build.launch(dev, lib.nd_attn_tail_fused, *ptrs, _build.ptr(out), plan["P"],
                             h * w, c, plan["grid"], float(eps), _build.stream_ptr(dev))
    elif route == "streamed":
        wb = torch.empty(plan["scratch"], device=dev, dtype=torch.bfloat16)
        code = _build.launch(dev, lib.nd_attn_tail_streamed, *ptrs, _build.ptr(out),
                             _build.ptr(wb), plan["P"], h * w, c, plan["grid"], float(eps),
                             _build.stream_ptr(dev))
    else:
        ops = torch.empty(plan["scratch"], device=dev, dtype=torch.bfloat16)
        code = _build.launch(dev, lib.nd_attn_tail_tiled, *ptrs, _build.ptr(out),
                             _build.ptr(ops), plan["P"], h * w, c, float(eps),
                             _build.stream_ptr(dev))
    _build.check(lib, code, "attn_tail")
    fused_attn_tail.launches += 1
    return out


_OCCUPANCY: Dict[Tuple[int, int], int] = {}  # fused-kernel blocks per SM, by (card index, C)


def _launch_bwd(x, tok, ln_scale, ln_bias, w1, b1, w2, b2, wp, bp, g, eps):
    _check(x, tok, w1, w2, wp, "attn_tail backward")
    if g.shape != x.shape:
        raise ValueError(f"attn_tail backward: g {tuple(g.shape)} does not match x")
    b, h, w, c = x.shape
    route = bwd_route(c)
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    args = [_build.on_device(t, dev, dt) for t, dt in (
        (tok, bf), (g, bf), (ln_scale, f32), (ln_bias, f32), (w1, bf), (b1, f32), (w2, bf),
        (b2, f32), (wp, bf))]
    lib = _build.library("attn_tail_bwd", _BWD_SIGNATURES)
    bps = 1
    if route == "fused":
        if (dev.index, c) not in _OCCUPANCY:
            _OCCUPANCY[dev.index, c] = _build.launch(dev, lib.nd_attn_tail_bwd_occupancy, c)
        bps = _OCCUPANCY[dev.index, c]
    plan = bwd_plan(b, h * w, c, _build.sm_count(dev), bps)
    p = plan["P"]

    def scratch(n, dt=f32):
        return torch.empty(n, device=dev, dtype=dt)

    dx = torch.empty_like(x)
    wout, vout = scratch(5 * c * c), scratch((6 + b) * c)
    head = [_build.ptr(x), *(_build.ptr(a) for a in args), _build.ptr(dx)]
    if route == "fused":
        wpart = scratch(plan["grid"] * 5 * c * c)
        vpart = scratch(plan["grid"] * (6 + b) * c)
        code = _build.launch(
            dev, lib.nd_attn_tail_bwd_fused, *head,
            *(_build.ptr(t) for t in (wpart, vpart, wout, vout)),
            b, h * w, c, plan["grid"], float(eps), _build.stream_ptr(dev))
    else:
        ops = scratch(p * 10 * c, bf)
        stats = scratch(p * 2)
        lpart = scratch(b * plan["ln_splits"] * 5 * c)
        dpart = scratch(plan["row_tiles"] * 2 * c)
        wpart = scratch(plan["splits"] * 5 * c * c)
        code = _build.launch(
            dev, lib.nd_attn_tail_bwd_tiled, *head,
            *(_build.ptr(t) for t in (ops, stats, lpart, dpart, wpart, wout, vout)),
            b, h * w, c, plan["ln_splits"], plan["ln_rows"], plan["splits"],
            plan["rows_per_split"], float(eps), _build.stream_ptr(dev))
    _build.check(lib, code, "attn_tail backward")
    fused_attn_tail_bwd.launches += 1
    dw1, dw2, dwp = wout.split([2 * c * c, 2 * c * c, c * c])
    dbp, db2, db1, dlnw, dlnb, dtok = vout.split([c, c, 2 * c, c, c, b * c])
    return (dx, dtok.view(b, c).to(tok.dtype), dlnw.to(ln_scale.dtype),
            dlnb.to(ln_bias.dtype), dw1.view(2 * c, c).to(w1.dtype), db1.to(b1.dtype),
            dw2.view(c, 2 * c).to(w2.dtype), db2.to(b2.dtype), dwp.view(c, c).to(wp.dtype),
            dbp.to(bp.dtype))


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
