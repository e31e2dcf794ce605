"""The gn_stats / gn_grad_stats kernels' launch plan (`ops/kernels/gn_stats.plan`),
held on the CPU: the grid covers every row of every sample exactly once,
fits the card, and the scratch and shared memory it sizes are what the
kernel (csrc/gn_stats.cu) indexes. The kernel's own sums are checked on the
card (tests/test_torch_port_cuda.py, chip_smoke.py)."""
import importlib

import numpy as np
import pytest

# the module (the package's `gn_stats` is the wrapper function)
gs = importlib.import_module("noisediff_tpu_torch.ops.kernels.gn_stats")

SMS = 132
# the training path's four stages (B 4), the card tests' edges, and extremes
CASES = [(4, 512 * 512, 48), (4, 256 * 256, 96), (4, 128 * 128, 192), (4, 64 * 64, 384),
         (4, 4, 384), (3, 35, 48), (1, 1920, 192), (16, 144, 96), (4, 1023, 8),
         (2, 63, 2048), (1, 178 * 266, 384), (64, 1, 8), (1, 1, 2048)]


def _rows_read(p, n, c):
    """How often the kernel's loops read each row of one sample: block s,
    thread row r reads rows row0 + r, row0 + r + R, ... below row1, in
    rounds of UNROLL (R = threads / (C / 8) rows in flight)."""
    rif = p["threads"] // (c // 8)
    count = np.zeros(n, np.int64)
    for s in range(p["splits"]):
        row0, row1 = s * p["rows"], min(n, (s + 1) * p["rows"])
        for r in range(rif):
            count[row0 + r:row1:rif] += 1
    return count


@pytest.mark.parametrize("b,n,c", CASES)
def test_plan_covers_every_row_once(b, n, c):
    p = gs.plan(b, n, c, SMS)
    assert p["splits"] >= 1 and p["rows"] >= 1
    assert (p["splits"] - 1) * p["rows"] < n <= p["splits"] * p["rows"]  # no empty block
    assert (_rows_read(p, n, c) == 1).all()


@pytest.mark.parametrize("b,n,c", CASES)
def test_plan_fits_the_card_and_sizes_the_scratch(b, n, c):
    p = gs.plan(b, n, c, SMS)
    lanes = c // 8
    # grid (splits, b); blocks of whole rows of C / 8 lanes
    assert p["splits"] < 2 ** 31 and b < 2 ** 16
    assert p["threads"] % lanes == 0 and lanes <= p["threads"] <= gs.THREADS
    # the dynamic shared memory the kernel is launched with, under the 48 KB
    # a launch gets without opting in: [rows in flight][2C] fp32 sums, then
    # their K2 slices per column
    # (K2 * 2C <= threads floats where K2 > 1); the last block's K slices of
    # C / 2 float4 columns reuse the sums' space
    rif = p["threads"] // lanes
    assert p["smem"] == (rif * 2 * c + p["threads"]) * 4 <= 48 * 1024
    k2 = p["threads"] // (2 * c) if p["threads"] >= 2 * c else 1
    assert (k2 == 1 or k2 * 2 * c <= p["threads"]) and k2 <= rif
    q4 = c // 2
    k = p["threads"] // q4 if p["threads"] >= q4 else 1
    assert k * q4 * 16 <= rif * 2 * c * 4
    # scratch: one (2, C) partial per block, one arrival counter per sample
    assert p["part"] == b * p["splits"] * 2 * c
    assert p["counters"] == b


@pytest.mark.parametrize("b,n,c", CASES)
def test_plan_splits_by_bytes_up_to_the_card(b, n, c):
    """S blocks a sample: one per SLAB_BYTES of it, at most enough to fill
    the card BLOCKS_PER_SM deep and at most one per row; fewer SMs never
    give more blocks."""
    p = gs.plan(b, n, c, SMS)
    want = max(1, min(n, -(-gs.BLOCKS_PER_SM * SMS // b), -(-n * c * 2 // gs.SLAB_BYTES)))
    assert p["splits"] <= want and p["splits"] == -(-n // -(-n // want))
    assert gs.plan(b, n, c, SMS // 2)["splits"] <= p["splits"]


def test_plan_takes_fewer_larger_slabs_where_the_map_is_small():
    """At the deep stage a block reads SLAB_BYTES, not the fill's share; at
    512^2 x 48 the card's fill decides."""
    deep = gs.plan(4, 64 * 64, 384, SMS)
    assert deep["splits"] * 4 < gs.BLOCKS_PER_SM * SMS
    assert deep["rows"] * 384 * 2 >= gs.SLAB_BYTES
    top = gs.plan(4, 512 * 512, 48, SMS)
    assert top["splits"] == -(-gs.BLOCKS_PER_SM * SMS // 4)
