"""Coordinate grids for the positional conditioning.

Port of noisediff_tpu/ops/coords.py (host half): a (H, W, 2) float32 grid,
channel 0 the row and channel 1 the column coordinate, each in [0, 1] when
rescaled (reference `utils/util.py:138-147`).
"""
from __future__ import annotations

import numpy as np


def make_coord(h: int, w: int, rescale: bool = False) -> np.ndarray:
    """Coordinate grid, shape (H, W, 2) float32, [row, col] order."""
    seq1 = np.arange(h, dtype=np.float32)
    seq2 = np.arange(w, dtype=np.float32)
    if rescale:
        seq1 = seq1 / (h - 1)
        seq2 = seq2 / (w - 1)
    yy, xx = np.meshgrid(seq1, seq2, indexing="ij")
    return np.stack([yy, xx], axis=-1)


def crop_coord_patch(
    full_h: int, full_w: int, y: int, x: int, h: int, w: int
) -> np.ndarray:
    """Coordinate patch for a crop at (y, x) of a (full_h, full_w) image:
    make_coord(full_h, full_w, rescale=True)[y:y+h, x:x+w] in O(h*w)."""
    seq1 = (np.arange(y, y + h, dtype=np.float32)) / (full_h - 1)
    seq2 = (np.arange(x, x + w, dtype=np.float32)) / (full_w - 1)
    yy, xx = np.meshgrid(seq1, seq2, indexing="ij")
    return np.stack([yy, xx], axis=-1)
