"""Host-side raw ingestion for generation: decode and numpy packing.

Port of the generation subset of noisediff_tpu/data/raw_host.py. A `.npy`
sidecar next to an `.ARW` path is read in place of the raw file (how test
and smoke trees are made without LibRaw); rawpy is imported only when a
real raw file has to be decoded. Packing is numpy (raw_util.py:17-35).
"""
from __future__ import annotations

import os

import numpy as np

BLACK_LEVEL = 512.0
WHITE_POINT = 16383.0
SCALE = WHITE_POINT - BLACK_LEVEL


def np_pack_bayer(im: np.ndarray) -> np.ndarray:
    """(H, W) Bayer -> (H/2, W/2, 4) [R, G1, B, G2] (raw_util.py:30-33)."""
    return np.stack(
        [im[0::2, 0::2], im[0::2, 1::2], im[1::2, 1::2], im[1::2, 0::2]], axis=-1
    )


def np_pack_raw(bayer: np.ndarray, rescale: bool = True) -> np.ndarray:
    im = np.maximum(bayer.astype(np.float32) - BLACK_LEVEL, 0.0)
    if rescale:
        im = im / SCALE
    return np_pack_bayer(im)


def decode_bayer(path: str) -> np.ndarray:
    """Decode a raw file to the (H, W) float32 Bayer DN mosaic.

    Resolution order: literal .npy path -> '<path>.npy' sidecar ->
    '<stem>.npy' sidecar -> rawpy (LibRaw)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    for cand in (path + ".npy", os.path.splitext(path)[0] + ".npy"):
        if os.path.exists(cand):
            return np.load(cand).astype(np.float32)
    try:
        import rawpy  # type: ignore
    except ImportError as exc:
        raise FileNotFoundError(
            f"{path}: no .npy sidecar found and rawpy is unavailable on this host"
        ) from exc
    with rawpy.imread(path) as raw:
        return raw.raw_image_visible.astype(np.float32)


def load_packed(path: str, rescale: bool = True) -> np.ndarray:
    """decode + pack_raw in one host call."""
    return np_pack_raw(decode_bayer(path), rescale=rescale)
