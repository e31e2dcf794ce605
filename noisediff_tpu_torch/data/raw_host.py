"""Host-side raw ingestion: decode, numpy packing, training noise pairs.

Port of the generation and training subset of noisediff_tpu/data/raw_host.py
and of `make_noise_pair` (noisediff_tpu/data/native.py:94-125). A `.npy`
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


def _sidecar(path: str):
    if path.endswith(".npy"):
        return path
    for cand in (path + ".npy", os.path.splitext(path)[0] + ".npy"):
        if os.path.exists(cand):
            return cand
    return None


def open_bayer(path: str) -> np.ndarray:
    """The (H, W) Bayer mosaic of a raw file without a float copy: a
    memory map of its `.npy` sidecar (slicing it reads only the slice), or
    the decoded mosaic. Same resolution order as `decode_bayer`."""
    npy = _sidecar(path)
    if npy is not None:
        return np.load(npy, mmap_mode="r")
    return decode_bayer(path)


def decode_bayer(path: str) -> np.ndarray:
    """Decode a raw file to the (H, W) float32 Bayer DN mosaic.

    Resolution order: literal .npy path -> '<path>.npy' sidecar ->
    '<stem>.npy' sidecar -> rawpy (LibRaw)."""
    npy = _sidecar(path)
    if npy is not None:
        return np.load(npy).astype(np.float32)
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


def make_noise_pair(bayer_in: np.ndarray, bayer_gt: np.ndarray, cy: int, cx: int, ch: int,
                    cw: int, ratio: float, black: float = BLACK_LEVEL,
                    white: float = WHITE_POINT):
    """(noisy, clean, noise) float32 (ch, cw, 4) crops at packed (cy, cx):
    the SonyTrainDataset item pipeline (reference dataset.py:119-128).

    Crops the Bayer region first and packs only the crop, as the JAX
    package's native library does; every step is per pixel, so the numbers
    equal pack-then-crop. The arithmetic is the native kernel's, in
    float32: (v - black) clamped at 0 times 1 / (white - black); the noisy
    frame times ratio clipped to [0, 1]; noise = noisy - clean."""
    f32 = np.float32
    inv = f32(1.0) / f32(white - black)

    def packed_crop(bayer):
        region = np.asarray(bayer[2 * cy: 2 * (cy + ch), 2 * cx: 2 * (cx + cw)], np.float32)
        v = np_pack_bayer(region) - f32(black)
        return np.where(v < 0, f32(0.0), v * inv).astype(np.float32)

    noisy = np.clip(packed_crop(bayer_in) * f32(ratio), f32(0.0), f32(1.0))
    clean = packed_crop(bayer_gt)
    return noisy, clean, noisy - clean
