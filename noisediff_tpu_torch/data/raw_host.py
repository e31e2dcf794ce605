"""Host-side raw ingestion: decode, numpy packing, training noise pairs,
the packed-frame cache, the PMN dark-shading resources and the EXIF and
raw-file helpers of the evaluation.

Port of noisediff_tpu/data/raw_host.py. A `.npy` sidecar next to an `.ARW`
path is read in place of the raw file, and a `.meta.json` sidecar in place
of its EXIF (how test and smoke trees are made without LibRaw); rawpy and
exifread are imported only when a real raw file has to be read. The frames
the datasets and the CLIs read are packed by the host library
(`data/native.py`, `load_packed_frame`), as the JAX package's are;
`pack_frame` and `make_noise_pair` here are the library's plain numpy
versions (raw_util.py:17-35), which the tests hold it against.
"""
from __future__ import annotations

import json
import os
import pickle
from fractions import Fraction
from typing import Dict, Optional, Tuple

import numpy as np

from . import native
from .native import BLACK_LEVEL, WHITE_POINT

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


def np_unpack_bayer(packed: np.ndarray) -> np.ndarray:
    """(h, w, 4) [R, G1, B, G2] -> (2h, 2w) Bayer mosaic, same units."""
    h, w, _ = packed.shape
    bayer = np.zeros((2 * h, 2 * w), packed.dtype)
    bayer[0::2, 0::2] = packed[..., 0]
    bayer[0::2, 1::2] = packed[..., 1]
    bayer[1::2, 1::2] = packed[..., 2]
    bayer[1::2, 0::2] = packed[..., 3]
    return bayer


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


def extract_iso_from_exif(path: str) -> Optional[int]:
    """The EXIF ISO tag (raw_util.py:142-158); None where exifread is not
    installed or the tag is absent."""
    try:
        import exifread  # type: ignore
    except ImportError:
        return None
    try:
        with open(path, "rb") as f:
            tags = exifread.process_file(f)
        if "EXIF ISOSpeedRatings" in tags:
            return int(str(tags["EXIF ISOSpeedRatings"]))
        return None
    except Exception:
        return None


def _exif_number(tag) -> float:
    """An EXIF rational or integer ('1/30', '800') as a number."""
    return float(Fraction(str(tag).strip()))


def metainfo(path: str) -> Tuple[float, float]:
    """(iso, exposure time) of a raw file (test_denoising.py:302-315): from
    a '<path>.meta.json' or '<stem>.meta.json' sidecar ({"iso": ...,
    "exposure": ...}) where there is one, else from EXIF (exifread, which
    the ELD evaluation then needs); a .dng keeps them under 'Image' tags."""
    for cand in (path + ".meta.json", os.path.splitext(path)[0] + ".meta.json"):
        if os.path.exists(cand):
            with open(cand, "r") as f:
                m = json.load(f)
            return float(m["iso"]), float(m["exposure"])

    import exifread  # type: ignore

    with open(path, "rb") as f:
        tags = exifread.process_file(f)
    group = "Image" if os.path.splitext(path)[1] == ".dng" else "EXIF"
    return _exif_number(tags[f"{group} ISOSpeedRatings"]), _exif_number(
        tags[f"{group} ExposureTime"])


def modify_raw_file(raw_file: str, tab: np.ndarray, position, out_file: str) -> None:
    """Write a uint16 plane into a copy of an uncompressed ARW / DNG
    (raw_util.py:324-348): the mosaic is the file's last l * c * 2 bytes and
    everything before it is copied as the header; `tab` goes at (y, x)."""
    import rawpy  # type: ignore  # the file's geometry

    with rawpy.imread(raw_file) as raw:
        l, c = raw.raw_image.shape
    with open(raw_file, "rb") as f:
        blob = f.read()
    mosaic = np.frombuffer(blob[-l * c * 2:], dtype=np.uint16).reshape(l, c).copy()
    header = blob[: -l * c * 2]
    y, x = position
    mosaic[y: y + tab.shape[0], x: x + tab.shape[1]] = tab
    with open(out_file, "wb") as f:
        f.write(header)
        f.write(mosaic.tobytes())


def vis_raw_file(raw_file, save_path: str, save_file: bool = True) -> np.ndarray:
    """LibRaw postprocess to sRGB in [0, 255] float (raw_util.py:351-373),
    saved through PIL when save_file; raw_file a path or a rawpy image."""
    import rawpy  # type: ignore

    raw = rawpy.imread(raw_file) if isinstance(raw_file, str) else raw_file
    rgb = raw.postprocess(use_camera_wb=True, half_size=False, no_auto_bright=True,
                          output_bps=16)
    rgb = np.clip(np.float32(rgb / 65535.0) * 255.0, 0, 255)
    if save_file:
        from PIL import Image

        Image.fromarray(rgb.astype(np.uint8)).save(save_path)
    return rgb


def pack_frame(bayer: np.ndarray, rescale: bool = True, black: float = BLACK_LEVEL,
               white: float = WHITE_POINT) -> np.ndarray:
    """Plain version of `native.pack_raw`: a Bayer mosaic (a frame or a
    crop) packed as the host library packs it (csrc/host/noisediff_host.cpp):
    the mosaic as uint16, (v - black) clamped at 0, times the float32
    reciprocal of (white - black) when `rescale`."""
    f32 = np.float32
    v = np_pack_bayer(np.asarray(bayer).astype(np.uint16, copy=False).astype(f32)) - f32(black)
    v = np.maximum(v, f32(0.0))
    if rescale:
        v = v * (f32(1.0) / f32(white - black))
    return v.astype(f32)


def make_noise_pair(bayer_in: np.ndarray, bayer_gt: np.ndarray, cy: int, cx: int, ch: int,
                    cw: int, ratio: float, black: float = BLACK_LEVEL,
                    white: float = WHITE_POINT):
    """Plain version of `native.make_noise_pair`: (noisy, clean, noise)
    float32 (ch, cw, 4) crops at packed (cy, cx), the SonyTrainDataset item
    pipeline (reference dataset.py:119-128).

    Crops the Bayer region first and packs only the crop, as the host
    library does; every step is per pixel, so the numbers equal
    pack-then-crop. The arithmetic is the library's, in float32
    (`pack_frame`); the noisy frame times ratio clipped to [0, 1]; noise =
    noisy - clean."""
    f32 = np.float32

    def packed_crop(bayer):
        return pack_frame(bayer[2 * cy: 2 * (cy + ch), 2 * cx: 2 * (cx + cw)], black=black,
                          white=white)

    noisy = np.clip(packed_crop(bayer_in) * f32(ratio), f32(0.0), f32(1.0))
    clean = packed_crop(bayer_gt)
    return noisy, clean, noisy - clean


def load_packed_frame(path: str, rescale: bool = True) -> np.ndarray:
    """A raw file's packed frame through the host library
    (`native.pack_raw`, the JAX package's `load_packed`): equal to the JAX
    package's frames, and to `pack_frame` of the decoded mosaic."""
    return native.pack_raw(open_bayer(path), rescale=rescale)


class PackedFrameCache:
    """Packed clean frames by name, in memory or as memmaps of packed
    float32 `.npy` files under cache_dir (written on first access), in
    place of the reference's whole-dataset RAM preload
    (dataset_denoising.py:36-43)."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir
        self._mem: Dict[str, np.ndarray] = {}
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def get(self, path: str) -> np.ndarray:
        key = os.path.basename(path).split(".ARW")[0].split(".npy")[0]
        if key in self._mem:
            return self._mem[key]
        if self.cache_dir:
            cpath = os.path.join(self.cache_dir, key + ".packed.npy")
            if not os.path.exists(cpath):
                np.save(cpath, load_packed_frame(path))
            arr = np.load(cpath, mmap_mode="r")
        else:
            arr = load_packed_frame(path)
        self._mem[key] = arr
        return arr


class Darkshading:
    """PMN dark-shading resources (raw_util.py:87-109) under resources_path:
    darkshading_{high,low}ISO_{k,b}.npy and darkshading_BLE.pkl. `get(iso)`
    is the full-resolution Bayer-domain map ds_k * iso + ds_b + BLE[iso],
    from the high-ISO pair above ISO 1600 and the low-ISO pair otherwise."""

    def __init__(self, resources_path: str):
        self.resources_path = resources_path
        self._loaded = False

    def _load(self):
        if self._loaded:
            return
        rp = self.resources_path
        with open(os.path.join(rp, "darkshading_BLE.pkl"), "rb") as f:
            self.blc_mean = pickle.load(f)
        self.ds_k_high = np.load(os.path.join(rp, "darkshading_highISO_k.npy"), allow_pickle=True)
        self.ds_b_high = np.load(os.path.join(rp, "darkshading_highISO_b.npy"), allow_pickle=True)
        self.ds_k_low = np.load(os.path.join(rp, "darkshading_lowISO_k.npy"), allow_pickle=True)
        self.ds_b_low = np.load(os.path.join(rp, "darkshading_lowISO_b.npy"), allow_pickle=True)
        self._loaded = True

    def get(self, iso: int) -> np.ndarray:
        self._load()
        if iso > 1600:
            ds_k, ds_b = self.ds_k_high, self.ds_b_high
        else:
            ds_k, ds_b = self.ds_k_low, self.ds_b_low
        return ds_k * iso + ds_b + self.blc_mean[iso]
