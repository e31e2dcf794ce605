"""ctypes bindings of the port's host data-plane library
(`csrc/host/noisediff_host.cpp`): threaded Bayer pack and unpack and the
fused training-pair crop.

Port of noisediff_tpu/data/native.py, with its signatures. The port keeps
its own copy of the JAX package's C++ source, and `g++` builds it at first
use into noisediff_tpu_torch/build/, named by a hash of the source, the
compiler and its flags (as ops/kernels/_build.py names the CUDA
libraries). Unlike the JAX module, a build that fails raises with the
compiler's output: nothing falls back to numpy. The numpy versions of the
same arithmetic are `raw_host.pack_frame` and `raw_host.make_noise_pair`,
which the tests hold this library against. The compiler is $CXX, g++ by
default.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host", "noisediff_host.cpp")
# the CUDA libraries' directory too (ops/kernels/_build.py)
BUILD_DIR = os.path.join(_PKG_DIR, "build")
# the rule of csrc/host/Makefile
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")
BLACK_LEVEL = 512.0
WHITE_POINT = 16383.0

_LIB = None
_LOCK = threading.Lock()


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _lib_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((_compiler(), *CXXFLAGS)).encode())
    return os.path.join(BUILD_DIR, f"libnoisediff_host-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile the library to `path` (through a temporary name, renamed on
    success, so a reader never sees a partial library); raise with the
    compiler's output where it fails."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_compiler(), *CXXFLAGS, "-o", tmp, SOURCE]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"the host library could not be built ({' '.join(cmd)}): "
                           f"{exc}") from exc
    if res.returncode != 0:
        raise RuntimeError(f"the host library failed to build ({' '.join(cmd)}, exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64, f32 = ctypes.c_int64, ctypes.c_float
        lib.nd_pack_raw.argtypes = [u16p, f32p, i64, i64, f32, f32, ctypes.c_int]
        lib.nd_unpack_raw.argtypes = [f32p, u16p, i64, i64, f32, f32]
        lib.nd_make_noise_pair.argtypes = [u16p, u16p, f32p, f32p, f32p] + [i64] * 6 + [f32] * 3
        for fn in (lib.nd_pack_raw, lib.nd_unpack_raw, lib.nd_make_noise_pair):
            fn.restype = None
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def pack_raw(bayer: np.ndarray, rescale: bool = True, black: float = BLACK_LEVEL,
             white: float = WHITE_POINT) -> np.ndarray:
    """Bayer (H, W) -> packed (H/2, W/2, 4) float32 [R, G1, B, G2]: the
    mosaic as uint16, (v - black) clamped at 0, times the float32
    reciprocal of (white - black) when `rescale` (raw_util.py:17-35)."""
    lib = _load()
    bayer16 = np.ascontiguousarray(bayer, dtype=np.uint16)
    h, w = bayer16.shape
    out = np.empty((h // 2, w // 2, 4), np.float32)
    lib.nd_pack_raw(bayer16, out, h, w, black, white, int(rescale))
    return out


def unpack_raw(packed: np.ndarray, black: float = BLACK_LEVEL,
               white: float = WHITE_POINT) -> np.ndarray:
    """Packed (h, w, 4) normalised float32 -> Bayer (2h, 2w) uint16 DN:
    v * (white - black) + black, clipped to [0, white] (raw_util.py:69-84)."""
    lib = _load()
    packed32 = np.ascontiguousarray(packed, dtype=np.float32)
    h, w, _ = packed32.shape
    out = np.empty((2 * h, 2 * w), np.uint16)
    lib.nd_unpack_raw(packed32, out, h, w, black, white)
    return out


def make_noise_pair(bayer_in: np.ndarray, bayer_gt: np.ndarray, cy: int, cx: int, ch: int,
                    cw: int, ratio: float, black: float = BLACK_LEVEL,
                    white: float = WHITE_POINT) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(noisy, clean, noise) float32 (ch, cw, 4) crops at packed (cy, cx):
    noisy = clip(pack(bayer_in) * ratio, 0, 1), clean = pack(bayer_gt),
    noise = noisy - clean (the SonyTrainDataset item, dataset.py:119-128),
    in one pass over the crop. Only the crop's Bayer rows are read and
    converted (a memory-mapped frame stays on disk elsewhere); every step
    is per pixel, so the numbers are the whole frame's."""
    lib = _load()
    fh, fw = bayer_in.shape[0] // 2, bayer_in.shape[1] // 2
    if (bayer_gt.shape != bayer_in.shape or min(cy, cx, ch, cw) < 0 or cy + ch > fh
            or cx + cw > fw):
        raise ValueError(f"crop ({cy}, {cx}, {ch}, {cw}) of packed frames {bayer_in.shape} / "
                         f"{bayer_gt.shape} halved")

    def crop(bayer):
        return np.ascontiguousarray(bayer[2 * cy: 2 * (cy + ch), 2 * cx: 2 * (cx + cw)],
                                    dtype=np.uint16)

    noisy, clean, noise = (np.empty((ch, cw, 4), np.float32) for _ in range(3))
    lib.nd_make_noise_pair(crop(bayer_in), crop(bayer_gt), noisy, clean, noise, 2 * ch, 2 * cw,
                           0, 0, ch, cw, ratio, black, white)
    return noisy, clean, noise
