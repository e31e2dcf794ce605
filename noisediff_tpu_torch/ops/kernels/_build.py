"""Build and load the port's CUDA kernel libraries.

Each source under `noisediff_tpu_torch/csrc/` is compiled by `nvcc` on
first use into its own shared library with a plain C interface and loaded
with ctypes (pointers and the stream are passed as `c_void_p`). Libraries
go to `noisediff_tpu_torch/build/` (listed in .gitignore), named by a hash of
the source and every header under csrc/, so an edited kernel or header is
rebuilt and an unchanged one is reused. `build_all()` starts one nvcc per
source at once.

Every call of a C entry point goes through `launch`, which makes the
tensors' card the current device for the call: the runtime API launches on
the current device and sets kernel attributes there, whichever card the
stream passed in belongs to.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("attn_tail", "attn_tail_bwd", "groupnorm_silu", "dual_head", "gn_stats", "conv_wgrad",
           "flash_attention")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_SMS: Dict[int, int] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, every header
    under csrc/ (any source may include any of them) and the flags."""
    h = hashlib.sha256()
    headers = sorted(fn for fn in os.listdir(CSRC_DIR) if fn.endswith(".cuh"))
    for fn in (f"{name}.cu", *headers):
        h.update(fn.encode())
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


class _Job:
    """One running nvcc: compiles to a temporary name, renamed on success."""

    def __init__(self, name: str):
        self.name = name
        self.out = _lib_path(name)
        self.tmp = f"{self.out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", self.tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(self) -> str:
        log, _ = self.proc.communicate()
        with open(os.path.join(BUILD_DIR, f"{self.name}.log"), "w") as f:
            f.write(log)
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}.cu:\n{log}")
        os.replace(self.tmp, self.out)  # atomic: a reader never sees a partial library
        return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source that has no current library, all nvcc
    processes at once. Returns {name: compiler log} for what was built."""
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = [_Job(n) for n in todo]
    logs = {}
    try:
        for job in jobs:
            logs[job.name] = job.finish()
    finally:
        for job in jobs:
            if job.proc.poll() is None:
                job.proc.kill()
                job.proc.wait()
    return logs


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for one kernel source, built on first use.
    `signatures` gives the ctypes argtypes of each C entry point (all
    return int)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(_lib_path(name))
            lib.nd_error_string.argtypes = [ctypes.c_int]
            lib.nd_error_string.restype = ctypes.c_char_p
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def launch(device, fn, *args) -> int:
    """fn(*args), a C entry point, with `device`'s card as the current
    device (restored after the call); returns its code."""
    import torch

    prev = torch.cuda.current_device()
    if prev == device.index:
        return fn(*args)
    torch.cuda.set_device(device.index)
    try:
        return fn(*args)
    finally:
        torch.cuda.set_device(prev)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.nd_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def on_device(t, device, dtype):
    """t as a contiguous tensor of `dtype` on `device`: t itself when it is
    one (no copy, no cast kernel, no new tensor per call), else a converted
    copy. A launch's inputs are raw pointers, so the wrappers that need
    gradients go through a torch.autograd.Function."""
    if t.dtype == dtype and t.device == device and t.is_contiguous():
        return t
    return t.detach().to(device=device, dtype=dtype).contiguous()


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def sm_count(device) -> int:
    """The number of SMs of `device`, read from the driver once per card."""
    import torch

    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
