"""The traced part of a `--trace 1` run: a few units after the measured
window, under torch.profiler, reduced to what the per-layer metrics read.

`profiled(fn, device)` runs fn inside a `pb::profiled` range with the card
synchronised at both ends, so that the range's host interval holds all of
its device work; that interval is the traced window. The device's numbers
come from a profile of the card's activity alone, which costs the host
little; the idle gaps' names from a second profile, of one more call of
fn with the host's operations recorded too, which slows the host. From
the profiles:

- busy_s: the union of the intervals in which a kernel, copy or set ran
  on the card, inside the window (device-side record_function ranges are
  not work and are left out);
- kernel_s: device seconds by kernel name;
- handwritten_s: the device seconds of the port's hand-written kernels,
  recognised by the names its CUDA sources declare `__global__`;
- breakdown: the ten device operations that took most time, and the ten
  longest idle gaps of the card, each named by what the host was doing
  (the innermost host range open at the gap's middle).
"""
from __future__ import annotations

import glob
import os
import re
import time
from typing import Callable, Dict, List, Tuple

SPAN = "pb::profiled"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(")


def handwritten_names(root: str) -> set:
    """Every kernel the port's CUDA sources declare `__global__`."""
    names = set()
    for path in glob.glob(os.path.join(root, "noisediff_tpu_torch", "csrc", "*.cu*")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return names


def _is_handwritten(name: str, names: set) -> bool:
    return any(tok in names for tok in re.split(r"\W+", name))


def _device_type(e) -> str:
    return str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]


def _profile(fn: Callable[[], None], device, host: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(SPAN):
            fn()
            sync()
        wall = time.perf_counter() - t0
    return prof, wall


def profiled(fn: Callable[[], None], device, root: str) -> Dict:
    """fn's traced numbers (module docstring); times in seconds."""
    out = reduce(*_profile(fn, device, host=False), root)
    out["breakdown"]["idle_gaps"] = reduce(*_profile(fn, device, host=True),
                                           root)["breakdown"]["idle_gaps"]
    return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(prof, wall: float, root: str) -> Dict:
    """One profile's numbers, in seconds: the window is `wall`, the host
    clock's time between the two synchronisations; the device's work is
    clipped to the SPAN range where the profile recorded the host."""
    events = list(prof.events())
    spans = [e for e in events if e.name == SPAN and _device_type(e) == "CPU"]
    if spans:
        w0, w1 = spans[0].time_range.start, spans[0].time_range.end  # microseconds
    else:  # the card's activity alone: every event is fn's
        dev_events = [e for e in events if _device_type(e) == "CUDA"]
        w0 = min((e.time_range.start for e in dev_events), default=0.0)
        w1 = max((e.time_range.end for e in dev_events), default=0.0)
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if end <= w0 or start >= w1:
            continue
        if _device_type(e) == "CUDA":
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, max(start, w0), min(end, w1)))
        elif e.name != SPAN:
            host.append(e)
    busy = _merge([(a, b) for _, a, b in device])
    busy_us = sum(b - a for a, b in busy)
    names = handwritten_names(root)
    kernel_s: Dict[str, float] = {}
    for name, a, b in device:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e6
    gaps = []
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, prev_end), (next_start, _) in zip(edges, edges[1:]):
        if next_start > prev_end:
            gaps.append((prev_end, next_start))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        open_ = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        label = "host outside any traced call"
        if open_:
            inner = max(open_, key=lambda e: e.time_range.start)
            users = [e for e in open_ if e.name.startswith("pb::")]
            user = max(users, key=lambda e: e.time_range.start) if users else None
            label = inner.name if user is None or user is inner else f"{user.name} > {inner.name}"
        idle.append([label[:160], (b - a) / 1e6])
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": wall,
        "busy_s": busy_us / 1e6,
        "kernel_s": kernel_s,
        "handwritten_s": sum(s for n, s in kernel_s.items() if _is_handwritten(n, names)),
        "breakdown": {"device_ops": [[n[:160], s] for n, s in top], "idle_gaps": idle},
    }
