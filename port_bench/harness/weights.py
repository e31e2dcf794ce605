"""Seeded weights, made on the device in one draw.

Every parameter of the model, in the order of its sorted names, is a slice
of one standard normal draw from a `torch.Generator` seeded by the run,
scaled per tensor: a weight (2 or more dimensions, embeddings included)
by gain / sqrt(fan_in); a 1-dimensional `weight` (a norm's scale) as
exp(N), log-normal with median 1, spread over the channels as a trained
network's scales are; any other vector (a bias) as 0.05 N. The values
are fp32, the dtype in which the port keeps its parameters. The
same seed gives the same tensors, which both the program and the
reference load.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def seeded_state(shapes: Dict[str, torch.Size], seed: int, device, gain: float = 1.0
                 ) -> Dict[str, torch.Tensor]:
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    scale, norm = [], []
    for n in names:
        shape = shapes[n]
        norm.append(len(shape) == 1 and n.endswith("weight"))
        if len(shape) >= 2:
            scale.append(gain / math.sqrt(math.prod(shape[1:])))
        else:
            scale.append(1.0 if norm[-1] else 0.05)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat = flat * torch.repeat_interleave(torch.tensor(scale, device=device), counts)
    return {n: (t.exp() if is_norm else t).view(shapes[n])
            for n, t, is_norm in zip(names, flat.split(sizes), norm)}


def shapes_of(module: torch.nn.Module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}
