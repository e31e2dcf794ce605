"""Optional noise-range compression mappings.

Port of noisediff_tpu/ops/mappings.py (reference utils/util.py:84-134:
tempsigmoid / inversesigmoid / piecewise_mapping /
inverse_piecewise_mapping), the math of the --scale_noise / --temperature
options. No shipped config uses them. Branch-free: torch.where in place of
the reference's boolean-mask assignment, with the sigmoid branch's input
clamped so that its unused lanes stay finite.
"""
from __future__ import annotations

import torch


def tempsigmoid(x: torch.Tensor, temp: float = 1.0) -> torch.Tensor:
    """sigmoid(x / temp) rescaled to (-1, 1)."""
    return torch.sigmoid(x / temp) * 2.0 - 1.0


def inversesigmoid(y: torch.Tensor, temp: float = 1.0) -> torch.Tensor:
    y01 = (y + 1.0) / 2.0
    return (torch.log(y01) - torch.log1p(-y01)) * temp


def _value_at(b: float, temp: float) -> float:
    """tempsigmoid(b) in float32, as the JAX package computes the knot."""
    return float(tempsigmoid(torch.tensor(b, dtype=torch.float32), temp))


def piecewise_mapping(x: torch.Tensor, b: float = 0.2, temp: float = 0.1) -> torch.Tensor:
    """tempsigmoid inside [-b, b], its linear continuation outside,
    continuous at the knots and mapping +-1 to +-1."""
    if not 0.0 < b < 1.0:
        raise ValueError("b must be in (0, 1)")
    k2 = (_value_at(b, temp) - 1.0) / (b - 1.0)
    mid = tempsigmoid(x, temp)
    lo = k2 * x + k2 - 1.0
    hi = k2 * x + 1.0 - k2
    return torch.where(x < -b, lo, torch.where(x > b, hi, mid))


def inverse_piecewise_mapping(y: torch.Tensor, b: float = 0.2,
                              temp: float = 0.1) -> torch.Tensor:
    value_at_b = _value_at(b, temp)
    k2 = (value_at_b - 1.0) / (b - 1.0)
    lo = (y - k2 + 1.0) / k2
    hi = (y + k2 - 1.0) / k2
    # the sigmoid branch's input clamped away from +-1: the lanes the where
    # drops give no inf / nan
    mid = inversesigmoid(y.clamp(-value_at_b, value_at_b), temp)
    return torch.where(y < -value_at_b, lo, torch.where(y > value_at_b, hi, mid))
