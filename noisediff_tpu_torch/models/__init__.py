"""Network registry, keyed by the reference `--net_name` strings.

Port of noisediff_tpu/models/__init__.py. Only NoiseDiffNet is ported so far;
the other names raise until their slice lands (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from .noisediff_net import NoiseDiffNet, is_unread_parameter

_NOT_YET_PORTED = (
    "UNet_PosEmbV2",
    "UNet_PosEmbV2_NoPosition",
    "UNet_PosEmbV2_CameraCond",
    "LSID",
)


def define_network(net_name: str, cfg, dtype: Optional[torch.dtype] = None):
    """Instantiate a network by its reference CLI name (`--net_name`)."""
    if net_name == "NoiseDiffNet":
        return NoiseDiffNet(dim=cfg.dim, channels=cfg.inp_dim, dtype=dtype)
    if net_name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"{net_name} is not ported to noisediff_tpu_torch yet (see ROADMAP.md, Queue 1)"
        )
    raise ValueError(f"{net_name} is not found. Available: ['NoiseDiffNet']")


__all__ = ["NoiseDiffNet", "define_network", "is_unread_parameter"]
