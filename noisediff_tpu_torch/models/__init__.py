"""Network registry, keyed by the reference `--net_name` strings.

Port of noisediff_tpu/models/__init__.py: NoiseDiffNet, the UNet_PosEmbV2
family (models/others.py) and LSID. As in the JAX registry, `--remat`
reaches NoiseDiffNet only.
"""
from __future__ import annotations

from typing import Optional

import torch

from .lsid import LSID
from .noisediff_net import NoiseDiffNet, is_unread_parameter
from .others import (
    PosEmbUNet, UNet_PosEmbV2, UNet_PosEmbV2_CameraCond, UNet_PosEmbV2_NoPosition)

_POSEMB = {
    "UNet_PosEmbV2": UNet_PosEmbV2,
    "UNet_PosEmbV2_NoPosition": UNet_PosEmbV2_NoPosition,
    "UNet_PosEmbV2_CameraCond": UNet_PosEmbV2_CameraCond,
}


def define_network(net_name: str, cfg, dtype: Optional[torch.dtype] = None):
    """Instantiate a network by its reference CLI name (`--net_name`)."""
    if net_name == "NoiseDiffNet":
        return NoiseDiffNet(dim=cfg.dim, channels=cfg.inp_dim, dtype=dtype,
                            remat=getattr(cfg, "remat", False))
    if net_name in _POSEMB:
        return _POSEMB[net_name](dim=cfg.dim, channels=cfg.inp_dim, cond_dim=cfg.cond_dim,
                                 dtype=dtype)
    if net_name == "LSID":
        # --lsid_width: the JAX package's extension (default 32 = the reference)
        return LSID(dtype=dtype, base_width=getattr(cfg, "lsid_width", 32))
    raise ValueError(f"{net_name} is not found. Available: "
                     f"{sorted(['LSID', 'NoiseDiffNet', *_POSEMB])}")


__all__ = ["LSID", "NoiseDiffNet", "PosEmbUNet", "UNet_PosEmbV2",
           "UNet_PosEmbV2_CameraCond", "UNet_PosEmbV2_NoPosition", "define_network",
           "is_unread_parameter"]
