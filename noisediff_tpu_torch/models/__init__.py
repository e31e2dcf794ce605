"""Network registry, keyed by the reference `--net_name` strings.

Port of noisediff_tpu/models/__init__.py. NoiseDiffNet and LSID are
ported; the UNet_PosEmbV2 family raises until its slice lands (ROADMAP.md,
Queue 1 item 3).
"""
from __future__ import annotations

from typing import Optional

import torch

from .lsid import LSID
from .noisediff_net import NoiseDiffNet, is_unread_parameter

_NOT_YET_PORTED = (
    "UNet_PosEmbV2",
    "UNet_PosEmbV2_NoPosition",
    "UNet_PosEmbV2_CameraCond",
)


def define_network(net_name: str, cfg, dtype: Optional[torch.dtype] = None):
    """Instantiate a network by its reference CLI name (`--net_name`)."""
    if net_name == "NoiseDiffNet":
        return NoiseDiffNet(dim=cfg.dim, channels=cfg.inp_dim, dtype=dtype,
                            remat=getattr(cfg, "remat", False))
    if net_name == "LSID":
        # --lsid_width: the JAX package's extension (default 32 = the reference)
        return LSID(dtype=dtype, base_width=getattr(cfg, "lsid_width", 32))
    if net_name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"{net_name} is not ported to noisediff_tpu_torch yet "
            "(see ROADMAP.md, Queue 1 item 3)"
        )
    raise ValueError(f"{net_name} is not found. Available: ['LSID', 'NoiseDiffNet']")


__all__ = ["LSID", "NoiseDiffNet", "define_network", "is_unread_parameter"]
