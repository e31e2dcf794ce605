"""EMA of the online parameters with ema-pytorch semantics.

Port of noisediff_tpu/train/ema.py (`ema_decay`, `HostEma`). The reference
trains with ema-pytorch (models/trainer_diffusion.py:63-69): beta 0.995,
update_after_step 500, update_every 20. `update()` is called once per
optimizer step and only every 20th call does anything; while the call
index is <= 500 the EMA is a straight copy of the online parameters;
afterwards the decay ramps as 1 - (1 + epoch / inv_gamma)^(-power), epoch
= step - update_after_step - 1, clamped to [min_value, beta].

The EMA is a separate fp32 copy of the parameters, updated in place by one
`torch._foreach_lerp_` over all of them on the applying calls (the JAX
package's jitted lerp, with the same host-side every-20th gate).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

# the reference's EMA(beta=0.995, update_after_step=500, update_every=20)
# with ema-pytorch's default ramp (inv_gamma 1, power 2/3, min_value 0)
BETA = 0.995
UPDATE_AFTER_STEP = 500
UPDATE_EVERY = 20
INV_GAMMA = 1.0
POWER = 2.0 / 3.0
MIN_VALUE = 0.0


def ema_decay(step: int) -> float:
    """Decay used by an APPLYING update at 0-based call index `step`: 0
    during the copy phase (step <= UPDATE_AFTER_STEP), then the ema-pytorch
    ramp clamped to [MIN_VALUE, BETA], evaluated in float32 as the JAX
    package does."""
    f32 = np.float32
    epoch = f32(max(step - UPDATE_AFTER_STEP - 1, 0))
    if step <= UPDATE_AFTER_STEP or epoch <= 0:
        return 0.0
    ramp = f32(1.0) - (f32(1.0) + epoch / f32(INV_GAMMA)) ** f32(-POWER)
    return float(np.clip(ramp, f32(MIN_VALUE), f32(BETA)))


class HostEma:
    """The every-UPDATE_EVERY-th-call EMA over named parameters.

    `maybe_apply(online)` is called once per optimizer step, after it; the
    call index of the update is the counter before the call. `calls` is
    saved with the optimizer state (`ema_step`), so a resumed run applies
    the same updates as an uninterrupted one."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]]):
        self.names = []
        self.params = []
        for name, p in named_params:
            self.names.append(name)
            self.params.append(p.detach().float().clone())
        self.calls = 0

    @torch.no_grad()
    def maybe_apply(self, online: Iterable[torch.Tensor]) -> bool:
        """One update() call; True when it applied the lerp."""
        calls = self.calls
        self.calls = calls + 1
        if calls % UPDATE_EVERY:
            return False
        weight = float(np.float32(1.0) - np.float32(ema_decay(calls)))
        torch._foreach_lerp_(self.params, [p.detach().float() for p in online], weight)
        return True

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.params))

    @torch.no_grad()
    def load_state_dict(self, sd) -> None:
        missing = set(self.names) ^ set(sd)
        if missing:
            raise KeyError(f"EMA state keys differ: {sorted(missing)[:5]}")
        for name, p in zip(self.names, self.params):
            p.copy_(sd[name])
