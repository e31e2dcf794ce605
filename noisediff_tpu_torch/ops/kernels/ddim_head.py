"""The DDIM sampler's fused tail: NoiseDiffNet's dual head and one DDIM
update in one pass, a hand-written Hopper kernel (`nd_ddim_head` in
`csrc/dual_head.cu`) and its plain PyTorch version.

    v   = fc2(gelu(fc1(shot_a + shot_b))) + conv1x1(x)          (fp32)
    x0  = clip(sqrt(a) x_t - sqrt(1 - a) v, -1, 1)
    eps = (sqrt(1 / a) x_t - x0) / sqrt(1 / a - 1)
    x'  = x0 sqrt(a_next) + c eps + sigma z

(reference ddp.py:331-354 and :404-444; the pred_v objective's clip and
rederive.) Counterpart of noisediff_tpu/ops/pallas/ddim_head.py
(`ddim_step_scalars`, `reference_ddim_head_update`,
`fused_ddim_head_update`).

The step scalars are computed on the host in fp32 (`ddim_step_scalars`)
and go to the kernel by value: no device tensor and no synchronisation per
step. The carry is fp32, as the port's samplers keep it. With sigma = 0
(the reference default eta = 0) the noise is None and the kernel reads
none: 0 z = 0 exactly.

`fused_ddim_head_update` runs the plain version for a tensor on the CPU
and the kernel for a tensor on the card; anything the kernel does not take
raises. Inference only, as in the JAX package: no backward.
`fused_ddim_head_update.launches` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .dual_head import _SIGNATURES, head_args, reference_dual_head

# the step scalars, as the kernel takes them by value (the JAX package pads
# its vector with an eighth zero for the TPU's layout; the port does not)
N_SCALARS = 7


def ddim_step_scalars(alpha, alpha_next, sigma, c) -> np.ndarray:
    """The per-step DDIM scalars as a (..., 7) fp32 array: sqrt(a),
    sqrt(1 - a), sqrt(1 / a), 1 / sqrt(1 / a - 1), sqrt(a_next), c, sigma.
    alpha = alphas_cumprod[t]; alpha_next folds the terminal step (1.0);
    sigma and c as in GaussianDiffusion.ddim_sample. Scalars or vectors."""
    one = np.float32(1.0)
    alpha = np.asarray(alpha, np.float32)
    return np.stack([
        np.sqrt(alpha),
        np.sqrt(one - alpha),
        np.sqrt(one / alpha),
        one / np.sqrt(np.maximum(one / alpha - one, np.float32(1e-20))),
        np.sqrt(np.asarray(alpha_next, np.float32)),
        np.broadcast_to(np.asarray(c, np.float32), alpha.shape),
        np.broadcast_to(np.asarray(sigma, np.float32), alpha.shape),
    ], axis=-1).astype(np.float32)


def _scalars(scal: Sequence[float]):
    s = np.asarray(scal, np.float32)
    if s.shape != (N_SCALARS,):
        raise ValueError(f"scal must be the ({N_SCALARS},) vector of ddim_step_scalars")
    return [float(v) for v in s]


def reference_ddim_head_update(x, shot_a, shot_b, xt, noise: Optional[torch.Tensor],
                               w1, b1, w2, b2, wr, br, scal) -> torch.Tensor:
    """Plain version. x, shot_a, shot_b: (B, H, W, C) trunk maps; xt and
    noise: (B, H, W, 4) carry and step noise (noise None: sigma is 0);
    head weights in PyTorch (out, in) layout as for `reference_dual_head`;
    scal from `ddim_step_scalars`. Returns the next carry in xt's dtype."""
    ac, one_m_ac, rac, iracm1, anext, c, sig = _scalars(scal)
    v = reference_dual_head(x, shot_a, shot_b, w1, b1, w2, b2, wr, br)  # fp32
    xt32 = xt.float()
    x0 = (ac * xt32 - one_m_ac * v).clamp(-1.0, 1.0)
    eps = (rac * xt32 - x0) * iracm1
    xn = x0 * anext + c * eps
    if noise is not None:
        xn = xn + sig * noise.float()
    return xn.to(xt.dtype)


def _launch(x, shot_a, shot_b, xt, noise, w1, b1, w2, b2, wr, br, scal):
    params, p = head_args(x, shot_a, shot_b, w1, b1, w2, b2, wr, br, "ddim_head")
    for t in (xt,) if noise is None else (xt, noise):
        if t.dtype != torch.float32 or t.shape != x.shape[:3] + (4,) or not t.is_contiguous():
            raise ValueError("ddim_head kernel takes a contiguous fp32 (B, H, W, 4) carry "
                             "and noise")
    dev = x.device
    out = torch.empty_like(xt)
    lib = _build.library("dual_head", _SIGNATURES)
    code = lib.nd_ddim_head(
        x.data_ptr(), shot_a.data_ptr(), shot_b.data_ptr(), *(a.data_ptr() for a in params),
        xt.data_ptr(), None if noise is None else noise.data_ptr(), out.data_ptr(),
        p, x.shape[-1], *_scalars(scal), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "ddim_head")
    fused_ddim_head_update.launches += 1
    return out


def fused_ddim_head_update(x, shot_a, shot_b, xt, noise: Optional[torch.Tensor],
                           w1, b1, w2, b2, wr, br, scal) -> torch.Tensor:
    """The heads and one DDIM update in one pass; returns the next carry.
    See `reference_ddim_head_update` for the arguments."""
    if x.device.type == "cpu":
        return reference_ddim_head_update(x, shot_a, shot_b, xt, noise, w1, b1, w2, b2, wr, br,
                                          scal)
    return _launch(x, shot_a, shot_b, xt, noise, w1, b1, w2, b2, wr, br, scal)


fused_ddim_head_update.launches = 0
