"""Full-frame noise generation: the whole packed SID frame (1424 x 2128 x 4)
in one sampling pass on one card.

Port of noisediff_tpu/diffusion/fullframe.py. The reference generates
fixed square crops and tiles them with an overlapping grid
(dataset.py:203-219); the JAX package generates the whole frame with its
height sharded over the device mesh. On one card the whole frame is one
pass: the condition is the packed clean frame, the frame's rescaled
coordinate grid and the ISO / ratio index, as in the JAX function.
Sharding the frame over several cards (the JAX spatial mesh axis) is
model parallelism, not the data parallelism of parallel/mesh.py, and is
not ported yet (ROADMAP.md, Queue 1 item 2).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.coords import make_coord
from .gaussian import GaussianDiffusion


def generate_full_frame(gd: GaussianDiffusion, clean_img: np.ndarray, iso_ratio_idx: int,
                        sampler: str = "dpm", sampling_timesteps: Optional[int] = None,
                        dpm_spacing: str = "lambda",
                        generator: Optional[torch.Generator] = None,
                        init_noise: Optional[torch.Tensor] = None) -> np.ndarray:
    """A full-frame noise map conditioned on a packed clean frame.

    clean_img: (H, W, 4) host array, H and W divisible by the UNet's
    downsample factor (8). `sampler` is 'dpm' (DPM-Solver++(2M) on
    `dpm_spacing`), 'ddim' (the fused DDIM tail where the model has a
    trunk and the objective is pred_v, as the generation CLI runs it) or
    anything else for ancestral DDPM. x_T is `init_noise` where given, else
    drawn from `generator` on the diffusion's device. Returns (H, W, 4)
    float32 numpy noise."""
    h, w, c = clean_img.shape
    dev = gd.device
    condition = {
        "clean_img": torch.as_tensor(np.asarray(clean_img, np.float32), device=dev)[None],
        "position": torch.as_tensor(make_coord(h, w, rescale=True), device=dev)[None],
        "iso_ratio_idx": torch.tensor([int(iso_ratio_idx)], device=dev),
    }
    shape = (1, h, w, c)
    if sampler == "dpm":
        out = gd.dpm_solver_sample(shape, condition, sampling_timesteps=sampling_timesteps,
                                   init_noise=init_noise, step_spacing=dpm_spacing,
                                   generator=generator)
    elif sampler == "ddim":
        out = gd.ddim_sample(shape, condition, sampling_timesteps=sampling_timesteps,
                             generator=generator, init_noise=init_noise,
                             trunk_fn=gd.fused_tail_trunk())
    else:
        out = gd.p_sample_loop(shape, condition, generator=generator, init_noise=init_noise)
    return out[0].float().cpu().numpy()
