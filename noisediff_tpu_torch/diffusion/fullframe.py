"""Full-frame noise generation: the whole packed SID frame (1424 x 2128 x 4)
in one sampling pass, on one card or split by rows over several.

Port of noisediff_tpu/diffusion/fullframe.py. The reference generates
fixed square crops and tiles them with an overlapping grid
(dataset.py:203-219); the JAX package generates the whole frame with its
height sharded over the device mesh. The condition is the packed clean
frame, the frame's rescaled coordinate grid and the ISO / ratio index, as
in the JAX function.

Under a process group of world > 1 (`parallel.mesh.setup`, one process
per card, as `torchrun --nproc_per_node N` starts them) the frame's height
is split over the ranks (`mesh.SpatialShard`, the JAX spatial mesh axis):
each rank builds the whole condition and keeps its rows, x_T and every
step's noise are drawn for the whole frame from a generator seeded alike
on every rank and sliced, and the model runs under `mesh.activate` (halo
rows for every conv wider than 1x1, GroupNorm statistics all-reduced).
The samplers are per pixel after the model call. Rank 0 gathers the rows.
Any model of the port runs so: NoiseDiffNet and the UNet_PosEmbV2 family
are built from the same blocks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.coords import make_coord
from ..parallel import mesh
from .gaussian import GaussianDiffusion


def generate_full_frame(gd: GaussianDiffusion, clean_img: np.ndarray, iso_ratio_idx: int,
                        sampler: str = "dpm", sampling_timesteps: Optional[int] = None,
                        dpm_spacing: str = "lambda",
                        generator: Optional[torch.Generator] = None,
                        init_noise: Optional[torch.Tensor] = None) -> Optional[np.ndarray]:
    """A full-frame noise map conditioned on a packed clean frame.

    clean_img: (H, W, 4) host array, H and W divisible by the UNet's
    downsample factor (8). `sampler` is 'dpm' (DPM-Solver++(2M) on
    `dpm_spacing`), 'ddim' (the fused DDIM tail where the model has a
    trunk and the objective is pred_v, as the generation CLI runs it) or
    anything else for ancestral DDPM. x_T is `init_noise` (the whole
    frame's, (1, H, W, 4)) where given, else drawn from `generator` on the
    diffusion's device. Returns (H, W, 4) float32 numpy noise; split over a
    process group of world > 1, on rank 0 only, and None on the other
    ranks, which then need a generator seeded alike on every rank for any
    draw."""
    h, w, c = clean_img.shape
    dev = gd.device
    shard = mesh.spatial_shard(h)
    draws = init_noise is None or sampler not in ("dpm", "ddim") or (
        sampler == "ddim" and float(gd.ddim_sampling_eta) != 0.0)
    if shard is not None and generator is None and draws:
        raise ValueError("a frame split over several ranks draws its noise from a generator "
                         "seeded alike on every rank: pass one")

    def rows(t, dim=1):  # this rank's rows of a whole-frame map
        return t if shard is None else shard.rows(t, dim)

    def upload(a):  # a whole-frame (H, W, C) host map: this rank's rows, (1, rows, W, C)
        return torch.as_tensor(rows(np.asarray(a, np.float32), 0), device=dev)[None]

    condition = {
        "clean_img": upload(clean_img),
        "position": upload(make_coord(h, w, rescale=True)),
        "iso_ratio_idx": torch.tensor([int(iso_ratio_idx)], device=dev),
    }
    if init_noise is not None:
        init_noise = rows(init_noise)
    shape = (1, condition["clean_img"].shape[1], w, c)
    with mesh.activate(shard):
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
    if shard is not None:
        out = mesh.gather_rows(out, shard)
        if out is None:
            return None
    return out[0].float().cpu().numpy()
