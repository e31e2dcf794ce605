"""Optimizer and the train steps of both stages.

Port of noisediff_tpu/train/state.py (`make_optimizer`,
`set_learning_rate`, `make_diffusion_train_step`,
`make_denoising_train_step`): Adam with torch-default
betas (0.9, 0.999) and eps 1e-8. torch.optim.Adam's weight_decay adds
wd * param to the gradient before the moment updates, which is exactly the
JAX chain add_decayed_weights -> scale_by_adam. The learning rate is set
per epoch on the param groups by the host loop.

Multi-process training: the steps run on the DDP-wrapped model
(parallel.wrap), whose backward all-reduces the gradients (their mean over
the ranks). Each rank holds its rows of the global batch (`shard`), and
the steps make every random draw for the global batch, from a generator
seeded alike on every rank, and keep this rank's rows, as the JAX step
draws with one key for the whole batch: a step on `world` ranks is the
one-process step on the concatenated batch. The logged losses are their
means over the ranks, as the JAX step's loss is the global batch's;
`grad_norm` is read after the all-reduce, so it is the same on every rank.

On a grid (`parallel.mesh.make_mesh`, the JAX data x spatial x model
mesh) the diffusion step takes this rank's rows of the batch and of the
frame (`Grid.local`), draws t for the global batch and the noise for the
global batch and the whole frame and keeps its rows of both, and runs the
model under the spatial shard. DDP wraps the model over the replica group
(data x spatial); the model axis's parameter blocks are already in the
model (`mesh.shard_parameters`). DDP averages over data x spatial, where the
spatial ranks' shares must add: each spatial rank's loss is the whole
frame's (its rows' sums all-reduced in `p_losses`), and the all-reduce's
backward hands every rank's rows the spatial size times their gradient,
which DDP's mean takes back, so the gradients are the one-process
gradients of the global batch's loss. The whole parameters' gradients are
then averaged over the model line, so the model ranks' copies of them stay
bit-equal (`mesh.average_replicated_grads`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..diffusion.gaussian import GaussianDiffusion
from ..ops import sna
from ..parallel import mesh
from ..parallel.mesh import SINGLE, Grid, Shard, all_reduce_mean

# --generation_result -> the batch key the diffusion learns to generate
TARGET_KEYS = {"noise": "noise", "image": "noisy_img"}


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def grad_norm(params) -> torch.Tensor:
    """Global L2 norm of the gradients (optax.global_norm): a parameter
    the model axis split (`mesh.model_shard_of`) adds the squares of every
    rank's block, summed over its model line; the others count once."""
    whole = [p.grad.float() for p in params if p.grad is not None
             and mesh.model_shard_of(p) is None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(whole)))
    split = [p for p in params if p.grad is not None and mesh.model_shard_of(p) is not None]
    if not split:
        return norm
    sq = torch.stack(torch._foreach_norm([p.grad.float() for p in split])).square().sum()
    sq = mesh.all_reduce_sum(sq, mesh.model_shard_of(split[0]).group, mesh.TP_REDUCE_SPAN)
    return torch.sqrt(norm.square() + sq)


def make_diffusion_train_step(diffusion: GaussianDiffusion, optimizer: torch.optim.Optimizer,
                              generation_result: str = "noise",
                              shard: Shard = SINGLE, grid: Optional[Grid] = None) -> Callable:
    """Returns step(batch, generator, draws=None) -> {'diffusion_loss',
    'grad_norm'} (device scalars): the loss on batch[target] with the
    condition (clean_img, coord, iso_ratio_idx), its gradients, one Adam
    step. The timesteps and the noise are drawn for the global batch (and
    the whole frame) from `generator`, t first, or given as `draws`, the
    global batch's (t, noise) (a caller holding another framework's
    draws); this rank keeps its rows. `diffusion`'s model is the
    DDP-wrapped one where `shard` has more than one rank. On a `grid` (its
    data axis replaces `shard`) the batch is this rank's part
    (`Grid.local`) and the frame's height is the diffusion's image_size."""
    if generation_result not in TARGET_KEYS:
        raise ValueError(f"--generation_result must be one of {sorted(TARGET_KEYS)}")
    if grid is not None and shard is not SINGLE:
        raise ValueError("a grid's data axis is the shard: pass one of them")
    target_key = TARGET_KEYS[generation_result]
    params = [p for g in optimizer.param_groups for p in g["params"]]
    spatial = None
    if grid is not None:
        shard, spatial = grid.data, grid.spatial(diffusion.image_size)

    def rows(x):  # this rank's rows of a global draw: batch, then frame
        x = shard.rows(x)
        return x if spatial is None or x.ndim < 4 else spatial.rows(x)

    def step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
             draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        img = batch[target_key]
        if draws is None:
            n = shard.world * img.shape[0]
            h = img.shape[1] if spatial is None else spatial.height
            t = torch.randint(0, diffusion.num_timesteps, (n,), generator=generator,
                              device=img.device)
            noise = torch.randn((n, h) + tuple(img.shape[2:]), generator=generator,
                                device=img.device)
        else:
            t, noise = (d.to(img.device) for d in draws)
        condition = {
            "clean_img": batch["clean_img"],
            "iso_ratio_idx": batch["iso_ratio_idx"],
            "position": batch["coord"],
        }
        optimizer.zero_grad(set_to_none=True)
        with mesh.activate(spatial):
            loss = diffusion.loss(img, condition, t=rows(t), noise=rows(noise))
        loss.backward()
        mesh.average_replicated_grads(params, None if grid is None else grid.model)
        norm = grad_norm(params)
        optimizer.step()
        return {"diffusion_loss": all_reduce_mean(loss.detach(), shard), "grad_norm": norm}

    return step


def make_denoising_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                              loss_l1: bool = True, loss_mse: bool = False,
                              lambda_l1: float = 1.0, lambda_mse: float = 1.0,
                              use_sna: bool = False, augment_flip: bool = True,
                              shard: Shard = SINGLE) -> Callable:
    """Returns step(batch, generator) -> {'mse_loss' and / or 'l1_loss',
    'loss_sum', 'grad_norm'} (device scalars) for the denoiser: batch
    'noisy_img' and 'clean_img' (B, H, W, 4), 'iso' and 'ratio' (B,).

    From `generator` (on the batch's device), in order: one flip of the
    whole batch along HEIGHT with probability 1/2 (the reference flips
    NCHW dim 2, trainer_denoising.py:105-111), then with use_sna the
    white-balance gains and Shot-Noise Augmentation (:207-217). Then the
    model's output in fp32 against the clean image: the mean L1 times
    lambda_l1 and / or the mean squared error times lambda_mse (:225-235),
    their gradients and one Adam step. With neither loss on, the loss is 0
    and so is every gradient, as in the JAX step. `model` is the
    DDP-wrapped one where `shard` has more than one rank; the batch is this
    rank's rows: the flip is one draw for the whole global batch, the
    gains and Kmax jitter are drawn for it and sliced, and the Poisson
    draws follow each sample's index in it."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        noisy, clean = batch["noisy_img"], batch["clean_img"]
        if augment_flip:
            flip = torch.rand((), generator=generator, device=generator.device) < 0.5
            noisy = torch.where(flip, noisy.flip(1), noisy)
            clean = torch.where(flip, clean.flip(1), clean)
        if use_sna:
            b = clean.shape[0]
            aug_wb = shard.rows(sna.sample_aug_wb(generator, shard.world * b))
            jitter = shard.rows(sna.draw_jitter(generator, shard.world * b))
            noisy, clean = sna.apply_sna(generator, noisy, clean, batch["iso"], batch["ratio"],
                                         aug_wb, jitter, first=shard.rank * b)
        optimizer.zero_grad(set_to_none=True)
        out = model(noisy).float()
        metrics = {}
        if loss_mse:
            metrics["mse_loss"] = torch.mean((out - clean) ** 2) * lambda_mse
        if loss_l1:
            metrics["l1_loss"] = torch.mean((out - clean).abs()) * lambda_l1
        terms = list(metrics.values())
        loss = sum(terms[1:], terms[0]) if terms else 0.0 * out.sum()
        loss.backward()
        metrics["loss_sum"] = loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        if shard.world > 1:  # one all-reduce for every logged loss
            means = all_reduce_mean(torch.stack(list(metrics.values())), shard)
            metrics = dict(zip(metrics, means.unbind()))
        metrics["grad_norm"] = grad_norm(params)
        optimizer.step()
        return metrics

    return step
