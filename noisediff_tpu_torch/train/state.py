"""Optimizer and the train steps of both stages.

Port of noisediff_tpu/train/state.py (`make_optimizer`,
`set_learning_rate`, `make_diffusion_train_step`,
`make_denoising_train_step`): Adam with torch-default
betas (0.9, 0.999) and eps 1e-8. torch.optim.Adam's weight_decay adds
wd * param to the gradient before the moment updates, which is exactly the
JAX chain add_decayed_weights -> scale_by_adam. The learning rate is set
per epoch on the param groups by the host loop.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..diffusion.gaussian import GaussianDiffusion
from ..ops import sna

# --generation_result -> the batch key the diffusion learns to generate
TARGET_KEYS = {"noise": "noise", "image": "noisy_img"}


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def grad_norm(params) -> torch.Tensor:
    """Global L2 norm of the gradients (optax.global_norm)."""
    grads = [p.grad.float() for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def make_diffusion_train_step(diffusion: GaussianDiffusion, optimizer: torch.optim.Optimizer,
                              generation_result: str = "noise") -> Callable:
    """Returns step(batch, generator) -> {'diffusion_loss', 'grad_norm'}
    (device scalars): the loss on batch[target] with the condition
    (clean_img, coord, iso_ratio_idx), timesteps and noise drawn from
    `generator`, its gradients, one Adam step."""
    if generation_result not in TARGET_KEYS:
        raise ValueError(f"--generation_result must be one of {sorted(TARGET_KEYS)}")
    target_key = TARGET_KEYS[generation_result]
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        condition = {
            "clean_img": batch["clean_img"],
            "iso_ratio_idx": batch["iso_ratio_idx"],
            "position": batch["coord"],
        }
        optimizer.zero_grad(set_to_none=True)
        loss = diffusion.loss(batch[target_key], condition, generator=generator)
        loss.backward()
        norm = grad_norm(params)
        optimizer.step()
        return {"diffusion_loss": loss.detach(), "grad_norm": norm}

    return step


def make_denoising_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                              loss_l1: bool = True, loss_mse: bool = False,
                              lambda_l1: float = 1.0, lambda_mse: float = 1.0,
                              use_sna: bool = False, augment_flip: bool = True) -> Callable:
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
    and so is every gradient, as in the JAX step."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        noisy, clean = batch["noisy_img"], batch["clean_img"]
        if augment_flip:
            flip = torch.rand((), generator=generator, device=generator.device) < 0.5
            noisy = torch.where(flip, noisy.flip(1), noisy)
            clean = torch.where(flip, clean.flip(1), clean)
        if use_sna:
            aug_wb = sna.sample_aug_wb(generator, clean.shape[0])
            noisy, clean = sna.apply_sna(generator, noisy, clean, batch["iso"], batch["ratio"],
                                         aug_wb)
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
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss_sum"] = loss.detach()
        metrics["grad_norm"] = grad_norm(params)
        optimizer.step()
        return metrics

    return step
