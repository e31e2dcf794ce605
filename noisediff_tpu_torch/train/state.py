"""Optimizer and diffusion train step.

Port of noisediff_tpu/train/state.py (`make_optimizer`,
`set_learning_rate`, `make_diffusion_train_step`): Adam with torch-default
betas (0.9, 0.999) and eps 1e-8. torch.optim.Adam's weight_decay adds
wd * param to the gradient before the moment updates, which is exactly the
JAX chain add_decayed_weights -> scale_by_adam. The learning rate is set
per epoch on the param groups by the host loop.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..diffusion.gaussian import GaussianDiffusion

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
