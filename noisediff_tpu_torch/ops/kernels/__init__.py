"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. On a CPU tensor a wrapper runs the plain version; on a CUDA tensor
it launches the kernel or raises. A wrapper that gradients flow through
does so as a torch.autograd.Function; none returns a tensor cut off from
autograd."""
from .attn_tail import (
    fused_attn_tail, fused_attn_tail_bwd, reference_attn_tail, reference_attn_tail_bwd)
from .conv_wgrad import conv_wgrad, reference_conv_wgrad
from .ddim_head import ddim_step_scalars, fused_ddim_head_update, reference_ddim_head_update
from .dual_head import fused_dual_head, reference_dual_head
from .flash_attention import flash_attention, reference_flash_attention
from .gn_stats import gn_grad_stats, gn_stats, reference_gn_grad_stats, reference_gn_stats
from .groupnorm_silu import (
    fused_groupnorm_film_silu, groupnorm_silu_apply, reference_groupnorm_film_silu,
    reference_groupnorm_silu_apply)
from .int8_conv import absmax, int8_conv, int8_conv_small, reference_absmax, reference_int8_conv

# every kernel wrapper of the port (each carries `.launches`)
KERNELS = (fused_attn_tail, fused_attn_tail_bwd, fused_groupnorm_film_silu, fused_dual_head,
           fused_ddim_head_update, gn_stats, gn_grad_stats, conv_wgrad, flash_attention,
           groupnorm_silu_apply, int8_conv, int8_conv_small, absmax)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    """{wrapper name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "absmax",
    "conv_wgrad",
    "ddim_step_scalars",
    "flash_attention",
    "fused_attn_tail",
    "fused_attn_tail_bwd",
    "fused_ddim_head_update",
    "fused_dual_head",
    "fused_groupnorm_film_silu",
    "gn_grad_stats",
    "gn_stats",
    "groupnorm_silu_apply",
    "int8_conv",
    "int8_conv_small",
    "launch_counts",
    "reference_absmax",
    "reference_attn_tail",
    "reference_attn_tail_bwd",
    "reference_conv_wgrad",
    "reference_ddim_head_update",
    "reference_dual_head",
    "reference_flash_attention",
    "reference_gn_grad_stats",
    "reference_gn_stats",
    "reference_groupnorm_film_silu",
    "reference_groupnorm_silu_apply",
    "reference_int8_conv",
    "reset_launch_counts",
]
