"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. On a CPU tensor a wrapper runs the plain version; on a CUDA tensor
it launches the kernel or raises. A wrapper that gradients flow through
does so as a torch.autograd.Function; none returns a tensor cut off from
autograd."""
from .attn_tail import (
    fused_attn_tail, fused_attn_tail_bwd, reference_attn_tail, reference_attn_tail_bwd)
from .dual_head import fused_dual_head, reference_dual_head
from .gn_stats import gn_grad_stats, gn_stats, reference_gn_grad_stats, reference_gn_stats
from .groupnorm_silu import fused_groupnorm_film_silu, reference_groupnorm_film_silu

# every kernel wrapper of the port (each carries `.launches`)
KERNELS = (fused_attn_tail, fused_attn_tail_bwd, fused_groupnorm_film_silu, fused_dual_head,
           gn_stats, gn_grad_stats)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    """{wrapper name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS",
    "fused_attn_tail",
    "fused_attn_tail_bwd",
    "fused_dual_head",
    "fused_groupnorm_film_silu",
    "gn_grad_stats",
    "gn_stats",
    "launch_counts",
    "reference_attn_tail",
    "reference_attn_tail_bwd",
    "reference_dual_head",
    "reference_gn_grad_stats",
    "reference_gn_stats",
    "reference_groupnorm_film_silu",
    "reset_launch_counts",
]
