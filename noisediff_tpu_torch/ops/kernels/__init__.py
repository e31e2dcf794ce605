"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. On a CPU tensor a wrapper runs the plain version; on a CUDA tensor
it launches the kernel or raises."""
from .attn_tail import fused_attn_tail, reference_attn_tail
from .dual_head import fused_dual_head, reference_dual_head
from .groupnorm_silu import fused_groupnorm_film_silu, reference_groupnorm_film_silu

# every kernel wrapper on the generation path (each carries `.launches`)
KERNELS = (fused_attn_tail, fused_groupnorm_film_silu, fused_dual_head)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "fused_attn_tail",
    "fused_dual_head",
    "fused_groupnorm_film_silu",
    "reference_attn_tail",
    "reference_dual_head",
    "reference_groupnorm_film_silu",
    "reset_launch_counts",
]
