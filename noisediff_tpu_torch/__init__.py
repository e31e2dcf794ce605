"""noisediff_tpu_torch — the PyTorch/CUDA port of noisediff_tpu.

A second package beside the JAX one, mirroring its layout (ops/, models/,
diffusion/, data/, train/, cli/). It imports torch, numpy and the standard
library only; the JAX package stays the reference the port is tested
against. The hand-written Hopper kernels live under csrc/ and are built on
first use into build/.
"""
