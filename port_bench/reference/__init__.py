"""Plain PyTorch / NumPy references that decide each cell's `correct`.

Written from the published models (NoiseDiff's `Diffusion_arch.py`, SID's
`SID_arch.py`, the reference's `denoising_diffusion_pytorch.py` and
`test_denoising.py`) in float32, with no hand-written kernel, cache or
fusion. Nothing here imports `jax`, `noisediff_tpu` or
`noisediff_tpu_torch`: the references share only parameter names with the
port, so that one seeded state_dict loads into both.
"""
