"""Diffusion samplers of the port."""
from .gaussian import GaussianDiffusion

__all__ = ["GaussianDiffusion"]
