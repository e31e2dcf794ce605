"""Numerics of the port: schedules, coordinate grids and the kernels."""
