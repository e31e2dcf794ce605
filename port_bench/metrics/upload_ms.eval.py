"""Median ms a frame takes on the card's clock from its two host mosaics
to the packed input (pinning, the copies, packing with the dark shading),
from the benchmark's CUDA events around that part of each frame of the
traced run's window."""
from harness.common import quantile


def read(rec):
    ms = rec.get("upload_ms")
    return quantile(ms, 0.5) if ms else None
