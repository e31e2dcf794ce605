"""The 95th percentile over every frame of the window of its time from the
host mosaics to its PSNR and SSIM on the host, in ms."""
from harness.common import quantile


def read(rec):
    return 1e3 * quantile(rec["unit_seconds"], 0.95)
