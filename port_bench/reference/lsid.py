"""LSID (Chen et al., Learning to See in the Dark, CVPR 2018; the
reference's `models/archs/SID_arch.py`) and the evaluation of one SID frame
(the reference's `test_denoising.py` with `--correct_darkshading
--correct_illum`), in plain float32 PyTorch.

Packing follows `utils/raw_util.py` (black level 512, white point 16383,
R G1 B G2 order); PSNR and SSIM are skimage's (`peak_signal_noise_ratio`,
`structural_similarity` with a uniform 7x7 window and the unbiased
covariance); the illuminance correction is the least-squares scale over
the unsaturated pixels of the ground truth.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BLACK_LEVEL = 512.0
WHITE_POINT = 16383.0
SCALE = WHITE_POINT - BLACK_LEVEL


class LSID(nn.Module):
    def __init__(self, inchannel: int = 4, base_width: int = 32):
        super().__init__()
        w = base_width
        widths = [w, 2 * w, 4 * w, 8 * w, 16 * w]
        cin = inchannel
        for level, c in enumerate(widths, 1):
            setattr(self, f"conv{level}_1", nn.Conv2d(cin, c, 3, padding=1))
            setattr(self, f"conv{level}_2", nn.Conv2d(c, c, 3, padding=1))
            cin = c
        for level, c in zip(range(6, 10), reversed(widths[:-1])):
            setattr(self, f"up{level}", nn.ConvTranspose2d(2 * c, c, 2, stride=2, bias=False))
            setattr(self, f"conv{level}_1", nn.Conv2d(2 * c, c, 3, padding=1))
            setattr(self, f"conv{level}_2", nn.Conv2d(c, c, 3, padding=1))
        self.conv10 = nn.Conv2d(w, inchannel, 1)

    def _block(self, name, x):
        x = F.leaky_relu(getattr(self, f"{name}_1")(x), 0.2)
        return F.leaky_relu(getattr(self, f"{name}_2")(x), 0.2)

    def forward(self, x):
        """x (B, H, W, 4) NHWC -> (B, H, W, 4)."""
        x = x.permute(0, 3, 1, 2)
        skips = []
        for level in range(1, 5):
            x = self._block(f"conv{level}", x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = self._block("conv5", x)
        for level in range(6, 10):
            skip = skips.pop()
            up = getattr(self, f"up{level}")(x)[:, :, : skip.shape[2], : skip.shape[3]]
            x = self._block(f"conv{level}", torch.cat([up, skip], dim=1))
        return self.conv10(x).permute(0, 2, 3, 1)


def pack(bayer: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H/2, W/2, 4) as R, G1, B, G2."""
    return torch.stack([bayer[0::2, 0::2], bayer[0::2, 1::2], bayer[1::2, 1::2],
                        bayer[1::2, 0::2]], dim=-1)


def pack_raw(bayer_dn: torch.Tensor) -> torch.Tensor:
    return pack((bayer_dn.float() - BLACK_LEVEL).clamp(min=0.0) / SCALE)


def pack_raw_withdarkshading(bayer_dn, darkshading, ratio: float) -> torch.Tensor:
    """raw_util.py:112-139: normalise, amplify and clip as the training
    data was, back to DN, subtract the dark shading, pack, black level."""
    im = ((bayer_dn.float() - BLACK_LEVEL) / SCALE * ratio).clamp(0.0, 1.0) / ratio
    im = (im * SCALE + BLACK_LEVEL).clamp(0.0, WHITE_POINT) - darkshading
    return (pack(im) - BLACK_LEVEL).clamp(min=0.0) / SCALE


def illuminance_correct(pred: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    pred = pred.clamp(0.0, 1.0)
    mask = (src != 1.0).float()
    return (pred * src * mask).sum() / (pred * pred * mask).sum() * pred


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / torch.mean((x - y) ** 2))


def ssim(x: torch.Tensor, y: torch.Tensor, win: int = 7) -> torch.Tensor:
    """skimage structural_similarity of (H, W, C) float images in [0, 1],
    in their dtype."""
    def filt(a):
        return F.avg_pool2d(a.permute(2, 0, 1)[None], win, stride=1)[0]

    ux, uy = filt(x), filt(y)
    n = win * win
    cov = n / (n - 1)
    vx = cov * (filt(x * x) - ux * ux)
    vy = cov * (filt(y * y) - uy * uy)
    vxy = cov * (filt(x * y) - ux * uy)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean()


def evaluate_frame(model: LSID, bayer_in, bayer_gt, darkshading, ratio: float):
    """(output frame, PSNR, SSIM) of one frame, as `test_denoising.py`
    scores it with `--correct_darkshading --correct_illum`; SSIM in
    float64, so that a gap to it is the other side's rounding alone."""
    noisy = (pack_raw_withdarkshading(bayer_in, darkshading, ratio) * ratio).clamp(0.0, 1.0)
    clean = pack_raw(bayer_gt).clamp(0.0, 1.0)
    out = model(noisy[None])[0].clamp(0.0, 1.0)
    out = illuminance_correct(out, clean)
    return out, psnr(out, clean), ssim(out.double(), clean.double())
