"""LSID — the Learning-to-See-in-the-Dark 5-level UNet denoiser, in PyTorch.

Port of noisediff_tpu/models/lsid.py (reference `models/archs/SID_arch.py:
49-175`), the plain graph. The JAX model's TPU lowerings (the width fold,
the phase-matmul ConvTranspose, the folded pool halving and the packed
head) compute the same math and are not carried over. Under NOISEDIFF_INT8=1
the 3x3 convs of at least 16 input and output channels take the int8 route
(`blocks.Conv2d.int8`; 21 a forward at fold 1, as in the JAX model), a
decoder level's first conv on the (upsampled, skip) parts without a concat;
conv1_1 (4 in) and conv10 (4 out) stay in the compute dtype.

4 channels in and out; per encoder level two conv3x3 + LeakyReLU(0.2)
(widths w, 2w, 4w, 8w, 16w; w = 32 in the reference) and a 2x2/2 max pool
with ceil mode; per decoder level a ConvTranspose2d(k=2, s=2, no bias), the
upsampled map cropped to the skip's size and concatenated as [upsampled,
skip], and two conv3x3 + LeakyReLU; a 1x1 head to 4 channels. He fan-out
init (std = sqrt(2 / (k * k * out_channels))) and zero bias, as
SID_arch.py:96-103 and the JAX model's `_he_fanout_conv`.

The JAX model writes the activation as max(x, 0.2x), the same function as
LeakyReLU(0.2) (their gradients differ only where a pre-activation is
exactly 0). The 'SAME' 2x2/2 pool of the JAX model equals
MaxPool2d(2, 2, ceil_mode=True) at odd sizes too.

Parameters are fp32; `dtype` (bf16 under mixed precision) is the compute
dtype. Input and output are NHWC, as in the JAX package and the port's
NoiseDiffNet; inside, the maps are channels-last NCHW views. At base width
32 the model has 7,760,004 parameters under the reference's 42
state_dict keys, so a reference `.pth` loads with a strict key match.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d


def _he_fanout_(weight: torch.Tensor, k: int, out_channels: int) -> None:
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / (k * k * out_channels)))


class _Conv(Conv2d):
    """SAME conv (3x3 or 1x1) run in the input's dtype, LSID init. Its
    weight gradient takes the conv_wgrad route only where NOISEDIFF_WGRAD
    asks for it, as the JAX model's `_ConvParams` does (opt-in; cuDNN's
    wgrad by default)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k)
        _he_fanout_(self.weight, k, cout)
        nn.init.zeros_(self.bias)


class _Up(nn.ConvTranspose2d):
    """ConvTranspose2d(k=2, s=2, no bias) run in the input's dtype; weight
    (in, out, 2, 2)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=2, bias=False)
        _he_fanout_(self.weight, 2, cout)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None, 2)


class LSID(nn.Module):
    def __init__(self, inchannel: int = 4, base_width: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        w = base_width
        widths = [w, 2 * w, 4 * w, 8 * w, 16 * w]
        cin = inchannel
        for level, c in enumerate(widths, 1):  # encoder conv1_* .. conv5_*
            setattr(self, f"conv{level}_1", _Conv(cin, c, 3))
            setattr(self, f"conv{level}_2", _Conv(c, c, 3))
            cin = c
        for level, c in zip(range(6, 10), reversed(widths[:-1])):  # decoder up6..up9
            setattr(self, f"up{level}", _Up(2 * c, c))
            setattr(self, f"conv{level}_1", _Conv(2 * c, c, 3))
            setattr(self, f"conv{level}_2", _Conv(c, c, 3))
        self.conv10 = _Conv(w, inchannel, 1)

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(getattr(self, f"{name}_1")(x), 0.2)
        return F.leaky_relu(getattr(self, f"{name}_2")(x), 0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, inchannel) NHWC, any H and W; returns the same shape
        in the compute dtype."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        skips = []
        for level in range(1, 5):
            x = self._block(f"conv{level}", x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = self._block("conv5", x)
        for level in range(6, 10):
            skip = skips.pop()
            up = getattr(self, f"up{level}")(x)[:, :, : skip.shape[2], : skip.shape[3]]
            # the int8 route quantizes the two parts on their own (no concat)
            join = getattr(self, f"conv{level}_1").int8
            x = self._block(f"conv{level}", (up, skip) if join else torch.cat([up, skip], dim=1))
        return self.conv10(x).permute(0, 2, 3, 1)
