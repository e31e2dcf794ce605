"""The UNet_PosEmbV2 family of alternate diffusion UNets, in PyTorch.

Port of noisediff_tpu/models/others.py (reference
`models/archs/others_arch.py`), the unfolded graph:

  UNet_PosEmbV2            :364-535  clean-image encoder branch + spatial
                                     positional FiLM; no ISO attention
  UNet_PosEmbV2_NoPosition :540-706  the positional blocks become plain
                                     ResnetBlocks; the condition may be the
                                     bare clean image
  UNet_PosEmbV2_CameraCond :796-985  UNet_PosEmbV2 + an ISO cross-attention
                                     AttnBlock per stage

One trunk, `PosEmbUNet`, with `use_position` and `use_iso_attn`, built from
NoiseDiffNet's blocks; each block runs its kernel or its plain version as
`blocks.runs_kernel` decides from the compute dtype and its width. The TPU
layout tricks of the JAX module (the width fold and the packed
`final_conv` head) compute the same math and are not carried over.

Torch keys are the JAX paths through `weights.torch_key`. A stage without
attention keeps a parameterless `nn.Identity` at slot `.2`, so its
down / up conv sits at `.3` as the bridge places it. At dim 48 the three
nets have 19,702,596 / 19,700,308 / 21,262,164 parameters.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from .blocks import (
    AttnBlock,
    Conv2d,
    Downsample,
    LearnedSinusoidalPosEmb,
    Mlp,
    ResnetBlock,
    ResnetBlock2,
    TimeMlp,
    Upsample,
    to_nhwc,
)

Condition = Union[torch.Tensor, Dict[str, torch.Tensor]]


class PosEmbUNet(nn.Module):
    """The shared trunk of the UNet_PosEmbV2 variants."""

    def __init__(self, dim: int = 48, channels: int = 4, cond_dim: int = 4,
                 dim_mults=(1, 2, 4, 8), resnet_block_groups: int = 8, pos_dim: int = 8,
                 iso_dim: int = 16, iso_vocab: int = 100, use_position: bool = True,
                 use_iso_attn: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim = dim
        self.channels = channels
        self.dtype = dtype
        self.use_position = use_position
        self.use_iso_attn = use_iso_attn
        self.downsample_factor = 2 ** (len(dim_mults) - 1)
        time_dim = dim * 4
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        g = resnet_block_groups

        def attn(c):
            return AttnBlock(c, iso_dim, 4, 32, dtype) if use_iso_attn else nn.Identity()

        def resnet(d_in, d_out):
            return ResnetBlock(d_in, d_out, time_dim, g, dtype)

        if use_position:
            self.pos_enc = LearnedSinusoidalPosEmb(2, pos_dim)
            self.pos_mlp = Mlp(pos_dim * 3, pos_dim * 2, pos_dim)
            self.pos_block1 = ResnetBlock2(dim, dim, pos_dim, 2, dtype)
            self.pos_block2 = ResnetBlock2(dim, dim, pos_dim, 2, dtype)
        else:  # others_arch.py:644-646: plain ResnetBlocks, groups 2
            self.pos_block1 = ResnetBlock(dim, dim, None, 2, dtype)
            self.pos_block2 = ResnetBlock(dim, dim, None, 2, dtype)
        if use_iso_attn:
            self.iso_embed = nn.Embedding(iso_vocab, iso_dim)

        # the clean-image encoder (others_arch.py:476-479, 493-500)
        self.cond_init_conv = Conv2d(cond_dim, dim, 7)
        self.cond_res_block1 = ResnetBlock(dim, dim, None, g, dtype)
        self.time_mlp = TimeMlp(dim, time_dim)
        self.init_conv = Conv2d(channels, dim, 7)
        self.cond_concat_conv = Conv2d(dim * 2, dim, 3)

        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                resnet(d_in, d_in),
                resnet(d_in, d_in),
                attn(d_in),
                Conv2d(d_in, d_out, 3) if last else Downsample(d_in, d_out),
            ]))
        mid = dims[-1]
        self.mid_block1 = resnet(mid, mid)
        self.mid_block2 = resnet(mid, mid)
        self.ups = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(reversed(in_out)):
            last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                resnet(d_out + d_in, d_out),
                resnet(d_out + d_in, d_out),
                attn(d_out),
                Conv2d(d_out, d_in, 3) if last else Upsample(d_out, d_in),
            ]))
        self.final_res_block = resnet(dim * 2, dim)
        self.final_conv = Conv2d(dim, channels, 1)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                condition: Condition) -> torch.Tensor:
        """x: (B, H, W, 4) noisy sample, NHWC as in the JAX package; time:
        (B,) int timesteps; condition: a dict with 'clean_img' (B, H, W, 4),
        'position' (B, H, W, 2) and 'iso_ratio_idx' (B,) (each read only
        where the variant uses it), or for UNet_PosEmbV2_NoPosition the bare
        clean image (others_arch.py:661). Returns (B, H, W, 4) in the model
        dtype. The inputs are cast to the compute dtype on entry, where the
        JAX module's first convs cast them. Under a spatial shard
        (`parallel.mesh.activate`) x and the condition are this rank's rows
        of the frame, and the blocks exchange what they need, forward and
        backward, as in NoiseDiffNet."""
        f = self.downsample_factor
        if x.shape[1] % f or x.shape[2] % f:
            raise ValueError(f"input spatial dims {tuple(x.shape[1:3])} must be divisible by {f}")
        dt = self.dtype or x.dtype

        def nchw(t):  # NHWC tensor -> channels-last NCHW view in the model dtype
            return t.to(dt).contiguous().permute(0, 3, 1, 2)

        if isinstance(condition, dict):
            clean = condition["clean_img"]
            position = condition.get("position")
            iso_ratio_idx = condition.get("iso_ratio_idx")
        else:
            clean, position, iso_ratio_idx = condition, None, None

        pos_emb = context = None
        if self.use_position:
            pos_emb = self.pos_mlp(self.pos_enc(nchw(position)))
        if self.use_iso_attn:
            context = self.iso_embed(iso_ratio_idx.long()).to(dt)[:, None, :]

        clean_emb = self.cond_res_block1(self.cond_init_conv(nchw(clean)))
        t = self.time_mlp(time, dt)

        h = self.init_conv(nchw(x))
        r = h
        h = self.cond_concat_conv((h, clean_emb))  # parts on the int8 route, else a concat
        h = self.pos_block1(h, pos_emb)
        skips = []
        for block1, block2, attn, down in self.downs:
            h = block1(h, t)
            skips.append(h)
            h = block2(h, t)
            skips.append(h)
            if self.use_iso_attn:
                h = attn(h, context)
            h = down(h)
        h = self.mid_block1(h, t)
        h = self.mid_block2(h, t)
        for block1, block2, attn, up in self.ups:
            h = block1((h, skips.pop()), t)
            h = block2((h, skips.pop()), t)
            if self.use_iso_attn:
                h = attn(h, context)
            h = up(h)
        h = self.pos_block2(h, pos_emb)
        h = self.final_res_block((h, r), t)
        return to_nhwc(self.final_conv(h))


def UNet_PosEmbV2(dim=48, channels=4, cond_dim=4, dtype=None, **kw):
    return PosEmbUNet(dim=dim, channels=channels, cond_dim=cond_dim, use_position=True,
                      use_iso_attn=False, dtype=dtype, **kw)


def UNet_PosEmbV2_NoPosition(dim=48, channels=4, cond_dim=4, dtype=None, **kw):
    return PosEmbUNet(dim=dim, channels=channels, cond_dim=cond_dim, use_position=False,
                      use_iso_attn=False, dtype=dtype, **kw)


def UNet_PosEmbV2_CameraCond(dim=48, channels=4, cond_dim=4, dtype=None, **kw):
    return PosEmbUNet(dim=dim, channels=channels, cond_dim=cond_dim, use_position=True,
                      use_iso_attn=True, dtype=dtype, **kw)
