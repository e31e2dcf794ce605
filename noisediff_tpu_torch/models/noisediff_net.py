"""NoiseDiffNet — the shipped conditional diffusion UNet, in PyTorch.

Port of noisediff_tpu/models/noisediff_net.py (reference
`models/archs/Diffusion_arch.py:447-646`), the unfolded graph. The TPU
lowerings of the JAX model (width fold, packed heads) compute the same
math and are not carried over. The w8a8 int8 route (NOISEDIFF_INT8=1) does
not compute the same math and is carried over (`blocks.Conv2d.int8`): it
quantizes the convs of at least 16 input and output channels that the JAX
model's corresponding route quantizes (the unfolded one; on the fused
routes the heads and the attention tail stay in the compute dtype inside
their kernels, as in the JAX package's fused routes). The output head is
the dual_head kernel. Each block, and the head, runs its kernel or its
plain version as `blocks.runs_kernel` decides once from the compute dtype
and its channel width: a bf16 model runs the kernels (at dim 48 every
one), an fp32 model (`dtype=None`) none.

4-stage UNet (dim_mults 1, 2, 4, 8): 7x7 init conv; per down stage two
time-FiLM ResnetBlocks, an ISO cross-attention AttnBlock and a
space-to-depth Downsample (a 3x3 conv at the last stage); two mid blocks;
the mirrored up path with skip concats; positional FiLM blocks at entry and
exit; a pixelwise shot-noise branch; out = shot_noise + read_noise.

`trunk` returns the three maps the heads read and `head_weights` the head
parameters: the counterpart of the JAX model's `trunk_only` clone
(noisediff_net.py:71, :310-318), which feeds the DDIM sampler's fused tail
(ops/kernels/ddim_head.py). `forward` is `trunk` and the dual head, so both
read one parameter tree.

At dim=48 the model has 21,268,088 parameters under the reference's 416
state_dict keys.

`remat=True` recomputes every ResnetBlock in the backward instead of
keeping its activations (`torch.utils.checkpoint`, non-reentrant): the JAX
model's `nn.remat(ResnetBlock)` (noisediff_net.py:135), over the same
blocks (shot_time, both blocks of each down and up stage, the mid blocks,
final_res_block); the positional ResnetBlock2s are kept, as in JAX. It
trades the blocks' forward compute for device memory in training and
changes nothing where autograd is off.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import fused_dual_head, reference_dual_head
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
    runs_kernel,
    to_nchw,
    to_nhwc,
    weight_matrix,
    whole_weight,
)


# AttnBlock parameters the one-token cross attention never reads: the query
# path (norm1, to_q) and the keys (to_k). They exist for the checkpoint;
# their gradient is zero in the JAX package and None here.
_UNREAD = (".norm1.", ".attn.to_q.", ".attn.to_k.")


def is_unread_parameter(name: str) -> bool:
    """Whether the forward never reads parameter `name`: an AttnBlock's
    query and key path, in NoiseDiffNet and UNet_PosEmbV2_CameraCond."""
    return any(part in "." + name for part in _UNREAD)


class NoiseDiffNet(nn.Module):
    def __init__(self, dim: int = 48, channels: int = 4, dim_mults=(1, 2, 4, 8),
                 resnet_block_groups: int = 8, iso_dim: int = 16, iso_vocab: int = 100,
                 pos_dim: int = 8, attn_heads: int = 4, attn_dim_head: int = 32,
                 dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        self.dim = dim
        self.channels = channels
        self.dtype = dtype
        self.remat = remat
        self.downsample_factor = 2 ** (len(dim_mults) - 1)
        time_dim = dim * 4
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        g = resnet_block_groups
        # the dual head (and the DDIM sampler's fused tail) runs its kernel
        self.head_kernel = runs_kernel("heads", dtype, dim)

        def attn(c):
            return AttnBlock(c, iso_dim, attn_heads, attn_dim_head, dtype)

        def resnet(d_in, d_out, groups=g):
            return ResnetBlock(d_in, d_out, time_dim, groups, dtype)

        self.init_conv = Conv2d(channels, dim, 7)
        self.iso_embed = nn.Embedding(iso_vocab, iso_dim)
        self.time_mlp = TimeMlp(dim, time_dim)

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

        self.pos_enc = LearnedSinusoidalPosEmb(2, pos_dim)
        self.pos_mlp = Mlp(pos_dim * 3, pos_dim * 2, pos_dim)
        self.pos_block1 = ResnetBlock2(dim, dim, pos_dim, 2, dtype)
        self.pos_block2 = ResnetBlock2(dim, dim, pos_dim, 2, dtype)

        self.shot_mlp1 = Mlp(channels * 2, dim, dim)
        self.shot_attn = attn(dim)
        self.shot_mlp2 = Mlp(dim, dim, dim)
        self.shot_time = resnet(dim, dim, groups=2)
        self.shot_mlp3 = Mlp(dim, dim, channels)

    def _res(self, block: ResnetBlock, x, t: torch.Tensor) -> torch.Tensor:
        """A ResnetBlock call, recomputed in the backward under remat."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, t, use_reentrant=False)
        return block(x, t)

    def trunk(self, x: torch.Tensor, time: torch.Tensor,
              condition: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor,
                                                            torch.Tensor]:
        """The pre-head maps (h, shot, shot_res), each (B, H, W, dim) NHWC
        in the model dtype. x: (B, H, W, 4) noisy sample, NHWC as in the JAX
        package; time: (B,) int timesteps; condition: 'clean_img' (B, H, W,
        4), 'position' (B, H, W, 2), 'iso_ratio_idx' (B,)."""
        f = self.downsample_factor
        if x.shape[1] % f or x.shape[2] % f:
            raise ValueError(f"input spatial dims {tuple(x.shape[1:3])} must be divisible by {f}")
        dt = self.dtype or x.dtype

        def nchw(t):  # NHWC tensor -> channels-last NCHW view in the model dtype
            return t.to(dt).contiguous().permute(0, 3, 1, 2)

        xin = nchw(x)
        clean = nchw(condition["clean_img"])
        position = nchw(condition["position"])
        context = self.iso_embed(condition["iso_ratio_idx"].long()).to(dt)[:, None, :]

        pos_emb = self.pos_mlp(self.pos_enc(position))
        t = self.time_mlp(time, dt)

        # shot-noise branch: pixelwise, conditioned on the clean image
        shot = self.shot_mlp1(torch.cat([clean, xin], dim=1))
        shot_res = shot
        shot = self.shot_attn(shot, context)
        shot = self.shot_mlp2(shot)
        shot = self._res(self.shot_time, shot, t)

        # UNet trunk (read-noise branch)
        h = self.init_conv(xin)
        r = h
        h = self.pos_block1(h, pos_emb)
        skips = []
        for block1, block2, attn, down in self.downs:
            h = self._res(block1, h, t)
            skips.append(h)
            h = self._res(block2, h, t)
            skips.append(h)
            h = attn(h, context)
            h = down(h)
        h = self._res(self.mid_block1, h, t)
        h = self._res(self.mid_block2, h, t)
        for block1, block2, attn, up in self.ups:
            h = self._res(block1, (h, skips.pop()), t)
            h = self._res(block2, (h, skips.pop()), t)
            h = attn(h, context)
            h = up(h)
        h = self.pos_block2(h, pos_emb)
        h = self._res(self.final_res_block, (h, r), t)
        return to_nhwc(h), to_nhwc(shot), to_nhwc(shot_res)

    def head_weights(self) -> Tuple[torch.Tensor, ...]:
        """(w1, b1, w2, b2, wr, br): shot_mlp3's fc1 and fc2 and final_conv
        in PyTorch (out, in) layout, the dual head's parameters (whole,
        where the model axis split them)."""
        fc1, fc2 = self.shot_mlp3.fc1, self.shot_mlp3.fc2
        return (weight_matrix(whole_weight(fc1)), fc1.bias, weight_matrix(whole_weight(fc2)),
                fc2.bias, weight_matrix(whole_weight(self.final_conv)), self.final_conv.bias)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                condition: Dict[str, torch.Tensor]) -> torch.Tensor:
        """`trunk`'s arguments; returns (B, H, W, 4) in the model dtype."""
        maps = self.trunk(x, time, condition)
        if not self.head_kernel and self.shot_mlp3.fc1.int8:
            # the JAX model's unfused heads, whose shot_mlp3.fc1 is quantized:
            # shot_mlp3(shot + shot_res) + final_conv(h) in the model dtype
            h, shot, shot_res = (to_nchw(m) for m in maps)
            return to_nhwc(self.shot_mlp3(shot + shot_res) + self.final_conv(h))
        head = fused_dual_head if self.head_kernel else reference_dual_head
        out = head(*maps, *self.head_weights())
        # the head sums in fp32; the model's output dtype is its compute
        # dtype, as in the JAX model (noisediff_net.py:350-354)
        return out.to(self.dtype or x.dtype)
