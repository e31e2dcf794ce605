"""NoiseDiffNet in plain float32 PyTorch (Dark Noise Diffusion, ICCP 2025;
the reference's `models/archs/Diffusion_arch.py:447-646`).

The same state_dict keys as the reference (and so as the port), NCHW maps,
every operation the textbook one: GroupNorm, LayerNorm, exact (erf) GELU,
one-token cross attention written as softmax over one key (identically 1),
the Downsample's space-to-depth + 1x1 conv, nearest Upsample + 3x3 conv.
Inputs and output are NHWC, as the port takes them.

`quant="fp8"` makes it the training cells' control, one precision below
bf16: every conv of at least 16 input and output channels rounds its
weight (scaled per output channel) and its input (scaled per tensor) to
fp8 e4m3, the absolute maximum scaled to 448, and passes the gradient
straight through.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


def fake_fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded to fp8 e4m3 after scaling its absolute maximum over `dims`
    to 448, the format's largest value; the gradient passes straight."""
    scale = x.detach().abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Conv(nn.Conv2d):
    """SAME conv (odd kernels), fake-quantized under `quant`."""

    quant: Optional[str] = None

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__(cin, cout, k, padding=k // 2, bias=bias)

    def forward(self, x):
        w = self.weight
        if self.quant == "fp8" and min(w.shape[:2]) >= 16:
            x = fake_fp8(x, (0, 1, 2, 3))
            w = fake_fp8(w, (1, 2, 3))
        return F.conv2d(x, w, self.bias, 1, self.padding)


class TimeMlp(nn.Sequential):
    def __init__(self, dim: int, time_dim: int):
        super().__init__(nn.Identity(), nn.Linear(dim, time_dim), nn.GELU(),
                         nn.Linear(time_dim, time_dim))
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                          * -(math.log(10000.0) / (half - 1)))
        emb = t.float()[:, None] * freqs[None, :]
        return super().forward(torch.cat([emb.sin(), emb.cos()], dim=-1))


class Mlp(nn.Module):
    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.fc1 = Conv(cin, hidden, 1)
        self.fc2 = Conv(hidden, cout, 1)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.proj = Conv(cin, cout, 3)
        self.norm = nn.GroupNorm(groups, cout, eps=1e-5)

    def forward(self, x, scale_shift=None):
        y = self.norm(self.proj(x))
        if scale_shift is not None:
            s, sh = scale_shift
            y = y * (s + 1.0) + sh
        return F.silu(y)


class ResnetBlock(nn.Module):
    """Time-FiLM ResnetBlock; `pixel` makes it ResnetBlock2, whose FiLM is a
    1x1 conv of the positional map."""

    def __init__(self, cin: int, cout: int, emb_dim: int, groups: int, pixel: bool = False):
        super().__init__()
        proj = Conv(emb_dim, 2 * cout, 1) if pixel else nn.Linear(emb_dim, 2 * cout)
        self.mlp = nn.Sequential(nn.SiLU(), proj)
        self.pixel = pixel
        self.block1 = Block(cin, cout, groups)
        self.block2 = Block(cout, cout, groups)
        self.res_conv = Conv(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, emb):
        ss = self.mlp(emb)
        if not self.pixel:
            ss = ss[:, :, None, None]
        h = self.block2(self.block1(x, ss.chunk(2, dim=1)))
        return h + self.res_conv(x)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x, context):
        """x (B, N, C), context (B, 1, Cc): softmax attention over the one
        context token, whose weight is 1 for every query."""
        b, n, _ = x.shape
        q = self.to_q(x).view(b, n, self.heads, -1).transpose(1, 2)
        k = self.to_k(context).view(b, 1, self.heads, -1).transpose(1, 2)
        v = self.to_v(context).view(b, 1, self.heads, -1).transpose(1, 2)
        attn = (q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5).softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 2):
        super().__init__()
        self.net = nn.Sequential(nn.Sequential(nn.Linear(dim, dim * mult), nn.GELU()),
                                 nn.Dropout(0.0), nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class AttnBlock(nn.Module):
    """x + proj_out(FF(LN2(y)) + y), y = x + attn(LN1(x), context)."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)
        self.proj_out = Conv(dim, dim, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = t + self.attn(self.norm1(t), context)
        t = t + self.ff(self.norm2(t))
        t = t.view(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(t) + x


class Downsample(nn.Sequential):
    """Space-to-depth ((c, p1, p2) channel order), then a 1x1 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Identity(), Conv(cin * 4, cout, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        x = x.view(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
        return self[1](x.reshape(b, c * 4, h // 2, w // 2))


class Upsample(nn.Sequential):
    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"), Conv(cin, cout, 3))


class NoiseDiffNet(nn.Module):
    def __init__(self, dim: int = 48, channels: int = 4, dim_mults=(1, 2, 4, 8),
                 resnet_block_groups: int = 8, iso_dim: int = 16, iso_vocab: int = 100,
                 pos_dim: int = 8, attn_heads: int = 4, attn_dim_head: int = 32):
        super().__init__()
        time_dim = dim * 4
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        g = resnet_block_groups

        def attn(c):
            return AttnBlock(c, iso_dim, attn_heads, attn_dim_head)

        self.init_conv = Conv(channels, dim, 7)
        self.iso_embed = nn.Embedding(iso_vocab, iso_dim)
        self.time_mlp = TimeMlp(dim, time_dim)
        self.downs = nn.ModuleList()
        for i, (a, b) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(a, a, time_dim, g), ResnetBlock(a, a, time_dim, g), attn(a),
                Conv(a, b, 3) if last else Downsample(a, b)]))
        self.mid_block1 = ResnetBlock(dims[-1], dims[-1], time_dim, g)
        self.mid_block2 = ResnetBlock(dims[-1], dims[-1], time_dim, g)
        self.ups = nn.ModuleList()
        for i, (a, b) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(b + a, b, time_dim, g), ResnetBlock(b + a, b, time_dim, g), attn(b),
                Conv(b, a, 3) if last else Upsample(b, a)]))
        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, g)
        self.final_conv = Conv(dim, channels, 1)
        self.pos_enc = nn.Module()
        self.pos_enc.weights = Conv(2, pos_dim, 1)
        self.pos_mlp = Mlp(pos_dim * 3, pos_dim * 2, pos_dim)
        self.pos_block1 = ResnetBlock(dim, dim, pos_dim, 2, pixel=True)
        self.pos_block2 = ResnetBlock(dim, dim, pos_dim, 2, pixel=True)
        self.shot_mlp1 = Mlp(channels * 2, dim, dim)
        self.shot_attn = attn(dim)
        self.shot_mlp2 = Mlp(dim, dim, dim)
        self.shot_time = ResnetBlock(dim, dim, time_dim, 2)
        self.shot_mlp3 = Mlp(dim, dim, channels)

    def set_quant(self, quant: Optional[str]) -> None:
        for m in self.modules():
            if isinstance(m, Conv):
                m.quant = quant

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                condition: Dict[str, torch.Tensor]) -> torch.Tensor:
        """x (B, H, W, 4), time (B,), condition 'clean_img' (B, H, W, 4),
        'position' (B, H, W, 2), 'iso_ratio_idx' (B,); returns (B, H, W, 4)."""
        def nchw(t):
            return t.float().permute(0, 3, 1, 2)

        xin, clean, pos = nchw(x), nchw(condition["clean_img"]), nchw(condition["position"])
        context = self.iso_embed(condition["iso_ratio_idx"].long())[:, None, :]
        p = self.pos_enc.weights(pos)
        pos_emb = self.pos_mlp(torch.cat([p, (2 * math.pi * p).sin(), (2 * math.pi * p).cos()],
                                         dim=1))
        t = self.time_mlp(time)

        shot = self.shot_mlp1(torch.cat([clean, xin], dim=1))
        shot_res = shot
        shot = self.shot_mlp2(self.shot_attn(shot, context))
        shot = self.shot_time(shot, t)

        h = self.init_conv(xin)
        r = h
        h = self.pos_block1(h, pos_emb)
        skips = []
        for block1, block2, attn, down in self.downs:
            h = block1(h, t)
            skips.append(h)
            h = block2(h, t)
            skips.append(h)
            h = down(attn(h, context))
        h = self.mid_block2(self.mid_block1(h, t), t)
        for block1, block2, attn, up in self.ups:
            h = block1(torch.cat([h, skips.pop()], dim=1), t)
            h = block2(torch.cat([h, skips.pop()], dim=1), t)
            h = up(attn(h, context))
        h = self.pos_block2(h, pos_emb)
        h = self.final_res_block(torch.cat([h, r], dim=1), t)
        out = self.shot_mlp3(shot + shot_res) + self.final_conv(h)
        return out.permute(0, 2, 3, 1)
