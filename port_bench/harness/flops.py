"""Operations of a model call, counted from the configuration's shapes.

Products only (2 per multiply-add of every convolution and linear layer),
as torch.utils.flop_counter counts them; normalisations, activations and
elementwise work are left out. NoiseDiffNet's one-token cross attention is
counted as the work it needs: the value and output projections of the one
context token (the queries, keys and the softmax over one key are the
constant 1 and are not counted).
"""
from __future__ import annotations


def _conv(ci: int, co: int, k: int, pixels: int) -> int:
    return 2 * ci * co * k * k * pixels


def noisediffnet_layers(cfg: dict, b: int, h: int, w: int):
    """[(name, flops)] of one NoiseDiffNet forward at (b, h, w)."""
    dim, mults = cfg["dim"], cfg["dim_mults"]
    pos, iso, heads, dh = cfg["pos_dim"], cfg["iso_dim"], cfg["attn_heads"], cfg["attn_dim_head"]
    ch = cfg.get("channels", 4)
    tdim = 4 * dim
    dims = [dim] + [dim * m for m in mults]
    in_out = list(zip(dims[:-1], dims[1:]))

    def px(s):
        return b * (h >> s) * (w >> s)

    layers = []

    def add(name, flops):
        layers.append((name, flops))

    def resnet_time(name, ci, co, p):
        add(f"{name}.mlp", 2 * tdim * 2 * co * b)
        add(f"{name}.block1", _conv(ci, co, 3, p))
        add(f"{name}.block2", _conv(co, co, 3, p))
        if ci != co:
            add(f"{name}.res_conv", _conv(ci, co, 1, p))

    def resnet_pos(name, c, p):
        add(f"{name}.mlp", _conv(pos, 2 * c, 1, p))
        add(f"{name}.block1", _conv(c, c, 3, p))
        add(f"{name}.block2", _conv(c, c, 3, p))

    def attn(name, c, p):
        add(f"{name}.token", 2 * b * (iso * heads * dh + heads * dh * c))
        add(f"{name}.ff", 2 * p * (c * 2 * c) * 2)
        add(f"{name}.proj_out", _conv(c, c, 1, p))

    p0 = px(0)
    add("time_mlp.1", 2 * b * dim * tdim)
    add("time_mlp.3", 2 * b * tdim * tdim)
    add("pos_enc", _conv(2, pos, 1, p0))
    add("pos_mlp", _conv(3 * pos, 2 * pos, 1, p0) + _conv(2 * pos, pos, 1, p0))
    add("shot_mlp1.fc1", _conv(2 * ch, dim, 1, p0))
    add("shot_mlp1.fc2", _conv(dim, dim, 1, p0))
    attn("shot_attn", dim, p0)
    add("shot_mlp2", 2 * _conv(dim, dim, 1, p0))
    resnet_time("shot_time", dim, dim, p0)
    add("init_conv", _conv(ch, dim, 7, p0))
    resnet_pos("pos_block1", dim, p0)
    for s, (a, o) in enumerate(in_out):
        last = s == len(in_out) - 1
        resnet_time(f"downs.{s}.0", a, a, px(s))
        resnet_time(f"downs.{s}.1", a, a, px(s))
        attn(f"downs.{s}.2", a, px(s))
        add(f"downs.{s}.3", _conv(a, o, 3, px(s)) if last else _conv(4 * a, o, 1, px(s + 1)))
    top = len(in_out) - 1
    resnet_time("mid_block1", dims[-1], dims[-1], px(top))
    resnet_time("mid_block2", dims[-1], dims[-1], px(top))
    for i, (a, o) in enumerate(reversed(in_out)):
        s = top - i
        resnet_time(f"ups.{i}.0", o + a, o, px(s))
        resnet_time(f"ups.{i}.1", o + a, o, px(s))
        attn(f"ups.{i}.2", o, px(s))
        add(f"ups.{i}.3", _conv(o, a, 3, px(max(s - 1, 0))))
    resnet_pos("pos_block2", dim, p0)
    resnet_time("final_res_block", 2 * dim, dim, p0)
    add("final_conv", _conv(dim, ch, 1, p0))
    add("shot_mlp3", _conv(dim, dim, 1, p0) + _conv(dim, ch, 1, p0))
    return layers


def lsid_layers(cfg: dict, b: int, h: int, w: int):
    """[(name, flops)] of one LSID forward at (b, h, w), odd
    sizes pooled with ceil mode."""
    base, cin = cfg["base_width"], cfg.get("channels", 4)
    widths = [base << i for i in range(5)]
    sizes = [(h, w)]
    for _ in range(4):
        hh, ww = sizes[-1]
        sizes.append(((hh + 1) // 2, (ww + 1) // 2))
    layers = []
    c_prev = cin
    for lvl, c in enumerate(widths):
        p = b * sizes[lvl][0] * sizes[lvl][1]
        layers.append((f"conv{lvl + 1}_1", _conv(c_prev, c, 3, p)))
        layers.append((f"conv{lvl + 1}_2", _conv(c, c, 3, p)))
        c_prev = c
    for i, lvl in enumerate(range(3, -1, -1)):
        c = widths[lvl]
        p_up = b * (2 * sizes[lvl + 1][0]) * (2 * sizes[lvl + 1][1])
        p = b * sizes[lvl][0] * sizes[lvl][1]
        layers.append((f"up{6 + i}", 2 * (2 * c) * c * 4 * (p_up // 4)))
        layers.append((f"conv{6 + i}_1", _conv(2 * c, c, 3, p)))
        layers.append((f"conv{6 + i}_2", _conv(c, c, 3, p)))
    layers.append(("conv10", _conv(base, cin, 1, b * h * w)))
    return layers


LAYERS = {"NoiseDiffNet": noisediffnet_layers, "LSID": lsid_layers}


def forward_flops(cfg: dict, b: int, h: int, w: int) -> int:
    return sum(f for _, f in LAYERS[cfg["model"]](cfg, b, h, w))

