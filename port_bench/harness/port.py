"""Building the system under test, the port (`noisediff_tpu_torch`), with
the benchmark's seeded weights, and its reference twin."""
from __future__ import annotations

import math

import torch

from . import weights


def precision_flags(allow_tf32: bool = False) -> None:
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32


def program_settings() -> None:
    """The port's settings for a run: TF32 off (its `set_precision_flags`)
    and cuDNN's heuristics, not its autotuner (the port sets none; an
    earlier reference in the same process may have turned it on)."""
    from noisediff_tpu_torch.cli.common import set_precision_flags

    set_precision_flags()
    torch.backends.cudnn.benchmark = False


def compute_dtype(cfg: dict):
    return {"bfloat16": torch.bfloat16, "float32": None}[cfg["compute_dtype"]]


def model_kwargs(cfg: dict) -> dict:
    if cfg["model"] == "NoiseDiffNet":
        keys = ("dim", "channels", "dim_mults", "resnet_block_groups", "iso_dim", "iso_vocab",
                "pos_dim", "attn_heads", "attn_dim_head")
        out = {k: cfg[k] for k in keys}
        out["dim_mults"] = tuple(out["dim_mults"])
        return out
    return {"inchannel": cfg["channels"], "base_width": cfg["base_width"]}


def program_model(cfg: dict, device) -> torch.nn.Module:
    """The port's model class at the configuration's widths, on `device`,
    its parameters uninitialised (made on the meta device, so nothing is
    drawn leaf by leaf), channels-last as the port's trainers place it."""
    if cfg["model"] == "NoiseDiffNet":
        from noisediff_tpu_torch.models import NoiseDiffNet as cls
    else:
        from noisediff_tpu_torch.models.lsid import LSID as cls
    with torch.device("meta"):
        model = cls(**model_kwargs(cfg), dtype=compute_dtype(cfg))
    return model.to_empty(device=device).to(memory_format=torch.channels_last)


def reference_model(cfg: dict, device) -> torch.nn.Module:
    """The plain reference at the configuration's widths on `device`,
    channels-last. cuDNN's heuristics pick slow fp32 kernels for it (a
    training check took ~40 s), so it times two candidates a shape (~12
    s); the reference runs after the window and is not timed."""
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.benchmark_limit = 2
    if cfg["model"] == "NoiseDiffNet":
        from reference.noisediff_net import NoiseDiffNet as cls
    else:
        from reference.lsid import LSID as cls
    with torch.device("meta"):
        model = cls(**model_kwargs(cfg))
    return model.to_empty(device=device).to(memory_format=torch.channels_last)


def seeded_weights(cfg: dict, model: torch.nn.Module, seed: int, device):
    gain = math.sqrt(2.0) if cfg.get("init") == "he" else 1.0
    return weights.seeded_state(weights.shapes_of(model), seed, device, gain)
