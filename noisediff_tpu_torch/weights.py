"""Weights into the port: JAX param trees, flat `.npz` snapshots and
reference `.pth`/`.pt` state dicts, all as a PyTorch `state_dict`.

The port's module names are the reference torch keys, so a `.pth` loads
as it is (after the DDP `module.` prefix is stripped). A JAX param tree (a
nested dict of arrays, as `noisediff_tpu` holds and its
`train/checkpoint.py` writes to `.npz` under `jax.tree_util.keystr` names)
is mapped by this module's own copy of the path rules of
noisediff_tpu/train/torch_import.py, with the layout transforms inverted:

    conv kernels    HWIO -> OIHW     (transpose 3, 2, 0, 1)
    LSID up6..up9   flip kh and kw, then (transpose 2, 3, 0, 1): the torch
                    ConvTranspose2d weight is (in, out, kh, kw), and the
                    flax/lax conv_transpose applies its kernel flipped
    dense kernels   (in, out) -> (out, in)
    norm scale      -> weight;  embedding -> weight
    RMSNorm g       (C,) -> (1, C, 1, 1)
    LinearAttention to_out -> to_out.0, out_norm -> to_out.1 (the
                    reference's Sequential(conv, RMSNorm))
    BatchNorm       the `batch_stats` collection's mean, var ->
                    running_mean, running_var, beside a num_batches_tracked
                    of 0 (flax counts no batches)

A single-process JAX run saves its snapshots as orbax directories, which
the port does not read (orbax writes zstd-compressed stores, and the port
imports neither orbax nor a zstd decoder): `scripts/orbax_to_npz.py`,
run where jax and orbax are installed, writes each as the flat `.npz`
beside it, and every loader here raises `orbax_error` on a directory
without one.

Training state crosses the same way: `adam_state_from_jax` turns an optax
Adam state (the `mu` and `nu` trees and the step count of
`train/state.make_optimizer`) into a `torch.optim.Adam` state_dict, so a
JAX run's `optimizer_G` snapshot (a flat `.npz`, `load_jax_opt_npz`)
resumes in the port.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

# flax segment -> torch segment (None drops the segment)
_NAME_RULES = {
    "lin1": "1",  # TimeMlp: Sequential(sinu, Linear, GELU, Linear)
    "lin2": "3",
    "sinu": None,
}
_STAGE_RE = re.compile(r"^(downs|ups)_(\d+)_(block1|block2|attn|down|up)$")
_STAGE_SLOT = {"block1": "0", "block2": "1", "attn": "2", "down": "3", "up": "3"}
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight", "embedding": "weight",
         "g": "g", "mean": "running_mean", "var": "running_var"}
_KEYSTR_RE = re.compile(r"\['([^']*)'\]")
# LSID's torch ConvTranspose2d modules (noisediff_tpu/train/torch_import.py)
_CONV_TRANSPOSE_NAMES = {"up6", "up7", "up8", "up9"}


def torch_key(path: Tuple[str, ...]) -> str:
    """flax param path (module..., leaf) -> reference torch state_dict key."""
    *mods, leaf = path
    out = []
    i = 0
    while i < len(mods):
        seg = mods[i]
        m = _STAGE_RE.match(seg)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}.{_STAGE_SLOT[m.group(3)]}")
            # Downsample / Upsample are Sequential(rearrange|upsample, Conv):
            # their flax path goes on conv/conv/..., a plain conv's conv/...
            rest = mods[i + 1:]
            if m.group(3) in ("down", "up") and rest[:2] == ["conv", "conv"]:
                out.append("1")
                i += 3
                continue
            i += 1
            continue
        if seg == "mlp":  # FiLM head: Sequential(SiLU, Linear | Conv)
            out.append("mlp.1")
        elif seg == "ff":  # FeedForward: Sequential(Sequential(Linear, GELU), Dropout, Linear)
            out.append("ff.net.0.0" if mods[i + 1] == "proj_in" else "ff.net.2")
            i += 1
        elif seg == "to_out":
            # CrossAttention's Sequential(Linear, Dropout); Attention's is a conv
            out.append("to_out" if mods[i + 1:i + 2] == ["conv"] else "to_out.0")
        elif seg in ("conv", "dense", "norm") and i == len(mods) - 1 and i > 0 and leaf != "g":
            pass  # the flax primitive inside a wrapper module collapses (RMSNorm's g is its own)
        elif seg in _NAME_RULES:
            if _NAME_RULES[seg] is not None:
                out.append(_NAME_RULES[seg])
        else:
            out.append(seg)
        i += 1
    return ".".join(out + [_LEAF[leaf]])


def _to_torch_layout(value: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    leaf = path[-1]
    if leaf == "kernel" and value.ndim == 4 and len(path) > 1 and path[-2] in _CONV_TRANSPOSE_NAMES:
        return value[::-1, ::-1].transpose(2, 3, 0, 1)  # (kh, kw, in, out) flipped -> (in, out, kh, kw)
    if leaf == "g" and value.ndim == 1:
        return value.reshape(1, -1, 1, 1)  # RMSNorm
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and value.ndim == 2:
        return value.T  # (in, out) -> (out, in)
    return value


def _flatten(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _linear_attention_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A LinearAttention module (the one holding an `out_norm`) keeps its
    output conv and norm in the reference's Sequential: to_out.0, to_out.1."""
    prefixes = [k[:-len("out_norm.g")] for k in sd if k.endswith("out_norm.g")]
    if not prefixes:
        return sd
    out = {}
    for k, v in sd.items():
        p = next((p for p in prefixes if k.startswith(p)), None)
        if p is not None and k[len(p):].startswith("to_out."):
            k = p + "to_out.0." + k[len(p) + len("to_out."):]
        elif p is not None and k[len(p):] == "out_norm.g":
            k = p + "to_out.1.g"
        out[k] = v
    return out


def _from_paths(items) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, value in items:
        arr = np.ascontiguousarray(_to_torch_layout(np.asarray(value, np.float32), tuple(path)))
        key = torch_key(tuple(path))
        if key in sd:
            raise ValueError(f"two parameters map to {key}")
        sd[key] = torch.from_numpy(arr)
    return _linear_attention_keys(sd)


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX param tree (nested dict of arrays) -> torch state_dict (fp32,
    CPU). A top-level 'params' collection is unwrapped; a 'batch_stats'
    collection beside it becomes the BatchNorm buffers."""
    if "params" not in params or not set(params) <= {"params", "batch_stats"}:
        return _from_paths(_flatten(params))
    sd = _from_paths(_flatten(params["params"]))
    if "batch_stats" in params:
        stats = _from_paths(_flatten(params["batch_stats"]))
        sd.update(stats)
        for k in stats:
            if k.endswith(".running_mean"):
                sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop DDP 'module.' prefixes (reference trainer_diffusion.py:341-346)."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}


def orbax_error(path: str) -> NotImplementedError:
    """The error for an orbax snapshot directory of the JAX package that has
    no converted `.npz` beside it."""
    return NotImplementedError(
        f"{path}: an orbax snapshot directory of the JAX package, which the port does not read; "
        f"convert it where jax and orbax are installed with `python scripts/orbax_to_npz.py "
        f"{path}` (a whole snapshot directory converts every component in it) and load the "
        f"{os.path.basename(os.path.normpath(path))}.npz it writes beside it")


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file -> torch state_dict: `.pth`/`.pt` (a torch
    state_dict, possibly DDP-prefixed) or a flat `.npz` snapshot of a JAX
    param tree."""
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return strip_module_prefix(sd)
    npz = path if path.endswith(".npz") else path + ".npz"
    if os.path.isfile(npz):
        with np.load(npz) as f:
            items = [(tuple(_KEYSTR_RE.findall(k)), f[k]) for k in f.files]
        if items and items[0][0][:1] == ("params",):
            items = [(p[1:], v) for p, v in items]
        return _from_paths(items)
    if os.path.isdir(path):
        raise orbax_error(path)
    raise FileNotFoundError(path)


def load_into(model: torch.nn.Module, path: str) -> None:
    """Load a checkpoint file into a model, strict key match."""
    model.load_state_dict(load_state_dict_file(path), strict=True)


def adam_state_from_jax(mu: Mapping[str, Any], nu: Mapping[str, Any], count: int,
                        optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module) -> Dict[str, Any]:
    """An optax `scale_by_adam` state (first and second moment trees in the
    JAX param layout, and its step count) -> a state_dict for `optimizer`,
    a torch.optim.Adam over `model.parameters()` in their order. The
    moments go through the parameters' key map and layout transforms;
    torch's Adam keeps the same moments and bias-corrects by the same
    count."""
    mu_sd, nu_sd = jax_params_to_state_dict(mu), jax_params_to_state_dict(nu)
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(mu_sd) or set(names) != set(nu_sd):
        raise ValueError("the Adam moments do not cover the model's parameters")
    sd = optimizer.state_dict()
    index = [i for g in sd["param_groups"] for i in g["params"]]
    if len(index) != len(names):
        raise ValueError("the optimizer does not hold exactly the model's parameters")
    sd["state"] = {
        i: {"step": torch.tensor(float(count)), "exp_avg": mu_sd[n].clone(),
            "exp_avg_sq": nu_sd[n].clone()}
        for i, n in zip(index, names)
    }
    return sd


_MOMENT_RE = re.compile(r"\.(mu|nu)(\[.*)$")


def load_jax_opt_npz(path: str) -> Tuple[Dict[str, Any], Dict[str, Any], int, Dict[str, int]]:
    """A flat `.npz` `optimizer_G` snapshot of the JAX trainer -> (mu, nu,
    count, counters): the Adam moment trees, the Adam step count and the
    trainer's {'step', 'ema_step'} where saved."""
    npz = path if path.endswith(".npz") else path + ".npz"
    if not os.path.isfile(npz) and os.path.isdir(path):
        raise orbax_error(path)
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    count: Optional[int] = None
    counters: Dict[str, int] = {}
    with np.load(npz) as f:
        for k in f.files:
            m = _MOMENT_RE.search(k)
            if m:
                node = mu if m.group(1) == "mu" else nu
                *mods, leaf = _KEYSTR_RE.findall(m.group(2))
                for seg in mods:
                    node = node.setdefault(seg, {})
                node[leaf] = f[k]
            elif k.endswith(".count") and ".inner_state" in k:
                count = int(f[k])
            elif k in ("['step']", "['ema_step']"):
                counters[k[2:-2]] = int(f[k])
    if not mu or count is None:
        raise ValueError(f"{npz}: no optax Adam state (mu, nu, count) found")
    return mu, nu, count, counters
