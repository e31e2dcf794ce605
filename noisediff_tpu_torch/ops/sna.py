"""Shot-Noise Augmentation (PMN), batched on the tensors' device.

Port of noisediff_tpu/ops/sna.py (reference `models/trainer_denoising.py`
get_aug_param_torch :115-138 and SNA_torch :140-166, applied at :207-217).
Like the JAX package, the whole augmentation is batched tensor work: per
batch one r in {0.25, 0.5} and one 3-in-4 gate, per sample clamped
Gaussian white-balance gains and a Kmax from the SonyA7S2 table jittered by
+-1%, and a Poisson draw over each (H, W, 4) sample. Every draw comes from
an explicit torch.Generator on the tensors' device, so nothing waits for
the host. `torch.poisson` cannot match `jax.random.poisson` draw for draw;
everything around the draw is the JAX package's arithmetic.

Each sample's Poisson draw comes from a generator of its own, seeded from
the step generator's seed and the sample's index in the step's batch
(`first` + its row): the draws of a sample do not depend on how the batch
was split, so the ranks of a multi-process step, each handed its rows,
draw together what one process draws for the whole batch, on the CPU
(whose Poisson draws consume the generator serially) as on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .raw import SONY_A7S2_ISO_TABLE, sony_kmax_array

WP, BL = 16383.0, 512.0

_ISO_TABLE = np.asarray(SONY_A7S2_ISO_TABLE, np.float32)
_KMAX_TABLE = np.asarray(sony_kmax_array())
# the tables on each device, uploaded once: a per-step upload from pageable
# memory would wait for the card
_DEVICE_TABLES: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    if device not in _DEVICE_TABLES:
        _DEVICE_TABLES[device] = (torch.from_numpy(_ISO_TABLE).to(device),
                                  torch.from_numpy(_KMAX_TABLE).to(device))
    return _DEVICE_TABLES[device]


def kmax_for_iso(iso: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Per-ISO K = Kmax * (1 + jitter) (trainer_denoising.py:150-152). ISOs
    of the SonyA7S2 table use its Kmax; others the linear K(iso) model
    0.0009546 * iso - 0.00193 (the reference's unknown-ISO branch)."""
    iso = iso.float()
    iso_table, kmax_table = _tables(iso.device)
    pos = torch.searchsorted(iso_table, iso.contiguous()).clamp(0, len(_ISO_TABLE) - 1)
    exact = iso_table[pos] == iso
    fallback = 0.0009546 * iso - 0.00193
    return torch.where(exact, kmax_table[pos], fallback) * (1.0 + jitter)


def aug_wb_from_draws(r: torch.Tensor, gate: torch.Tensor, n_g: torch.Tensor,
                      n_r: torch.Tensor, n_b: torch.Tensor) -> torch.Tensor:
    """The gains of get_aug_param_torch from its draws: r (scalar, 0.25 or
    0.5), gate (scalar bool: augment this batch) and three (B,) standard
    normals. Returns (B, 4) in channel order R, G1, B, G2, normalised so
    the smallest gain is not below 0 (:128-132)."""
    u = r
    aug_g = torch.minimum(torch.clamp(n_g * r, min=0.0), 4 * u)
    aug_r = torch.minimum(torch.clamp((1 + n_r * r) * (1 + aug_g) - 1, min=0.0), 4 * u)
    aug_b = torch.minimum(torch.clamp((1 + n_b * r) * (1 + aug_g) - 1, min=0.0), 4 * u)
    zeros = torch.zeros_like(aug_g)
    aug_r = torch.where(gate, aug_r, zeros)
    aug_g = torch.where(gate, aug_g, zeros)
    aug_b = torch.where(gate, aug_b, zeros)

    daug = torch.minimum(torch.minimum(aug_r, aug_g), aug_b)
    daug = torch.clamp(daug, max=0.0)  # daug[daug > 0] = 0
    aug_r = (1 + aug_r) / (1 + daug) - 1
    aug_g = (1 + aug_g) / (1 + daug) - 1
    aug_b = (1 + aug_b) / (1 + daug) - 1
    return torch.stack([aug_r, aug_g, aug_b, aug_g], dim=1)  # R, G1, B, G2 (:210)


def sample_aug_wb(generator: torch.Generator, batch: int) -> torch.Tensor:
    """Per-sample white-balance gains (B, 4) on the generator's device:
    one r and one gate for the batch, as get_aug_param_torch draws them."""
    dev = generator.device
    r = torch.randint(0, 2, (), generator=generator, device=dev).float() * 0.25 + 0.25
    gate = torch.randint(0, 4, (), generator=generator, device=dev) != 0  # 3/4 augmented
    n_g, n_r, n_b = torch.randn((3, batch), generator=generator, device=dev)
    return aug_wb_from_draws(r, gate, n_g, n_r, n_b)


def draw_jitter(generator: torch.Generator, batch: int) -> torch.Tensor:
    """The per-sample Kmax jitter, uniform in [-0.01, 0.01): the first draw
    `apply_sna` makes from its generator when it is given none."""
    u = torch.rand((batch,), generator=generator, device=generator.device)
    return u * 0.02 - 0.01


_MASK64 = (1 << 64) - 1


def sample_seed(seed: int, index: int) -> int:
    """The seed of sample `index`'s Poisson generator under a step
    generator seeded with `seed`: splitmix64's finaliser of the pair, kept
    to 63 bits."""
    z = (int(seed) + 0x9E3779B97F4A7C15 * (int(index) + 1)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def draw_poisson(seed: int, lam: torch.Tensor, first: int = 0) -> torch.Tensor:
    """Poisson draws of mean lam (B, ...), row i from a generator seeded
    with sample_seed(seed, first + i): one draw a sample, then one stack."""
    g = torch.Generator(device=lam.device)
    rows = []
    for i in range(lam.shape[0]):
        g.manual_seed(sample_seed(seed, first + i))
        rows.append(torch.poisson(lam[i], generator=g))
    return torch.stack(rows)


def apply_sna(generator: torch.Generator, noisy: torch.Tensor, clean: torch.Tensor,
              iso: torch.Tensor, ratio: torch.Tensor,
              aug_wb: torch.Tensor, jitter: Optional[torch.Tensor] = None,
              first: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched SNA_torch (:140-166, applied at :207-217).

    noisy / clean: (B, H, W, 4) in [0, 1] (the ratio-amplified domain);
    iso / ratio: (B,); aug_wb: (B, 4). The clean image gains
    dy = clean * wb; the noisy one a Poisson draw of mean dy in units of
    K * ratio / (WP - BL). Samples whose gains are all zero pass through
    unchanged (the reference skips them). The Kmax jitter (B,) is drawn
    from `generator` unless given; the Poisson draws come from the
    generator's seed, the batch's rows being samples first, first + 1, ...
    of the step's batch (draw_poisson)."""
    b = clean.shape[0]
    if jitter is None:
        jitter = draw_jitter(generator, b)
    K = kmax_for_iso(iso, jitter)

    ratio = ratio.float().reshape(b, 1, 1, 1)
    Kb = K.reshape(b, 1, 1, 1)
    wb = aug_wb.reshape(b, 1, 1, 4).float()

    gt_dn = clean.float() * (WP - BL) / ratio
    dy = gt_dn * wb
    lam = torch.clamp(dy / Kb, min=0.0)
    dn = draw_poisson(generator.initial_seed(), lam, first) * Kb
    dy = dy * ratio / (WP - BL)
    dn = dn / (WP - BL) * ratio  # ori=False branch (:163-164)

    active = (aug_wb.abs().amax(dim=1) != 0).reshape(b, 1, 1, 1)
    return torch.where(active, noisy + dn, noisy), torch.where(active, clean + dy, clean)
