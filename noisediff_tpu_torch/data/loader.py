"""Ordered batching for generation.

Counterpart of the generation use of noisediff_tpu/data/loader.py: batches
in dataset order, never shuffled, the last one possibly short. A
`torch.utils.data.DataLoader` with a numpy collate; worker processes (when
asked for) start with `spawn`, so none inherits the parent's CUDA state.
"""
from __future__ import annotations

import numpy as np
from torch.utils.data import DataLoader


def collate(samples) -> dict:
    """Stack a list of per-item dicts into a batch dict (numpy; strings and
    other metadata stay lists)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(first, (int, np.integer)):
            out[key] = np.asarray(vals, np.int32)
        elif isinstance(first, (float, np.floating)):
            out[key] = np.asarray(vals, np.float32)
        else:
            out[key] = list(vals)
    return out


def generation_loader(dataset, batch_size: int, num_workers: int = 0) -> DataLoader:
    """Batches of `batch_size` items in dataset order. num_workers <= 1
    loads in the calling process."""
    workers = num_workers if num_workers > 1 else 0
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=False,
        drop_last=False,
        num_workers=workers,
        collate_fn=collate,
        multiprocessing_context="spawn" if workers else None,
    )
