"""Batching for generation and training.

Counterpart of noisediff_tpu/data/loader.py:
  * generation: batches in dataset order, never shuffled, the last one
    possibly short; a `torch.utils.data.DataLoader` with a numpy collate,
    whose worker processes (when asked for) start with `spawn`, so none
    inherits the parent's CUDA state;
  * training (`TrainLoader`, create_dataloader's train policy): every epoch
    shuffled by default_rng(seed + epoch), drop_last, items loaded in a
    thread pool (decoding and packing run in numpy, which releases the
    GIL) a few batches ahead of the consumer. The batch order equals the
    JAX package's.
Under multi-process runs (`create_train_loader` with world_size > 1, and a
sampler given to `generation_loader`) each rank loads its own shard
(data/sampler.py): the training batch per rank is the global batch over
the world size, as in the JAX create_dataloader.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
from typing import Iterator, Optional

import numpy as np
from torch.utils.data import DataLoader

from .sampler import ShardedIterSampler

# batches the training loader's threads load ahead of the consumer
PREFETCH = 4


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


def generation_loader(dataset, batch_size: int, num_workers: int = 0,
                      sampler=None) -> DataLoader:
    """Batches of `batch_size` items in dataset order, or in `sampler`'s
    order (a rank's StridedShardSampler shard). num_workers <= 1 loads in
    the calling process."""
    workers = num_workers if num_workers > 1 else 0
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=False,
        sampler=sampler,
        drop_last=False,
        num_workers=workers,
        collate_fn=collate,
        multiprocessing_context="spawn" if workers else None,
    )


class TrainLoader:
    """Shuffled, drop_last batches of a dataset with `set_epoch`, loaded by
    `num_workers` threads at most PREFETCH batches ahead. With a `sampler`
    (a rank's ShardedIterSampler) the batches are cut from its indices
    instead of the one-process shuffle."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 2, seed: int = 0,
                 sampler: Optional[ShardedIterSampler] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.sampler = sampler
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def indices(self) -> list:
        if self.sampler is not None:
            return list(self.sampler)
        idx = np.arange(len(self.dataset))
        np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx.tolist()

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size

    def _load(self, batch_indices) -> dict:
        return collate([self.dataset[i] for i in batch_indices])

    def __iter__(self) -> Iterator[dict]:
        idx = self.indices()
        bs = self.batch_size
        batches = [idx[i: i + bs] for i in range(0, len(idx) - bs + 1, bs)]
        if self.num_workers <= 1:
            for b in batches:
                yield self._load(b)
            return
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            todo = iter(batches)
            pending = collections.deque(
                pool.submit(self._load, b) for b in itertools.islice(todo, PREFETCH))
            try:
                while pending:
                    batch = pending.popleft().result()
                    nxt = next(todo, None)
                    if nxt is not None:
                        pending.append(pool.submit(self._load, nxt))
                    yield batch
            finally:
                for fut in pending:
                    fut.cancel()


def create_train_loader(dataset, batch_size: int, num_workers: int = 2, seed: int = 0,
                        world_size: int = 1, rank: int = -1) -> TrainLoader:
    """The JAX create_dataloader's train policy: one process shuffles the
    whole dataset into batches of batch_size; world_size > 1 ranks each
    take their ShardedIterSampler shard in batches of batch_size //
    world_size, which must divide."""
    if world_size <= 1:
        return TrainLoader(dataset, batch_size, num_workers, seed=seed)
    if batch_size % world_size:
        raise ValueError(f"distributed run: global batch_size {batch_size} must divide "
                         f"across {world_size} processes")
    sampler = ShardedIterSampler(len(dataset), world_size, max(rank, 0), seed=seed)
    return TrainLoader(dataset, batch_size // world_size, num_workers, seed=seed,
                       sampler=sampler)
