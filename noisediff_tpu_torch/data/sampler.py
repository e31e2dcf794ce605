"""Deterministic per-process data sharding.

Port of noisediff_tpu/data/sampler.py (reference DistIterSampler,
dataloader/data_sampler.py:12-62), kept as the port's own copy: pure numpy,
so for every (dataset_len, num_replicas, rank, ratio, seed, epoch) both
packages give the same index lists.

  StridedShardSampler  unshuffled strided shard (rank, rank + world, ...):
                       multi-process generation, each rank writes a
                       disjoint set of patches
  ShardedIterSampler   the epoch-seeded permutation every rank draws alike,
                       indices modulo the dataset size, rank's strided shard
                       of it: multi-process training, per-rank batches
"""
from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


class StridedShardSampler:
    """Process `rank` takes indices rank, rank + num_replicas, ..."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0):
        self.indices_list = list(range(rank, dataset_len, num_replicas))

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices_list)

    def __len__(self) -> int:
        return len(self.indices_list)


class ShardedIterSampler:
    """ceil(dataset_len * ratio / num_replicas) indices a rank and epoch:
    rank's strided shard of default_rng(seed + epoch)'s permutation of the
    enlarged range, each index modulo dataset_len."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 ratio: float = 1.0, seed: int = 0):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_len = int(dataset_len)
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.epoch = 0
        self.seed = seed
        self.num_samples = int(math.ceil(dataset_len * ratio / num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> List[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        indices = rng.permutation(self.total_size) % self.dataset_len
        shard = indices[self.rank: self.total_size: self.num_replicas]
        assert len(shard) == self.num_samples
        return shard.tolist()

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples
