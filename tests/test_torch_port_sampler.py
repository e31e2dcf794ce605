"""The port's per-rank samplers and loaders against the JAX package's:
`data/sampler.py` gives the same index lists for every (dataset_len,
num_replicas, rank, ratio, seed, epoch), and a distributed training loader
cuts the same per-rank batches as the JAX create_dataloader."""
import numpy as np
import pytest

from noisediff_tpu.data import loader as jax_loader
from noisediff_tpu.data import sampler as jax_sampler
from noisediff_tpu_torch.data import loader, sampler

# (dataset_len, num_replicas, rank, ratio, seed, epoch)
CASES = [
    (100, 1, 0, 1.0, 0, 0),
    (100, 2, 0, 1.0, 0, 3),
    (100, 2, 1, 1.0, 0, 3),
    (7, 4, 3, 1.0, 5, 1),      # more replicas' share than items: indices wrap modulo 7
    (50, 3, 2, 100.0, 1, 2),   # the reference's dataset enlargement ratio
    (13, 8, 5, 2.5, 9, 11),
    (1, 2, 1, 1.0, 0, 0),
]


@pytest.mark.parametrize("n,world,rank,ratio,seed,epoch", CASES)
def test_sampler_indices_equal_jax(n, world, rank, ratio, seed, epoch):
    want = jax_sampler.ShardedIterSampler(n, world, rank, ratio=ratio, seed=seed)
    got = sampler.ShardedIterSampler(n, world, rank, ratio=ratio, seed=seed)
    want.set_epoch(epoch)
    got.set_epoch(epoch)
    assert list(got) == list(want) and len(got) == len(want)
    assert all(0 <= i < n for i in got)
    strided = sampler.StridedShardSampler(n, world, rank)
    strided.set_epoch(epoch)
    assert list(strided) == list(jax_sampler.StridedShardSampler(n, world, rank))
    assert len(strided) == len(jax_sampler.StridedShardSampler(n, world, rank))


def test_sharded_sampler_shards_are_disjoint_and_cover_the_permutation():
    shards = [sampler.ShardedIterSampler(40, 4, r, seed=2) for r in range(4)]
    for s in shards:
        s.set_epoch(6)
    assert sorted(i for s in shards for i in s) == list(range(40))
    with pytest.raises(ValueError, match="rank"):
        sampler.ShardedIterSampler(10, 2, 2)


class _Items:
    """A dataset whose items are their indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray([i])}


@pytest.mark.parametrize("world,rank", [(1, -1), (2, 0), (2, 1), (4, 3)])
def test_train_loader_batches_equal_jax(world, rank):
    """Per-rank batches of batch_size / world from the rank's shard (the
    whole shuffled dataset at world 1), equal to the JAX loader's, every
    epoch."""
    ds = _Items(37)
    got = loader.create_train_loader(ds, 8, num_workers=1, seed=3, world_size=world, rank=rank)
    want = jax_loader.create_dataloader(ds, phase="train", batch_size=8, num_workers=1,
                                        dist=world > 1, world_size=world, rank=max(rank, 0),
                                        seed=3)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        g = [b["i"][:, 0].tolist() for b in got]
        assert g == [b["i"][:, 0].tolist() for b in want]
        assert len(g) == len(got) and all(len(b) == 8 // world for b in g)


def test_train_loader_needs_a_divisible_global_batch():
    with pytest.raises(ValueError, match="divide"):
        loader.create_train_loader(_Items(10), 6, world_size=4, rank=0)


def test_generation_loader_walks_the_strided_shard():
    ds = _Items(11)
    got = loader.generation_loader(ds, 2, sampler=sampler.StridedShardSampler(11, 3, 1))
    assert [b["i"][:, 0].tolist() for b in got] == [[1, 4], [7, 10]]
