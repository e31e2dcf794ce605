"""Multi-process data parallelism (torch.distributed, DDP); see mesh.py."""
from .mesh import SINGLE, Shard, all_reduce_mean, barrier, setup, teardown, unwrap, wrap

__all__ = ["SINGLE", "Shard", "all_reduce_mean", "barrier", "setup", "teardown", "unwrap",
           "wrap"]
