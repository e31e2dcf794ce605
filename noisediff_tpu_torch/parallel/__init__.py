"""Multi-process parallelism (torch.distributed, DDP, the spatial axis);
see mesh.py."""
from .mesh import (
    SINGLE, Shard, SpatialShard, activate, all_reduce_mean, barrier, setup, spatial,
    spatial_shard, teardown, unwrap, wrap)

__all__ = ["SINGLE", "Shard", "SpatialShard", "activate", "all_reduce_mean", "barrier", "setup",
           "spatial", "spatial_shard", "teardown", "unwrap", "wrap"]
