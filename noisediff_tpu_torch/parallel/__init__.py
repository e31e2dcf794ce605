"""Multi-process parallelism (torch.distributed, DDP, the data x spatial x
model grid); see mesh.py."""
from .mesh import (
    SINGLE, Grid, ModelShard, Shard, SpatialShard, activate, all_reduce_mean, barrier,
    gather_params, make_mesh, param_sharding_rules, setup, shard_parameters, spatial,
    spatial_shard, teardown, unwrap, wrap)

__all__ = ["SINGLE", "Grid", "ModelShard", "Shard", "SpatialShard", "activate",
           "all_reduce_mean", "barrier", "gather_params", "make_mesh", "param_sharding_rules",
           "setup", "shard_parameters", "spatial", "spatial_shard", "teardown", "unwrap", "wrap"]
