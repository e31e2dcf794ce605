"""Multi-process data parallelism: torch.distributed and DDP.

Counterpart of noisediff_tpu/parallel/mesh.py's data axis. The reference's
whole distributed story is NCCL DDP (SURVEY.md §2.7: `init_dist`
train_diffusion.py:18-25, DDP modules.py:79, DistIterSampler
data_sampler.py:12-62); the JAX package expresses it as a mesh over the
batch axis, this package as the reference does: one process per card, the
launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR /
MASTER_PORT, as `torchrun` sets them), a process group (NCCL on the card,
gloo on the CPU; the backend is an argument, so a caller may run gloo over
CUDA tensors), DDP's gradient all-reduce, and each rank's rows of the
global batch (`Shard`).

JAX functions without a counterpart here, and why:
  put_replicated, shard_batch  DDP broadcasts rank 0's parameters when it
                     wraps the model, and each rank loads and uploads its
                     own rows of the batch (data/sampler.ShardedIterSampler)
  activate           there is no trace-time mesh: the GroupNorm statistics
                     kernels are per-rank calls, and DDP all-reduces the
                     gradients they feed
  make_mesh, replicated, data_sharding  the process group is the data axis
  data_sharding(spatial=True), param_sharding_rules  the spatial and model
                     axes are model parallelism (halo exchanges in every
                     conv, GroupNorm statistics all-reduced across shards),
                     a different mechanism from DDP (ROADMAP.md, Queue 1
                     item 2)
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

# how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Shard:
    """This process's rows of the global batch: rank `rank` of `world`
    holds rows [rank * b, (rank + 1) * b) of a global batch of world * b.

    Random draws over a batch are made at the global batch's size from a
    generator seeded alike on every rank, and each rank keeps its rows
    (`rows`), so a step on `world` ranks draws what one process draws for
    the concatenated batch."""

    rank: int = 0
    world: int = 1

    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of x, drawn for the global batch along `dim`."""
        if self.world == 1:
            return x
        b = x.shape[dim] // self.world
        return x.narrow(dim, self.rank * b, b)


SINGLE = Shard()


def setup(device: torch.device, backend: Optional[str] = None) -> Tuple[Shard, torch.device]:
    """Join the process group the launcher's environment names (WORLD_SIZE
    set, as torchrun sets it; a world of 1 included, whose one rank runs
    DDP's reducer and the backend's all-reduce like any other). Returns
    this process's Shard and its device: on the card, LOCAL_RANK modulo the
    cards present (the reference's init_dist), made the current device.
    `backend` defaults to NCCL for the card and gloo for the CPU. Without a
    launcher's environment nothing is set up: Shard(0, 1) and `device`."""
    if "WORLD_SIZE" not in os.environ:
        return SINGLE, device
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                timeout=TIMEOUT)
    return Shard(rank, world), device


def wrap(model: torch.nn.Module, device: torch.device,
         unread: Optional[Callable[[str], bool]] = None) -> torch.nn.Module:
    """`model` under DDP when a process group is up (`setup`), else `model`
    itself. Parameters for which `unread(name)` holds (never
    read by the forward, so never given a gradient) are left out of the
    all-reduce, which would otherwise wait for them at every step; they
    start equal on every rank, from the same seed or checkpoint, and never
    change."""
    if not dist.is_initialized():
        return model
    if unread is not None:
        ignore = [n for n, _ in model.named_parameters() if unread(n)]
        torch.nn.parallel.DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, ignore)
    ids = [device.index] if device.type == "cuda" else None
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=ids, output_device=device if ids else None)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module DDP wraps, or `model` itself."""
    return model.module if isinstance(model, torch.nn.parallel.DistributedDataParallel) else model


def all_reduce_mean(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The mean of t over the ranks (a new tensor); t itself on one rank."""
    if shard.world == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / shard.world


def barrier() -> None:
    """Wait for every rank, where a process group is up (NCCL's on this
    rank's current card)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def teardown() -> None:
    """Leave the process group, where one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
