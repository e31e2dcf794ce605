"""Multi-process parallelism: torch.distributed, DDP and the spatial axis.

Counterpart of noisediff_tpu/parallel/mesh.py's data and spatial axes. The
reference's whole distributed story is NCCL DDP (SURVEY.md §2.7:
`init_dist` train_diffusion.py:18-25, DDP modules.py:79, DistIterSampler
data_sampler.py:12-62); the JAX package expresses it as a mesh over the
batch axis, this package as the reference does: one process per card, the
launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR /
MASTER_PORT, as `torchrun` sets them), a process group (NCCL on the card,
gloo on the CPU; the backend is an argument, so a caller may run gloo over
CUDA tensors), DDP's gradient all-reduce, and each rank's rows of the
global batch (`Shard`).

The spatial axis (the JAX `data_sharding(spatial=True)` and `activate`):
the same process group splits one frame's height into contiguous row
ranges (`SpatialShard`, each a multiple of 8 rows, the UNet's /8). Under
`activate(shard)` the model's blocks see this rank's rows: every conv
wider than 1x1 exchanges its halo rows with the neighbouring ranks
(`halo_rows`), every GroupNorm all-reduces its statistics over the ranks
(`all_reduce_sum`), and `gather_rows` puts the frame together on rank 0.
XLA inserts these collectives for the JAX package; here they are written
out. Forward only: the sharded backward is not ported (ROADMAP.md, Queue 1
item 2).

JAX functions without a counterpart here, and why:
  put_replicated, shard_batch  DDP broadcasts rank 0's parameters when it
                     wraps the model, and each rank loads and uploads its
                     own rows of the batch (data/sampler.ShardedIterSampler)
  make_mesh, replicated, data_sharding  the process group is the data axis
                     and, under `activate`, the spatial axis
  param_sharding_rules  the model axis (wide layers' output channels over
                     the cards) is not ported (ROADMAP.md, Queue 1 item 2)
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# the spatial axis: one frame's rows over the ranks
# ---------------------------------------------------------------------------

# every shard holds a multiple of this many rows: the UNet's downsampling
# factor, so each of its stages splits the frame at whole rows, and every
# shard starts on an even row at each stride-2 Downsample
ROW_MULTIPLE = 8


def split_rows(height: int, world: int) -> List[int]:
    """The rows of each of `world` contiguous shards of `height` rows: each
    a multiple of ROW_MULTIPLE, the larger ones first, differing by at most
    ROW_MULTIPLE (1424 over 4: 360, 360, 352, 352). Raises where height is
    not a multiple of ROW_MULTIPLE or a shard would be empty."""
    if world < 1 or height < 1 or height % ROW_MULTIPLE:
        raise ValueError(f"a frame of {height} rows does not split over {world} ranks: its "
                         f"height must be a positive multiple of {ROW_MULTIPLE}")
    units = height // ROW_MULTIPLE
    if units < world:
        raise ValueError(f"{height} rows over {world} ranks would leave a shard empty (at most "
                         f"{units} shards of {ROW_MULTIPLE} rows)")
    base, extra = divmod(units, world)
    return [ROW_MULTIPLE * (base + (r < extra)) for r in range(world)]


@dataclass(frozen=True)
class SpatialShard:
    """Rank `rank` of `world` holds rows [r0, r1) (`bounds`) of a frame of
    `height` rows (`split_rows`). Random draws over the frame are made for
    the whole frame from a generator seeded alike on every rank, and each
    rank keeps its rows (`rows`), the rule `Shard.rows` follows for
    batches: world n draws what one process draws."""

    rank: int
    world: int
    height: int

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is not one of {self.world}")
        split_rows(self.height, self.world)

    @property
    def bounds(self) -> Tuple[int, int]:
        sizes = split_rows(self.height, self.world)
        r0 = sum(sizes[:self.rank])
        return r0, r0 + sizes[self.rank]

    def sizes(self, rows: int) -> List[int]:
        """Every rank's rows of a map of which this rank holds `rows`."""
        r0, r1 = self.bounds
        return [n * rows // (r1 - r0) for n in split_rows(self.height, self.world)]

    def at_scale(self, rows: int) -> Tuple[int, int]:
        """(this rank's first row, the frame's rows) of a map of which this
        rank holds `rows` rows: a stage at 1 / f of the frame's height holds
        1 / f of each shard (every shard a multiple of the UNet's /8)."""
        r0, r1 = self.bounds
        n = r1 - r0
        if (rows * r0) % n or (rows * self.height) % n:
            raise ValueError(f"a map of {rows} rows is not this shard's rows [{r0}, {r1}) of "
                             f"{self.height} at any scale")
        return rows * r0 // n, rows * self.height // n

    def rows(self, x, dim: int = 1):
        """This rank's rows of x (a tensor or a numpy array), a map of the
        whole frame along `dim`."""
        r0, r1 = self.bounds
        if x.shape[dim] != self.height:
            raise ValueError(f"rows of a map of {x.shape[dim]} rows, not the frame's "
                             f"{self.height}")
        return x[(slice(None),) * dim + (slice(r0, r1),)]


_SPATIAL: contextvars.ContextVar = contextvars.ContextVar("spatial_shard", default=None)


@contextlib.contextmanager
def activate(shard: Optional[SpatialShard]):
    """`with activate(shard):` the model's blocks see `shard`'s rows of a
    frame (the JAX `activate(mesh)`); a no-op where shard is None or of
    world 1, so a one-process forward is exactly what it is without it."""
    if shard is None or shard.world == 1:
        yield
        return
    token = _SPATIAL.set(shard)
    try:
        yield
    finally:
        _SPATIAL.reset(token)


def spatial() -> Optional[SpatialShard]:
    """The active SpatialShard (`activate`), or None. Raises where autograd
    is on: the sharded forward exchanges rows no backward sends back (the
    halo's adjoint and GroupNorm's gradient sums across shards are not
    ported: ROADMAP.md, Queue 1 item 2)."""
    shard = _SPATIAL.get()
    if shard is not None and torch.is_grad_enabled():
        raise NotImplementedError(
            "the spatially sharded model runs forward only (torch.no_grad or "
            "torch.inference_mode): its backward is not ported (ROADMAP.md, Queue 1 item 2)")
    return shard


def spatial_shard(height: int) -> Optional[SpatialShard]:
    """The SpatialShard of this process for a frame of `height` rows when a
    process group of world > 1 is up (`setup`), else None."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return SpatialShard(dist.get_rank(), dist.get_world_size(), height)


def _wire_device(t: torch.Tensor) -> torch.device:
    """Where the backend takes t's data: gloo's point-to-point ops take CPU
    tensors only, so a CUDA tensor goes through the host there (ranks that
    share one card); NCCL sends from the card."""
    if t.device.type == "cuda" and dist.get_backend() != "nccl":
        return torch.device("cpu")
    return t.device


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous, where the backend takes it (`_wire_device`)."""
    return t.to(_wire_device(t)).contiguous()


def _exchange(ops) -> None:
    """Run point-to-point ops [(send or recv, tensor, peer)] as one batch."""
    if ops:
        p2p = [dist.P2POp(dist.isend if send else dist.irecv, t, peer) for send, t, peer in ops]
        for req in dist.batch_isend_irecv(p2p):
            req.wait()


# the profiler spans of the spatial axis's collectives (their count and
# host time, waits included, in a torch.profiler trace)
HALO_SPAN = "nd::halo_rows"
GN_SPAN = "nd::gn_all_reduce"


def halo_rows(x: torch.Tensor, k: int, shard: SpatialShard) -> torch.Tensor:
    """x: this rank's rows of a map, (B, C, h, W) channels-last. Returns
    (B, C, h + 2k, W): k rows of the rank above, x, k rows of the rank
    below; zero rows at the frame's own top and bottom, where a SAME conv
    pads. Only the 2k rows cross between ranks."""
    b, c, h, w = x.shape
    if k > h:
        raise ValueError(f"a halo of {k} rows needs shards of at least {k} rows, this one "
                         f"has {h}")
    with torch.profiler.record_function(HALO_SPAN):
        xh = x.permute(0, 2, 3, 1)  # the (B, h, W, C) memory of a channels-last map
        ops, recv = [], {}
        for peer, mine in ((shard.rank - 1, xh[:, :k]), (shard.rank + 1, xh[:, h - k:])):
            if 0 <= peer < shard.world:
                send = _wire(mine)
                recv[peer] = torch.empty_like(send)
                ops += [(True, send, peer), (False, recv[peer], peer)]
        _exchange(ops)

        def edge(peer):
            if peer in recv:
                return recv[peer].to(x.device)
            return x.new_zeros((b, k, w, c))

        out = torch.cat([edge(shard.rank - 1), xh, edge(shard.rank + 1)], dim=1)
    return out.permute(0, 3, 1, 2)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks (a new tensor on t's device; every rank
    gets the same bits)."""
    with torch.profiler.record_function(GN_SPAN):
        out = _wire(t).clone()
        dist.all_reduce(out)
        return out.to(t.device)


def gather_rows(x: torch.Tensor, shard: SpatialShard, dim: int = 1) -> Optional[torch.Tensor]:
    """On rank 0, the whole map: every rank's rows of x along `dim`, in
    rank order (on x's device); None on the other ranks."""
    if shard.rank != 0:
        _exchange([(True, _wire(x), 0)])
        return None
    parts = [x]
    for peer, n in enumerate(shard.sizes(x.shape[dim])[1:], start=1):
        shape = list(x.shape)
        shape[dim] = n
        parts.append(torch.empty(shape, dtype=x.dtype, device=_wire_device(x)))
    _exchange([(False, p, peer) for peer, p in enumerate(parts[1:], start=1)])
    return torch.cat([p.to(x.device) for p in parts], dim=dim)
