"""Multi-process parallelism: torch.distributed, DDP, and the JAX mesh's
data x spatial x model axes.

Counterpart of noisediff_tpu/parallel/mesh.py. The reference's whole
distributed story is NCCL DDP (SURVEY.md §2.7: `init_dist`
train_diffusion.py:18-25, DDP modules.py:79, DistIterSampler
data_sampler.py:12-62); the JAX package expresses it as a device mesh whose
collectives XLA inserts, this package as the reference does: one process
per card, the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR / MASTER_PORT, as `torchrun` sets them), a process group (NCCL
on the card, gloo on the CPU; the backend is an argument, so a caller may
run gloo over CUDA tensors), DDP's gradient all-reduce, and each rank's
rows of the global batch (`Shard`). The collectives are written out here.

The grid (`make_mesh`, the JAX `make_mesh`): the processes laid out
row-major over (data, spatial, model), one process group for every line of
each axis and one over data x spatial at each model coordinate (the
replica group, which DDP reduces over).

  data     each rank holds its rows of the global batch (`Shard`).
  spatial  the ranks of a spatial line split one frame's height into
           contiguous row ranges (`SpatialShard`, each a multiple of 8
           rows, the UNet's /8). Under `activate(shard)` the model's blocks
           see this rank's rows: every conv wider than 1x1 exchanges its
           halo rows with the neighbouring ranks (`halo_rows`), every
           GroupNorm all-reduces its statistics over the line
           (`all_reduce_sum`), and `gather_rows` puts the frame together on
           the line's first rank. Each collective is differentiable: the
           halo's backward sends the borrowed rows' gradient back to their
           owner, the all-reduce's all-reduces the gradient.
  model    the wide layers' output channels (`param_sharding_rules`, the
           JAX rule) are split over a model line (`ModelShard`,
           `shard_parameters`): a rank stores, and its optimizer updates,
           only its block of each. A conv or Linear computes its own output
           channels and all-gathers them (`tp_output`), and sums its
           input's gradient over the line (`tp_input`); where a kernel reads
           a whole weight, the weight is all-gathered (`tp_weight`). The
           whole parameters' gradients are averaged over the line
           (`average_replicated_grads`), so its ranks' copies stay equal.
           `gather_params` puts the parameters (or gradients) together.

A world without a grid (`setup` alone) is the grid {data: world} for
training and {spatial: world} for `generate_full_frame` (`spatial_shard`).

JAX functions without a counterpart here, and why:
  put_replicated, shard_batch  DDP broadcasts the replica group's first
                     rank's parameters when it wraps the model, and each
                     rank loads and uploads its own rows of the batch
                     (data/sampler.ShardedIterSampler, `Grid.local`)
  replicated, data_sharding  a tensor is on one process; `Grid.local`
                     takes its rows
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class Shard:
    """This process's rows of the global batch: rank `rank` of `world`
    holds rows [rank * b, (rank + 1) * b) of a global batch of world * b.
    `group` is the process group of the data axis (None: the whole world).

    Random draws over a batch are made at the global batch's size from a
    generator seeded alike on every rank, and each rank keeps its rows
    (`rows`), so a step on `world` ranks draws what one process draws for
    the concatenated batch."""

    rank: int = 0
    world: int = 1
    group: Any = field(default=None, compare=False)

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
         unread: Optional[Callable[[str], bool]] = None, group: Any = None) -> torch.nn.Module:
    """`model` under DDP over `group` (None: the whole world; on a grid its
    replica group, `Grid.replica_group`) when a process group is up
    (`setup`), else `model` itself. Parameters for which `unread(name)`
    holds (never read by the forward, so never given a gradient) are left
    out of the all-reduce, which would otherwise wait for them at every
    step; they start equal on every rank, from the same seed or checkpoint,
    and never change."""
    if not dist.is_initialized():
        return model
    if unread is not None:
        ignore = [n for n, _ in model.named_parameters() if unread(n)]
        torch.nn.parallel.DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, ignore)
    ids = [device.index] if device.type == "cuda" else None
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=ids, output_device=device if ids else None, process_group=group)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module DDP wraps, or `model` itself."""
    return model.module if isinstance(model, torch.nn.parallel.DistributedDataParallel) else model


def all_reduce_mean(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The mean of t over the shard's ranks (a new tensor); t itself on one
    rank."""
    if shard.world == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=shard.group)
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
# the grid: data x spatial x model over the processes
# ---------------------------------------------------------------------------

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS)


def mesh_shape(axis_sizes: Optional[Mapping[str, int]], n: int) -> Dict[str, int]:
    """{data, spatial, model: size} of a grid of n processes from an
    ordered {axis: size} dict, the JAX `make_mesh` rule (mesh.py:55-73 of
    the JAX package): one size of -1 is inferred, and the sizes must
    multiply to n (ValueError otherwise); an axis left out has size 1; None
    is {data: n}. The axes come in the JAX package's order, data outermost,
    model innermost."""
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: n}
    names = list(axis_sizes)
    if any(a not in AXES for a in names) or names != sorted(names, key=AXES.index):
        raise ValueError(f"mesh axes {names} are not an ordered subset of {AXES}")
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1 or any(s < 1 and s != -1 for s in sizes):
        raise ValueError(f"mesh {dict(axis_sizes)}: each size is positive, at most one -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    sizes = [n // known if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} processes")
    return {a: dict(zip(names, sizes)).get(a, 1) for a in AXES}


def _rank_grid(shape: Mapping[str, int]) -> np.ndarray:
    """The ranks laid out as the JAX package lays out its devices
    (`np.asarray(devices).reshape(sizes)`): row-major over AXES."""
    return np.arange(int(np.prod([shape[a] for a in AXES]))).reshape([shape[a] for a in AXES])


def grid_coords(shape: Mapping[str, int], rank: int) -> Dict[str, int]:
    """{axis: rank's coordinate} on a grid of `shape` (`mesh_shape`)."""
    return dict(zip(AXES, (int(i) for i in np.argwhere(_rank_grid(shape) == rank)[0])))


def axis_lines(shape: Mapping[str, int], axis: str) -> List[List[int]]:
    """Every line of ranks along `axis` (the other coordinates fixed), in
    order: the process groups of that axis."""
    i = AXES.index(axis)
    return np.moveaxis(_rank_grid(shape), i, -1).reshape(-1, shape[axis]).tolist()


def replica_lines(shape: Mapping[str, int]) -> List[List[int]]:
    """The ranks at each model coordinate, over data x spatial: the groups
    DDP reduces each parameter (or this rank's block of it) over."""
    return np.moveaxis(_rank_grid(shape), -1, 0).reshape(shape[MODEL_AXIS], -1).tolist()


@dataclass(frozen=True)
class ModelShard:
    """Rank `rank` of the `world` ranks of a model line (over `group`): it
    holds block `rank` of the output channels of every sharded parameter,
    as the JAX NamedSharding P(..., 'model') places blocks on devices."""

    rank: int
    world: int
    group: Any = field(default=None, compare=False)


class Grid:
    """This process's place on the grid (`make_mesh`): `shape` {axis:
    size}, `coords` {axis: coordinate}, and the process groups of its lines
    (`groups`, by axis) and of its replica group."""

    def __init__(self, shape: Mapping[str, int], rank: int, groups=None, replica_group=None):
        self.shape = dict(shape)
        self.rank = rank
        self.coords = grid_coords(self.shape, rank)
        self.groups = dict(groups or {})
        self.replica_group = replica_group

    @property
    def data(self) -> Shard:
        """This rank's rows of the global batch, over its data line."""
        return Shard(self.coords[DATA_AXIS], self.shape[DATA_AXIS], self.groups.get(DATA_AXIS))

    @property
    def model(self) -> Optional[ModelShard]:
        """This rank's block of the sharded parameters; None on a model axis
        of 1."""
        if self.shape[MODEL_AXIS] == 1:
            return None
        return ModelShard(self.coords[MODEL_AXIS], self.shape[MODEL_AXIS],
                          self.groups.get(MODEL_AXIS))

    def spatial(self, height: int) -> Optional[SpatialShard]:
        """This rank's rows of a frame of `height` rows over its spatial
        line; None on a spatial axis of 1."""
        if self.shape[SPATIAL_AXIS] == 1:
            return None
        return SpatialShard(self.coords[SPATIAL_AXIS], self.shape[SPATIAL_AXIS], height,
                            self.groups.get(SPATIAL_AXIS))

    def local(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """This rank's part of a global batch (the JAX
        `shard_batch(spatial=True)`): its rows (data) of every entry, and
        its rows of the frame (spatial) of every (B, H, W, C) map."""
        out = {}
        for k, v in batch.items():
            v = self.data.rows(v)
            shard = self.spatial(v.shape[1]) if v.ndim == 4 else None
            out[k] = v if shard is None else shard.rows(v)
        return out


def make_mesh(axis_sizes: Optional[Mapping[str, int]] = None) -> Grid:
    """The grid of the process group (`setup`; one process without one):
    `mesh_shape(axis_sizes, world)`, with a process group for every line of
    each axis and every replica line. Every rank creates every group, in
    one order (`dist.new_group` is collective), and keeps its own."""
    if not dist.is_initialized():
        return Grid(mesh_shape(axis_sizes, 1), 0)
    rank = dist.get_rank()
    shape = mesh_shape(axis_sizes, dist.get_world_size())
    groups, replica = {}, None
    for axis in AXES:
        for line in axis_lines(shape, axis):
            g = dist.new_group(line)
            if rank in line:
                groups[axis] = g
    for line in replica_lines(shape):
        g = dist.new_group(line)
        if rank in line:
            replica = g
    return Grid(shape, rank, groups, replica)


# ---------------------------------------------------------------------------
# the wire: where each backend takes a tensor, and the raw collectives
# ---------------------------------------------------------------------------

def _wire_device(t: torch.Tensor) -> torch.device:
    """Where the backend takes t's data: gloo's collectives here take CPU
    tensors, so a CUDA tensor goes through the host there (ranks that
    share one card); NCCL sends from the card."""
    if t.device.type == "cuda" and dist.get_backend() != "nccl":
        return torch.device("cpu")
    return t.device


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous, where the backend takes it (`_wire_device`)."""
    return t.to(_wire_device(t)).contiguous()


def _exchange(ops, group=None) -> None:
    """Run point-to-point ops [(send or recv, tensor, global peer)] over
    `group` as one batch."""
    if ops:
        p2p = [dist.P2POp(dist.isend if send else dist.irecv, t, peer, group=group)
               for send, t, peer in ops]
        for req in dist.batch_isend_irecv(p2p):
            req.wait()


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over `group` (a new tensor on t's device; every rank
    gets the same bits)."""
    out = _wire(t).clone()
    dist.all_reduce(out, group=group)
    return out.to(t.device)


def _gather(t: torch.Tensor, tp: ModelShard, dim: int) -> torch.Tensor:
    """Every model rank's t (one shape on all), in rank order along `dim`."""
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(tp.world)]
    dist.all_gather(parts, w, group=tp.group)
    return torch.cat(parts, dim=dim).to(t.device)


# the profiler spans of the collectives (their count and host time, waits
# included, in a torch.profiler trace; each on both directions)
HALO_SPAN = "nd::halo_rows"
GN_SPAN = "nd::gn_all_reduce"
LOSS_SPAN = "nd::loss_all_reduce"
TP_GATHER_SPAN = "nd::tp_gather"
TP_REDUCE_SPAN = "nd::tp_reduce"
INT8_SPAN = "nd::int8_amax"
SPANS = (HALO_SPAN, GN_SPAN, LOSS_SPAN, TP_GATHER_SPAN, TP_REDUCE_SPAN, INT8_SPAN)


# ---------------------------------------------------------------------------
# the spatial axis: one frame's rows over the ranks of a spatial line
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
    `height` rows (`split_rows`); its collectives run over `group` (None:
    the whole world, whose ranks are then the line's). Random draws over
    the frame are made for the whole frame from a generator seeded alike on
    every rank, and each rank keeps its rows (`rows`), the rule
    `Shard.rows` follows for batches: world n draws what one process
    draws."""

    rank: int
    world: int
    height: int
    group: Any = field(default=None, compare=False)

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is not one of {self.world}")
        split_rows(self.height, self.world)

    @property
    def bounds(self) -> Tuple[int, int]:
        sizes = split_rows(self.height, self.world)
        r0 = sum(sizes[:self.rank])
        return r0, r0 + sizes[self.rank]

    def peer(self, r: int) -> int:
        """The global rank of rank r of this shard's line."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

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
    world 1, so a one-process forward is exactly what it is without it.
    The backward needs no context: each collective keeps its shard."""
    if shard is None or shard.world == 1:
        yield
        return
    token = _SPATIAL.set(shard)
    try:
        yield
    finally:
        _SPATIAL.reset(token)


def spatial() -> Optional[SpatialShard]:
    """The active SpatialShard (`activate`), or None."""
    return _SPATIAL.get()


def spatial_shard(height: int) -> Optional[SpatialShard]:
    """The SpatialShard of this process for a frame of `height` rows when a
    process group of world > 1 is up (`setup`), else None: the grid
    {spatial: world}, over the whole world."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return SpatialShard(dist.get_rank(), dist.get_world_size(), height)


def _swap_edges(top: torch.Tensor, bottom: torch.Tensor, shard: SpatialShard):
    """Send `top` to the rank above and `bottom` to the rank below (each
    (B, k, W, C)), as one batch; returns what they sent here (from above,
    from below), None at the frame's own top or bottom."""
    ops, recv = [], {}
    for d, mine in ((-1, top), (1, bottom)):
        if 0 <= shard.rank + d < shard.world:
            send = _wire(mine)
            recv[d] = torch.empty_like(send)
            peer = shard.peer(shard.rank + d)
            ops += [(True, send, peer), (False, recv[d], peer)]
    _exchange(ops, shard.group)
    return tuple(recv[d].to(top.device) if d in recv else None for d in (-1, 1))


class _HaloRows(torch.autograd.Function):
    """halo_rows and its adjoint. Forward: (B, h, W, C) rows of a map ->
    (B, h + 2k, W, C), k rows of the rank above, the rows, k of the rank
    below (zeros at the frame's top and bottom). Backward: the gradient of
    the k borrowed rows goes back to the rank that lent them and is added
    into its k edge rows; the zero rows' gradient is dropped."""

    @staticmethod
    def forward(ctx, xh, k: int, shard: SpatialShard):
        ctx.k, ctx.shard = k, shard
        b, h, w, c = xh.shape
        with torch.profiler.record_function(HALO_SPAN):
            above, below = _swap_edges(xh[:, :k], xh[:, h - k:], shard)
            zeros = xh.new_zeros((b, k, w, c))
            return torch.cat([zeros if above is None else above, xh,
                              zeros if below is None else below], dim=1)

    @staticmethod
    def backward(ctx, g):
        k = ctx.k
        h = g.shape[1] - 2 * k
        with torch.profiler.record_function(HALO_SPAN):
            above, below = _swap_edges(g[:, :k], g[:, k + h:], ctx.shard)
            dx = g[:, k:k + h].clone()
            if above is not None:
                dx[:, :k] += above
            if below is not None:
                dx[:, h - k:] += below
        return dx, None, None


def halo_rows(x: torch.Tensor, k: int, shard: SpatialShard) -> torch.Tensor:
    """x: this rank's rows of a map, (B, C, h, W) channels-last. Returns
    (B, C, h + 2k, W): k rows of the rank above, x, k rows of the rank
    below; zero rows at the frame's own top and bottom, where a SAME conv
    pads. Only the 2k rows cross between ranks, in the forward and (their
    gradient) in the backward."""
    if k > x.shape[2]:
        raise ValueError(f"a halo of {k} rows needs shards of at least {k} rows, this one "
                         f"has {x.shape[2]}")
    # the (B, h, W, C) memory of a channels-last map
    return _HaloRows.apply(x.permute(0, 2, 3, 1), k, shard).permute(0, 3, 1, 2)


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks; its adjoint is the same sum of the
    gradients (every rank's output reads every rank's input)."""

    @staticmethod
    def forward(ctx, t, group, span: str):
        ctx.group, ctx.span = group, span
        with torch.profiler.record_function(span):
            return _reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(ctx.span):
            return _reduce(g, ctx.group), None, None


def all_reduce_sum(t: torch.Tensor, group: Any = None, span: str = GN_SPAN) -> torch.Tensor:
    """The sum of t over `group`'s ranks (None: the whole world), a new
    tensor on t's device; every rank gets the same bits. Differentiable:
    the gradient is all-reduced over the same group. `span` names the
    profiler span (GroupNorm's statistics by default)."""
    return _AllReduceSum.apply(t, group, span)


def all_reduce_max(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The maximum of t over `group`'s ranks (None: the whole world), a new
    tensor on t's device. Not differentiable: it serves the int8 route's
    activation scale, which is inference only."""
    with torch.profiler.record_function(INT8_SPAN):
        out = _wire(t).clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        return out.to(t.device)


def gather_rows(x: torch.Tensor, shard: SpatialShard, dim: int = 1) -> Optional[torch.Tensor]:
    """On the line's first rank, the whole map: every rank's rows of x
    along `dim`, in rank order (on x's device); None on the other ranks."""
    if shard.rank != 0:
        _exchange([(True, _wire(x), shard.peer(0))], shard.group)
        return None
    parts = [x]
    for n in shard.sizes(x.shape[dim])[1:]:
        shape = list(x.shape)
        shape[dim] = n
        parts.append(torch.empty(shape, dtype=x.dtype, device=_wire_device(x)))
    _exchange([(False, p, shard.peer(r)) for r, p in enumerate(parts[1:], start=1)],
              shard.group)
    return torch.cat([p.to(x.device) for p in parts], dim=dim)


# ---------------------------------------------------------------------------
# the model axis: the wide layers' output channels over a model line
# ---------------------------------------------------------------------------

# narrow layers stay whole: the all-gather would cost more than the
# products it splits (the JAX _TP_MIN_WIDTH)
TP_MIN_WIDTH = 128


def _out_dim(module: torch.nn.Module, name: str) -> Optional[int]:
    """The dim of `module`'s parameter `name` that holds the last dim of
    its flax leaf, where that leaf has two dims or more (the JAX rule
    shards the last): dim 0 of a conv or Linear weight (OIHW, (out, in)),
    dim 1 of a transposed conv's (in, out, kh, kw) and of an embedding's
    (vocab, features); None for the rest (biases, norm parameters,
    RMSNorm's g, a flax (C,) vector)."""
    if name != "weight":
        return None
    if isinstance(module, (torch.nn.ConvTranspose2d, torch.nn.Embedding)):
        return 1
    if isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
        return 0
    return None


def param_sharding_rules(mesh, model: torch.nn.Module,
                         min_width: int = TP_MIN_WIDTH) -> Dict[str, Optional[int]]:
    """{parameter name: the dim split over the model axis, or None} for
    `model` on `mesh` (a Grid or an {axis: size} dict): the JAX
    `param_sharding_rules` (mesh.py:141-157) in the torch layout. A
    parameter is split where the model axis has more than one rank, its
    flax leaf has two dims or more, and its output channels (`_out_dim`)
    number at least min_width and divide by the model axis's size."""
    size = dict(getattr(mesh, "shape", mesh)).get(MODEL_AXIS, 1)
    out = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            dim = _out_dim(module, pname) if size > 1 else None
            if dim is not None and (p.shape[dim] < min_width or p.shape[dim] % size):
                dim = None
            out[f"{mname}.{pname}" if mname else pname] = dim
    return out


def model_shard_of(p: torch.Tensor) -> Optional[ModelShard]:
    """The ModelShard whose block parameter p holds (`shard_parameters`),
    or None for a whole parameter."""
    return getattr(p, "model_shard", None)


def shard_parameters(model: torch.nn.Module, tp: Optional[ModelShard],
                     min_width: int = TP_MIN_WIDTH) -> Dict[str, Optional[int]]:
    """Keep only this rank's block of every parameter that
    `param_sharding_rules` splits (the output channels [rank * n, (rank +
    1) * n)), before the optimizer and DDP see the model; every such module
    computes with its block (its `tp`, blocks.Conv2d and blocks.Linear; a
    module without one raises). Returns the rules; nothing where tp is
    None."""
    if tp is None:
        return {}
    rules = param_sharding_rules({MODEL_AXIS: tp.world}, model, min_width)
    for mname, module in model.named_modules():
        for pname, p in list(module.named_parameters(recurse=False)):
            name = f"{mname}.{pname}" if mname else pname
            if rules[name] is None:
                continue
            if rules[name] != 0 or not hasattr(module, "tp"):
                raise NotImplementedError(
                    f"{name}: the model axis splits it, and {type(module).__name__} has no "
                    "computation over a block of its output channels")
            n = p.shape[0] // tp.world
            part = torch.nn.Parameter(p.detach()[tp.rank * n:(tp.rank + 1) * n].clone(),
                                      requires_grad=p.requires_grad)
            part.model_shard = tp
            setattr(module, pname, part)
            module.tp = tp
    return rules


def gather_params(model: torch.nn.Module, grads: bool = False) -> Dict[str, Any]:
    """The whole model's state dict (what `np.asarray` of a global JAX
    array gives): every sharded parameter's blocks gathered over its model
    line; with grads, each parameter's gradient instead (None where it has
    none). Collective over the model lines: every rank calls it."""
    model = unwrap(model)
    out = {} if grads else dict(model.state_dict())
    for name, p in model.named_parameters():
        t = p.grad if grads else p.detach()
        tp = model_shard_of(p)
        out[name] = t if t is None or tp is None else _gather(t.contiguous(), tp, 0)
    return out


def average_replicated_grads(params, tp: Optional[ModelShard]) -> None:
    """Average the gradients of the whole (unsplit) parameters over the
    model line, in place, as one all-reduce. Every model rank computes
    them from the same values, so the mean is each rank's own gradient;
    but a card's kernels need not give the same bits twice (cuDNN picks
    its algorithms per process), and replicas that drift apart would stop
    being one model. A no-op where tp is None."""
    if tp is None:
        return
    grads = [p.grad for p in params if p.grad is not None and model_shard_of(p) is None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    with torch.profiler.record_function(TP_REDUCE_SPAN):
        flat = _reduce(flat, tp.group) / tp.world
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


class _TPInput(torch.autograd.Function):
    """The input of a column-parallel layer: itself; its gradient summed
    over the model line (each rank's layer sees only its channels' share of
    it)."""

    @staticmethod
    def forward(ctx, x, tp: ModelShard):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(TP_REDUCE_SPAN):
            return _reduce(g, ctx.tp.group), None


class _TPOutput(torch.autograd.Function):
    """Every model rank's output channels along the last dim of a
    contiguous tensor. The backward keeps this rank's block: every rank
    computes the same loss from the whole output, so its gradient there is
    already whole."""

    @staticmethod
    def forward(ctx, y, tp: ModelShard):
        ctx.tp, ctx.n = tp, y.shape[-1]
        with torch.profiler.record_function(TP_GATHER_SPAN):
            return _gather(y, tp, -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.tp.rank * ctx.n, ctx.n).contiguous(), None


class _TPWeight(torch.autograd.Function):
    """A whole weight from every model rank's block along dim 0; the
    backward keeps this rank's block of the gradient (whole on every rank,
    as in `_TPOutput`), in the parameter's own strides."""

    @staticmethod
    def forward(ctx, w, tp: ModelShard):
        ctx.tp, ctx.n = tp, w.shape[0]
        ctx.layout = (w.shape, w.stride())
        with torch.profiler.record_function(TP_GATHER_SPAN):
            return _gather(w.contiguous(), tp, 0)

    @staticmethod
    def backward(ctx, g):
        shape, stride = ctx.layout
        out = torch.empty_strided(shape, stride, dtype=g.dtype, device=g.device)
        return out.copy_(g.narrow(0, ctx.tp.rank * ctx.n, ctx.n)), None


def tp_input(x: torch.Tensor, tp: ModelShard) -> torch.Tensor:
    """x into a column-parallel layer (`_TPInput`)."""
    return _TPInput.apply(x, tp)


def tp_output(y: torch.Tensor, tp: ModelShard, dim: int = -1) -> torch.Tensor:
    """The whole output of a column-parallel layer from this rank's
    channels y: along the last dim, or (dim 1) along C of a channels-last
    (B, C, H, W) map, returned channels-last."""
    if dim == 1 and y.ndim == 4:
        return _TPOutput.apply(y.permute(0, 2, 3, 1).contiguous(), tp).permute(0, 3, 1, 2)
    return _TPOutput.apply(y.contiguous(), tp)


def tp_weight(w: torch.Tensor, tp: Optional[ModelShard]) -> torch.Tensor:
    """The whole weight of which w is this rank's block (w itself where tp
    is None), for a kernel that reads all of it."""
    return w if tp is None else _TPWeight.apply(w, tp)
