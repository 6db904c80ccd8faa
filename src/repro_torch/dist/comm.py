"""Collectives over ``torch.distributed``: the port's stand-in for the XLA
collectives that the JAX package's ``shard_map`` bodies call.

The JAX mesh is SPMD inside one process; the port's mesh is one process a
rank, each running the same program on its own shard, with the collectives
written out. The wrappers keep the JAX semantics:

  ``all_reduce_sum`` / ``all_reduce_mean``   ``lax.psum`` / ``lax.pmean``
  ``all_gather_rows``                        ``lax.all_gather(x, axis=0,
                                             tiled=True)``: the group's
                                             blocks concatenated in rank
                                             order
  ``all_to_all``                             ``lax.all_to_all(x, axis, 0, 0,
                                             tiled=False)`` on an
                                             ``(n, cap, D)`` buffer: row
                                             block j goes to rank j, and
                                             block i of the result came
                                             from rank i
  ``broadcast``                              the value of ``src`` everywhere
  ``all_reduce_max``                         ``lax.pmax``
  ``all_gather`` / ``reduce_scatter``        ``lax.all_gather(..., axis=d,
                                             tiled=True)`` /
                                             ``lax.psum_scatter(...,
                                             scatter_dimension=d,
                                             tiled=True)``

The sharded train step's collectives carry a backward (JAX transposes
its collectives; here each is an ``autograd.Function``): ``gather`` (FSDP's
gather on use, reduce-scatter backward), ``gather_replicated`` (a gather
for compute every rank repeats whole, its backward this rank's block of
the cotangent), ``tp_enter`` / ``tp_exit`` (identity forward with an
all-reduce backward, all-reduce forward with an identity backward: the
boundaries of a tensor-parallel region), ``tp_scatter`` (a
reduce-scatter out of such a region onto the rank's block, all-gather
backward: the mLSTM's q and k onto its heads, a row-parallel product onto
the rank's rows of the sequence), ``keep_block`` (the rank's block of a
value every rank computed whole, all-gather backward), ``all_to_all`` (the
inverse exchange) and ``replicated_output`` (group rank 0's value forward;
JAX's transpose of an output declared replicated, the cotangent divided by the
group's size, backward).

Each takes the process group of a mesh axis (``launch.mesh.Mesh.group``);
``None`` is the whole world, and :data:`SELF` (the group of a mesh axis of
size 1) is this rank alone: a collective over it is the identity, as one
over a mesh axis of size 1 is in JAX.

The backend is chosen once, by :func:`init`, from the topology:

  * ``nccl`` when every rank owns a card (``cuda:{local_rank}``);
  * ``gloo`` on the CPU;
  * ``gloo`` with an explicit host transport when ranks share a card (the
    card machine's one H100 at world > 1: NCCL refuses two ranks on one
    device). A CUDA tensor is copied into a pinned host buffer, reduced by
    gloo and copied back; :attr:`Comm.staged_bytes` counts the bytes that
    crossed. The speed of collectives across cards cannot be measured
    that way.

Nothing falls back: a failed collective raises, and the backend never
changes after :func:`init`. A CPU tensor under ``nccl`` goes through the
rank's card and back (only the host-side integer counts of calibration do
that).

Each wrapper adds its result's bytes to :attr:`Comm.bytes` under its family
(``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``,
``broadcast``), the quantity JAX's dry-run reads from the HLO. Under :class:`counting` no
process group is needed: every wrapper records its family and result bytes
the same way and returns a ``meta`` tensor of the result's shape, and a
shapes-only mesh (``launch.mesh.Mesh(..., build_groups=False)``) hands out
:class:`CountedGroup` objects. That is how ``launch.op_analysis`` counts a
step's collectives.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

# a collective that waits longer than this raises instead of hanging
TIMEOUT_S = 600


@dataclass
class Comm:
    """The process group this process joined, and what crossed it."""
    backend: str                 # "nccl" | "gloo"
    transport: str               # "nccl" | "host" | "pinned-host"
    world: int
    rank: int
    device: torch.device
    staged_bytes: int = 0        # bytes copied through pinned host memory
    calls: Dict[str, int] = field(default_factory=dict)
    seconds: Dict[str, float] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)   # result bytes

    def report(self) -> Dict:
        """What a run's report carries about its collectives."""
        return {"backend": self.backend, "transport": self.transport,
                "world": self.world, "staged_bytes": self.staged_bytes,
                "calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": {k: round(v, 6) for k, v in self.seconds.items()}}


@dataclass
class Count:
    """What a step's collectives move, counted without a process group:
    calls and result bytes per family (as :class:`Comm` records them)."""
    world: int
    calls: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)

    def record(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        out = torch.empty(tuple(shape), dtype=dtype, device="meta")
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = (self.bytes.get(name, 0)
                            + out.numel() * out.element_size())
        return out


class CountedGroup:
    """A mesh axis group under :class:`counting`: its axes and size, no
    ranks behind it."""

    def __init__(self, axes, size: int):
        self.axes, self.size = tuple(axes), int(size)

    def __repr__(self) -> str:
        return f"CountedGroup({self.axes}, {self.size})"


_STATE: Dict[str, object] = {"comm": None, "count": None}


class counting:
    """Context manager: the wrappers count instead of communicating. ``world``
    is the size of the default group (``group=None``). Yields the
    :class:`Count`."""

    def __init__(self, world: int = 1):
        self.count = Count(world=int(world))

    def __enter__(self) -> Count:
        if _STATE["count"] is not None:
            raise RuntimeError("comm.counting: already counting")
        _STATE["count"] = self.count
        return self.count

    def __exit__(self, *exc):
        _STATE["count"] = None
        return False


def is_counting() -> bool:
    return _STATE["count"] is not None


def choose_backend(world: int, device: torch.device,
                   n_cards: int) -> tuple:
    """(backend, transport) for ``world`` ranks on ``device`` with
    ``n_cards`` cards in the host: NCCL only when every rank owns a
    card."""
    if device.type == "cpu":
        return "gloo", "host"
    if device.type != "cuda":
        raise ValueError(f"no collective backend for device {device}")
    if world <= n_cards:
        return "nccl", "nccl"
    return "gloo", "pinned-host"


def init(world: int, rank: int, device: DeviceLike = None, *,
         init_method: str = "env://") -> Comm:
    """Join the default process group of ``world`` ranks as ``rank`` and
    return the :class:`Comm` that the wrappers use. ``device`` is "cuda"
    (the default: raises without a card) or "cpu": under NCCL the rank
    takes ``cuda:{LOCAL_RANK}`` (``torchrun`` sets it; without it, the
    rank), otherwise every rank of the host shares ``cuda:0``.
    ``init_method`` is ``env://`` under ``torchrun``, or
    ``tcp://localhost:PORT``."""
    if _STATE["comm"] is not None or dist.is_initialized():
        raise RuntimeError("comm.init: a process group is already up")
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and n_cards == 0:
        raise RuntimeError("comm.init: device cuda asked for, no card")
    backend, transport = choose_backend(world, dev, n_cards)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    comm = Comm(backend=backend, transport=transport, world=world,
                rank=rank, device=dev)
    _STATE["comm"] = comm
    return comm


def current() -> Comm:
    """The :class:`Comm` of this process; raises before :func:`init`."""
    comm = _STATE["comm"]
    if comm is None:
        raise RuntimeError("no process group: call comm.init first")
    return comm


def is_initialized() -> bool:
    return _STATE["comm"] is not None


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    if _STATE["comm"] is not None:
        dist.destroy_process_group()
        _STATE["comm"] = None


def barrier() -> None:
    if is_counting():
        return
    comm = current()
    if comm.backend == "nccl":
        dist.barrier(device_ids=[comm.device.index])
    else:
        dist.barrier()


def group_size(group=None) -> int:
    return _size(group)


# ---------------------------------------------------------------------------
# staging: a tensor as the backend takes it, and back
# ---------------------------------------------------------------------------
def _wire(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """A contiguous copy of ``x`` where the backend reads it: pinned host
    memory for a CUDA tensor under gloo, the card for a CPU tensor under
    NCCL; otherwise a contiguous clone (the wrappers never write into
    their input)."""
    if comm.backend == "gloo" and x.is_cuda:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        comm.staged_bytes += x.numel() * x.element_size()
        return h
    if comm.backend == "nccl" and not x.is_cuda:
        return x.to(comm.device)
    return x.contiguous().clone()


def _back(y: torch.Tensor, like: torch.Tensor, comm: Comm) -> torch.Tensor:
    if y.device == like.device:
        return y
    if like.is_cuda and comm.backend == "gloo":
        comm.staged_bytes += y.numel() * y.element_size()
    return y.to(like.device)


def _empty_wire(shape, like: torch.Tensor, comm: Comm) -> torch.Tensor:
    if comm.backend == "gloo" and like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    if comm.backend == "nccl" and not like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, device=comm.device)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


class _timed:
    """Times one collective of family ``name``, adding its result's bytes
    (``nbytes``) to the family's."""

    def __init__(self, comm: Comm, name: str, nbytes: int):
        self.comm, self.name, self.nbytes = comm, name, nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        c = self.comm
        c.calls[self.name] = c.calls.get(self.name, 0) + 1
        c.seconds[self.name] = (c.seconds.get(self.name, 0.0)
                                + time.perf_counter() - self.t0)
        c.bytes[self.name] = c.bytes.get(self.name, 0) + self.nbytes
        return False


def _nbytes(shape, x: torch.Tensor) -> int:
    n = x.element_size()
    for d in shape:
        n *= int(d)
    return n


class _SelfGroup:
    """The group of a mesh axis of size 1: this rank alone. Every
    collective over it is the identity (torch has no such group)."""

    def __repr__(self) -> str:
        return "SELF"


SELF = _SelfGroup()


def _size(group) -> int:
    if group is SELF:
        return 1
    if isinstance(group, CountedGroup):
        return group.size
    if group is None and is_counting():
        return _STATE["count"].world
    return dist.get_world_size(group)


# A group of one rank that torch does hold (the world at world size 1) runs
# its collectives all the same: that is how NCCL is exercised on a host
# with one card.


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the group, on every rank."""
    if group is SELF:
        return x.clone()
    if is_counting():
        return _STATE["count"].record("all_reduce", x.shape, x.dtype)
    comm = current()
    with _timed(comm, "all_reduce", _nbytes(x.shape, x)):
        w = _wire(x, comm)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
        return _back(w, x, comm)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmean``: the sum over the group divided by its size."""
    return all_reduce_sum(x, group) / _size(group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather(x, axis=0, tiled=True)``: every rank's ``x``
    concatenated along dim 0 in group-rank order."""
    if group is SELF:
        return x.clone()
    n = _size(group)
    shape = (n * x.shape[0],) + tuple(x.shape[1:])
    if is_counting():
        return _STATE["count"].record("all_gather", shape, x.dtype)
    comm = current()
    with _timed(comm, "all_gather", _nbytes(shape, x)):
        w = _wire(x, comm)
        out = _empty_wire(shape, x, comm)
        dist.all_gather_into_tensor(out, w, group=group)
        return _back(out, x, comm)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not the "
                         f"group's size {n}")
    if group is SELF:
        return x.clone()
    if is_counting():
        return _STATE["count"].record("all_to_all", x.shape, x.dtype)
    comm = current()
    with _timed(comm, "all_to_all", _nbytes(x.shape, x)):
        w = _wire(x, comm)
        out = _empty_wire(tuple(x.shape), x, comm)
        dist.all_to_all_single(out, w, group=group)
        return _back(out, x, comm)


class _AllToAll(torch.autograd.Function):
    """The exchange is its own inverse: block i of the cotangent goes back
    to rank i (``lax.all_to_all``'s transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)`` on ``x (n, cap,
    ...)``, n the group's size: block j of ``x`` goes to rank j, and block
    i of the result is what rank i sent here. Differentiable: the backward
    sends each cotangent block back where its row came from."""
    return _AllToAll.apply(x, group)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """The value that group rank ``src`` holds, on every rank of the
    group (``x`` gives the shape and dtype on the others)."""
    if group is SELF:
        return x.clone()
    if is_counting():
        return _STATE["count"].record("broadcast", x.shape, x.dtype)
    comm = current()
    with _timed(comm, "broadcast", _nbytes(x.shape, x)):
        w = _wire(x, comm)
        gsrc = (src if group is None
                else dist.get_global_rank(group, src))
        dist.broadcast(w, src=gsrc, group=group)
        return _back(w, x, comm)


def gather_rows_to_host(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``x`` as CPU tensors, in group-rank order, moving one
    rank's block at a time: a rank never holds more than one block beyond
    its own on the device (the sharded Gram's row blocks at flush)."""
    if group is SELF:
        return [x.cpu()]
    n = _size(group)
    me = dist.get_rank(group)
    out = []
    for src in range(n):
        buf = x if src == me else torch.empty_like(x)
        out.append(broadcast(buf, src=src, group=group).cpu())
    return out


def all_reduce_ints(values: List[int], group=None) -> List[int]:
    """Host integers summed over the group (row counts)."""
    t = torch.tensor(values, dtype=torch.int64)
    return [int(v) for v in all_reduce_sum(t, group).tolist()]


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmax``: the elementwise max of ``x`` over the group (no
    gradient)."""
    if group is SELF:
        return x.clone()
    if is_counting():
        return _STATE["count"].record("all_reduce", x.shape, x.dtype)
    comm = current()
    with _timed(comm, "all_reduce", _nbytes(x.shape, x)):
        w = _wire(x.detach(), comm)
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=group)
        return _back(w, x, comm)


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``lax.all_gather(x, axis_name, axis=dim, tiled=True)``: the group's
    blocks concatenated along ``dim`` in group-rank order (no gradient:
    see :func:`gather`)."""
    if group is SELF:
        return x.clone()
    return all_gather_rows(x.movedim(dim, 0).contiguous(),
                           group).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``lax.psum_scatter(x, axis_name, scatter_dimension=dim,
    tiled=True)``: the sum of ``x`` over the group, of which each rank
    keeps its block along ``dim`` (block i on group rank i)."""
    if group is SELF:
        return x.clone()
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    xt = x.movedim(dim, 0)
    shape = (xt.shape[0] // n,) + tuple(xt.shape[1:])
    if is_counting():
        return _STATE["count"].record("reduce_scatter", shape,
                                      x.dtype).movedim(0, dim)
    comm = current()
    with _timed(comm, "reduce_scatter", _nbytes(shape, x)):
        w = _wire(xt.contiguous(), comm)
        out = _empty_wire(shape, x, comm)
        dist.reduce_scatter(out, list(w.chunk(n)), op=dist.ReduceOp.SUM,
                            group=group)
        return _back(out, x, comm).movedim(0, dim)


# ---------------------------------------------------------------------------
# collectives with a backward: the sharded train step's (``dist.sharding.
# Placement``). Each counts as the wrapper it runs; a backward's collective
# counts when the backward runs it.
# ---------------------------------------------------------------------------
class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """FSDP's gather on use: the group's blocks of a parameter along
    ``dim``; the backward reduce-scatters (sums) the full cotangent back to
    this rank's block, the transpose of ``lax.all_gather``. Every rank of
    the group computes its own share of the loss through the whole tensor,
    so the sum is the gradient of the group's loss."""
    if group is SELF:
        return x
    return _Gather.apply(x, dim, group)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), \
            None, None, None


def gather_replicated(x: torch.Tensor, dim: int, group,
                      index: int) -> torch.Tensor:
    """The group's blocks along ``dim`` for a computation that every rank
    of the group then repeats whole (the same inputs, the same cotangent):
    each rank already holds the whole gradient, so the backward keeps
    block ``index`` (this rank's position in the group) and moves
    nothing."""
    if group is SELF:
        return x
    return _GatherReplicated.apply(x, dim, group, index)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Into a tensor-parallel region over ``group``: the identity forward,
    an all-reduce (sum) backward. A replicated tensor that each rank uses
    for its own share only (its heads, its columns, its experts) gets each
    rank's part of the gradient, and the sum is the whole."""
    if group is SELF:
        return x
    return _Enter.apply(x, group)


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_exit(x: torch.Tensor, group) -> torch.Tensor:
    """Out of a tensor-parallel region over ``group``: the all-reduce (sum)
    of the ranks' partial results forward (a row-parallel product, a
    vocab-parallel sum), the identity backward (every rank holds the same
    cotangent of the replicated sum)."""
    if group is SELF:
        return x
    return _Exit.apply(x, group)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


def tp_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Out of a tensor-parallel region onto this rank's block: the ranks'
    partial results summed and split along ``dim`` (a row-parallel product
    whose output columns the rank then computes on alone), the transpose of
    :func:`gather`: the backward all-gathers the blocks' cotangents, each
    rank's the whole gradient of its partial result."""
    if group is SELF:
        return x
    return _Scatter.apply(x, dim, group)


class _Keep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // _size(group)
        return x.narrow(dim, index * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None, \
            None


def keep_block(x: torch.Tensor, dim: int, group, index: int) -> torch.Tensor:
    """Block ``index`` (this rank's position in the group) along ``dim``
    of a value that every rank of the group computed whole: the transpose
    of :func:`gather_replicated`. The backward all-gathers the blocks'
    cotangents, so every rank holds the whole cotangent of the whole value,
    as every rank held it before the value was split (a sub-block computed
    whole on every model rank, leaving onto the rank's rows of the
    sequence)."""
    if group is SELF:
        return x
    return _Keep.apply(x, dim, group, index)


class _ReplicatedOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = _size(group)
        return broadcast(x, src=0, group=group)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def replicated_output(x: torch.Tensor, group) -> torch.Tensor:
    """A ``shard_map`` output declared replicated over ``group``'s axis
    with ``check_vma=False`` (JAX's expert-parallel body): forward, group
    rank 0's value on every rank (JAX returns device 0's copy); backward,
    JAX's transpose of such an output, which hands every rank the
    cotangent divided by the group's size, whatever the ranks' copies held
    (``jax/_src/shard_map.py``, ``_shard_map_transpose``)."""
    if group is SELF:
        return x
    return _ReplicatedOutput.apply(x, group)
