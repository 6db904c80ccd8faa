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
(``all_reduce``, ``all_gather``, ``all_to_all``, ``broadcast``), the
quantity JAX's dry-run reads from the HLO. Under :class:`counting` no
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


def init(world: int, rank: int, device="cpu", *,
         init_method: str = "env://") -> Comm:
    """Join the default process group of ``world`` ranks as ``rank`` and
    return the :class:`Comm` that the wrappers use. ``device`` is "cpu" or
    "cuda": under NCCL the rank takes ``cuda:{LOCAL_RANK}`` (``torchrun``
    sets it; without it, the rank), otherwise every rank of the host
    shares ``cuda:0``. ``init_method`` is ``env://`` under ``torchrun``,
    or ``tcp://localhost:PORT``."""
    if _STATE["comm"] is not None or dist.is_initialized():
        raise RuntimeError("comm.init: a process group is already up")
    dev = torch.device(device)
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


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)`` on ``x (n, cap,
    ...)``, n the group's size: block j of ``x`` goes to rank j, and block
    i of the result is what rank i sent here."""
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
