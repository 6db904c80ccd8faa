"""The op counter: what one step of the port does, counted op by op
(counterpart of ``repro/launch/hlo_analysis.py``'s ``analyze``).

PyTorch has no HLO to read, so :class:`Counter` is a ``TorchDispatchMode``
that sees every ATen op of a step as it runs, on ``meta`` tensors by
default (shapes only: nothing is allocated on any device), or on CPU or
CUDA tensors, which count the same. Per rank (a rank runs its own step):

  flops       2·M·N·K for every ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``
              (``torch.utils.flop_counter``'s formulas, which also give the
              convolutions'), ``mv`` and ``dot``; each kernel wrapper of
              ``kernels/ops.py`` reports its own (``ops.*_cost``)
  bytes       the ideal-fusion model of ``hlo_analysis._comp_hbm``: an op
              that is not elementwise or a view reads each of its inputs
              once and writes its outputs once; elementwise and view ops
              count zero, as fused into their consumers, so a read through
              them resolves to the tensors in memory behind them. A gather
              (``index``, ``embedding``) reads what it produces, an indexed
              or in-place write (``index_put_``, ``copy_`` into a cache)
              writes and reads only its update, and a step output that no
              counted op wrote is written at the end. Kernels add their
              ``plain`` or ``resident`` bytes (``resident=True``: their
              intermediates stay on chip, JAX's ``pallas_flash=True``)
  live bytes  every storage a step allocates, from its op to the moment it
              is freed (a weakref finalizer on the storage), and the peak
              of their sum: the step's ``temp_bytes``
  collectives result bytes per family, from ``dist.comm.counting``

What a kernel wrapper runs (the CUDA kernel, a ``ctypes`` call no dispatch
mode sees, or the plain version, which would count another algorithm) is
hidden from the counter but for its allocations, and on ``meta`` it runs
nothing (``kernels/ops.py``). No number here depends on the device the
step ran on.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import pytree
from repro_torch.dist import comm
from repro_torch.kernels import ops as kops

aten = torch.ops.aten

# elementwise beyond the ``pointwise`` tag: casts, copies, masks
_ELEMENTWISE = {aten._to_copy, aten.clone, aten.copy, aten.tril, aten.triu,
                aten.where, aten.masked_fill, aten.lerp, aten.clamp,
                aten.repeat, aten.expand_copy, aten.alias_copy}
# new tensors whose values are a constant or an iota (fused, as XLA's
# broadcast constants are), or no values at all
_FACTORY = {aten.empty, aten.empty_like, aten.empty_strided, aten.zeros,
            aten.zeros_like, aten.ones, aten.ones_like, aten.full,
            aten.full_like, aten.new_empty, aten.new_empty_strided,
            aten.new_zeros, aten.new_ones, aten.new_full, aten.arange,
            aten.scalar_tensor, aten.fill_, aten.zero_, aten.lift_fresh_copy,
            aten.linspace}
# views that the schema does not mark as aliases
_VIEWS = {aten._unsafe_view, aten.lift_fresh, aten.detach, aten.alias}
# gathers: read as many bytes as they produce
_WINDOW_READ = {aten.index, aten.gather, aten.index_select, aten.embedding,
                aten.take_along_dim}
# indexed writes: write and read their update only (argument position)
_WINDOW_WRITE = {aten.copy_: 1, aten.index_put: 2, aten.index_put_: 2,
                 aten._index_put_impl_: 2, aten.index_copy: 3,
                 aten.index_copy_: 3, aten.index_add: 3, aten.index_add_: 3,
                 aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3,
                 aten.scatter_add_: 3, aten.slice_scatter: 1,
                 aten.select_scatter: 1, aten.masked_scatter: 2,
                 aten.masked_scatter_: 2, aten.embedding_dense_backward: 0}
_IGNORED = {aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
            aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
            aten.record_stream, aten.set_}


def _mv_flops(a, b, *args, **kw) -> float:
    return 2.0 * a.shape[0] * a.shape[1]


def _addmv_flops(c, a, b, *args, **kw) -> float:
    return 2.0 * a.shape[0] * a.shape[1]


def _dot_flops(a, b, *args, **kw) -> float:
    return 2.0 * a.shape[0]


_EXTRA_FLOPS = {aten.mv: _mv_flops, aten.addmv: _addmv_flops,
                aten.dot: _dot_flops, aten.vdot: _dot_flops}


def distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements a tensor addresses (a broadcast dim, stride
    0, holds one)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def storages_bytes(tensors) -> Dict[int, int]:
    """{storage: bytes} of the tensors' distinct storages."""
    out: Dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        out.setdefault(st._cdata, st.nbytes())
    return out


class Counter(TorchDispatchMode):
    """Counts FLOPs, bytes and live storage of the ops run under it (see
    the module's note). ``known`` holds the storages that exist before the
    step (its arguments): they are not the step's allocations."""

    def __init__(self, resident: bool = False, known=()):
        super().__init__()
        self.resident = resident
        self.flops = 0.0
        self.bytes = 0.0
        self.per_op: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._known = set(known)
        self._alloc: Dict[int, int] = {}     # step storage -> bytes, live
        self._hidden = 0
        self._kinds: Dict[Any, str] = {}
        # a tensor fused away (elementwise, or a view of one) -> the
        # serials of the tensors in memory behind it; a tensor in memory ->
        # its serial, whose bytes are _src_bytes[serial]
        self._virtual = WeakIdKeyDictionary()
        self._serial = WeakIdKeyDictionary()
        self._src_bytes: Dict[int, int] = {}

    # -- installation -----------------------------------------------------
    def __enter__(self):
        if kops._COUNTER is not None:
            raise RuntimeError("op_analysis: a counter is already counting")
        kops._COUNTER = self
        return super().__enter__()

    def __exit__(self, *exc):
        kops._COUNTER = None
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel_call(self, name: str, t: torch.Tensor, cost):
        """A kernel wrapper's call (``kernels/ops.py``), by its own formula
        (``cost()``, ``ops.*_cost``). The ops run inside count no FLOPs or
        bytes (their allocations still count as live storage); yields True
        where nothing must run (a meta tensor: the wrapper returns an empty
        output)."""
        c = cost()
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "flops_needed": 0.0,
                                           "plain": 0.0, "resident": 0.0})
        k["calls"] += 1
        k["flops"] += c["flops"]
        k["flops_needed"] += c.get("flops_needed", c["flops"])
        k["plain"] += c["plain"]
        k["resident"] += c["resident"]
        self.flops += c["flops"]
        self.bytes += c["resident" if self.resident else "plain"]
        self._hidden += 1
        try:
            yield t.device.type == "meta"
        finally:
            self._hidden -= 1

    # -- the dispatch -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track(out)
        if not self._hidden:
            self._account(func, args, kwargs, out)
        return out

    def _track(self, out) -> None:
        for t in pytree.tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._alloc:
                continue
            n = st.nbytes()
            self._alloc[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        n = self._alloc.pop(key, 0)
        self.live -= n

    def _kind(self, func) -> str:
        kind = self._kinds.get(func)
        if kind is not None:
            return kind
        pkt = func._overloadpacket
        args = func._schema.arguments
        rets = func._schema.returns
        inplace = bool(args and args[0].alias_info is not None
                       and args[0].alias_info.is_write)
        if pkt in _IGNORED:
            kind = "ignored"
        elif pkt in _FACTORY:
            kind = "factory"
        elif pkt in _WINDOW_WRITE:
            kind = "window_write"
        elif pkt in _WINDOW_READ:
            kind = "window_read"
        elif pkt in _VIEWS or (rets and rets[0].alias_info is not None
                               and not rets[0].alias_info.is_write
                               and not inplace):
            kind = "view"
        elif torch.Tag.pointwise in func.tags or pkt in _ELEMENTWISE:
            kind = "elementwise_inplace" if inplace else "elementwise"
        else:
            kind = "material"
        self._kinds[func] = kind
        return kind

    def _sources(self, t: torch.Tensor) -> frozenset:
        src = self._virtual.get(t)
        if src is not None:
            return src
        serial = self._serial.get(t)
        if serial is None:
            serial = len(self._src_bytes)
            self._src_bytes[serial] = distinct_bytes(t)
            self._serial[t] = serial
        return frozenset((serial,))

    def _read(self, tensors) -> int:
        srcs = frozenset().union(*(self._sources(t) for t in tensors))
        return sum(self._src_bytes[s] for s in srcs)

    def _materialize(self, tensors) -> None:
        for t in tensors:
            self._virtual.pop(t, None)
            self._serial.pop(t, None)

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        rec = self.per_op.setdefault(name, {"calls": 0, "flops": 0.0,
                                            "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def _account(self, func, args, kwargs, out) -> None:
        kind = self._kind(func)
        if kind in ("ignored", "factory"):
            return
        ins = pytree.tensors((args, kwargs))
        outs = pytree.tensors(out)
        pkt = func._overloadpacket
        if kind == "view":
            src = self._virtual.get(ins[0]) if ins else None
            for o in outs:
                if src is not None:
                    self._virtual[o] = src
            return
        if kind == "elementwise":
            src = frozenset().union(*(self._sources(t) for t in ins))
            for o in outs:
                self._virtual[o] = src
            return
        name = str(pkt).split(".")[-1]
        if kind == "elementwise_inplace":
            dst = args[0]
            if dst in self._virtual:     # still fused: gather its sources
                self._virtual[dst] = frozenset().union(
                    *(self._sources(t) for t in ins))
                return
            # written into a tensor in memory: that write happens
            self._add(name, 0.0, self._read(ins) + distinct_bytes(dst))
            return
        if kind == "window_read":
            nbytes = sum(distinct_bytes(o) for o in outs)
            self._materialize(outs)
            self._add(name, 0.0, 2 * nbytes)
            return
        if kind == "window_write":
            pos = _WINDOW_WRITE[pkt]
            upd = args[pos] if len(args) > pos else None
            upd = [upd] if isinstance(upd, torch.Tensor) else []
            dst = args[0] if pkt is not aten.embedding_dense_backward \
                else None
            if pkt is aten.copy_ and dst in self._virtual:
                self._virtual[dst] = frozenset().union(
                    *(self._sources(t) for t in upd))
                return
            wrote = (distinct_bytes(dst) if pkt is aten.copy_
                     else sum(distinct_bytes(u) for u in upd))
            self._materialize(outs)
            self._add(name, 0.0, wrote + self._read(upd))
            return
        fn = flop_counter.flop_registry.get(pkt) or _EXTRA_FLOPS.get(pkt)
        flops = float(fn(*args, **kwargs, out_val=out)) if fn else 0.0
        nbytes = self._read(ins) + sum(distinct_bytes(o) for o in outs)
        self._materialize(outs)
        self._add(name, flops, nbytes)

    def finish(self, outputs) -> None:
        """The step's outputs that no counted op wrote (an elementwise
        chain ends in them: AdamW's new parameters) are written now."""
        seen = set()
        for t in pytree.tensors(outputs):
            if id(t) in seen or t not in self._virtual:
                continue
            seen.add(id(t))
            self._add("(outputs)", 0.0, self._read([t]) + distinct_bytes(t))


def count(fn: Callable, *args, resident: bool = False,
          world: Optional[int] = None) -> Dict:
    """``fn(*args)`` once under a :class:`Counter`. ``args`` are the step's
    arguments (trees of tensors); with ``world`` its collectives are counted
    by ``dist.comm.counting(world)`` instead of run. Returns the counts:
    ``flops``, ``bytes``, ``per_op``, ``kernels``, ``memory`` (argument,
    output, temp and peak bytes: the peak is the arguments plus the most the
    step held at once of its own allocations) and ``collectives``, with the
    seconds the count took and ``fn``'s result as ``out``."""
    arg_st = storages_bytes(pytree.tensors(list(args)))
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        coll = stack.enter_context(comm.counting(world)) \
            if world is not None else None
        c = stack.enter_context(Counter(resident=resident, known=arg_st))
        out = fn(*args)
        c.finish(out)
    seconds = time.perf_counter() - t0
    out_st = {k: v for k, v in storages_bytes(pytree.tensors(out)).items()
              if k not in arg_st}
    output_bytes = sum(out_st.values())
    argument_bytes = sum(arg_st.values())
    per_family = dict(coll.bytes) if coll is not None else {}
    return {
        "flops": c.flops, "bytes": c.bytes, "resident": resident,
        "per_op": c.per_op, "kernels": c.kernels,
        "memory": {"argument_bytes": argument_bytes,
                   "output_bytes": output_bytes,
                   "temp_bytes": max(c.peak - output_bytes, 0),
                   "peak_bytes": argument_bytes + max(c.peak, output_bytes)},
        "collectives": {"total_bytes": float(sum(per_family.values())),
                        "per_op": per_family,
                        "calls": dict(coll.calls) if coll else {}},
        "count_s": seconds, "out": out}


def to_meta(tree):
    """The same tree with every tensor an empty ``meta`` tensor of its
    shape, dtype and strides (what a step is counted on); a tensor that
    sits at several places of the tree (a group's shared basis) stays one
    tensor."""
    memo: Dict[int, torch.Tensor] = {}

    def meta(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) not in memo:
            memo[id(t)] = torch.empty_strided(t.shape, t.stride(),
                                              dtype=t.dtype, device="meta")
        return memo[id(t)]

    return pytree.tree_map(meta, tree)
