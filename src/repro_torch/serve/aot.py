"""The serve executables' registries and the cache-row functions behind
them (counterpart of ``repro/serve/aot.py``).

The batcher dispatches every prefill, decode and cache update through one
registry object with the JAX package's roles (``decode``, ``prefill``,
``scatter``, ``purge`` and, for the paged pool, ``decode_paged``,
``prefill_ext``, ``scatter_paged``, ``purge_paged``, ``copy_blocks``).
Two registries share that interface:

* :class:`TracedRegistry` calls the model eagerly, one launch per op. What
  it keeps of the JAX registry is the bookkeeping: the JAX registry traces
  one ``jax.jit`` per role and retraces for every new shape and dtype of
  the operands; here ``prefill_retraces``, ``decode_retraces`` and
  ``scatter_retraces`` count the first call of each distinct signature
  (role, params tree, and every operand's shapes and dtypes). So the
  bucketing invariant stays testable as it is in JAX: at most ⌈log2
  max_len⌉ prefill signatures and one decode signature per rank rung.
* :class:`AotRegistry` is the counterpart of the JAX registry that
  compiles its executables ahead of time. In PyTorch the counterpart of a
  compiled XLA executable is a captured CUDA graph: one replay launches a
  whole decode step (some 2100 kernels for SmolLM-360M) for the cost of
  one launch. Each (role, variant) entry is JAX's: decode per rank rung,
  prefill and ``prefill_ext`` per (rung, bucket), ``scatter_paged`` per
  (batch, source width). An entry owns static device buffers for the
  inputs the host feeds it (tokens, lengths, starts, the block table),
  binds the rung's params and the pool's own tensors, runs its first call
  eagerly on a side stream (the call's own result; it also does the
  first-use work: the kernels' build and load, their attribute and
  occupancy queries, cuBLAS's workspace) and then captures the same call
  with ``torch.cuda.graph``. A dispatch copies the inputs into the static
  buffers and replays; its outputs are the graph's own buffers, which the
  next replay overwrites, so a reader copies them at once (the batcher's
  ``_last_logits`` does). ``warm()`` makes exactly JAX's warm set.

  ``decode``, ``decode_paged``, ``prefill`` and ``prefill_ext`` replay
  graphs. ``scatter``, ``purge``, ``scatter_paged``, ``purge_paged`` and
  ``copy_blocks`` stay eager by design: they filter their index lists on
  the host (below). They still make an entry, which ``aot_compiles``
  counts with the captures, so the stats match JAX's. On a CPU pool there
  is no graph: every entry runs the same static-buffer path eagerly.
  A capture that fails on the card raises; nothing falls back to eager
  dispatch there. Several registries may share one card (``FrontDoor``
  replicas, each stepping on its own thread): a capture runs in
  ``thread_local`` error mode, so the other threads go on allocating,
  copying and launching, and one lock serializes the captures of the
  process, whose device-wide synchronize and cache release must not fall
  inside another thread's capture (in torch's default global mode a late
  capture beside a serving replica failed on the card with
  ``cudaErrorStreamCaptureInvalidated``).

  ``AotCache`` is not ported: a CUDA graph lives in one process and cannot
  be serialized. What a disk cache saves at a cold boot in the port is the
  ``nvcc`` build, which ``kernels/_build.py`` already caches; so
  ``aot_cache_hits`` and ``aot_deser_failures`` stay 0 and ``cache_dir``
  is accepted for parity and stores nothing.

The row functions update the pool IN PLACE and return it, where the JAX
ones return a new pool. The JAX ones also mark the rows and blocks they
must skip with out-of-range sentinels (slot >= batch, block >= arena size,
a null-block table entry, a position past the table) and let XLA drop
those writes (``mode="drop"``). ``index_put_`` has no such mode, so every
index list here is filtered on the host before it reaches the device, and
block 0 is never a write target.
"""
from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.obs import trace

# One capture at a time in the process (module docstring): the CUDA context
# it guards is the process's.
_CAPTURE_LOCK = threading.Lock()

# Roles an engine dispatches through the registry; the paged ones are only
# live when ServeConfig.kv_block > 0
ROLE_DECODE = "decode"
ROLE_PREFILL = "prefill"
ROLE_SCATTER = "scatter"
ROLE_PURGE = "purge"
ROLE_DECODE_PAGED = "decode_paged"
ROLE_PREFILL_EXT = "prefill_ext"
ROLE_SCATTER_PAGED = "scatter_paged"
ROLE_PURGE_PAGED = "purge_paged"
ROLE_COPY_BLOCKS = "copy_blocks"

AOT_STAT_KEYS = ("aot_compiles", "aot_cache_hits", "aot_deser_failures",
                 "aot_fallbacks")
RETRACE_KEYS = ("prefill_retraces", "decode_retraces", "scatter_retraces")


# ---------------------------------------------------------------------------
# Cache-row functions
# ---------------------------------------------------------------------------
def _row_leaves(pool: Dict, src: Optional[Dict] = None
                ) -> Iterator[tuple]:
    """(pool leaf, src leaf) for every cache leaf of every run, as JAX's
    ``tree.map`` over ``runs`` walks them: k/v and every recurrent state
    leaf (``ssm``, ``mlstm``, ``slstm``; a paged arena, pure attention,
    holds only k/v). Each carries a leading stacked-layer axis, so the
    batch (or arena block) axis is 1."""
    for r, run in pool["runs"].items():
        dst = pytree.tensors(run)
        yield from zip(dst, pytree.tensors(src["runs"][r]) if src is not None
                       else [None] * len(dst))


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _dev_index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                           device=device)


def scatter_rows(pool: Dict, src: Dict, slots) -> Dict:
    """One whole-pool update: row j of every ``src`` cache leaf (k/v and
    recurrent state alike) lands in row slots[j] of the pool, its ``pos``
    too, so a new tenant starts from its own prefill's state. A slot >=
    the pool's batch is
    padding and is dropped (filtered out here)."""
    nrows = pool["pos"].shape[0]
    slots = _host(slots)
    keep = np.nonzero(slots < nrows)[0]
    if keep.size == 0:
        return pool
    dev = pool["pos"].device
    dst, j = _dev_index(slots[keep], dev), _dev_index(keep, dev)
    for pool_l, src_l in _row_leaves(pool, src):
        pool_l[:, dst] = src_l[:, j].to(device=dev, dtype=pool_l.dtype)
    pool["pos"][dst] = src["pos"].to(device=dev, dtype=torch.int32)[j]
    return pool


def purge_rows(pool: Dict, rows) -> Dict:
    """Zero the cache rows of quarantined slots, every leaf (k/v and
    recurrent state), and mark them dead (pos = -1), so a later tenant, or
    a masked dead region, can never read poisoned state (0·NaN leaks
    through attention: masking is not enough). Rows >= batch are padding
    (dropped)."""
    nrows = pool["pos"].shape[0]
    rows = _host(rows)
    rows = rows[rows < nrows]
    if rows.size == 0:
        return pool
    idx = _dev_index(rows, pool["pos"].device)
    for leaf, _ in _row_leaves(pool):
        leaf[:, idx] = 0
    pool["pos"][idx] = -1
    return pool


def scatter_paged(pool: Dict, src: Dict, slots, table, starts) -> Dict:
    """Paged admission write: route each freshly prefilled row of ``src``
    (leaves (n, B, S, KV, hd)) through the block table into the arena
    (leaves (n, P, bk, KV, hd)). Row j's token i lands at absolute position
    starts[j] + i, i.e. arena block table[slots[j], absp // bk], offset
    absp % bk. Dropped: padding rows (slot >= table rows), tokens past the
    row's live length, positions past the table and null-block (0) table
    entries, so shared prefix blocks below ``starts`` are never written.
    ``table`` is the host table (numpy)."""
    table = _host(table)
    slots, starts = _host(slots), _host(starts)
    nrows, NB = table.shape
    k0 = next(_row_leaves(pool))[0]
    P, bk = k0.shape[1], k0.shape[2]
    S = next(_row_leaves(src))[0].shape[2]
    src_pos = _host(src["pos"])
    i = np.arange(S)[None, :]
    absp = starts[:, None] + i                            # (B, S)
    blk = absp // bk
    ok = ((i < (src_pos - starts)[:, None]) & (slots[:, None] < nrows)
          & (blk < NB))
    srow = np.minimum(slots, nrows - 1)
    tb = table[srow[:, None], np.minimum(blk, NB - 1)]
    ok &= (tb > 0) & (tb < P)
    jj, ii = np.nonzero(ok)
    dev = pool["pos"].device
    if jj.size:
        pb = _dev_index(tb[jj, ii], dev)
        off = _dev_index(absp[jj, ii] % bk, dev)
        j_d, i_d = _dev_index(jj, dev), _dev_index(ii, dev)
        for pool_l, src_l in _row_leaves(pool, src):
            pool_l[:, pb, off] = src_l[:, j_d, i_d].to(device=dev,
                                                       dtype=pool_l.dtype)
    keep = np.nonzero(slots < pool["pos"].shape[0])[0]
    if keep.size:
        pool["pos"][_dev_index(slots[keep], dev)] = torch.as_tensor(
            src_pos[keep].astype(np.int32), device=dev)
    return pool


def purge_paged(pool: Dict, rows, blocks) -> Dict:
    """Paged quarantine and retirement: zero the listed arena blocks (only
    those whose refcount hit zero: a shared prefix block another request
    still holds is never listed, the host allocator sees to it) and mark
    the listed slot rows dead (pos = -1), which drops their decode writes
    and zeroes their outputs. Out-of-range rows and blocks are padding;
    block 0 is never written."""
    k0 = next(_row_leaves(pool))[0]
    P = k0.shape[1]
    blocks = _host(blocks)
    blocks = blocks[(blocks > 0) & (blocks < P)]
    dev = pool["pos"].device
    if blocks.size:
        idx = _dev_index(blocks, dev)
        for leaf, _ in _row_leaves(pool):
            leaf[:, idx] = 0
    rows = _host(rows)
    rows = rows[rows < pool["pos"].shape[0]]
    if rows.size:
        pool["pos"][_dev_index(rows, dev)] = -1
    return pool


def copy_blocks(pool: Dict, src, dst) -> Dict:
    """Copy-on-write fork: arena block src[j] -> dst[j] for each j. The
    destination blocks are freshly allocated (refcount 1, unshared), so
    this is the only write a shared block's content ever feeds. Pairs with
    an out-of-range entry (>= arena size) or a null-block destination are
    padding and are dropped. Every source block is read (gathered into a
    new tensor) before any destination is written, as in JAX's
    ``leaf.at[:, dst].set(leaf[:, src])``."""
    k0 = next(_row_leaves(pool))[0]
    P = k0.shape[1]
    src, dst = _host(src), _host(dst)
    keep = (src < P) & (dst > 0) & (dst < P)
    if not keep.any():
        return pool
    dev = pool["pos"].device
    s, d = _dev_index(src[keep], dev), _dev_index(dst[keep], dev)
    for leaf, _ in _row_leaves(pool):
        leaf[:, d] = leaf[:, s]
    return pool


# ---------------------------------------------------------------------------
# Signatures, fingerprints and entry keys
# ---------------------------------------------------------------------------
def _sig_of(x: Any) -> str:
    """Structure plus every leaf's shape and dtype: what a new ``jax.jit``
    trace keys on."""
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{_sig_of(x[k])}" for k in sorted(x)) \
            + "}"
    if isinstance(x, (list, tuple)):
        return "[" + ",".join(_sig_of(v) for v in x) + "]"
    if isinstance(x, (torch.Tensor, np.ndarray)):
        dt = str(x.dtype).replace("torch.", "")
        return f"{tuple(x.shape)}:{dt}"
    return type(x).__name__


def live_fingerprint(params, cfg: ModelConfig) -> str:
    """Fingerprint for an in-memory (non-artifact) boot: the param tree's
    structure, leaf shapes and dtypes, and the model dims (a saved artifact
    uses ``ckpt.store.artifact_fingerprint``)."""
    h = hashlib.sha256(_sig_of(params).encode())
    h.update(json.dumps({"name": cfg.name, "n_layers": cfg.n_layers,
                         "d_model": cfg.d_model,
                         "vocab_size": cfg.vocab_size},
                        sort_keys=True).encode())
    return "live-" + h.hexdigest()[:32]


def cache_key(fingerprint: str, role: str, variant: Tuple, sig: str,
              scfg, cfg: ModelConfig) -> str:
    """sha256 over everything that could change an entry: the artifact
    fingerprint, serve and model config, the torch and CUDA versions and
    the device, and the entry's (role, variant, signature)."""
    payload = {
        "fingerprint": fingerprint,
        "role": role,
        "variant": list(variant),
        "sig": sig,
        "scfg": {"batch": scfg.batch, "max_len": scfg.max_len,
                 "kv_block": getattr(scfg, "kv_block", 0)},
        "model": {"name": cfg.name, "n_layers": cfg.n_layers,
                  "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
                  "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                  "dtype": str(cfg.dtype)},
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "cpu"),
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def _device_tokens(tokens, params) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device)


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------
class TracedRegistry:
    """Eager dispatch of the serve roles with the JAX registry's retrace
    counters: the first call of each distinct (role, params, operand
    shapes and dtypes) signature bumps ``prefill_retraces`` /
    ``decode_retraces`` / ``scatter_retraces`` as a new ``jax.jit`` trace
    would. The params tree's signature is computed once per tree object
    (the ladder's rungs live as long as the batcher)."""

    kind = "traced"

    def __init__(self, cfg: ModelConfig, scfg, stats: Optional[Dict] = None):
        self.cfg, self.scfg = cfg, scfg
        self.stats = stats if stats is not None else {}
        for k in RETRACE_KEYS:
            self.stats.setdefault(k, 0)
        self.signatures: set = set()
        self._psig: Dict[int, tuple] = {}

    def bind_stats(self, stats: Dict) -> None:
        """Fold any counts accumulated so far into ``stats`` and make it
        the live counter dict (the engine owns one stats surface)."""
        for k, v in self.stats.items():
            stats[k] = stats.get(k, 0) + v
        self.stats = stats

    def _params_sig(self, params) -> str:
        hit = self._psig.get(id(params))
        if hit is None or hit[0] is not params:
            hit = (params, _sig_of(params))
            self._psig[id(params)] = hit
        return hit[1]

    def _seen(self, role: str, counter: str, params, *operands) -> None:
        key = (role, self._params_sig(params) if params is not None else "",
               _sig_of(list(operands)))
        if key not in self.signatures:
            self.signatures.add(key)
            self.stats[counter] += 1

    # role dispatch; variant hints are accepted (and ignored beyond the
    # signature) so the engine calls every registry alike. Host tokens
    # (numpy) are uploaded here.
    @torch.inference_mode()
    def decode(self, params, cache, tokens, *, level: int = 0):
        self._seen(ROLE_DECODE, "decode_retraces", params, cache, tokens)
        return T.decode_step(params, self.cfg, cache,
                             _device_tokens(tokens, params))

    @torch.inference_mode()
    def prefill(self, params, batch, *, level: int = 0, bucket=None):
        self._seen(ROLE_PREFILL, "prefill_retraces", params, batch)
        return T.prefill(params, self.cfg, batch, max_len=self.scfg.max_len)

    @torch.inference_mode()
    def scatter(self, pool, src, slots):
        self._seen(ROLE_SCATTER, "scatter_retraces", None, pool, src, slots)
        return scatter_rows(pool, src, slots)

    @torch.inference_mode()
    def purge(self, pool, rows):
        return purge_rows(pool, rows)

    @torch.inference_mode()
    def decode_paged(self, params, cache, tokens, table, *, level: int = 0):
        self._seen(ROLE_DECODE_PAGED, "decode_retraces", params, cache,
                   tokens, table)
        return T.decode_step(params, self.cfg, cache,
                             _device_tokens(tokens, params), table=table)

    @torch.inference_mode()
    def prefill_ext(self, params, batch, arena, table, *, level: int = 0,
                    bucket=None):
        self._seen(ROLE_PREFILL_EXT, "prefill_retraces", params, batch,
                   arena, table)
        return T.prefill_ext(params, self.cfg, batch, arena, table)

    @torch.inference_mode()
    def scatter_paged(self, pool, src, slots, table, starts):
        self._seen(ROLE_SCATTER_PAGED, "scatter_retraces", None, pool, src,
                   slots, table, starts)
        return scatter_paged(pool, src, slots, table, starts)

    @torch.inference_mode()
    def purge_paged(self, pool, rows, blocks):
        return purge_paged(pool, rows, blocks)

    @torch.inference_mode()
    def copy_blocks(self, pool, src, dst):
        return copy_blocks(pool, src, dst)

    def warm(self, ladder: Sequence, bucketed: bool, paged: bool = False,
             *, pool: Optional[Dict] = None) -> None:
        """No-op: the traced registry runs every call eagerly."""


class _Entry:
    """One (role, variant) of an :class:`AotRegistry`: the static input
    buffers, the params and pool it is bound to (their storage addresses at
    capture), and on the card the graph and its output buffers."""

    def __init__(self, role: str, variant: Tuple, key: str, params,
                 pool: Optional[Dict], bufs: Dict[str, torch.Tensor]):
        self.role, self.variant, self.key = role, variant, key
        self.params = params
        self.ptrs = self._ptrs(pool)
        self.bufs = bufs
        self.fed: Dict[str, Any] = {}   # sticky feeds: the source last copied
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.nbytes = 0                 # device memory the graph's pool took

    @staticmethod
    def _ptrs(pool: Optional[Dict]) -> tuple:
        return (tuple(t.data_ptr() for t in pytree.tensors(pool))
                if pool is not None else ())

    def binds(self, params, pool: Optional[Dict], feeds: Dict) -> bool:
        """Whether a dispatch with these operands may use this entry: the
        same params object, the pool's leaves at the captured addresses
        (a rebuilt pool is not replayed onto dead storage) and inputs of
        the buffers' shapes."""
        return (params is self.params and self._ptrs(pool) == self.ptrs
                and all(tuple(np.shape(v)) == tuple(self.bufs[k].shape)
                        for k, v in feeds.items()))

    def feed(self, feeds: Dict, sticky: Tuple[str, ...] = ()) -> None:
        """Copy the inputs into the static buffers; a ``sticky`` input is
        copied only when its source object changed (the batcher makes a
        new device table only when the host edited it)."""
        for k, v in feeds.items():
            if k in sticky:
                if self.fed.get(k) is v:
                    continue
                self.fed[k] = v
            self.bufs[k].copy_(torch.as_tensor(v))


class AotRegistry:
    """The serving surface as one CUDA graph per decode and prefill
    signature, behind :class:`TracedRegistry`'s role interface, with the
    JAX ``AotRegistry``'s stat keys (``aot_compiles``, ``aot_cache_hits``,
    ``aot_deser_failures``, ``aot_fallbacks`` and the three retrace
    counters, which stay 0). ``aot_compiles`` counts the entries made;
    ``aot_fallbacks`` the entries made again because a dispatch did not fit
    the one it had (another params object, a rebuilt pool, other shapes).
    ``replays`` and ``calls`` count graph replays and dispatches per role;
    they are not stat keys, so the stats schema stays JAX's (a kernel
    wrapper's ``.launches`` counts Python calls, so a replay adds nothing
    there). ``cache_dir`` is accepted for parity with the JAX registry and
    stores nothing (module docstring)."""

    kind = "aot"

    def __init__(self, cfg: ModelConfig, scfg, fingerprint: str,
                 cache_dir: Optional[str] = None,
                 stats: Optional[Dict] = None):
        self.cfg, self.scfg = cfg, scfg
        self.fingerprint = fingerprint
        self.cache_dir = cache_dir
        self.stats = stats if stats is not None else {}
        for k in AOT_STAT_KEYS + RETRACE_KEYS:
            self.stats.setdefault(k, 0)
        self._mem: Dict[Tuple, _Entry] = {}
        self.replays: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self._side: Optional[torch.cuda.Stream] = None

    def bind_stats(self, stats: Dict) -> None:
        for k, v in self.stats.items():
            stats[k] = stats.get(k, 0) + v
        self.stats = stats

    def entries(self) -> List[Tuple[str, Tuple]]:
        """The (role, variant) of every entry, in the order they were
        made."""
        return list(self._mem)

    def graph_bytes(self) -> Dict[Tuple[str, Tuple], int]:
        """Device memory each captured graph's pool holds."""
        return {k: e.nbytes for k, e in self._mem.items()
                if e.graph is not None}

    # ---- entries ---------------------------------------------------------
    def _new_entry(self, role: str, variant: Tuple, params, pool, feeds,
                   device) -> _Entry:
        if (role, variant) in self._mem:
            self.stats["aot_fallbacks"] += 1
        bufs = {k: torch.zeros(np.shape(v), dtype=torch.int32, device=device)
                for k, v in feeds.items()}
        sig = _sig_of([params, pool, bufs]) if params is not None \
            else _sig_of([pool])
        e = _Entry(role, variant,
                   cache_key(self.fingerprint, role, variant, sig,
                             self.scfg, self.cfg),
                   params, pool, bufs)
        self._mem[(role, variant)] = e
        self.stats["aot_compiles"] += 1
        return e

    def _eager_entry(self, role: str, variant: Tuple) -> None:
        """An eager role's entry: made once per (role, variant), nothing
        captured."""
        if (role, variant) not in self._mem:
            self._new_entry(role, variant, None, None, {}, None)

    def _capture(self, e: _Entry, run: Callable[[], Any]):
        """The entry's first call, eagerly on a side stream (it returns
        this dispatch's result), then the same call captured into a CUDA
        graph whose output buffers the replays fill."""
        dev = e.params["embed"].device
        cur = torch.cuda.current_stream(dev)
        with _CAPTURE_LOCK:
            if self._side is None:
                self._side = torch.cuda.Stream(dev)
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                out = run()
            cur.wait_stream(self._side)
            for t in pytree.tensors(out):
                t.record_stream(cur)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(dev)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                e.out = run()
            e.nbytes = torch.cuda.memory_reserved(dev) - before
        e.graph = g
        return out

    def _dispatch(self, role: str, variant: Tuple, params, pool, feeds,
                  body: Callable, sticky: Tuple[str, ...] = ()):
        """Feed the entry of (role, variant) and replay it, making it first
        when there is none or the one there does not fit. ``body(bufs)``
        is the role on the static buffers."""
        self.calls[role] = self.calls.get(role, 0) + 1
        e = self._mem.get((role, variant))
        if e is None or not e.binds(params, pool, feeds):
            dev = params["embed"].device
            e = self._new_entry(role, variant, params, pool, feeds, dev)
            e.feed(feeds, sticky)
            with trace.span("aot_compile", role=role, variant=list(variant)):
                if dev.type != "cuda":
                    return body(e.bufs)
                try:
                    return self._capture(e, lambda: body(e.bufs))
                except BaseException:
                    # no entry without its graph: a failed capture raises,
                    # and nothing replays eagerly on the card later
                    del self._mem[(role, variant)]
                    raise
        e.feed(feeds, sticky)
        if e.graph is None:           # a CPU pool: the same path, eagerly
            return body(e.bufs)
        e.graph.replay()
        self.replays[role] = self.replays.get(role, 0) + 1
        return e.out

    # ---- role dispatch ---------------------------------------------------
    @torch.inference_mode()
    def decode(self, params, cache, tokens, *, level: int = 0):
        def body(b):
            logits, _ = T.decode_step(params, self.cfg, cache, b["tokens"])
            return logits
        return self._dispatch(ROLE_DECODE, (level,), params, cache,
                              {"tokens": tokens}, body), cache

    @torch.inference_mode()
    def prefill(self, params, batch, *, level: int = 0, bucket=None):
        if bucket is None:         # exact-length path (recurrent archs)
            bucket = ("exact", int(np.shape(batch["tokens"])[0]),
                      int(np.shape(batch["tokens"])[1]))
        feeds = {k: batch[k] for k in ("tokens", "lengths") if k in batch}
        return self._dispatch(
            ROLE_PREFILL, (level, bucket), params, None, feeds,
            lambda b: T.prefill(params, self.cfg, b,
                                max_len=self.scfg.max_len))

    @torch.inference_mode()
    def scatter(self, pool, src, slots):
        self._eager_entry(ROLE_SCATTER, (int(src["pos"].shape[0]),))
        return scatter_rows(pool, src, slots)

    @torch.inference_mode()
    def purge(self, pool, rows):
        self._eager_entry(ROLE_PURGE, ())
        return purge_rows(pool, rows)

    @torch.inference_mode()
    def decode_paged(self, params, cache, tokens, table, *, level: int = 0):
        def body(b):
            logits, _ = T.decode_step(params, self.cfg, cache, b["tokens"],
                                      table=b["table"])
            return logits
        return self._dispatch(ROLE_DECODE_PAGED, (level,), params, cache,
                              {"tokens": tokens, "table": table}, body,
                              sticky=("table",)), cache

    @torch.inference_mode()
    def prefill_ext(self, params, batch, arena, table, *, level: int = 0,
                    bucket=None):
        if bucket is None:
            bucket = ("exact", int(np.shape(batch["tokens"])[0]),
                      int(np.shape(batch["tokens"])[1]))
        feeds = {k: batch[k] for k in ("tokens", "lengths", "starts")}
        feeds["table"] = table
        return self._dispatch(
            ROLE_PREFILL_EXT, (level, bucket), params, arena, feeds,
            lambda b: T.prefill_ext(params, self.cfg, b, arena, b["table"]))

    @torch.inference_mode()
    def scatter_paged(self, pool, src, slots, table, starts):
        width = next(_row_leaves(src))[0].shape[2]
        self._eager_entry(ROLE_SCATTER_PAGED,
                          (int(src["pos"].shape[0]), int(width)))
        return scatter_paged(pool, src, slots, table, starts)

    @torch.inference_mode()
    def purge_paged(self, pool, rows, blocks):
        self._eager_entry(ROLE_PURGE_PAGED, ())
        return purge_paged(pool, rows, blocks)

    @torch.inference_mode()
    def copy_blocks(self, pool, src, dst):
        self._eager_entry(ROLE_COPY_BLOCKS, ())
        return copy_blocks(pool, src, dst)

    # ---- boot --------------------------------------------------------------
    def prefill_buckets(self) -> List[int]:
        """The pow2 prompt buckets the engine can ever ask for: 2, 4, …
        capped at ``max_len`` (which is itself a bucket when not a power of
        two)."""
        out, b = [], 2
        while b < self.scfg.max_len:
            out.append(b)
            b *= 2
        out.append(self.scfg.max_len)
        return sorted(set(out))

    def warm(self, ladder: Sequence, bucketed: bool, paged: bool = False,
             *, pool: Dict) -> None:
        """Make the JAX registry's warm set on the batcher's ``pool``: the
        decode step of every rank rung, the prefill of every pow2 bucket at
        full rank, the cache helpers, and with ``paged`` the block-arena
        surface in place of the contiguous decode and scatter. Each graph
        entry's first call runs on the empty pool, where every slot is
        dead: a dead row's decode parks at slot 0 of its own row or writes
        nothing, and a prefill builds a fresh cache, so warming leaves no
        trace in any result. After this, a drain at full rank makes no
        entry (``aot_compiles`` stays flat)."""
        if bool((pool["pos"] >= 0).any()):
            raise ValueError("warm() runs on an empty pool: a live slot's "
                             "decode would advance")
        B = self.scfg.batch
        tok = np.zeros((B, 1), dtype=np.int32)
        ones = np.ones((B,), dtype=np.int32)
        with trace.span("aot_warm", rungs=len(ladder), bucketed=bucketed,
                        paged=paged):
            if not paged:
                for level, params in enumerate(ladder):
                    self.decode(params, pool, tok, level=level)
            if bucketed:
                for sb in self.prefill_buckets():
                    self.prefill(ladder[0], {
                        "tokens": np.zeros((B, sb), dtype=np.int32),
                        "lengths": ones}, level=0, bucket=sb)
                if not paged:
                    self._eager_entry(ROLE_SCATTER, (B,))
            if not paged:
                self._eager_entry(ROLE_PURGE, ())
                return
            NB = self.scfg.max_len // self.scfg.kv_block
            tbl = np.zeros((B, NB), dtype=np.int32)
            for level, params in enumerate(ladder):
                self.decode_paged(params, pool, tok, tbl, level=level)
            seen = set()
            for sb in self.prefill_buckets():
                self.prefill_ext(ladder[0], {
                    "tokens": np.zeros((B, sb), dtype=np.int32),
                    "lengths": ones, "starts": np.zeros((B,), np.int32)},
                    pool, tbl, level=0, bucket=sb)
                # plain prefill emits max_len-wide src caches, prefill_ext
                # bucket-wide ones
                for width in (self.scfg.max_len, sb):
                    if width not in seen:
                        seen.add(width)
                        self._eager_entry(ROLE_SCATTER_PAGED, (B, width))
            self._eager_entry(ROLE_PURGE_PAGED, ())
            self._eager_entry(ROLE_COPY_BLOCKS, ())
