"""The serve executables' registry and the cache-row functions behind it
(counterpart of the traced half of ``repro/serve/aot.py``).

The batcher dispatches every prefill, decode and cache update through one
registry object with the JAX package's roles (``decode``, ``prefill``,
``scatter``, ``purge`` and, for the paged pool, ``decode_paged``,
``prefill_ext``, ``scatter_paged``, ``purge_paged``, ``copy_blocks``).
PyTorch runs eagerly, so :class:`TracedRegistry` calls the model directly;
what it keeps of the JAX registry is the bookkeeping. The JAX registry
traces one ``jax.jit`` per role and retraces for every new shape and dtype
of the operands; here the counters ``prefill_retraces``,
``decode_retraces`` and ``scatter_retraces`` count the first call of each
distinct signature (role, params tree, and every operand's shapes and
dtypes). So the bucketing invariant stays testable as it is in JAX: at most
⌈log2 max_len⌉ prefill signatures and one decode signature per rank rung.
CUDA-graph capture per signature (ROADMAP Queue 1, item 8) will key on the
same signatures; ``AotRegistry`` and ``AotCache`` wait for it.

The row functions update the pool IN PLACE and return it, where the JAX
ones return a new pool. The JAX ones also mark the rows and blocks they
must skip with out-of-range sentinels (slot >= batch, block >= arena size,
a null-block table entry, a position past the table) and let XLA drop
those writes (``mode="drop"``). ``index_put_`` has no such mode, so every
index list here is filtered on the host before it reaches the device, and
block 0 is never a write target.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T

# the roles whose signatures count as (re)traces; the paged ones are only
# live when ServeConfig.kv_block > 0
ROLE_DECODE = "decode"
ROLE_PREFILL = "prefill"
ROLE_SCATTER = "scatter"
ROLE_DECODE_PAGED = "decode_paged"
ROLE_PREFILL_EXT = "prefill_ext"
ROLE_SCATTER_PAGED = "scatter_paged"


# ---------------------------------------------------------------------------
# Cache-row functions
# ---------------------------------------------------------------------------
def _kv_pairs(pool: Dict, src: Optional[Dict] = None
              ) -> Iterator[tuple]:
    """(pool leaf, src leaf) for every k/v leaf of every run; leaves carry
    a leading stacked-layer axis, so the batch (or arena block) axis is 1."""
    for r, run in pool["runs"].items():
        for name, leaf in run["kv"].items():
            yield leaf, (None if src is None
                         else src["runs"][r]["kv"][name])


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _dev_index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                           device=device)


def scatter_rows(pool: Dict, src: Dict, slots) -> Dict:
    """One whole-pool update: row j of every ``src`` cache leaf lands in row
    slots[j] of the pool, its ``pos`` too. A slot >= the pool's batch is
    padding and is dropped (filtered out here)."""
    nrows = pool["pos"].shape[0]
    slots = _host(slots)
    keep = np.nonzero(slots < nrows)[0]
    if keep.size == 0:
        return pool
    dev = pool["pos"].device
    dst, j = _dev_index(slots[keep], dev), _dev_index(keep, dev)
    for pool_l, src_l in _kv_pairs(pool, src):
        pool_l[:, dst] = src_l[:, j].to(device=dev, dtype=pool_l.dtype)
    pool["pos"][dst] = src["pos"].to(device=dev, dtype=torch.int32)[j]
    return pool


def purge_rows(pool: Dict, rows) -> Dict:
    """Zero the cache rows of quarantined slots and mark them dead (pos =
    -1), so a later tenant, or a masked dead region, can never read
    poisoned state (0·NaN leaks through attention: masking is not
    enough). Rows >= batch are padding (dropped)."""
    nrows = pool["pos"].shape[0]
    rows = _host(rows)
    rows = rows[rows < nrows]
    if rows.size == 0:
        return pool
    idx = _dev_index(rows, pool["pos"].device)
    for leaf, _ in _kv_pairs(pool):
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
    k0 = next(_kv_pairs(pool))[0]
    P, bk = k0.shape[1], k0.shape[2]
    S = next(_kv_pairs(src))[0].shape[2]
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
        for pool_l, src_l in _kv_pairs(pool, src):
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
    k0 = next(_kv_pairs(pool))[0]
    P = k0.shape[1]
    blocks = _host(blocks)
    blocks = blocks[(blocks > 0) & (blocks < P)]
    dev = pool["pos"].device
    if blocks.size:
        idx = _dev_index(blocks, dev)
        for leaf, _ in _kv_pairs(pool):
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
    k0 = next(_kv_pairs(pool))[0]
    P = k0.shape[1]
    src, dst = _host(src), _host(dst)
    keep = (src < P) & (dst > 0) & (dst < P)
    if not keep.any():
        return pool
    dev = pool["pos"].device
    s, d = _dev_index(src[keep], dev), _dev_index(dst[keep], dev)
    for leaf, _ in _kv_pairs(pool):
        leaf[:, d] = leaf[:, s]
    return pool


# ---------------------------------------------------------------------------
# Signatures
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


class TracedRegistry:
    """Eager dispatch of the serve roles with the JAX registry's retrace
    counters: the first call of each distinct (role, params, operand
    shapes and dtypes) signature bumps ``prefill_retraces`` /
    ``decode_retraces`` / ``scatter_retraces`` as a new ``jax.jit`` trace
    would. The params tree's signature is computed once per tree object
    (the ladder's rungs live as long as the batcher)."""

    def __init__(self, cfg: ModelConfig, scfg, stats: Optional[Dict] = None):
        self.cfg, self.scfg = cfg, scfg
        self.stats = stats if stats is not None else {}
        for k in ("prefill_retraces", "decode_retraces", "scatter_retraces"):
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
    # signature) so the engine calls every registry alike
    @torch.inference_mode()
    def decode(self, params, cache, tokens, *, level: int = 0):
        self._seen(ROLE_DECODE, "decode_retraces", params, cache, tokens)
        return T.decode_step(params, self.cfg, cache, tokens)

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
        return T.decode_step(params, self.cfg, cache, tokens, table=table)

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
