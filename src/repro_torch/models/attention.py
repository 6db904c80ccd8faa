"""Attention: GQA/MHA with RoPE, qk-norm and sliding windows; full-sequence
(train/prefill) and cached single-token (decode) paths (counterpart of
``repro/models/attention.py``).

Every score computation of the cached paths goes through ``kernels.ops``:
the flash kernel for full sequences, the decode kernels against the
contiguous cache or the paged block arena, and on the CPU their plain
versions, which are the dense-mask formulation of the JAX package's
``_sdpa``. The prefix-reuse tail prefill (``attend_prefill_ext``) and the
encoder-decoder cross-attention (``cross_kv`` and ``attend_cross``: the
cross paths of JAX's ``attend_full(kv=)`` and ``attend_decode(cross_kv=)``)
are plain torch ops, as the JAX package computes them with ``_sdpa``,
outside any Pallas kernel. M-RoPE needs nothing here: its angles arrive
like RoPE's (``models.rotary``). Under a ``dist.sharding.Placement``
(sharded training) ``attend_full`` is tensor-parallel over the heads
where the placement split them. Under sequence parallelism (``sp``, the
residual's "seq" share) ``attend_full``, ``attend_prefill`` and
``attend_cross`` take and return the rank's rows of the sequence: the
input all-gathered along it on entry, the output reduce-scattered (heads
split) or cut to the rank's rows (computed whole) on exit
(``models.params.enter_region``, ``leave_region``). In serving under a
placement ``attend_cross`` reads the rank's rows of a ``cross_kv`` split over
``model`` and merges the ranks' softmax states.

Serving under a placement with the cache's rows split over ``model`` (a
``dist.sharding.SeqSplit``: JAX's ``constrain(k, "batch", "kv_seq", ...)``
on a cache placed by ``CACHE_AXES``) takes design (a): the layer's q, k,
v and o projections are gathered whole over ``model`` on use, and every
model rank computes every head of its batch rows. Splitting the heads
instead would need the new K/V of every head on every rank (its block
holds every kv head of its rows), an all-gather of q, k and v over the
heads each step, to save a projection that costs a fraction of a
layer's weights; and a rank's whole-head output needs no reduction, so
the residual stream stays replicated over ``model`` bit for bit.
``attend_prefill`` keeps the rank's rows of the cache it builds;
``attend_decode`` writes the new K/V only on the rank whose block holds
the write slot, runs the decode kernel's state-out variant over its
block (its live rows a prefix of it), and merges the model ranks' states
in rank order (``kernels.ref.merge_states``: torch ops on every device,
the arithmetic of the kernel's own cluster merge, which XLA's
partitioner does in JAX; no TPU kernel does it).

The decode KV cache is preallocated and updated IN PLACE by index
assignment, where the JAX package returns a new cache from a functional
``.at[].set`` (``attention.py:443-444``). The JAX package routes the writes
it must skip (a paged dead row or a position past the table, a contiguous
position past the cache) out of range and lets XLA drop them
(``mode="drop"``); PyTorch's ``index_put_`` has no such mode. So every
decode write index list has one entry per row of the batch
(``cache_write_index``, ``paged_write_index``), and a row that must not
write points at a slot it may read and writes back the value already
there. The lists are fixed-length and need no host sync, so a decode step
captures into a CUDA graph (``serve.aot.AotRegistry``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.dist import comm
from repro_torch.dist import sharding as SH
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF, merge_states
from repro_torch.models import rotary
from repro_torch.models.params import (Builder, apply_linear,
                                       apply_row_parallel, enter_region,
                                       head_rms_norm, leave_region)


def init_attention(b: Builder, cfg: ModelConfig,
                   stack: Tuple[int, ...] = (), cross: bool = False) -> None:
    """q/k/v/o projections (qwen2-vl's q/k/v with a bias) and, with
    ``cfg.qk_norm``, per-head q/k norms, which a cross block has not."""
    heads_ax = "heads" if cfg.shard_attn_heads else "fsdp"
    kv_ax = "kv_heads" if cfg.shard_attn_heads else "fsdp"
    bias = cfg.family == "vlm"   # qwen2-vl carries qkv bias
    b.linear("wq", cfg.d_model, cfg.q_dim, ("fsdp", heads_ax), stack, bias=bias)
    b.linear("wk", cfg.d_model, cfg.kv_dim, ("fsdp", kv_ax), stack, bias=bias)
    b.linear("wv", cfg.d_model, cfg.kv_dim, ("fsdp", kv_ax), stack, bias=bias)
    b.linear("wo", cfg.q_dim, cfg.d_model, (heads_ax, "fsdp"), stack,
             scale=0.02 / max(1, cfg.n_layers) ** 0.5)
    if cfg.qk_norm and not cross:
        b.ones("q_norm", (*stack, cfg.head_dim), ((None,) * len(stack)) + (None,))
        b.ones("k_norm", (*stack, cfg.head_dim), ((None,) * len(stack)) + (None,))


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
         angles: Optional[torch.Tensor]
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (…, H, hd), k and v (…, KV, hd), the head counts read from the
    projections' widths (a rank's share of the heads under tensor
    parallelism)."""
    hd = cfg.head_dim
    q, k, v = (apply_linear(p[n], x) for n in ("wq", "wk", "wv"))
    q = _split_heads(q, q.shape[-1] // hd, hd)
    k = _split_heads(k, k.shape[-1] // hd, hd)
    v = _split_heads(v, v.shape[-1] // hd, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = head_rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = head_rms_norm(p["k_norm"], k, cfg.norm_eps)
    if angles is not None:
        q = rotary.apply_rope(q, angles)
        k = rotary.apply_rope(k, angles)
    return q, k, v


def cross_kv(p: Dict, cfg: ModelConfig, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cross block's K and V of the encoder output (B, T, D): (B, T, KV,
    hd) each, no rope."""
    k = _split_heads(apply_linear(p["wk"], enc_out), cfg.n_kv_heads,
                     cfg.head_dim)
    v = _split_heads(apply_linear(p["wv"], enc_out), cfg.n_kv_heads,
                     cfg.head_dim)
    return k, v


def attend_cross(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, split=None, sp=None
                 ) -> torch.Tensor:
    """Cross-attention of x (B, S, D) to the encoder's K/V (B, T, KV, hd):
    q from x with no rope and no norm, every encoder position visible (an
    all-true mask), JAX's ``_sdpa``. A dead decode row gets no exact zero
    here, as in JAX (``attention.py:397-401`` there).

    With ``split`` (a ``dist.sharding.SeqSplit``: serving under a
    placement whose ``cross_kv`` rows split over ``model``) k and v are
    this rank's rows: each rank forms the float32 softmax state of its
    rows (``_cross_state``), and the model ranks' states, all-gathered in
    one tensor, are merged in rank order with ``kernels.ref.
    merge_states``' arithmetic, as the self-attention's are
    (``_split_decode``). Plain torch ops, as JAX's cross-attention is
    plain XLA ops. Under ``sp`` x is the rank's rows of the decoder's
    sequence, and so is the output: the block is computed whole."""
    x = enter_region(x, None, sp)
    B, S, _ = x.shape
    q = _split_heads(apply_linear(p["wq"], x), cfg.n_heads, cfg.head_dim)
    if split is None:
        mask = torch.ones((B, S, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        return leave_region(apply_linear(
            p["wo"], _sdpa_masked(cfg, q, k, v, mask)), None, sp)
    hd = q.shape[-1]
    acc, m, l = _cross_state(cfg, q, k, v)
    st = comm.all_gather(torch.cat([acc, m[..., None], l[..., None]],
                                   dim=-1)[None], 0, split.group)
    out = merge_states(st[..., :hd], st[..., hd], st[..., hd + 1], v.dtype)
    return apply_linear(p["wo"], out.reshape(B, S, -1))


def _cross_state(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor):
    """The unnormalised softmax state of ``_sdpa_masked`` with every row
    visible over a block of the encoder rows: q (B, S, H, hd), k/v (B, T,
    KV, hd). Returns float32 (acc (B, S, H, hd), m (B, S, H), l (B, S,
    H)): the sum of p·v with p rounded to v's dtype, the max score and the
    sum of unrounded p, ``merge_states``' operands."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * hd ** -0.5
    cap = cfg.attn_logit_softcap
    if cap:
        s = cap * torch.tanh(s / cap)
    m = s.amax(dim=-1, keepdim=True)
    pr = torch.exp(s - m)
    acc = torch.einsum("bkgst,btkh->bskgh", pr.to(v.dtype).float(),
                       v.float())

    def rows(t):                                # (B, KV, G, S) -> (B, S, H)
        return t.permute(0, 3, 1, 2).reshape(B, S, H)
    return (acc.reshape(B, S, H, hd), rows(m[..., 0]),
            rows(pr.sum(dim=-1)))


def _tp_replicated(p: Dict, group) -> Dict:
    """The attention's leaves that every model rank holds whole but uses
    for its own heads only (k and v where the kv heads are not split, the
    qk-norm scales), each through ``comm.tp_enter``: a rank's gradient of
    them is its heads' part, summed over ``model``."""
    out = dict(p)
    if SH.share_of(p["wk"], "col") is None:
        for name in ("wk", "wv"):
            out[name] = {k: comm.tp_enter(v, group) if k in ("w", "b")
                         else v for k, v in p[name].items()}
    for name in ("q_norm", "k_norm"):
        if name in p:
            out[name] = comm.tp_enter(p[name], group)
    return out


def _kv_of_local_heads(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                       h0: int, hl: int):
    """The kv heads that the q heads [h0, h0 + hl) read (GQA groups of G =
    H / KV q heads) when every rank holds all the kv heads (they do not
    split over ``model`` where the q heads do): the one kv head the local
    q heads share, else one kv head a q head."""
    G = cfg.n_heads // cfg.n_kv_heads
    if G % hl == 0:
        j = h0 // G
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    idx = torch.arange(h0, h0 + hl, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def attend_full(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                angles: Optional[torch.Tensor], *, causal: bool = True,
                window: int = 0, sp=None) -> torch.Tensor:
    """Train/prefill self-attention over the full sequence. Under a
    placement that splits the heads over ``model`` (``wq`` marked
    column-parallel, ``wo`` row-parallel: JAX's ``constrain`` of q, k, v
    and the output over "heads" / "kv_heads"), each rank runs the flash
    kernel on its own heads and the output is summed over ``model``; where
    the kv heads stay whole, a rank's q heads read their own group's.
    Under ``sp`` (sequence parallelism) x and the output are the rank's
    rows (``enter_region``, ``leave_region``)."""
    tp = SH.share_of(p["wq"], "col")
    x = enter_region(x, None if tp is None else tp.group, sp)
    B, S, _ = x.shape
    if tp is not None:
        p = _tp_replicated(p, tp.group)
    q, k, v = _qkv(p, cfg, x, angles)
    if tp is not None and SH.share_of(p["wk"], "col") is None:
        hl = q.shape[2]
        k, v = _kv_of_local_heads(cfg, k, v, tp.index * hl, hl)
    out = kops.flash_attention(q, k, v, causal, window,
                               cfg.attn_logit_softcap)
    out = out.reshape(B, S, q.shape[2] * cfg.head_dim)
    if tp is not None:
        return apply_row_parallel(p["wo"], out, tp.group, sp)
    return leave_region(apply_linear(p["wo"], out), None, sp)


# ---------------------------------------------------------------------------
# Decode path (single new token against a cache)
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
                  dtype: torch.dtype, device: torch.device) -> Dict:
    """Full cache when window==0, else ring buffer of size window."""
    length = window if window else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def cache_write_index(pos: torch.Tensor, length: int, window: int
                      ) -> Tuple[torch.Tensor, ...]:
    """Where a decode step writes each row's new K/V in a contiguous cache
    of ``length`` slots: (rows, slots, keep), one entry per row. Ring
    (window > 0): every row writes, at pos mod length (keep is None).
    Full: a dead row (pos = -1) parks its write at slot 0 of its own row,
    masked by length 0 downstream and overwritten on slot reuse, as in the
    JAX package; a row past the end of the cache (pos >= length, a request
    longer than max_len) has keep False and points at slot 0, where its
    write puts back the value already there (JAX drops its out-of-range
    ``.at[].set``). ``decode_step`` computes the index once per step."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    if window:
        return rows, torch.remainder(pos, length).long(), None
    keep = pos < length
    slot = torch.where(keep, pos.clamp_min(0), torch.zeros_like(pos))
    return rows, slot.long(), keep


def paged_write_index(pos: torch.Tensor, table: torch.Tensor, bk: int
                      ) -> Tuple[torch.Tensor, ...]:
    """Where a decode step writes each row's new K/V in a paged arena:
    (blocks, offsets, keep), one entry per row. A dead row (pos < 0) and a
    position past the table have keep False and point at offset 0 of the
    null block 0, where their writes put back the value already there, so
    that block gets no new content (the JAX package points them at an
    out-of-range block that XLA drops). A live position's table entry is an
    allocated block, never 0. ``decode_step`` computes it once per step."""
    NB = table.shape[1]
    rows = torch.arange(pos.shape[0], device=pos.device)
    safe = pos.clamp_min(0).long()
    lblk = torch.div(safe, bk, rounding_mode="floor")
    keep = (pos >= 0) & (lblk < NB)
    blk = table[rows, lblk.clamp_max(NB - 1)].long()
    zero = torch.zeros_like(blk)
    return (torch.where(keep, blk, zero), torch.where(keep, safe % bk, zero),
            keep)


def local_write_index(index: Tuple[torch.Tensor, ...], split
                      ) -> Tuple[torch.Tensor, ...]:
    """``cache_write_index``'s (rows, slots, keep) of the whole cache
    made a rank's under ``split`` (a ``dist.sharding.SeqSplit``): a row
    whose slot lies in the rank's block writes at ``slot - offset``; every
    other row has keep False and points at slot 0, where its write puts
    back the value already there. No host read."""
    rows, slot, keep = index
    mine = (slot >= split.offset) & (slot < split.offset + split.rows)
    if keep is not None:
        mine = mine & keep
    return rows, torch.where(mine, slot - split.offset,
                             torch.zeros_like(slot)), mine


def split_live_rows(pos: torch.Tensor, window: int, split) -> torch.Tensor:
    """(B,) int32: each slot's live rows in this rank's block of the
    cache, a prefix of it. A slot's live rows are a prefix of the whole
    cache in both layouts (``kernels.decode_attention.live_rows``: [0,
    len) full, [0, min(len, window)) ring), so the block's are
    ``clamp(live - offset, 0, rows)``."""
    live = (pos + 1).clamp_min(0)
    if window:
        live = live.clamp_max(window)
    live = live.clamp_max(split.length)
    return (live - split.offset).clamp(0, split.rows).to(torch.int32)


def _split_decode(cfg: ModelConfig, q: torch.Tensor, cache: Dict,
                  pos: torch.Tensor, window: int, split) -> torch.Tensor:
    """Decode attention of q (B, H, hd) over a cache whose rows are split
    over ``model``: the state-out kernel over this rank's block, the
    states all-gathered over the model group in one tensor and merged in
    rank order (block order). Returns (B, H, hd) in q's dtype, identical
    on every model rank."""
    hd = q.shape[-1]
    acc, m, l = kops.decode_attention_state(
        q, cache["k"], cache["v"], split_live_rows(pos, window, split),
        softcap=cfg.attn_logit_softcap)
    st = comm.all_gather(torch.cat([acc, m[..., None], l[..., None]],
                                   dim=-1)[None], 0, split.group)
    return merge_states(st[..., :hd], st[..., hd], st[..., hd + 1], q.dtype)


def _write_rows(leaf: torch.Tensor, index: Tuple[torch.Tensor, ...],
                new: torch.Tensor) -> None:
    """leaf[i, j] = new for every (i, j) of ``index``'s first two lists;
    where its ``keep`` is False the value already at (i, j) goes back."""
    i, j, keep = index
    new = new.to(leaf.dtype)
    if keep is not None:
        new = torch.where(keep[:, None, None], new, leaf[i, j])
    leaf[i, j] = new


def attend_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  pos: torch.Tensor, cache: Dict,
                  angles: Optional[torch.Tensor], *, window: int = 0,
                  table: Optional[torch.Tensor] = None,
                  write_index: Optional[Tuple[torch.Tensor, ...]] = None,
                  split=None) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,D); pos: (B,) int per-sequence positions of the new token
    (-1 marks a dead/purged slot: its output row is exact zeros). Writes
    the new K/V into ``cache`` in place and returns (out, cache).

    With ``split`` (a ``dist.sharding.SeqSplit``) ``cache`` is this rank's
    block of rows of a contiguous cache of ``split.length`` rows a slot,
    and ``write_index`` (when given) is already the block's
    (``local_write_index``); see the module's note.

    With ``table`` (B, NB) int32 the cache is a paged arena: k/v (P, bk,
    KV, hd), logical block j of row b in arena block table[b, j] (full
    layout only). Dead rows write nothing there. ``write_index`` is what
    ``paged_write_index`` (paged) or ``cache_write_index`` (contiguous)
    returns, when the caller has it."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, angles)
    if split is not None:
        if table is not None:
            raise NotImplementedError("a paged pool on a mesh: JAX places "
                                      "none")
        wi = (write_index if write_index is not None else local_write_index(
            cache_write_index(pos, split.length, window), split))
        _write_rows(cache["k"], wi, k_new[:, 0])
        _write_rows(cache["v"], wi, v_new[:, 0])
        out = _split_decode(cfg, q[:, 0], cache, pos, window, split)
    elif table is not None:
        if window:
            raise ValueError("the paged cache is full-layout only")
        wi = (write_index if write_index is not None else
              paged_write_index(pos, table, cache["k"].shape[1]))
        _write_rows(cache["k"], wi, k_new[:, 0])
        _write_rows(cache["v"], wi, v_new[:, 0])
        out = kops.decode_attention_paged(q[:, 0], cache["k"], cache["v"],
                                          pos + 1, table,
                                          softcap=cfg.attn_logit_softcap)
    else:
        wi = (write_index if write_index is not None else
              cache_write_index(pos, cache["k"].shape[1], window))
        _write_rows(cache["k"], wi, k_new[:, 0])
        _write_rows(cache["v"], wi, v_new[:, 0])
        out = kops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                    pos + 1, window=window,
                                    softcap=cfg.attn_logit_softcap)
    out = apply_linear(p["wo"], out.reshape(B, 1, cfg.q_dim))
    return out, cache


def _cache_slots(k: torch.Tensor, lengths: torch.Tensor, L: int,
                 window: int, start: int = 0) -> torch.Tensor:
    """Gather prefill K (or V) into the decode-cache slot layout.

    Full cache (window=0): slot s holds position s; live iff s < len.
    Ring: slot s (< window) holds the LATEST position p ≡ s (mod window)
    with p < len. k: (B, S, K, hd) -> (B, L, K, hd): slots [start, start
    + L) (a rank's block of a sequence-split cache)."""
    B, S = k.shape[0], k.shape[1]
    s = torch.arange(start, start + L, device=k.device)[None, :]  # (1, L)
    lengths = lengths.to(device=k.device, dtype=torch.int64)
    if window:
        cycles = torch.div(lengths[:, None] - 1 - s, window,
                           rounding_mode="floor")
        p = s + cycles * window
        valid = (p >= 0) & (s < window)
    else:
        p = s.expand(B, L)
        valid = s < lengths[:, None]
    idx = p.clamp(0, S - 1)
    g = k[torch.arange(B, device=k.device)[:, None], idx]     # (B, L, K, hd)
    return torch.where(valid[..., None, None], g, torch.zeros_like(g))


def attend_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                   angles: Optional[torch.Tensor], *, causal: bool = True,
                   window: int = 0, max_len: int = 0,
                   lengths: Optional[torch.Tensor] = None,
                   split=None, sp=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention that also materializes the decode cache.

    Full cache: k/v placed at [0, S) of a (B, max_len, ...) buffer.
    Windowed: ring layout — the last `window` live tokens land at slot
    pos%window. `lengths` (B,) marks per-row live prompt lengths when the
    batch is right-padded; slots past a row's length are zeroed. With
    ``split`` (a ``dist.sharding.SeqSplit`` of the cache's ``window or
    max_len`` rows) only this rank's block of rows is built. Under ``sp``
    x and the output are the rank's rows of the prompts; the K/V are
    every row's, gathered."""
    x = enter_region(x, None, sp)
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, angles)
    out = kops.flash_attention(q, k, v, causal, window,
                               cfg.attn_logit_softcap)
    out = leave_region(apply_linear(p["wo"], out.reshape(B, S, cfg.q_dim)),
                       None, sp)
    L, start = window if window else max_len, 0
    if split is not None:
        if split.length != L:
            raise ValueError(f"a split of {split.length} rows for a cache "
                             f"of {L}")
        L, start = split.rows, split.offset
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    ck = _cache_slots(k, lengths, L, window, start)
    cv = _cache_slots(v, lengths, L, window, start)
    return out, {"k": ck, "v": cv}


def _sdpa_masked(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Dense-mask attention of the JAX package's ``_sdpa``: q (B, S, H,
    hd), k/v (B, T, KV, hd), mask (B, S, T) bool. Products accumulate in
    fp32 (inputs widened exactly), scores are scaled after QK, masked
    scores take ``NEG_INF``, the softmax runs in fp32 and its weights are
    rounded to v's dtype for PV. Returns (B, S, H*hd) in v's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * hd ** -0.5
    cap = cfg.attn_logit_softcap
    if cap:
        s = cap * torch.tanh(s / cap)
    s = torch.where(mask[:, None, None], s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.to(v.dtype).reshape(B, S, H * hd)


def attend_prefill_ext(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                       angles: Optional[torch.Tensor], arena: Dict,
                       table: torch.Tensor, starts: torch.Tensor,
                       lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Tail prefill against a paged prefix (prefix-reuse admission).

    x: (B, St, D) embeds of the UNSHARED tail only, positions starting at
    ``starts`` (the caller's rope angles encode that offset); arena: paged
    k/v (P, bk, KV, hd), read only; table: (B, NB) int block table whose
    first ``starts[b]`` positions hold the shared prefix; starts/lengths:
    (B,) prefix length and live TAIL length.

    Each tail query attends [shared prefix | causal tail]. Returns (out
    (B, St, D), tail cache {k, v}: (B, St, KV, hd), slot s = tail position
    s, zeroed past ``lengths``; ``serve.aot.scatter_paged`` writes it
    through the table at absolute offsets). Plain torch ops, as in the JAX
    package (no kernel there either): prefix-reuse serving is bound by the
    admission rate, not by prefill operations."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, angles)
    bk = arena["k"].shape[1]
    NB = table.shape[1]
    Lp = NB * bk
    idx = table.to(device=x.device, dtype=torch.long)
    kp = arena["k"][idx].reshape(B, Lp, *arena["k"].shape[2:])
    vp = arena["v"][idx].reshape(B, Lp, *arena["v"].shape[2:])
    kk = torch.cat([kp.to(k.dtype), k], dim=1)          # (B, Lp+S, KV, hd)
    vv = torch.cat([vp.to(v.dtype), v], dim=1)
    starts = starts.to(device=x.device, dtype=torch.long)
    prefix_ok = (torch.arange(Lp, device=x.device)[None, :]
                 < starts[:, None])                     # (B, Lp)
    ar = torch.arange(S, device=x.device)
    tail_ok = ar[None, :] <= ar[:, None]                # (S, S)
    mask = torch.cat([prefix_ok[:, None, :].expand(B, S, Lp),
                      tail_ok[None].expand(B, S, S)], dim=2)
    out = apply_linear(p["wo"], _sdpa_masked(cfg, q, kk, vv, mask))
    ck = _cache_slots(k, lengths, S, 0).to(k.dtype)
    cv = _cache_slots(v, lengths, S, 0).to(v.dtype)
    return out, {"k": ck, "v": cv}
