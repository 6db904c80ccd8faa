"""Attention: GQA/MHA with RoPE, qk-norm and sliding windows; full-sequence
(train/prefill) and cached single-token (decode) paths (counterpart of
``repro/models/attention.py``).

Every score computation goes through ``kernels.ops``: the flash kernel for
full sequences, the decode kernel against the cache, and on the CPU their
plain versions, which are the dense-mask formulation of the JAX package's
``_sdpa``. Cross-attention, M-RoPE and the paged pool come with their
slices.

The decode KV cache is preallocated and updated IN PLACE by index
assignment, where the JAX package returns a new cache from a functional
``.at[].set`` (``attention.py:443-444``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import rotary
from repro_torch.models.params import Builder, apply_linear, head_rms_norm


def init_attention(b: Builder, cfg: ModelConfig,
                   stack: Tuple[int, ...] = ()) -> None:
    heads_ax = "heads" if cfg.shard_attn_heads else "fsdp"
    kv_ax = "kv_heads" if cfg.shard_attn_heads else "fsdp"
    bias = cfg.family == "vlm"   # qwen2-vl carries qkv bias
    b.linear("wq", cfg.d_model, cfg.q_dim, ("fsdp", heads_ax), stack, bias=bias)
    b.linear("wk", cfg.d_model, cfg.kv_dim, ("fsdp", kv_ax), stack, bias=bias)
    b.linear("wv", cfg.d_model, cfg.kv_dim, ("fsdp", kv_ax), stack, bias=bias)
    b.linear("wo", cfg.q_dim, cfg.d_model, (heads_ax, "fsdp"), stack,
             scale=0.02 / max(1, cfg.n_layers) ** 0.5)
    if cfg.qk_norm:
        b.ones("q_norm", (*stack, cfg.head_dim), ((None,) * len(stack)) + (None,))
        b.ones("k_norm", (*stack, cfg.head_dim), ((None,) * len(stack)) + (None,))


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
         angles: Optional[torch.Tensor]
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _split_heads(apply_linear(p["wq"], x), cfg.n_heads, cfg.head_dim)
    k = _split_heads(apply_linear(p["wk"], x), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(apply_linear(p["wv"], x), cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm and "q_norm" in p:
        q = head_rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = head_rms_norm(p["k_norm"], k, cfg.norm_eps)
    if angles is not None:
        q = rotary.apply_rope(q, angles)
        k = rotary.apply_rope(k, angles)
    return q, k, v


def attend_full(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                angles: Optional[torch.Tensor], *, causal: bool = True,
                window: int = 0) -> torch.Tensor:
    """Train/prefill self-attention over the full sequence."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, angles)
    out = kops.flash_attention(q, k, v, causal, window,
                               cfg.attn_logit_softcap)
    return apply_linear(p["wo"], out.reshape(B, S, cfg.q_dim))


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


def attend_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  pos: torch.Tensor, cache: Dict,
                  angles: Optional[torch.Tensor], *, window: int = 0,
                  ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,D); pos: (B,) int per-sequence positions of the new token
    (-1 marks a dead/purged slot: its output row is exact zeros). Writes
    the new K/V into ``cache`` in place and returns (out, cache)."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, angles)
    rows = torch.arange(B, device=x.device)
    L = cache["k"].shape[1]
    # dead rows (pos = -1) park their write in their own row (slot 0 of the
    # full cache, the last slot of the ring) — masked by length 0
    # downstream, fully overwritten on slot reuse
    slot = torch.remainder(pos, L) if window else pos.clamp_min(0)
    cache["k"][rows, slot.long()] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot.long()] = v_new[:, 0].to(cache["v"].dtype)
    out = kops.decode_attention(q[:, 0], cache["k"], cache["v"], pos + 1,
                                window=window,
                                softcap=cfg.attn_logit_softcap)
    out = apply_linear(p["wo"], out.reshape(B, 1, cfg.q_dim))
    return out, cache


def _cache_slots(k: torch.Tensor, lengths: torch.Tensor, L: int,
                 window: int) -> torch.Tensor:
    """Gather prefill K (or V) into the decode-cache slot layout.

    Full cache (window=0): slot s holds position s; live iff s < len.
    Ring: slot s (< window) holds the LATEST position p ≡ s (mod window)
    with p < len. k: (B, S, K, hd) -> (B, L, K, hd)."""
    B, S = k.shape[0], k.shape[1]
    s = torch.arange(L, device=k.device)[None, :]            # (1, L)
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
                   ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention that also materializes the decode cache.

    Full cache: k/v placed at [0, S) of a (B, max_len, ...) buffer.
    Windowed: ring layout — the last `window` live tokens land at slot
    pos%window. `lengths` (B,) marks per-row live prompt lengths when the
    batch is right-padded; slots past a row's length are zeroed."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x, angles)
    out = kops.flash_attention(q, k, v, causal, window,
                               cfg.attn_logit_softcap)
    out = apply_linear(p["wo"], out.reshape(B, S, cfg.q_dim))
    L = window if window else max_len
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    ck = _cache_slots(k, lengths, L, window)
    cv = _cache_slots(v, lengths, L, window)
    return out, {"k": ck, "v": cv}
