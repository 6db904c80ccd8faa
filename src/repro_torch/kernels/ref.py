"""Plain PyTorch versions of every kernel (counterpart of
``repro/kernels/ref.py``). On a CPU tensor ``kernels.ops`` runs these; on the
card ``chip_smoke.py`` holds each CUDA kernel against them.

They follow the CUDA kernels' rounding, not only their math, so that kernel
and plain version agree tightly in bf16 as well:

* ``lowrank_matmul`` rounds the rank-R intermediate ``t = x@B`` to C's dtype
  before the second product (``_gemv_kernel``/``_kernel`` of the TPU
  package, ``lowrank_matmul.py:49,68``);
* ``flash_attention``, ``decode_attention`` and ``decode_attention_paged``
  round the softmax weights to v's dtype before the PV product, while the
  denominator sums the unrounded weights; masked scores take
  ``NEG_INF = -1e30``, never ``-inf``, and the denominator is floored at
  ``1e-30``.

In float32 every rounding above is the identity, so these equal the JAX
package's oracles to float32 accuracy.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def lowrank_matmul(x: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor) -> torch.Tensor:
    """y = (x @ B) @ C.  x: (..., K); B: (K, R); C: (R, N)."""
    t = x.float() @ B.float()
    t = t.to(C.dtype).float()
    return (t @ C.float()).to(x.dtype)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row softmax of fp32 scores ``s (..., T)`` against ``v (..., T, hd)``
    with the kernels' rounding: p is rounded to v's dtype for PV, the
    denominator sums unrounded p and is floored at 1e-30."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = p.to(v.dtype).float() @ v.float()
    return pv / l


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    return_lse: bool = False):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd); GQA via H = KV*G.
    Returns (B, S, H, hd); with ``return_lse`` also each row's float32
    log-sum-exp of its masked scores, ``m + log(max(l, 1e-30))`` as JAX's
    ``_flash_fwd_pass`` keeps it (its ``(B, KV, G, S)`` as (B, H, S)): what
    ``flash_bwd_rule`` recomputes the probabilities from."""
    Bb, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(Bb, S, KV, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    vv = v.permute(0, 2, 1, 3)[:, :, None]                    # (B,KV,1,T,hd)
    out = _softmax_pv(s, vv)                                  # (B,KV,G,S,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(Bb, S, H, hd).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return out, (m + torch.log(l.clamp_min(1e-30))).reshape(Bb, H, S)


# ---------------------------------------------------------------------------
# The tiled FlashAttention-2 backward of JAX's model (``repro/models/
# attention.py``: ``_use_flash_jnp``, ``_tile_mask``, ``_tile_pairs``,
# ``_flash_bwd_rule``): plain torch ops, as JAX computes it with XLA ops
# outside any Pallas kernel. Nothing S x T materializes: each (bq, bk) tile
# of probabilities is recomputed from (q, k, lse).
# ---------------------------------------------------------------------------
# JAX's model takes its tiled attention at or above this many scores a
# (batch, head), in tiles of FLASH_BQ query rows and FLASH_BK keys
FLASH_THRESHOLD = 1024 * 2048
FLASH_BQ, FLASH_BK = 512, 1024


def use_flash_jnp(S: int, T: int, bq: int = FLASH_BQ,
                  bk: int = FLASH_BK) -> bool:
    """JAX's ``_use_flash_jnp``: the tiled path where the score matrix
    reaches ``FLASH_THRESHOLD`` and the tiles divide S and T."""
    return (S * T >= FLASH_THRESHOLD
            and S % min(bq, S) == 0 and T % min(bk, T) == 0)


def tile_mask(qi: int, ki: int, bq: int, bk: int, causal: bool,
              window: int, device=None) -> torch.Tensor:
    """(bq, bk) bool: which (query, key) pairs of tile (qi, ki) the mask
    keeps (JAX's ``_tile_mask``)."""
    qpos = qi * bq + torch.arange(bq, device=device)[:, None]
    kpos = ki * bk + torch.arange(bk, device=device)[None, :]
    msk = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        msk &= kpos <= qpos
    if window:
        msk &= kpos > qpos - window
    return msk


def tile_pairs(nq: int, nk: int, bq: int, bk: int, causal: bool,
               window: int) -> list:
    """The (q tile, k tile) pairs with a live entry, q-major (JAX's
    ``_tile_pairs``): a tile that the mask empties is never visited."""
    pairs = []
    for qi in range(nq):
        q_lo, q_hi = qi * bq, qi * bq + bq - 1
        for ki in range(nk):
            k_lo, k_hi = ki * bk, ki * bk + bk - 1
            if causal and k_lo > q_hi:
                continue
            if window and k_hi < q_lo - window + 1:
                continue
            pairs.append((qi, ki))
    return pairs


def flash_bwd_rule(causal: bool, window: int, bq: int, bk: int,
                   qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor):
    """JAX's ``_flash_bwd_rule`` in float32: qg (B, S, KV, G, hd)
    pre-scaled, k/v (B, T, KV, hd), out and dout (B, S, KV, G, hd), lse
    (B, KV, G, S). Two passes over the live tiles: k-outer for dk and dv,
    q-outer for dq, with ``D = Σ dout·out`` a row. Returns (dqg, dk, dv) in
    qg's, k's and v's dtypes."""
    B, S, K, G, hd = qg.shape
    T = k.shape[1]
    nq, nk = S // bq, T // bk
    dev = qg.device
    D = (dout * out).sum(-1).permute(0, 2, 3, 1)              # (B,K,G,S)
    do_r = dout.permute(0, 2, 3, 1, 4)                        # (B,K,G,S,hd)

    def p_tile(qi, ki):
        qb = qg[:, qi * bq:(qi + 1) * bq]
        kb = k[:, ki * bk:(ki + 1) * bk]
        s = torch.einsum("bqkgh,btkh->bkgqt", qb, kb)
        msk = tile_mask(qi, ki, bq, bk, causal, window, dev)
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        return qb, kb, torch.exp(
            s - lse[..., qi * bq:(qi + 1) * bq, None])     # (B,K,G,bq,bk)

    def ds_tile(p, qi, ki):
        do_b = do_r[..., qi * bq:(qi + 1) * bq, :]
        dp = torch.einsum("bkgqh,btkh->bkgqt", do_b,
                          v[:, ki * bk:(ki + 1) * bk])
        return do_b, p * (dp - D[..., qi * bq:(qi + 1) * bq, None])

    pairs = tile_pairs(nq, nk, bq, bk, causal, window)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
    for qi, ki in sorted(pairs, key=lambda p: (p[1], p[0])):  # k-outer
        qb, _, p = p_tile(qi, ki)
        do_b, ds = ds_tile(p, qi, ki)
        dv[:, ki * bk:(ki + 1) * bk] += torch.einsum("bkgqt,bkgqh->btkh",
                                                     p, do_b)
        dk[:, ki * bk:(ki + 1) * bk] += torch.einsum("bkgqt,bqkgh->btkh",
                                                     ds, qb)
        del p, ds
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=dev)
    for qi, ki in pairs:                                      # q-outer
        _, kb, p = p_tile(qi, ki)
        _, ds = ds_tile(p, qi, ki)
        dq[:, qi * bq:(qi + 1) * bq] += torch.einsum("bkgqt,btkh->bqkgh",
                                                     ds, kb)
        del p, ds
    return dq.to(qg.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Ragged single-token decode attention, dense-mask formulation.

    q: (B, H, hd) one query per sequence; k/v: (B, L, KV, hd) cache pool;
    lengths: (B,) int = pos + 1 (0 marks a dead slot whose output row is
    exact zeros). window > 0 = ring-buffer layout (ring size window; slots
    >= window are alignment padding). The query is scaled before QK, as in
    the decode kernel. Returns (B, H, hd)."""
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    slot = torch.arange(L, device=q.device)[None, :]          # (1, L)
    pos = (lengths - 1)[:, None]
    if window:
        age = torch.remainder(pos - slot, window)
        valid = (age < torch.clamp(pos + 1, max=window)) & (slot < window)
    else:
        valid = slot <= pos
    qg = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    vv = v.permute(0, 2, 1, 3)[:, :, None]                    # (B,KV,1,L,hd)
    out = _softmax_pv(s[..., None, :], vv)[..., 0, :]         # (B,KV,G,hd)
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_state(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           softcap: float = 0.0):
    """The unnormalised softmax state of ``decode_attention`` over a block
    of each slot's rows, full layout: q (B, H, hd); k/v (B, L, KV, hd);
    lengths (B,) int, each slot's live rows in the block, a prefix (0: no
    live row). Returns float32 (acc (B, H, hd), m (B, H), l (B, H)): the
    sum of p·v with p rounded to v's dtype, the max of the live scores
    (``NEG_INF`` where none is live) and the sum of unrounded p (0 where
    none is). The ops are ``decode_attention``'s, so ``merge_states`` of
    one state over the whole cache gives its output bit for bit."""
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    valid = (torch.arange(L, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, None, :]     # (B,1,1,1,L)
    qg = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[..., 0, :], s, torch.full_like(s, NEG_INF))
    s = s[..., None, :]                                       # (B,KV,G,1,L)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    vv = v.permute(0, 2, 1, 3)[:, :, None]                    # (B,KV,1,L,hd)
    acc = p.to(v.dtype).float() @ vv.float()                  # (B,KV,G,1,hd)
    return (acc[..., 0, :].reshape(B, H, hd), m.reshape(B, H),
            l.reshape(B, H))


def merge_states(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Softmax states of R blocks of the same rows merged in block order,
    as the decode kernel's cluster merges its blocks': acc (R, ..., hd), m
    and l (R, ...) float32 (``decode_attention_state``'s, stacked).
    M = max m_r, w_r = exp(m_r - M), o = Σ w_r·acc_r / max(Σ w_r·l_r,
    1e-30), rounded to ``dtype``. Rows live in no block give exact zeros
    (their acc and l are 0)."""
    big = m.amax(dim=0)
    w = torch.exp(m - big)
    a = (w[..., None] * acc).sum(dim=0)
    den = (w * l).sum(dim=0).clamp_min(1e-30)
    return (a / den[..., None]).to(dtype)


def decode_attention_paged(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           table: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """Paged-pool decode attention, as the contiguous plain version on the
    gathered layout. q: (B, H, hd); k/v: (P, bk, KV, hd) block arena
    (block 0 the never-written null block); lengths: (B,) = pos + 1 (0: a
    dead slot, exact-zero row); table: (B, NB) int, logical block j of
    slot b in arena block table[b, j]. Gathering each slot's blocks back
    into a (B, NB*bk, KV, hd) cache gives the contiguous layout value for
    value, so this equals ``decode_attention`` on it bit for bit. Returns
    (B, H, hd)."""
    B, NB = table.shape
    bk = k.shape[1]
    idx = table.to(device=k.device, dtype=torch.long)
    kc = k[idx].reshape(B, NB * bk, *k.shape[2:])
    vc = v[idx].reshape(B, NB * bk, *v.shape[2:])
    return decode_attention(q, kc, vc, lengths, softcap=softcap)

def gram(x: torch.Tensor) -> torch.Tensor:
    """G = XᵀX with fp32 accumulation. x: (N, D) -> (D, D) fp32."""
    xf = x.float()
    return xf.T @ xf
