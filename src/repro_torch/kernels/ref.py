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
                    ) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd); GQA via H = KV*G.
    Returns (B, S, H, hd)."""
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
    return out.permute(0, 3, 1, 2, 4).reshape(Bb, S, H, hd).to(q.dtype)


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
