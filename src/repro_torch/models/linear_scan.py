"""Chunked linear-recurrence engine (counterpart of
``repro/models/linear_scan.py``).

One engine powers every O(1)-state sequence mixer of the port:

  * xLSTM mLSTM   — matrix memory ``S_t = f_t S_{t-1} + i_t v_t k_t^T`` with
    stabilized exponential gating and the ``max(|n^T q|, 1)`` normalizer.
  * Mamba-2 / SSD — per-head scalar decay ``S_t = a_t S_{t-1} + (Δu)_t B_t^T``
    read out with C_t (q := C, k := B, v := Δ·u, no input gate / normalizer).

Sequences are processed in chunks of length ``L``: intra-chunk interactions
are an (L×L)-masked matmul pair and only the O(S/L) inter-chunk state
recurrence is a loop. This is the standard chunked linear-attention
factorization: exact, not an approximation. The JAX package computes it
with plain XLA ops outside any Pallas kernel; here it is plain torch ops
(batched matrix products through ``torch.einsum``/``matmul``).

Numerical stabilization is the JAX package's, step for step: all gates live
in log space; a running max ``m`` is carried across chunks; the matrix state
and normalizer are stored rescaled by ``exp(-m)``; masked (future) entries
are set to ``NEG`` before the ``exp``; padded steps carry ``log_f = 0`` and
``log_i = NEG``; the mLSTM denominator ``max(|n^T q|, 1)`` becomes
``max(|ñ^T q|, exp(-(F + M)))`` in rescaled coordinates. Everything inside
runs in float32.

The chunk's state update (JAX's ``einsum("bthv,bthd,bth->bhvd")``) is one
product per head, ``(v·sw)^T k``, so no (B, L, H, dv, dk) tensor is ever
formed (at xLSTM's dv = dk = 512 and L = 128 that would be 0.5 GB a row).

Shapes (all functions):
  q : (B, S, H, dk)      k : (B, S, H, dk)      v : (B, S, H, dv)
  log_f : (B, S, H)  per-step log forget gate (<= 0)
  log_i : (B, S, H)  per-step log input gate (unbounded; stabilized here)
State: S (B, H, dv, dk), n (B, H, dk), m (B, H).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30


class ScanState(NamedTuple):
    S: torch.Tensor       # (B, H, dv, dk) rescaled matrix memory
    n: torch.Tensor       # (B, H, dk)    rescaled normalizer (mLSTM only)
    m: torch.Tensor       # (B, H)        running log-max stabilizer


def init_state(batch: int, heads: int, dk: int, dv: int,
               dtype=torch.float32, device=None) -> ScanState:
    return ScanState(
        S=torch.zeros((batch, heads, dv, dk), dtype=dtype, device=device),
        n=torch.zeros((batch, heads, dk), dtype=dtype, device=device),
        m=torch.zeros((batch, heads), dtype=dtype, device=device),
    )


def _chunk(x: torch.Tensor, L: int) -> torch.Tensor:
    """(B, S, ...) -> (B, S//L, L, ...)."""
    B, S = x.shape[:2]
    return x.reshape(B, S // L, L, *x.shape[2:])


def chunked_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_f: torch.Tensor, log_i: torch.Tensor,
                 state: Optional[ScanState] = None,
                 *, chunk: int = 128, normalize: bool = False,
                 ) -> Tuple[torch.Tensor, ScanState]:
    """Exact chunked linear recurrence. Returns (y (B,S,H,dv), final state).

    y_t = (S_t q_t) / denom_t      with S_t = exp(log_f_t) S_{t-1}
                                          + exp(log_i_t) v_t k_t^T
    denom_t = max(|n_t^T q_t|, 1) when normalize else 1.
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    out_dtype = v.dtype
    L = min(chunk, S)
    if S % L:
        pad = L - S % L
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        # padded steps: forget=1 (log 0), input gate -inf (contribute nothing)
        log_f = F.pad(log_f, (0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG)
    Sp = q.shape[1]
    if state is None:
        state = init_state(B, H, dk, dv, device=q.device)

    f32 = torch.float32
    qc, kc, vc = (_chunk(x, L).to(f32) for x in (q, k, v))
    lfc, lic = (_chunk(x, L).to(f32) for x in (log_f, log_i))   # (B,C,L,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    S0, n0, m0 = (t.to(f32) for t in state)
    ys = []
    for c in range(Sp // L):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]       # (B,L,H,d)
        lf, li = lfc[:, c], lic[:, c]                   # (B,L,H)
        Fc = torch.cumsum(lf, dim=1)                    # decay to step j incl
        FL = Fc[:, -1]                                  # (B,H) chunk decay
        w = li - Fc                                     # source log-weight
        # per-step stabilizer M_j = max(m0, cummax_{τ<=j} w_τ)
        M = torch.maximum(m0[:, None], torch.cummax(w, dim=1).values)
        m_new = torch.maximum(m0 + FL, w.amax(dim=1) + FL)

        # ---- intra-chunk attention-style term ---------------------------
        # A[j,τ] = exp(w_τ - M_j) for τ <= j; masked to NEG before the exp
        logA = w[:, None, :, :] - M[:, :, None, :]      # (B, j, τ, H)
        logA = torch.where(mask[None, :, :, None], logA,
                           torch.full_like(logA, NEG))
        A = torch.exp(logA)
        qk = torch.einsum("bjhd,bthd->bjth", qb, kb)    # (B,j,τ,H)
        intra = torch.einsum("bjth,bthv->bjhv", qk * A, vb)

        # ---- inter-chunk (carried state) term: exp(m0 - M_j) ------------
        carry_w = torch.exp(m0[:, None] - M)            # (B,L,H)
        inter = torch.einsum("bhvd,bjhd->bjhv", S0, qb) * carry_w[..., None]
        num = intra + inter                             # (B,L,H,dv)

        if normalize:
            nk = torch.einsum("bjth,bthd->bjhd", A, kb)  # Σ_τ A k_τ
            nvec = nk + n0[:, None] * carry_w[..., None]
            dot = (nvec * qb).sum(-1)                   # (B,L,H)
            # true m at step j is F_j + M_j
            denom = torch.maximum(dot.abs(), torch.exp(-(Fc + M)))
            y = num / denom[..., None]
        else:
            # undo the exp(-m_j) rescale (exact: m_j == 0 for SSD gates)
            y = num * torch.exp(Fc + M)[..., None]
        ys.append(y)

        # ---- state update: per head (v·sw)^T k --------------------------
        sw = torch.exp(w + FL[:, None] - m_new[:, None])        # (B,L,H)
        vs = (vb * sw[..., None]).permute(0, 2, 3, 1)           # (B,H,dv,L)
        upd = torch.matmul(vs, kb.permute(0, 2, 1, 3))          # (B,H,dv,dk)
        dec = torch.exp(m0 + FL - m_new)
        S0 = S0 * dec[..., None, None] + upd
        n0 = n0 * dec[..., None] + torch.einsum("bthd,bth->bhd", kb, sw)
        m0 = m_new
    y = torch.stack(ys, dim=1).reshape(B, Sp, H, dv)[:, :S]
    return y.to(out_dtype), ScanState(S0, n0, m0)


def step_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_f: torch.Tensor, log_i: torch.Tensor,
              state: ScanState, *, normalize: bool = False,
              ) -> Tuple[torch.Tensor, ScanState]:
    """Single decode step. q/k/v: (B, H, d·); log_f/log_i: (B, H)."""
    S0, n0, m0 = state
    lf = log_f.to(torch.float32)
    li = log_i.to(torch.float32)
    m_new = torch.maximum(m0 + lf, li)
    dec = torch.exp(m0 + lf - m_new)
    inp = torch.exp(li - m_new)
    qf, kf, vf = (a.to(torch.float32) for a in (q, k, v))
    S_new = S0 * dec[..., None, None] + (
        (vf * inp[..., None])[..., :, None] * kf[..., None, :])
    n_new = n0 * dec[..., None] + kf * inp[..., None]
    num = torch.einsum("bhvd,bhd->bhv", S_new, qf)
    if normalize:
        dot = (n_new * qf).sum(-1)
        denom = torch.maximum(dot.abs(), torch.exp(-m_new))
        y = num / denom[..., None]
    else:
        y = num * torch.exp(m_new)[..., None]
    return y.to(v.dtype), ScanState(S_new, n_new, m_new)


def reference_scan(q, k, v, log_f, log_i, state=None, *, normalize=False):
    """Per-step oracle (O(S) sequential) for tests. Same signature and
    semantics as ``chunked_scan``."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = init_state(B, H, dk, dv, device=q.device)
    ys = []
    for t in range(S):
        y, state = step_scan(*(a[:, t].to(torch.float32)
                               for a in (q, k, v, log_f, log_i)),
                             state, normalize=normalize)
        ys.append(y)
    return torch.stack(ys, dim=1).to(v.dtype), state
