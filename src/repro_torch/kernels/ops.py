"""Public ops over the kernels (counterpart of ``repro/kernels/ops.py``).

Dispatch rule, by where the operands lie:

* a CPU tensor goes to the plain PyTorch version in ``kernels.ref``;
* a CUDA tensor goes to the hand-written kernel, or the wrapper raises.

Nothing catches a failed build or launch to carry on with the plain version,
and no library call stands in for a kernel. Unlike the JAX wrapper, nothing
is padded or transposed here: the kernels mask ragged edges themselves and
read the model's layouts in place.

``lowrank_matmul`` and ``flash_attention`` are differentiable through
``torch.autograd.Function``s whose backward is the reference formulation of
``ops._lowrank_bwd`` / ``ops._flash_bwd`` in the JAX package; the kernels
stay forward-only. Where JAX's model takes its tiled attention
(``_sdpa_flash_jnp``: ``flash_tiled``), the flash forward also keeps each
row's log-sum-exp (the kernel's LSE flag) and the backward is JAX's tiled
FlashAttention-2 rule (``ref.flash_bwd_rule``), which never holds an S x T
tensor. ``decode_attention`` and ``gram`` are inference-only;
``gram`` runs the ``gram_blocked`` kernel for the streaming calibrator.

A meta tensor (shapes only, no data) takes the plain version: that is how
``core.capture.discover_capture_dims`` walks a forward pass without running
it, as the JAX package does under ``jax.eval_shape``.

While ``launch.op_analysis.Counter`` counts a step it sits in ``_COUNTER``,
and each wrapper reports its call by its own formula (``*_cost``): the
FLOPs of the plain product, as JAX's dry-run counts them (the full masked
score tile; causal blocks that the kernel skips are not subtracted, and
``flops_needed`` gives what the mask keeps), and its bytes under two
models, ``plain`` (the intermediates that the plain version materialises,
each written and read once: low-rank ``t``, the float32 score tile, the
gathered paged cache) and ``resident`` (those stay on chip). The CUDA
kernels are ``ctypes`` calls that no dispatch mode sees, and the plain
version's ops would count another algorithm, so what runs inside a wrapper
is hidden from the counter, and under the counter a meta call returns an
output of the right shape without running anything.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    decode_attention_bkgh, decode_attention_paged_bkgh,
    decode_attention_state_bkgh)
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.gram import gram_blocked
from repro_torch.kernels.lowrank_matmul import lowrank_gemv, lowrank_matmul_2d

# At or below this many flattened rows the low-rank matmul is decode-shaped:
# route to the weight-streaming kernel instead of the prefill tiler.
GEMV_MAX_ROWS = 64

# the op counter while it counts a step (launch.op_analysis.Counter)
_COUNTER = None


# ---------------------------------------------------------------------------
# each kernel's work by its own formula: {flops, plain, resident} (bytes)
# ---------------------------------------------------------------------------
def _nb(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lowrank_cost(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> dict:
    """y = (x@B)@C over x's flattened rows, in x's dtype: two products;
    ``t`` (M, R) in x's dtype is the plain version's intermediate."""
    K, R, N = B.shape[0], B.shape[1], C.shape[-1]
    M = x.numel() // K
    es = x.element_size()
    resident = _nb(x, B, C) + M * N * es
    return {"flops": 2.0 * M * R * (K + N), "resident": resident,
            "plain": resident + 2 * M * R * es}


def _pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the mask keeps, query i at position i, key j
    at j: causal j <= i, window j > i - window."""
    if causal:
        hi = S * (S + 1) // 2 if S <= T else T * (T + 1) // 2 + (S - T) * T
    else:
        hi = S * T
    lo = 0
    if window and S > window:          # keys at or below i - window
        n = S - window
        lo = n * (n + 1) // 2
    return hi - lo


def flash_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int, lse: bool = False) -> dict:
    """QKᵀ and PV over the full (S, T) tile of every head; the plain
    version's float32 score tile is written once and read once; with
    ``lse`` a float32 row statistic is written too."""
    Bb, S, H, hd = q.shape
    T = k.shape[1]
    resident = (_nb(q, k, v) + q.numel() * q.element_size()
                + (4 * Bb * H * S if lse else 0))
    return {"flops": 4.0 * Bb * H * S * T * hd,
            "flops_needed": 4.0 * Bb * H * _pairs(S, T, causal, window) * hd,
            "resident": resident, "plain": resident + 2 * Bb * H * S * T * 4}


def decode_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> dict:
    """One query a row against the whole (B, L) cache, as the plain version
    (dead and unwritten slots masked, not skipped)."""
    Bb, H, hd = q.shape
    L = k.shape[1]
    resident = _nb(q, k, v, lengths) + q.numel() * q.element_size()
    return {"flops": 4.0 * Bb * H * L * hd, "resident": resident,
            "plain": resident + 2 * Bb * H * L * 4}


def decode_state_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor) -> dict:
    """``decode_cost`` of the rows given, with the float32 state (acc,
    m, l) written in place of o."""
    Bb, H, hd = q.shape
    L = k.shape[1]
    resident = _nb(q, k, v, lengths) + 4 * Bb * H * (hd + 2)
    return {"flops": 4.0 * Bb * H * L * hd, "resident": resident,
            "plain": resident + 2 * Bb * H * L * 4}


def decode_paged_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, table: torch.Tensor) -> dict:
    """The contiguous formula over the table's NB·bk slots a row; only the
    blocks the table names are read. The plain version gathers them into a
    contiguous copy first (written and read once)."""
    Bb, H, hd = q.shape
    L = table.shape[1] * k.shape[1]
    kv = 2 * Bb * L * k.shape[2] * hd * k.element_size()
    resident = (_nb(q, lengths, table) + q.numel() * q.element_size() + kv)
    return {"flops": 4.0 * Bb * H * L * hd, "resident": resident,
            "plain": resident + 2 * kv + 2 * Bb * H * L * 4}


def gram_cost(x2: torch.Tensor, out: Optional[torch.Tensor]) -> dict:
    """XᵀX (N, D) into a float32 (D, D), read first when accumulated."""
    N, D = x2.shape
    nb = _nb(x2) + D * D * 4 * (1 if out is None else 2)
    return {"flops": 2.0 * N * D * D, "resident": nb, "plain": nb}


_NOT_COUNTING = contextlib.nullcontext(False)


def _kernel_call(name: str, t: torch.Tensor, cost):
    """Around a wrapper's work: under the op counter, its ``kernel_call``
    (report ``cost()``, hide the work's ops; True where the call must not
    run: a meta tensor); otherwise a context that yields False."""
    counter = _COUNTER
    if counter is None:
        return _NOT_COUNTING
    return counter.kernel_call(name, t, cost)


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    or meta tensor); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{what}: no kernel or plain version for {t.device}")


# ---------------------------------------------------------------------------
# lowrank_matmul: y = (x @ B) @ C
# ---------------------------------------------------------------------------
def _lowrank_fwd_impl(x: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor) -> torch.Tensor:
    *lead, K = x.shape
    N = C.shape[-1]
    gemv = x.numel() // K <= GEMV_MAX_ROWS
    with _kernel_call("lowrank_gemv" if gemv else "lowrank_matmul_2d", x,
                      lambda: lowrank_cost(x, B, C)) as skip:
        if skip:
            return x.new_empty((*lead, N))
        x2 = x.reshape(-1, K)
        B = B.to(x.dtype)
        C = C.to(x.dtype)
        if not _route(x, "lowrank_matmul"):
            y = ref.lowrank_matmul(x2, B, C)
        else:
            # the kernels read row-major operands; a view that is not one
            # (a slice, a transpose) is copied once here
            x2, B, C = x2.contiguous(), B.contiguous(), C.contiguous()
            y = (lowrank_gemv if gemv else lowrank_matmul_2d)(x2, B, C)
        return y.reshape(*lead, N)


class _LowRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, B, C):
        ctx.save_for_backward(x, B, C)
        return _lowrank_fwd_impl(x, B, C)

    @staticmethod
    def backward(ctx, g):
        # only the grads asked for: LoRA freezes B and C, and then two
        # thirds of the products below are never needed
        need_x, need_B, need_C = ctx.needs_input_grad
        x, B, C = ctx.saved_tensors
        g2 = g.float().reshape(-1, g.shape[-1])
        dx = dB = dC = None
        if need_B or need_C:
            x2 = x.float().reshape(-1, x.shape[-1])
        if need_C:
            t2 = x2 @ B.float()                               # (M, R)
            dC = (t2.T @ g2).to(C.dtype)
        if need_x or need_B:
            gt = g2 @ C.float().T                             # (M, R)
        if need_B:
            dB = (x2.T @ gt).to(B.dtype)
        if need_x:
            dx = (gt @ B.float().T).reshape(x.shape).to(x.dtype)
        return dx, dB, dC


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def lowrank_matmul(x: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor) -> torch.Tensor:
    """y = (x @ B) @ C.  x: (..., K); B: (K, R); C: (R, N)."""
    if _needs_grad(x, B, C):
        return _LowRank.apply(x, B, C)
    return _lowrank_fwd_impl(x, B, C)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def _flash_fwd_impl(q, k, v, causal, window, softcap, lse=False):
    """o, or (o, lse) with ``lse`` (the kernel's float32 row statistic,
    written only when asked for)."""
    with _kernel_call("flash_attention", q, lambda: flash_cost(
            q, k, v, causal, window, lse)) as skip:
        if skip:
            out = q.new_empty(q.shape)
            Bb, S, H, _ = q.shape
            return (out, q.new_empty((Bb, H, S), dtype=torch.float32)
                    ) if lse else out
        if not _route(q, "flash_attention"):
            return ref.flash_attention(q, k, v, causal=causal,
                                       window=window, softcap=softcap,
                                       return_lse=lse)
        return flash_attention_bshd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, softcap=softcap,
                                    return_lse=lse)


def flash_tiled(S: int, T: int, softcap: float) -> bool:
    """Whether the backward takes the tiled FlashAttention-2 formulation
    (``ref.flash_bwd_rule``, and the forward keeps ``lse``): where JAX's
    model takes ``_sdpa_flash_jnp`` (``ref.use_flash_jnp``, no softcap);
    elsewhere it recomputes the dense plain version, as JAX's ``_sdpa``
    differentiates its dense scores."""
    return not softcap and ref.use_flash_jnp(S, T)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.opts = (causal, window, softcap)
        ctx.tiled = flash_tiled(q.shape[1], k.shape[1], softcap)
        if not ctx.tiled:
            ctx.save_for_backward(q, k, v)
            return _flash_fwd_impl(q, k, v, causal, window, softcap)
        out, lse = _flash_fwd_impl(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap = ctx.opts
        if ctx.tiled:
            return (*_flash_bwd_tiled(g, *ctx.saved_tensors, causal,
                                      window), None, None, None)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = ref.flash_attention(*ins, causal=causal, window=window,
                                      softcap=softcap)
            dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None, None


def _flash_bwd_tiled(g, q, k, v, out, lse, causal: bool, window: int):
    """(dq, dk, dv) by ``ref.flash_bwd_rule`` in float32 at JAX's tiles
    (``_sdpa_flash_jnp``: bq 512, bk 1024, cut to S and T), q pre-scaled
    as JAX scales it."""
    Bb, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5

    def grouped(t):
        return t.float().reshape(Bb, S, KV, G, hd)
    dqg, dk, dv = ref.flash_bwd_rule(
        causal, window, min(ref.FLASH_BQ, S), min(ref.FLASH_BK, T),
        grouped(q) * scale, k.float(), v.float(), grouped(out),
        lse.reshape(Bb, KV, G, S), grouped(g))
    return ((dqg * scale).reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) -> (B, S, H, hd)."""
    if _needs_grad(q, k, v):
        return _Flash.apply(q, k, v, causal, window, softcap)
    return _flash_fwd_impl(q, k, v, causal, window, softcap)


# ---------------------------------------------------------------------------
# decode attention (single new token vs. the ragged KV cache pool)
# ---------------------------------------------------------------------------
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, hd) — one new token per sequence; k/v: (B, L, KV, hd)
    cache pool; lengths: (B,) per-slot live length (pos + 1). window > 0 =
    ring-buffer cache layout. Returns (B, H, hd). Inference-only."""
    with _kernel_call("decode_attention", q,
                      lambda: decode_cost(q, k, v, lengths)) as skip:
        if skip:
            return q.new_empty(q.shape)
        if not _route(q, "decode_attention"):
            return ref.decode_attention(q, k, v, lengths, window=window,
                                        softcap=softcap)
        B, H, hd = q.shape
        KV = k.shape[2]
        o = decode_attention_bkgh(q.reshape(B, KV, H // KV, hd), k, v,
                                  lengths.to(torch.int32), window=window,
                                  softcap=softcap)
        return o.reshape(B, H, hd)


def decode_attention_state(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           softcap: float = 0.0):
    """The softmax state of decode attention over a block of each slot's
    rows, full layout: q (B, H, hd); k/v (B, L, KV, hd); lengths (B,) each
    slot's live rows in the block (a prefix). Returns float32 (acc (B, H,
    hd), m (B, H), l (B, H)); ``kernels.ref.merge_states`` merges the
    blocks'.
    Inference-only."""
    with _kernel_call("decode_attention_state", q, lambda: decode_state_cost(
            q, k, v, lengths)) as skip:
        B, H, hd = q.shape
        if skip:
            return (q.new_empty(q.shape, dtype=torch.float32),
                    q.new_empty((B, H), dtype=torch.float32),
                    q.new_empty((B, H), dtype=torch.float32))
        if not _route(q, "decode_attention_state"):
            return ref.decode_attention_state(q, k, v, lengths,
                                              softcap=softcap)
        KV = k.shape[2]
        acc, m, l = decode_attention_state_bkgh(
            q.reshape(B, KV, H // KV, hd), k, v, lengths.to(torch.int32),
            softcap=softcap)
        return acc.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def decode_attention_paged(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           table: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """Paged-pool decode attention. q: (B, H, hd); k/v: (P, bk, KV, hd)
    block arena (block 0 the null block); lengths: (B,) live length per
    slot (pos + 1; 0: a dead slot, exact-zero row); table: (B, NB) block
    table. Returns (B, H, hd). Inference-only, full layout only."""
    with _kernel_call("decode_attention_paged", q, lambda: decode_paged_cost(
            q, k, v, lengths, table)) as skip:
        if skip:
            return q.new_empty(q.shape)
        if not _route(q, "decode_attention_paged"):
            return ref.decode_attention_paged(q, k, v, lengths, table,
                                              softcap=softcap)
        B, H, hd = q.shape
        KV = k.shape[2]
        o = decode_attention_paged_bkgh(
            q.reshape(B, KV, H // KV, hd), k, v, lengths.to(torch.int32),
            table.to(torch.int32), softcap=softcap)
        return o.reshape(B, H, hd)


# ---------------------------------------------------------------------------
# gram
# ---------------------------------------------------------------------------
def gram(x: torch.Tensor, out: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """x: (..., D) -> (D, D) fp32 Gram accumulated over all leading dims.
    With ``out`` ((D, D) float32), the Gram is added into it in place and
    ``out`` is returned: the streaming calibrator's fold."""
    x2 = x.reshape(-1, x.shape[-1])
    with _kernel_call("gram_blocked", x2, lambda: gram_cost(x2, out)) as skip:
        if skip:
            D = x2.shape[1]
            return out if out is not None else x2.new_empty(
                (D, D), dtype=torch.float32)
        if _route(x2, "gram"):
            return gram_blocked(x2.contiguous(), out)
        g = ref.gram(x2)
        return g if out is None else out.add_(g)
