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
stay forward-only. ``decode_attention`` and ``gram`` are inference-only;
``gram`` runs the ``gram_blocked`` kernel for the streaming calibrator.

A meta tensor (shapes only, no data) takes the plain version: that is how
``core.capture.discover_capture_dims`` walks a forward pass without running
it, as the JAX package does under ``jax.eval_shape``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    decode_attention_bkgh, decode_attention_paged_bkgh)
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.gram import gram_blocked
from repro_torch.kernels.lowrank_matmul import lowrank_gemv, lowrank_matmul_2d

# At or below this many flattened rows the low-rank matmul is decode-shaped:
# route to the weight-streaming kernel instead of the prefill tiler.
GEMV_MAX_ROWS = 64


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
    x2 = x.reshape(-1, K)
    B = B.to(x.dtype)
    C = C.to(x.dtype)
    if not _route(x, "lowrank_matmul"):
        y = ref.lowrank_matmul(x2, B, C)
    else:
        # the kernels read row-major operands; a view that is not one (a
        # slice, a transpose) is copied once here
        x2, B, C = x2.contiguous(), B.contiguous(), C.contiguous()
        kernel = (lowrank_gemv if x2.shape[0] <= GEMV_MAX_ROWS
                  else lowrank_matmul_2d)
        y = kernel(x2, B, C)
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
def _flash_fwd_impl(q, k, v, causal, window, softcap):
    if not _route(q, "flash_attention"):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return flash_attention_bshd(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal,
                                window=window, softcap=softcap)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap)
        return _flash_fwd_impl(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap = ctx.opts
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = ref.flash_attention(*ins, causal=causal, window=window,
                                      softcap=softcap)
            dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None, None


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
    if not _route(q, "decode_attention"):
        return ref.decode_attention(q, k, v, lengths, window=window,
                                    softcap=softcap)
    B, H, hd = q.shape
    KV = k.shape[2]
    o = decode_attention_bkgh(q.reshape(B, KV, H // KV, hd), k, v,
                              lengths.to(torch.int32), window=window,
                              softcap=softcap)
    return o.reshape(B, H, hd)


def decode_attention_paged(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           table: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """Paged-pool decode attention. q: (B, H, hd); k/v: (P, bk, KV, hd)
    block arena (block 0 the null block); lengths: (B,) live length per
    slot (pos + 1; 0: a dead slot, exact-zero row); table: (B, NB) block
    table. Returns (B, H, hd). Inference-only, full layout only."""
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
    if _route(x2, "gram"):
        return gram_blocked(x2.contiguous(), out)
    g = ref.gram(x2)
    return g if out is None else out.add_(g)
