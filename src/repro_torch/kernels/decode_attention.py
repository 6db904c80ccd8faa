"""Ragged single-token decode attention: wrapper around
``csrc/decode_attention.cu``.

Replaces the TPU kernel ``decode_attention_bkgh``
(``repro/kernels/decode_attention.py``, ``_kernel``) in its full and ring
cache layouts. The cache pool is read in place at its own length: no
padding copy. What bounds the kernel on the card and how the design answers
is in the note at the top of the CUDA source. The plain version is
``kernels.ref.decode_attention``. The paged variant
(``decode_attention_paged_bkgh``) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8


def _fn():
    fn = _build.lib("decode_attention").drt_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [P] * 5 + [I] * 5 + [F, I, F, I, P]
        fn.restype = I
    return fn


def decode_attention_bkgh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """q (B, KV, G, hd) one token per slot; k/v (B, L, KV, hd) cache pool;
    lengths (B,) int32 = pos + 1 (0: dead slot, exact-zero output); window
    > 0 selects the ring layout. All on the card. Returns (B, KV, G, hd)."""
    code = _build.check_operands("decode_attention", q, k, v)
    B, KV, G, hd = q.shape
    L = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2] != KV
            or k.shape[3] != hd or hd not in HEAD_DIMS
            or not 1 <= G <= MAX_GROUP):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} (hd in "
                         f"{HEAD_DIMS}, G <= {MAX_GROUP})")
    if (lengths.shape != (B,) or lengths.dtype != torch.int32
            or lengths.device != q.device or not lengths.is_contiguous()):
        raise ValueError(f"decode_attention: lengths must be a contiguous "
                         f"({B},) int32 tensor on {q.device}")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
               o.data_ptr(), B, L, KV, G, hd, hd ** -0.5, int(window),
               float(softcap), code, _build.stream_of(q))
    _build.check_rc(rc, "decode_attention")
    decode_attention_bkgh.launches += 1
    return o


decode_attention_bkgh.launches = 0
