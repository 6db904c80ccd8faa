"""Prefill flash attention: wrapper around ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_bh``
(``repro/kernels/flash_attention.py``, ``_kernel``). The kernel reads q, k
and v in the model's own (B, S, H, hd) / (B, T, KV, hd) layout, so the
wrapper neither transposes nor pads; what bounds it on the card and how the
design answers is in the note at the top of the CUDA source. The plain
version is ``kernels.ref.flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

HEAD_DIMS = (16, 32, 64, 128)


def _fn():
    fn = _build.lib("flash_attention").drt_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [P] * 4 + [I] * 6 + [F, I, I, F, I, P]
        fn.restype = I
    return fn


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, hd); k/v (B, T, KV, hd) on the card, one dtype, with
    H a multiple of KV and hd in HEAD_DIMS -> o (B, S, H, hd)."""
    code = _build.check_operands("flash_attention", q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or H % KV or hd not in HEAD_DIMS):
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (hd in {HEAD_DIMS})")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               B, S, T, H, KV, hd, hd ** -0.5, int(causal), int(window),
               float(softcap), code, _build.stream_of(q))
    _build.check_rc(rc, "flash_attention")
    flash_attention_bshd.launches += 1
    return o


flash_attention_bshd.launches = 0
