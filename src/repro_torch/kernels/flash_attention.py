"""Prefill flash attention: wrapper around ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_bh``
(``repro/kernels/flash_attention.py``, ``_kernel``). The kernel reads q, k
and v in the model's own (B, S, H, hd) / (B, T, KV, hd) layout, so the
wrapper neither transposes nor pads; what bounds it on the card and how the
design answers is in the note at the top of the CUDA source. The plain
version is ``kernels.ref.flash_attention``.

Two variants, picked by ``_variant`` from the dtype, hd and whether q, k, v
(and the output, allocated here) start on 16-byte boundaries, which the
tensor-core kernel's TMA copies need (a tensor PyTorch allocates does):
``"wgmma"`` (bfloat16 on the tensor cores) and ``"simt"`` (float32 FMA on
the CUDA cores; float32 operands and the operands the tensor-core kernel
does not take). ``.launches_by_variant`` counts each.

``return_lse`` sets the kernel's LSE flag: each query row's float32
log-sum-exp (``m + log(max(l, 1e-30))``, (B, H, S)) is written beside o,
for the tiled backward (``kernels.ref.flash_bwd_rule``);
``.launches_lse`` counts those launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

HEAD_DIMS = (16, 32, 64, 128, 256)
VARIANTS = ("wgmma", "simt")


def _fn(name: str = "drt_flash_attention"):
    fn = getattr(_build.lib("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = [P] * 5 + [I] * 6 + [F, I, I, F]
        fn.argtypes += [I, P] if name == "drt_flash_attention" else [P]
        fn.restype = I
    return fn


def _allowed(dtype: torch.dtype, hd: int, aligned: bool = True) -> tuple:
    """The variants that take q/k/v of ``dtype`` and head dim ``hd``,
    preferred first. ``aligned``: q, k and v start on 16-byte
    boundaries."""
    if hd not in HEAD_DIMS:
        return ()
    if dtype == torch.bfloat16 and aligned:
        return VARIANTS
    return ("simt",)


def _variant(dtype: torch.dtype, hd: int, aligned: bool = True,
             variant: Optional[str] = None) -> str:
    """The variant ``flash_attention_bshd`` launches: the preferred one, or
    ``variant`` if it takes the operands. Raises ValueError for a variant
    that does not, or an hd no variant takes."""
    allowed = _allowed(dtype, hd, aligned)
    if not allowed:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if variant is not None and variant not in allowed:
        raise ValueError(f"flash_attention: variant {variant!r} does not "
                         f"take {dtype} operands at hd {hd} (allowed: "
                         f"{allowed})")
    return variant or allowed[0]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         variant: Optional[str] = None,
                         return_lse: bool = False):
    """q (B, S, H, hd); k/v (B, T, KV, hd) on the card, one dtype, with
    H a multiple of KV and hd in HEAD_DIMS -> o (B, S, H, hd), and with
    ``return_lse`` (o, lse (B, H, S) float32). ``variant`` ("wgmma" or
    "simt") forces one that takes these operands, for comparing the two;
    by default ``_variant`` picks."""
    code = _build.check_operands("flash_attention", q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or H % KV or hd not in HEAD_DIMS):
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (hd in {HEAD_DIMS})")
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    variant = _variant(q.dtype, hd, aligned, variant)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel() == 0:
        return (o, lse) if return_lse else o
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, S, T, H, KV, hd,
            hd ** -0.5, int(causal), int(window), float(softcap))
    if variant == "wgmma":
        rc = _fn("drt_flash_attention_wgmma")(*args, _build.stream_of(q))
    else:
        rc = _fn()(*args, code, _build.stream_of(q))
    _build.check_rc(rc, f"flash_attention ({variant})")
    flash_attention_bshd.launches += 1
    flash_attention_bshd.launches_by_variant[variant] += 1
    if return_lse:
        flash_attention_bshd.launches_lse += 1
        return o, lse
    return o


flash_attention_bshd.launches = 0
flash_attention_bshd.launches_by_variant = dict.fromkeys(VARIANTS, 0)
flash_attention_bshd.launches_lse = 0
