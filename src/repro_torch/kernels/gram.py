"""Gram matrix G = XᵀX with float32 accumulation: wrapper around
``csrc/gram.cu``.

Replaces the TPU kernel ``gram_blocked`` (``repro/kernels/gram.py``,
``_kernel``). x is float32 or bfloat16 and is read in place at its own
shape: ragged N and D are masked inside the kernel, nothing is padded. What
bounds the kernel on the card and how the design answers is in the note at
the top of the CUDA source. The plain version is ``kernels.ref.gram``.

Two variants, picked by ``_variant`` from the dtype, the shape and whether
x and the output start on 16-byte boundaries: ``"wgmma"`` (bfloat16 on the
tensor cores; D % 8 == 0, both aligned) and ``"simt"`` (float32 FMA on the
CUDA cores; float32 inputs and the other operands).
``.launches_by_variant`` counts each.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P


VARIANTS = ("wgmma", "simt")


def _fn(name: str = "drt_gram"):
    fn = getattr(_build.lib("gram"), name)
    if fn.argtypes is None:
        fn.argtypes = ([P, P, I, I, I, I, P] if name == "drt_gram"
                       else [P, P, I, I, I, P])
        fn.restype = I
    return fn


def _allowed(dtype: torch.dtype, N: int, D: int,
             aligned: bool = True) -> tuple:
    """The variants that take x (N, D) of ``dtype``, preferred first.
    ``aligned``: x and the output start on 16-byte boundaries (the
    tensor-core kernel copies rows of 8 bf16 and adds rows of 4 floats at a
    time, so it also needs D % 8 == 0)."""
    if dtype == torch.bfloat16 and D % 8 == 0 and aligned:
        return VARIANTS
    return ("simt",)


def _variant(dtype: torch.dtype, N: int, D: int, aligned: bool = True,
             variant: Optional[str] = None) -> str:
    """The variant ``gram_blocked`` launches for x (N, D) of ``dtype``: the
    preferred one, or ``variant`` if it takes x (else ValueError)."""
    allowed = _allowed(dtype, N, D, aligned)
    if variant is not None and variant not in allowed:
        raise ValueError(f"gram_blocked: variant {variant!r} does not take "
                         f"{dtype} x of shape ({N}, {D}) (allowed: "
                         f"{allowed})")
    return variant or allowed[0]


def tiles(D: int, edge: int = 64) -> list:
    """The (row, column) output tiles of the upper triangle that the
    kernels' blocks own, block b the b-th, row by row (csrc: upper_tile)."""
    nt = -(-D // edge)
    out = []
    for b in range(nt * (nt + 1) // 2):
        ti = 0
        while b >= nt - ti:
            b -= nt - ti
            ti += 1
        out.append((ti, ti + b))
    return out


def gram_blocked(x: torch.Tensor, out: Optional[torch.Tensor] = None, *,
                 variant: Optional[str] = None) -> torch.Tensor:
    """x (N, D) on the card -> XᵀX (D, D) float32. With ``out`` (a
    contiguous (D, D) float32 tensor on the same card) XᵀX is added into
    it in place, and ``out`` is returned. ``variant`` ("wgmma" or "simt")
    forces one that takes x, for comparing the two; by default
    ``_variant`` picks."""
    code = _build.check_operands("gram_blocked", x)
    if x.dim() != 2:
        raise ValueError(f"gram_blocked: x must be (N, D), got "
                         f"{tuple(x.shape)}")
    N, D = x.shape
    aligned = x.data_ptr() % 16 == 0 and (out is None
                                         or out.data_ptr() % 16 == 0)
    variant = _variant(x.dtype, N, D, aligned, variant)
    if out is None:
        g = torch.empty((D, D), dtype=torch.float32, device=x.device)
    else:
        if (out.shape != (D, D) or out.dtype != torch.float32
                or out.device != x.device or not out.is_contiguous()):
            raise ValueError(f"gram_blocked: out must be a contiguous "
                             f"({D}, {D}) float32 tensor on {x.device}")
        g = out
    if D == 0:
        return g
    if variant == "wgmma":
        rc = _fn("drt_gram_wgmma")(x.data_ptr(), g.data_ptr(), N, D,
                                   int(out is not None), _build.stream_of(x))
    else:
        rc = _fn()(x.data_ptr(), g.data_ptr(), N, D, code,
                   int(out is not None), _build.stream_of(x))
    _build.check_rc(rc, f"gram_blocked ({variant})")
    gram_blocked.launches += 1
    gram_blocked.launches_by_variant[variant] += 1
    return g


gram_blocked.launches = 0
gram_blocked.launches_by_variant = dict.fromkeys(VARIANTS, 0)
