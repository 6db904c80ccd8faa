"""Gram matrix G = XᵀX with float32 accumulation: wrapper around
``csrc/gram.cu``.

Replaces the TPU kernel ``gram_blocked`` (``repro/kernels/gram.py``,
``_kernel``). x is float32 or bfloat16 and is read in place at its own
shape: ragged N and D are masked inside the kernel, nothing is padded. What
bounds the kernel on the card and how the design answers is in the note at
the top of the CUDA source. The plain version is ``kernels.ref.gram``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P


def _fn():
    fn = _build.lib("gram").drt_gram
    if fn.argtypes is None:
        fn.argtypes = [P, P, I, I, I, I, P]
        fn.restype = I
    return fn


def gram_blocked(x: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, D) on the card -> XᵀX (D, D) float32. With ``out`` (a
    contiguous (D, D) float32 tensor on the same card) XᵀX is added into
    it in place, and ``out`` is returned."""
    code = _build.check_operands("gram_blocked", x)
    if x.dim() != 2:
        raise ValueError(f"gram_blocked: x must be (N, D), got "
                         f"{tuple(x.shape)}")
    N, D = x.shape
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
    rc = _fn()(x.data_ptr(), g.data_ptr(), N, D, code, int(out is not None),
               _build.stream_of(x))
    _build.check_rc(rc, "gram_blocked")
    gram_blocked.launches += 1
    return g


gram_blocked.launches = 0
