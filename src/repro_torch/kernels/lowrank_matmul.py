"""Fused low-rank product y = (x @ B) @ C: wrappers around
``csrc/lowrank_matmul.cu``.

``lowrank_gemv`` replaces the TPU kernel ``lowrank_gemv``
(``repro/kernels/lowrank_matmul.py``, ``_gemv_kernel``) for decode rows;
``lowrank_matmul_2d`` replaces ``lowrank_matmul_2d`` (``_kernel``) for
prefill rows. The design, and what bounds each kernel on the card, is in the
note at the top of the CUDA source. Each wrapper validates its operands,
allocates the output (and the gemv's float32 partials), launches on the
current stream and counts its launches in ``.launches``.
The plain version is ``kernels.ref.lowrank_matmul``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P

# reduction slices of the decode kernel's split products: enough blocks to
# spread one weight matrix over the card, few enough partials to sum cheaply
GEMV_MAX_SLICES = 16
GEMV_MIN_SLICE = 64


def _fn(name: str):
    so = _build.lib("lowrank_matmul")
    fn = getattr(so, name)
    if fn.argtypes is None:
        if name == "drt_lowrank_gemv":
            fn.argtypes = [P] * 6 + [I] * 9 + [P]
        elif name == "drt_lowrank_matmul_2d":
            fn.argtypes = [P] * 4 + [I] * 5 + [P]
        else:
            fn.argtypes = []
        fn.restype = I
    return fn


def _slices(k: int):
    """(slices, per-slice length) for a reduction of length k."""
    s = max(1, min(GEMV_MAX_SLICES, -(-k // GEMV_MIN_SLICE)))
    per = -(-k // s)
    return -(-k // per), per


def lowrank_gemv(x: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor) -> torch.Tensor:
    """x (M, K), B (K, R), C (R, N) on the card, one dtype -> y (M, N).
    Decode shape (any M, meant for M <= 64). Three launches: x@B and t@C
    as split products into float32 partials, then the sum into y."""
    code = _build.check_operands("lowrank_gemv", x, B, C)
    M, K = x.shape
    R, N = C.shape
    if B.shape != (K, R):
        raise ValueError(f"lowrank_gemv: shapes {tuple(x.shape)} "
                         f"{tuple(B.shape)} {tuple(C.shape)}")
    s1, kper1 = _slices(K)
    s2, kper2 = _slices(R)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    tpart = torch.empty((s1, M, R), dtype=torch.float32, device=x.device)
    ypart = torch.empty((s2, M, N), dtype=torch.float32, device=x.device)
    rc = _fn("drt_lowrank_gemv")(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        tpart.data_ptr(), ypart.data_ptr(), M, K, R, N, s1, kper1, s2,
        kper2, code, _build.stream_of(x))
    _build.check_rc(rc, "lowrank_gemv")
    lowrank_gemv.launches += 1
    return y


lowrank_gemv.launches = 0


@functools.lru_cache(maxsize=None)
def max_rank_2d() -> int:
    """Largest rank ``lowrank_matmul_2d`` takes (t[32 rows, R] must fit
    one block's shared memory)."""
    return _fn("drt_lowrank_2d_max_rank")()


def lowrank_matmul_2d(x: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor) -> torch.Tensor:
    """x (M, K), B (K, R), C (R, N) on the card, one dtype -> y (M, N).
    Prefill shape. One launch: a cluster of 8 blocks per 32-row tile keeps
    t = x@B, rounded to C's dtype (the TPU kernel's rounding of t), in its
    shared memory and emits y = t@C."""
    code = _build.check_operands("lowrank_matmul_2d", x, B, C)
    M, K = x.shape
    R, N = C.shape
    if B.shape != (K, R):
        raise ValueError(f"lowrank_matmul_2d: shapes {tuple(x.shape)} "
                         f"{tuple(B.shape)} {tuple(C.shape)}")
    if R > max_rank_2d():
        raise ValueError(f"lowrank_matmul_2d: rank {R} exceeds the kernel's "
                         f"shared-memory bound {max_rank_2d()}")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    rc = _fn("drt_lowrank_matmul_2d")(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), M, K, R, N,
        code, _build.stream_of(x))
    _build.check_rc(rc, "lowrank_matmul_2d")
    lowrank_matmul_2d.launches += 1
    return y


lowrank_matmul_2d.launches = 0
