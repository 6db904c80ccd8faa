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

``lowrank_matmul_2d`` has three variants, picked by ``_variant_2d`` from
the dtype, the shapes and whether x and C start on 16-byte boundaries (the
tensor-core kernels' TMA copies need it; a tensor PyTorch allocates does):
``"wgmma"`` (one launch, t kept on chip, bfloat16 on the tensor cores, R up
to ``wgmma_max_rank()``), ``"simt"`` (one launch, t on chip, float32 FMA on
the CUDA cores, R up to ``simt_max_rank()``) and ``"split"`` (two launches
through an (M, R) t in device memory, any rank: on the tensor cores for
bfloat16 operands whose K and N are multiples of 8 and whose x and C are
aligned, ``_split_on_tensor_cores``, else on the CUDA cores). Every rank
takes ``"split"``, so no rank is refused. ``.launches_by_variant`` counts
each.
"""
from __future__ import annotations

from typing import Optional

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
        elif name == "drt_lowrank_matmul_2d_wgmma":
            fn.argtypes = [P] * 4 + [I] * 4 + [P]
        elif name == "drt_lowrank_matmul_2d_split":
            fn.argtypes = [P] * 5 + [I] * 6 + [P]
        elif name == "drt_lowrank_2d_wgmma_clusters":
            fn.argtypes = [I, I]
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


# Shared memory one block may use on sm_90 (csrc: MM_SMEM_MAX), and the
# layouts of the two prefill kernels' shared memory, mirrored from the CUDA
# sources (mm_smem_bytes, wg_smem_bytes) so that the variant is chosen on
# any machine; chip_smoke.py holds the mirrors to the compiled formulas.
SMEM_MAX = 232448
WGMMA_TILE = 64           # rows of a cluster's tile, ranks of a t chunk
VARIANTS = ("wgmma", "simt", "split")
# float32 rows from which "split"'s two tiled products beat the fused
# CUDA-core kernel: measured 1.3-1.8x faster a SmolLM prefill at 512 and
# 2048 rows, 1.2x slower at 128 and 256 (PERF.md). The two give the same
# bits: each sums every output as one float32 FMA chain in k order.
SPLIT_ROWS_F32 = 512


def _simt_smem(rp: int) -> int:
    return 4 * (rp * 32 + 64 * 64 + 64 * 33)


def _wgmma_smem(nrc: int) -> int:
    # two warpgroups; the ring region: 3 slots of phase 1 beside the
    # unpacked B tiles, or 6 of phase 2
    tile, raw = 64 * 64 * 2, 64 * 9 * 16
    slot1, slot2, bsw = tile + 2 * raw, 2 * tile, 4 * tile
    return 1024 + nrc * tile + max(3 * slot1 + bsw, 6 * slot2)


def _max_rank(smem, limit: int, step: int) -> int:
    n = 0
    while smem(n + 1) <= limit:
        n += 1
    return n * step


def simt_max_rank() -> int:
    """Largest rank of the CUDA-core kernel: t[32 rows, R] in float32."""
    return _max_rank(lambda n: _simt_smem(64 * n), SMEM_MAX, 64)


def wgmma_max_rank() -> int:
    """Largest rank of the tensor-core kernel: t[64 rows, R] in bf16 (its
    dynamic shared memory leaves 1 KB for its static mbarriers)."""
    return _max_rank(_wgmma_smem, SMEM_MAX - 1024, WGMMA_TILE)


def _split_on_tensor_cores(dtype: torch.dtype, K: int, N: int,
                           aligned: bool = True) -> bool:
    """Whether ``"split"`` runs its two products on the tensor cores: x and
    C by TMA (K and N multiples of 8, both 16-byte aligned); B and t by TMA
    at R % 8 == 0, else by 16-byte words shifted into place."""
    return (dtype == torch.bfloat16 and K >= 8 and K % 8 == 0
            and N % 8 == 0 and aligned)


def _allowed_2d(dtype: torch.dtype, M: int, K: int, R: int, N: int,
                aligned: bool = True) -> tuple:
    """The variants that take these operands, preferred first: the fused
    kernels where t fits on chip, then ``"split"``, which takes every rank.
    ``"split"`` goes ahead of the fused CUDA-core kernel where it runs on
    the tensor cores and the fused tensor-core kernel cannot hold t (bf16
    ranks above ``wgmma_max_rank()``: measured 13.8-19.8x faster at rank
    1585 at 2048 and 512 rows), and for float32 from ``SPLIT_ROWS_F32``
    rows (PERF.md). ``aligned``: x and C start on 16-byte boundaries (y and
    t are allocated here, so they always do)."""
    tc = _split_on_tensor_cores(dtype, K, N, aligned)
    out = []
    if tc and 1 <= R <= wgmma_max_rank():
        out.append("wgmma")
    if ((tc and R > wgmma_max_rank())
            or (dtype == torch.float32 and M >= SPLIT_ROWS_F32)):
        out.append("split")
    if R <= simt_max_rank():
        out.append("simt")
    if "split" not in out:
        out.append("split")
    return tuple(out)


def _variant_2d(dtype: torch.dtype, M: int, K: int, R: int, N: int,
                aligned: bool = True, variant: Optional[str] = None) -> str:
    """The variant ``lowrank_matmul_2d`` launches for these operands: the
    preferred one, or ``variant`` if it takes them (else ValueError)."""
    allowed = _allowed_2d(dtype, M, K, R, N, aligned)
    if variant is not None and variant not in allowed:
        raise ValueError(f"lowrank_matmul_2d: variant {variant!r} does not "
                         f"take {dtype} operands x ({M}, {K}), B ({K}, {R}),"
                         f" C ({R}, {N}) (allowed: {allowed})")
    return variant or allowed[0]


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def lowrank_matmul_2d(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
                      variant: Optional[str] = None) -> torch.Tensor:
    """x (M, K), B (K, R), C (R, N) on the card, one dtype -> y (M, N).
    Prefill shape. t = x@B is rounded to C's dtype (the TPU kernel's
    rounding of t) before y = t@C: in one launch, a cluster of blocks per
    row tile keeping t in its shared memory ("wgmma", "simt"), or in two
    through a (M, R) t allocated here ("split"). ``variant`` forces one that
    takes these operands, for comparing them; by default ``_variant_2d``
    picks."""
    code = _build.check_operands("lowrank_matmul_2d", x, B, C)
    M, K = x.shape
    R, N = C.shape
    if B.shape != (K, R):
        raise ValueError(f"lowrank_matmul_2d: shapes {tuple(x.shape)} "
                         f"{tuple(B.shape)} {tuple(C.shape)}")
    variant = _variant_2d(x.dtype, M, K, R, N, _aligned(x, C), variant)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    if variant == "split":
        t = torch.empty((M, R), dtype=x.dtype, device=x.device)
        rc = _fn("drt_lowrank_matmul_2d_split")(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            t.data_ptr(), M, K, R, N, code,
            int(_split_on_tensor_cores(x.dtype, K, N, _aligned(x, C))),
            _build.stream_of(x))
    elif variant == "wgmma":
        rc = _fn("drt_lowrank_matmul_2d_wgmma")(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), M, K, R,
            N, _build.stream_of(x))
    else:
        rc = _fn("drt_lowrank_matmul_2d")(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), M, K, R,
            N, code, _build.stream_of(x))
    _build.check_rc(rc, f"lowrank_matmul_2d ({variant})")
    lowrank_matmul_2d.launches += 1
    lowrank_matmul_2d.launches_by_variant[variant] += 1
    return y


lowrank_matmul_2d.launches = 0
lowrank_matmul_2d.launches_by_variant = dict.fromkeys(VARIANTS, 0)
