"""Fused low-rank product y = (x @ B) @ C: wrappers around
``csrc/lowrank_matmul.cu``.

``lowrank_gemv`` replaces the TPU kernel ``lowrank_gemv``
(``repro/kernels/lowrank_matmul.py``, ``_gemv_kernel``) for decode rows;
``lowrank_matmul_2d`` replaces ``lowrank_matmul_2d`` (``_kernel``) for
prefill rows. The design, and what bounds each kernel on the card, is in the
note at the top of the CUDA source. Each wrapper validates its operands,
allocates the output (and t, or the earlier gemv's float32 partials),
launches on the current stream and counts its calls in ``.launches``.
The plain version is ``kernels.ref.lowrank_matmul``.

``lowrank_gemv`` has three variants, picked by ``_variant_gemv`` from the
dtype, M, K and whether x starts on a 16-byte boundary: ``"mma"`` (bfloat16,
the tensor cores) and ``"fma"`` (float32, the CUDA cores) are the same two
launches, the weights streamed once through a cluster per strip of output
columns, launch 2 overlapping launch 1 by programmatic dependent launch
(``gemv_plan`` mirrors their geometry); ``"splitk"`` is the earlier three
launches through float32 partials, for x whose rows are not on 16-byte
boundaries, M above ``GEMV_MAX_ROWS`` and the same-run comparison.

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

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P

# reduction slices of the earlier ("splitk") decode kernel's split products:
# enough blocks to spread one weight matrix over the card, few enough
# partials to sum cheaply
GEMV_MAX_SLICES = 16
GEMV_MIN_SLICE = 64
# the two-launch decode kernel's geometry (csrc: GV2_*): strips of output
# columns, reduction chunks, ring slots, cluster bound, the rows of x a
# block holds
GEMV_STRIP = 64
GEMV_CHUNK = 64
GEMV_STAGES = 5
GEMV_MAX_CLUSTER = 8
GEMV_MAX_ROWS = 64
# a weight at least this large is streamed over every block the card holds
# at once, a smaller one over half of them (_gemv_target_blocks)
GEMV_BIG_BYTES = 8 << 20
GEMV_VARIANTS = ("mma", "fma", "splitk")
_RAW_BYTES, _TILE_BYTES = 64 * 9 * 16, 64 * 64 * 2    # hopper_mma.cuh


def _fn(name: str):
    so = _build.lib("lowrank_matmul")
    fn = getattr(so, name)
    if fn.argtypes is None:
        if name == "drt_lowrank_gemv":
            fn.argtypes = [P] * 6 + [I] * 9 + [P]
        elif name == "drt_lowrank_gemv_stream":
            fn.argtypes = [P] * 5 + [I] * 7 + [P]
        elif name == "drt_lowrank_gemv_plan":
            fn.argtypes = [I] * 7 + [P]
        elif name == "drt_lowrank_gemv_card":
            fn.argtypes = [P]
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


def _esize(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _t_stride(R: int, dtype: torch.dtype) -> int:
    """t's row stride: R rounded up to 16 bytes (csrc: gv2_t_stride)."""
    step = 16 // _esize(dtype)
    return -(-R // step) * step


def _gemv_smem(esize: int, mt: int) -> int:
    wslot = _RAW_BYTES if esize == 2 else GEMV_CHUNK * GEMV_STRIP * 4
    return (128 + GEMV_STAGES * (wslot + mt * GEMV_CHUNK * esize)
            + (_TILE_BYTES if esize == 2 else 0)
            + (mt + GEMV_MAX_CLUSTER) * (GEMV_STRIP + 4) * 4)


_CARDS: dict = {}


def card(device: torch.device) -> tuple:
    """(SMs, shared memory bytes of one SM) of a CUDA device, asked of the
    driver once (csrc: drt_lowrank_gemv_card); the two-launch decode
    kernel's block targets are planned for it."""
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    if i not in _CARDS:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(i):
            _build.check_rc(_fn("drt_lowrank_gemv_card")(
                ctypes.cast(out, ctypes.c_void_p)), "lowrank_gemv card")
        _CARDS[i] = (out[0], out[1])
    return _CARDS[i]


def _gemv_target_blocks(esize: int, mt: int, wbytes: int,
                        card: tuple) -> int:
    """The blocks a launch over a weight of ``wbytes`` aims at: what the
    card ((SMs, shared memory an SM)) holds at once at this shared memory
    (1 KB of each block's is the system's), halved for a weight under
    ``GEMV_BIG_BYTES`` so that launch 2, started early, finds room beside
    launch 1 (PERF.md holds both against each other)."""
    sms, sm_smem = card
    held = sms * (sm_smem // (_gemv_smem(esize, mt) + 1024))
    return held // (1 if wbytes >= GEMV_BIG_BYTES else 2)


def _gemv_launch(kred: int, ncols: int, esize: int, mt: int,
                 card: tuple) -> dict:
    nch = -(-kred // GEMV_CHUNK)
    strips = -(-ncols // GEMV_STRIP)
    target = _gemv_target_blocks(esize, mt, kred * ncols * esize, card)
    cs = max(1, min(target // strips, GEMV_MAX_CLUSTER, nch))
    per = -(-nch // cs)
    cs = -(-nch // per)
    return {"reduction": kred, "columns": ncols, "blocks": target,
            "strips": strips, "strip_width": GEMV_STRIP, "cluster": cs,
            "chunks_per_block": per, "grid": (strips, cs, 1),
            "k_splits": tuple((r * per * GEMV_CHUNK,
                               min(kred, (r + 1) * per * GEMV_CHUNK))
                              for r in range(cs)),
            "smem": _gemv_smem(esize, mt)}


def gemv_plan(M: int, K: int, R: int, N: int, dtype: torch.dtype,
              card: tuple) -> dict:
    """The launch geometry of the two-launch decode kernel (``"mma"``,
    ``"fma"``) for x (M, K), B (K, R), C (R, N) on a card of ``card`` =
    (SMs, shared memory an SM) (``card(device)``), mirrored from
    ``csrc/lowrank_matmul.cu`` (``gv2_launch_plan``, ``gv2_smem_bytes``,
    ``gv2_t_stride``; ``drt_lowrank_gemv_plan`` answers the same on the
    card). ``rows_tile``: rows of x a block holds (M rounded up to 16, 32 or
    64); ``t_stride``: t's row stride (R rounded up to 16 bytes). Each of
    the two ``launches`` (t = x@B, then y = t@C) has: the blocks it aims at
    (``_gemv_target_blocks``), the strips of ``strip_width`` output columns,
    the cluster size (blocks splitting a strip's reduction), the chunks of
    ``GEMV_CHUNK`` rows a block, the grid (strips, cluster, 1), the
    reduction rows [k0, k1) of each cluster rank (``k_splits``, summed in
    that order) and the dynamic shared memory."""
    es = _esize(dtype)
    mt = _rows_tile(M)
    return {"rows_tile": mt, "stages": GEMV_STAGES,
            "t_stride": _t_stride(R, dtype),
            "launches": (_gemv_launch(K, R, es, mt, card),
                         _gemv_launch(R, N, es, mt, card))}


def _rows_tile(M: int) -> int:
    return 16 if M <= 16 else 32 if M <= 32 else 64


@functools.lru_cache(maxsize=4096)
def _gemv_blocks(M: int, K: int, R: int, N: int, esize: int,
                 card: tuple) -> tuple:
    """The block targets of the two launches (``gemv_plan``'s
    ``blocks``), kept per shape: the wrapper passes them to the kernel."""
    mt = _rows_tile(M)
    return (_gemv_target_blocks(esize, mt, K * R * esize, card),
            _gemv_target_blocks(esize, mt, R * N * esize, card))


def _allowed_gemv(dtype: torch.dtype, M: int, K: int, R: int,
                  aligned: bool = True) -> tuple:
    """The variants that take these operands, preferred first: the
    two-launch kernel (``"mma"`` for bfloat16, ``"fma"`` for float32) where
    x's rows start on 16-byte boundaries (``aligned``: x's base; and K
    times the value size a multiple of 16), M is at most
    ``GEMV_MAX_ROWS`` and K and R are not empty; ``"splitk"`` for all."""
    out = []
    if (aligned and 1 <= M <= GEMV_MAX_ROWS and K >= 1 and R >= 1
            and K * _esize(dtype) % 16 == 0):
        out.append("mma" if dtype == torch.bfloat16 else "fma")
    out.append("splitk")
    return tuple(out)


def _variant_gemv(dtype: torch.dtype, M: int, K: int, R: int,
                  aligned: bool = True,
                  variant: Optional[str] = None) -> str:
    """The variant ``lowrank_gemv`` launches for these operands: the
    preferred one, or ``variant`` if it takes them (else ValueError)."""
    allowed = _allowed_gemv(dtype, M, K, R, aligned)
    if variant is not None and variant not in allowed:
        raise ValueError(f"lowrank_gemv: variant {variant!r} does not take "
                         f"{dtype} operands x ({M}, {K}), B ({K}, {R}) "
                         f"(x 16-byte aligned: {aligned}; allowed: "
                         f"{allowed})")
    return variant or allowed[0]


def lowrank_gemv(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
                 variant: Optional[str] = None) -> torch.Tensor:
    """x (M, K), B (K, R), C (R, N) on the card, one dtype -> y (M, N).
    Decode shape (M <= ``GEMV_MAX_ROWS``; "splitk" takes any M). By
    default ``_variant_gemv`` picks: two launches through a t of x's dtype
    allocated here ("mma", "fma"), or three through float32 partials
    ("splitk"); ``variant`` forces one that takes these operands, for
    comparing them."""
    code = _build.check_operands("lowrank_gemv", x, B, C)
    M, K = x.shape
    R, N = C.shape
    if B.shape != (K, R):
        raise ValueError(f"lowrank_gemv: shapes {tuple(x.shape)} "
                         f"{tuple(B.shape)} {tuple(C.shape)}")
    variant = _variant_gemv(x.dtype, M, K, R, _aligned(x), variant)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    if variant == "splitk":
        s1, kper1 = _slices(K)
        s2, kper2 = _slices(R)
        tpart = torch.empty((s1, M, R), dtype=torch.float32, device=x.device)
        ypart = torch.empty((s2, M, N), dtype=torch.float32, device=x.device)
        rc = _fn("drt_lowrank_gemv")(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            tpart.data_ptr(), ypart.data_ptr(), M, K, R, N, s1, kper1, s2,
            kper2, code, _build.stream_of(x))
    else:
        t = torch.empty((M, _t_stride(R, x.dtype)), dtype=x.dtype,
                        device=x.device)
        b1, b2 = _gemv_blocks(M, K, R, N, _esize(x.dtype), card(x.device))
        rc = _fn("drt_lowrank_gemv_stream")(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            t.data_ptr(), M, K, R, N, b1, b2, code, _build.stream_of(x))
    _build.check_rc(rc, f"lowrank_gemv ({variant})")
    lowrank_gemv.launches += 1
    lowrank_gemv.launches_by_variant[variant] += 1
    return y


lowrank_gemv.launches = 0
lowrank_gemv.launches_by_variant = dict.fromkeys(GEMV_VARIANTS, 0)


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
