"""Ragged single-token decode attention: wrappers around
``csrc/decode_attention.cu``.

``decode_attention_bkgh`` replaces the TPU kernel of the same name
(``repro/kernels/decode_attention.py``, ``_kernel``) in its full and ring
cache layouts; the cache pool is read in place at its own length, with no
padding copy. ``decode_attention_paged_bkgh`` replaces the paged TPU kernel
(``_paged_kernel``): the full layout read through a block table out of one
arena of blocks. Both launch one kernel template; in the paged one only the
row address differs. Each call is two launches: blocks that each take
``CHUNK`` of a slot's rows and write a partial softmax into float32 scratch
(allocated here), then their merge into o; ``launches`` counts the call once.
The grid's chunk count comes from the pool's shape alone, so no length is
read on the host. What bounds them on the card and how the design answers
is in the note at the top of the CUDA source. The plain versions are
``kernels.ref.decode_attention`` and ``kernels.ref.
decode_attention_paged``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8
# rows of a slot one block takes (csrc: DA_CHUNK; chip_smoke.py holds the
# mirror to the compiled constant)
CHUNK = 32
# the grid's second dimension, the chunks of the longest slot, is at most
# 65535: the pool's rows (L, or NB * bk when paged) are bounded by it
MAX_ROWS = 65535 * CHUNK


def _fn():
    fn = _build.lib("decode_attention").drt_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [P] * 6 + [I] * 5 + [F, I, F, I, P]
        fn.restype = I
    return fn


def _paged_fn():
    fn = _build.lib("decode_attention").drt_decode_attention_paged
    if fn.argtypes is None:
        fn.argtypes = [P] * 7 + [I] * 7 + [F, F, I, P]
        fn.restype = I
    return fn


def chunks(rows: int) -> int:
    """Blocks a (slot, kv head) gets in a pool of ``rows`` rows a slot (L,
    or NB * bk): the grid's second dimension."""
    return -(-rows // CHUNK)


def live_chunks(length: int, rows: int, window: int = 0) -> list:
    """The [start, end) row ranges the blocks of a slot of ``length`` (pos
    + 1) visit in a pool of ``rows`` rows a slot, in the order the merge
    takes them (csrc: live_rows and the partial kernel's early exit). They
    depend on the length and, for the ring, on the window alone."""
    if length <= 0:
        return []
    n = min(rows, window) if window else min(length, rows)
    return [(c, min(n, c + CHUNK)) for c in range(0, n, CHUNK)]


def _scratch(B: int, KV: int, G: int, hd: int, rows: int,
             device) -> torch.Tensor:
    """The partial kernel's float32 scratch: m and l (B, KV, chunks, G),
    then acc (B, KV, chunks, G, hd)."""
    return torch.empty(B * KV * chunks(rows) * G * (hd + 2),
                       dtype=torch.float32, device=device)


def _check_index(what: str, t: torch.Tensor, shape, device) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.int32
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {tuple(shape)} int32 "
                         f"tensor on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


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
            or not 1 <= G <= MAX_GROUP or not 1 <= L <= MAX_ROWS):
        raise ValueError(f"decode_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} (hd in "
                         f"{HEAD_DIMS}, G <= {MAX_GROUP}, L <= {MAX_ROWS})")
    _check_index("decode_attention: lengths", lengths, (B,), q.device)
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    part = _scratch(B, KV, G, hd, L, q.device)
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
               o.data_ptr(), part.data_ptr(), B, L, KV, G, hd, hd ** -0.5,
               int(window), float(softcap), code, _build.stream_of(q))
    _build.check_rc(rc, "decode_attention")
    decode_attention_bkgh.launches += 1
    return o


decode_attention_bkgh.launches = 0



def decode_attention_paged_bkgh(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, lengths: torch.Tensor,
                                table: torch.Tensor, *,
                                softcap: float = 0.0) -> torch.Tensor:
    """q (B, KV, G, hd) one token per slot; k/v (P, bk, KV, hd) block
    arena, block 0 the never-written null block; lengths (B,) int32 = pos
    + 1 (0: dead slot, exact-zero output); table (B, NB) int32, logical
    block j of slot b in arena block table[b, j] (entries in [0, P)). All
    on the card. Returns (B, KV, G, hd)."""
    code = _build.check_operands("decode_attention_paged", q, k, v)
    B, KV, G, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention_paged: k/v must be one (P, bk, "
                         f"KV, hd) arena shape, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    P, bk = k.shape[0], k.shape[1]
    if (k.shape[2] != KV or k.shape[3] != hd or hd not in HEAD_DIMS
            or not 1 <= G <= MAX_GROUP or P < 1 or bk < 1):
        raise ValueError(f"decode_attention_paged: unsupported shapes q "
                         f"{tuple(q.shape)} arena {tuple(k.shape)} (hd in "
                         f"{HEAD_DIMS}, G <= {MAX_GROUP})")
    if table.dim() != 2 or table.shape[0] != B:
        raise ValueError(f"decode_attention_paged: table must be ({B}, NB), "
                         f"got {tuple(table.shape)}")
    NB = table.shape[1]
    # a block stages only the table entries its chunk spans, so the table's
    # width is bounded by the grid's chunks alone, not by shared memory
    if not 1 <= NB * bk <= MAX_ROWS:
        raise ValueError(f"decode_attention_paged: NB = {NB} blocks of "
                         f"{bk} rows outside [1, {MAX_ROWS}] rows")
    _check_index("decode_attention_paged: lengths", lengths, (B,), q.device)
    _check_index("decode_attention_paged: table", table, (B, NB), q.device)
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    part = _scratch(B, KV, G, hd, NB * bk, q.device)
    rc = _paged_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), table.data_ptr(), o.data_ptr(),
                     part.data_ptr(), B, NB, bk, P, KV, G, hd, hd ** -0.5,
                     float(softcap), code, _build.stream_of(q))
    _build.check_rc(rc, "decode_attention_paged")
    decode_attention_paged_bkgh.launches += 1
    return o


decode_attention_paged_bkgh.launches = 0
