"""Ragged single-token decode attention: wrappers around
``csrc/decode_attention.cu``.

``decode_attention_bkgh`` replaces the TPU kernel of the same name
(``repro/kernels/decode_attention.py``, ``_kernel``) in its full and ring
cache layouts; the cache pool is read in place at its own length, with no
padding copy. ``decode_attention_paged_bkgh`` replaces the paged TPU kernel
(``_paged_kernel``): the full layout read through a block table out of one
arena of blocks. Both launch one kernel template; in the paged one only the
row address differs. Each call is ONE launch: a thread-block cluster of
``CLUSTER`` blocks a (slot, kv head) splits the slot's rows and merges its
blocks' softmax states in distributed shared memory, with no scratch and no
second kernel. The grid is ``B * KV * CLUSTER`` blocks, so no length is
read on the host. Which rows each block (cluster rank) visits, and the
order of every merge, depend on the slot's length and window alone
(``rank_rows`` mirrors the compiled plan, ``drt_decode_plan``); what bounds
the kernels on the card and how the design answers is in the note at the
top of the CUDA source. The plain versions are ``kernels.ref.
decode_attention`` and ``kernels.ref.decode_attention_paged``.

``decode_attention_state_bkgh`` is the same kernel with its state out
(a template flag): in place of o it writes the cluster's merged softmax
state in float32, ``acc`` (B, KV, G, hd) unnormalised, ``m`` and ``l``
(B, KV, G), for a slot whose rows are split over several processes (a
sequence-split cache on a mesh: each model rank runs it over its block,
and ``kernels.ref.merge_states`` merges the ranks' states as the cluster
merges its blocks'). Its plain version is ``kernels.ref.
decode_attention_state``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8
# the plan's constants (csrc: DA_CL, DA_TILE, DA_WARPS, DA_STAGES,
# DA_RING_BYTES; chip_smoke.py holds them to drt_decode_config): blocks a
# (slot, kv head), rows a rank takes a turn, warps a block, ring slots a
# warp, the warps' rings in bytes
CLUSTER = 8
TILE = 64
WARPS = 4
STAGES = 4
RING_BYTES = WARPS * STAGES * 32 * 4 * 2 * 16
# a block's shared memory on sm_90 (csrc: DA_SMEM_MAX)
SMEM_MAX = 232448
# rows and lengths are int32; nothing else bounds a pool's rows, but a
# paged block stages its tiles' table entries (``smem_bytes``)
MAX_ROWS = 2 ** 31 - 1


def _fn():
    fn = _build.lib("decode_attention").drt_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [P] * 5 + [I] * 5 + [F, I, F, I, P]
        fn.restype = I
    return fn


def _state_fn():
    fn = _build.lib("decode_attention").drt_decode_attention_state
    if fn.argtypes is None:
        fn.argtypes = [P] * 7 + [I] * 5 + [F, F, I, P]
        fn.restype = I
    return fn


def _paged_fn():
    fn = _build.lib("decode_attention").drt_decode_attention_paged
    if fn.argtypes is None:
        fn.argtypes = [P] * 6 + [I] * 7 + [F, F, I, P]
        fn.restype = I
    return fn


def live_rows(length: int, rows: int, window: int = 0) -> int:
    """The live rows of a slot of ``length`` (pos + 1) in a pool of
    ``rows`` rows a slot, a prefix in both layouts: [0, length) full, [0,
    min(length, window)) in the ring, whose other rows are dead until the
    ring wraps (csrc: da_live_rows)."""
    if length <= 0:
        return 0
    return min(length, window if window > 0 else length, rows)


def rank_rows(length: int, rows: int, window: int = 0) -> list:
    """The [start, end) row ranges each of the ``CLUSTER`` ranks of a
    slot's cluster visits, in order: rank r takes tiles r, r + CLUSTER,
    ... of ``TILE`` rows of the slot's ``live_rows``; the merge takes the
    ranks in order (csrc: da_rank_tiles, drt_decode_plan). For a pool that
    holds the slot's rows it depends on the length and, for the ring, the
    window alone; no row outside ``live_rows`` is visited."""
    n = live_rows(length, rows, window)
    return [[(t, min(n, t + TILE))
             for t in range(r * TILE, n, CLUSTER * TILE)]
            for r in range(CLUSTER)]


def tile_entries(bk: int) -> int:
    """Table entries one tile can span at block size ``bk``."""
    return (TILE - 1) // bk + 2


def smem_bytes(G: int, hd: int, paged: bool = False, rows: int = 0,
               bk: int = 1) -> int:
    """A launch's dynamic shared memory (csrc: da_smem_bytes): the warps'
    rings, the block's merged state, and when paged the table entries of
    rank 0's tiles in a pool of ``rows`` rows."""
    s = RING_BYTES + 4 * (G * hd + 2 * G)
    if paged:
        s += 4 * len(rank_rows(rows, rows)[0]) * tile_entries(bk)
    return s


def _check_index(what: str, t: torch.Tensor, shape, device) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.int32
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {tuple(shape)} int32 "
                         f"tensor on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def _check_aligned(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operand of shape {tuple(t.shape)} "
                             f"does not start on a 16-byte boundary (the "
                             f"kernel loads 16 bytes a lane)")


def decode_attention_bkgh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """q (B, KV, G, hd) one token per slot; k/v (B, L, KV, hd) cache pool;
    lengths (B,) int32 = pos + 1 (0: dead slot, exact-zero output); window
    > 0 selects the ring layout. All on the card, q, k and v on 16-byte
    boundaries. Returns (B, KV, G, hd)."""
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
    _check_aligned("decode_attention", q, k, v)
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
               o.data_ptr(), B, L, KV, G, hd, hd ** -0.5, int(window),
               float(softcap), code, _build.stream_of(q))
    _build.check_rc(rc, "decode_attention")
    decode_attention_bkgh.launches += 1
    return o


decode_attention_bkgh.launches = 0


def decode_attention_state_bkgh(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, lengths: torch.Tensor, *,
                                softcap: float = 0.0):
    """The state-out variant of :func:`decode_attention_bkgh`, full
    layout: q (B, KV, G, hd); k/v (B, L, KV, hd), a block of each slot's
    rows; lengths (B,) int32, each slot's live rows in the block, a prefix
    (0: no live row, the empty state). All on the card, q, k and v on
    16-byte boundaries. Returns float32 (acc (B, KV, G, hd), m (B, KV,
    G), l (B, KV, G)): the merged unnormalised sum, its max and its
    denominator (``kernels.ref.merge_states`` gives o)."""
    code = _build.check_operands("decode_attention_state", q, k, v)
    B, KV, G, hd = q.shape
    L = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2] != KV
            or k.shape[3] != hd or hd not in HEAD_DIMS
            or not 1 <= G <= MAX_GROUP or not 1 <= L <= MAX_ROWS):
        raise ValueError(f"decode_attention_state: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} (hd in "
                         f"{HEAD_DIMS}, G <= {MAX_GROUP}, L <= {MAX_ROWS})")
    _check_index("decode_attention_state: lengths", lengths, (B,), q.device)
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    l = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return acc, m, l
    _check_aligned("decode_attention_state", q, k, v)
    rc = _state_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), acc.data_ptr(), m.data_ptr(),
                     l.data_ptr(), B, L, KV, G, hd, hd ** -0.5,
                     float(softcap), code, _build.stream_of(q))
    _build.check_rc(rc, "decode_attention_state")
    decode_attention_state_bkgh.launches += 1
    return acc, m, l


decode_attention_state_bkgh.launches = 0


def decode_attention_paged_bkgh(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, lengths: torch.Tensor,
                                table: torch.Tensor, *,
                                softcap: float = 0.0) -> torch.Tensor:
    """q (B, KV, G, hd) one token per slot; k/v (P, bk, KV, hd) block
    arena, block 0 the never-written null block; lengths (B,) int32 = pos
    + 1 (0: dead slot, exact-zero output); table (B, NB) int32, logical
    block j of slot b in arena block table[b, j] (entries in [0, P)). All
    on the card, q, k and v on 16-byte boundaries. Returns (B, KV, G,
    hd)."""
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
    # a block stages the table entries its tiles span in shared memory
    if (not 1 <= NB * bk <= MAX_ROWS
            or smem_bytes(G, hd, True, NB * bk, bk) > SMEM_MAX):
        raise ValueError(f"decode_attention_paged: NB = {NB} blocks of "
                         f"{bk} rows: a block's table entries exceed its "
                         f"shared memory ({SMEM_MAX} bytes)")
    _check_index("decode_attention_paged: lengths", lengths, (B,), q.device)
    _check_index("decode_attention_paged: table", table, (B, NB), q.device)
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    _check_aligned("decode_attention_paged", q, k, v)
    rc = _paged_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), table.data_ptr(), o.data_ptr(), B,
                     NB, bk, P, KV, G, hd, hd ** -0.5, float(softcap), code,
                     _build.stream_of(q))
    _build.check_rc(rc, "decode_attention_paged")
    decode_attention_paged_bkgh.launches += 1
    return o


decode_attention_paged_bkgh.launches = 0


def compiled_config() -> dict:
    """The compiled plan's constants (``drt_decode_config``), on the card."""
    out = (ctypes.c_int * 5)()
    _build.lib("decode_attention").drt_decode_config(
        ctypes.cast(out, ctypes.c_void_p))
    return dict(zip(("cluster", "tile", "warps", "stages", "ring_bytes"),
                    list(out)))


def compiled_rank_rows(length: int, rows: int, window: int = 0) -> list:
    """``rank_rows`` as the compiled plan gives it (``drt_decode_plan``)."""
    fn = _build.lib("decode_attention").drt_decode_plan
    if fn.argtypes is None:
        fn.argtypes = [I, I, I, I, P, I]
        fn.restype = I
    cap = -(-rows // TILE) + 1
    out = (ctypes.c_int * (2 * cap))()
    ranks = []
    for r in range(CLUSTER):
        got = fn(length, rows, window, r, ctypes.cast(out, ctypes.c_void_p),
                 cap)
        ranks.append([(out[2 * i], out[2 * i + 1]) for i in range(got)])
    return ranks
