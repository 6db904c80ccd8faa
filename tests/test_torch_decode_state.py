"""The state-out variant of the decode kernel, on the CPU (its plain
versions ``kernels.ref.decode_attention_state`` and ``merge_states``),
split over 1, 2 and 4 row blocks of each slot's cache as the sharded
decode step splits it over ``model``, against the whole-cache decode
attention of the port and of the JAX package (``repro.kernels.ref.
decode_attention``, the decode kernel's oracle) on the same numpy inputs.

Each block's live rows come from ``models.attention.split_live_rows``,
the helper the sharded step uses: a slot's live rows are a prefix of its
cache in the full and the ring layouts, so a block's are ``clamp(live -
offset, 0, rows)``. Lengths sit at the blocks' boundaries and one either
side, past the end of a full cache, and past a ring's wrap; slots are
dead on one block or on every block (exact zeros). At one block the merge
equals the whole-cache output bit for bit; over 2 and 4 blocks within
``tests/test_kernels.py:15``'s tolerance. The CUDA variant is held to the
same plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.dist.sharding import SeqSplit
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import split_live_rows
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:15
L = 48                                       # rows a slot; 48 / 4 = 12


def _lengths(n_blocks: int, window: int) -> list:
    """pos + 1 of every slot: dead, 1, each block boundary and one either
    side, the cache's end and past it (a full cache's position past its
    rows; a ring that wrapped)."""
    rows = L // n_blocks
    out = {0, 1, L - 1, L, L + 1, 2 * L + 5}
    for b in range(1, n_blocks + 1):
        out |= {b * rows - 1, b * rows, b * rows + 1}
    return sorted(x for x in out if x >= 0)


def _inputs(B, H, KV, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    dt = getattr(torch, dtype)
    return [torch.tensor(a).to(dt) for a in (q, k, v)], (q, k, v)


def _split_merge(q, k, v, lengths, window, softcap, n_blocks):
    """The sharded step's arithmetic on one process: each block's state
    over its rows, stacked in block order, merged."""
    rows = L // n_blocks
    pos = lengths.to(torch.int32) - 1
    states = []
    for b in range(n_blocks):
        sp = SeqSplit(None, b * rows, rows, L)
        local = split_live_rows(pos, window, sp)
        states.append(ops.decode_attention_state(
            q, k[:, b * rows:(b + 1) * rows], v[:, b * rows:(b + 1) * rows],
            local, softcap=softcap))
    acc, m, l = (torch.stack(t) for t in zip(*states))
    return ref.merge_states(acc, m, l, q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_blocks", [1, 2, 4])
@pytest.mark.parametrize("window", [0, L])
@pytest.mark.parametrize("G,softcap", [(1, 0.0), (2, 30.0), (3, 0.0),
                                       (8, 50.0)])
def test_blocks_merged_equal_the_whole_cache(G, softcap, window, n_blocks,
                                             dtype):
    """Full and ring layouts, G 1-8, with and without softcap: every slot's
    merged output against the whole-cache decode attention of the port and
    of JAX."""
    KV, hd = 2, 16
    lens = _lengths(n_blocks, window)
    (q, k, v), (qn, kn, vn) = _inputs(len(lens), KV * G, KV, hd, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32)
    got = _split_merge(q, k, v, lengths, window, softcap, n_blocks)
    whole = ref.decode_attention(q, k, v, lengths, window=window,
                                 softcap=softcap)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jref.decode_attention(
        jnp.asarray(qn).astype(jdt), jnp.asarray(kn).astype(jdt),
        jnp.asarray(vn).astype(jdt), jnp.asarray(lens, dtype=jnp.int32),
        window=window, softcap=softcap).astype(jnp.float32))
    scale = float(whole.float().abs().max())
    if n_blocks == 1:
        assert torch.equal(got, whole)
    else:
        assert float((got.float() - whole.float()).abs().max()) \
            <= TOL[dtype] * scale
    assert float(np.abs(got.float().numpy() - want).max()) \
        <= TOL[dtype] * scale
    assert torch.equal(got[0], torch.zeros_like(got[0]))      # dead slot


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_a_block_without_live_rows_is_the_empty_state(n_blocks):
    """A slot whose live rows all lie in the first block: every later block
    has none and gives m = -1e30, l = 0, acc = 0, which the merge weighs
    at exp(-1e30 - M) = 0; a slot dead on every block merges to exact
    zeros."""
    (q, k, v), _ = _inputs(2, 4, 2, 16, "float32", seed=1)
    rows = L // n_blocks
    lengths = torch.tensor([0, rows - 1], dtype=torch.int32)
    for b in range(1, n_blocks):
        sp = SeqSplit(None, b * rows, rows, L)
        local = split_live_rows(lengths - 1, 0, sp)
        assert local.tolist() == [0, 0]
        acc, m, l = ref.decode_attention_state(
            q, k[:, b * rows:(b + 1) * rows], v[:, b * rows:(b + 1) * rows],
            local)
        assert torch.all(m == ref.NEG_INF) and torch.all(l == 0)
        assert torch.all(acc == 0)
    got = _split_merge(q, k, v, lengths, 0, 0.0, n_blocks)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[1], ref.decode_attention(
        q[1:], k[1:, :rows], v[1:, :rows], lengths[1:])[0])


def test_split_live_rows_is_the_kernels_prefix():
    """``split_live_rows`` over the blocks sums to the kernel's live rows
    (``kernels.decode_attention.live_rows``) and each block's are a prefix
    of it, in both layouts."""
    from repro_torch.kernels.decode_attention import live_rows
    for window in (0, 20, L):
        for n in (1, 2, 4):
            rows = L // n
            for length in range(0, 2 * L + 3):
                pos = torch.tensor([length - 1], dtype=torch.int32)
                got = [int(split_live_rows(pos, window, SeqSplit(
                    None, b * rows, rows, L))[0]) for b in range(n)]
                assert sum(got) == live_rows(length, L, window)
                assert got == sorted(got, reverse=True)
                assert all(0 <= g <= rows for g in got)

