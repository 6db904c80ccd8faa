"""The port's paged KV pool and prefix reuse against the JAX package's, on
the CPU, and the plain version of the paged decode kernel.

The batcher twins reuse ``test_torch_batcher``'s machinery: the same
weights, requests and fault plans go through the JAX ``ContinuousBatcher``
and the port's, on the paged pool and on the paged pool with prefix reuse
(copy-on-write forks included), and must agree on tokens, status, the
shed/rejected/failed sets, metrics, stats and the pool's bookkeeping. The
contiguous pool stays the oracle: the paged runs give its tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_paged_bkgh
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.serve import aot

from test_torch_batcher import (CFG, CHAOS, CONTIG, PAGED, SHARED,
                                assert_pool_drained, mixed_requests, outs,
                                run, shared_registries, twin,
                                uniform_requests, weights)
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the plain version against the TPU kernel (interpret mode)
# ---------------------------------------------------------------------------
def _paged_inputs(dtype=np.float32, hd=16):
    """tests/test_decode_fast_path.py's paged shapes: a shuffled arena, a
    dead slot (all-null table row) and a slot filling every block."""
    bk, B, NB, H, KV = 16, 3, 4, 4, 2
    P = B * NB + 1
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, H, hd)).astype(dtype)
    ka = rng.standard_normal((P, bk, KV, hd)).astype(dtype)
    va = rng.standard_normal((P, bk, KV, hd)).astype(dtype)
    ka[0] = 0
    va[0] = 0
    perm = np.random.default_rng(7).permutation(np.arange(1, P))
    lengths = np.asarray([37, 0, NB * bk], dtype=np.int32)
    table = np.zeros((B, NB), dtype=np.int32)
    j = 0
    for b in range(B):
        nblk = -(-int(lengths[b]) // bk)
        table[b, :nblk] = perm[j:j + nblk]
        j += nblk
    return q, ka, va, lengths, table


@pytest.mark.parametrize("softcap,hd", [
    pytest.param(0.0, 16, id="0.0"), pytest.param(20.0, 16, id="20.0"),
    pytest.param(0.0, 256, id="0.0-hd256")])   # gemma3's head dim
def test_plain_paged_matches_jax_kernel_and_contiguous_plain(softcap, hd):
    q, ka, va, lengths, table = _paged_inputs(hd=hd)
    B, H, hd = q.shape
    KV = ka.shape[2]
    jo = decode_attention_paged_bkgh(
        jnp.asarray(q).reshape(B, KV, H // KV, hd), jnp.asarray(ka),
        jnp.asarray(va), jnp.asarray(lengths), jnp.asarray(table),
        softcap=softcap, interpret=True)
    jo = np.asarray(jo).reshape(B, H, hd)
    t = [torch.as_tensor(a) for a in (q, ka, va, lengths, table)]
    o = ref.decode_attention_paged(*t, softcap=softcap).numpy()
    # on CPU tensors the op takes the plain version
    np.testing.assert_array_equal(
        ops.decode_attention_paged(*t, softcap=softcap).numpy(), o)
    err = np.abs(o - jo).max() / max(np.abs(jo).max(), 1e-30)
    assert err < 2e-5, err
    assert (o[1] == 0).all()                       # the dead slot
    # bit-identical to the contiguous plain version on the gathered layout
    NB, bk = table.shape[1], ka.shape[1]
    kc = t[1][t[4].long()].reshape(B, NB * bk, KV, hd)
    vc = t[2][t[4].long()].reshape(B, NB * bk, KV, hd)
    oc = ref.decode_attention(t[0], kc, vc, t[3], softcap=softcap).numpy()
    np.testing.assert_array_equal(o, oc)


def test_paged_decode_writes_nothing_for_dead_rows_and_never_block_0():
    """The paged decode step's write index has one entry per row: a dead
    row (pos -1) and a position past the table are not kept and point at
    offset 0 of the null block, which their write leaves as it was; every
    kept target is a real block at the right offset."""
    pos = torch.tensor([5, -1, 17, 64], dtype=torch.int32)
    table = torch.tensor([[3, 0, 0, 0], [0, 0, 0, 0], [4, 7, 0, 0],
                          [1, 2, 5, 6]], dtype=torch.int32)
    blk, off, keep = A.paged_write_index(pos, table, 16)
    assert keep.tolist() == [True, False, True, False]
    assert blk.tolist() == [3, 0, 7, 0] and off.tolist() == [5, 0, 1, 0]
    arena = torch.zeros((8, 16, 1, 2))
    A._write_rows(arena, (blk, off, keep), torch.ones((4, 1, 2)))
    assert arena[0].abs().sum() == 0                  # the null block
    assert arena[3, 5].eq(1).all() and arena[7, 1].eq(1).all()
    assert arena.eq(1).sum() == 4
    rows, slot, keep = A.cache_write_index(pos, 64, 0)
    assert rows.tolist() == [0, 1, 2, 3] and slot.tolist() == [5, 0, 17, 0]
    assert keep.tolist() == [True, True, True, False]


# ---------------------------------------------------------------------------
# the row functions
# ---------------------------------------------------------------------------
def _arena(P=6, bk=2, B=3):
    k = torch.arange(P, dtype=torch.float32)[None, :, None, None, None] \
        .expand(2, P, bk, 1, 2).clone()
    return {"runs": {"run0": {"kv": {"k": k, "v": k.clone()}}},
            "pos": torch.zeros((B,), dtype=torch.int32)}


def test_copy_blocks_reads_every_source_before_writing():
    pool = _arena()
    # a chain 1 -> 2 -> 3: block 3 must get block 2's OLD content; the
    # sentinel pair (6, 6) and a null-block destination are dropped
    aot.copy_blocks(pool, np.array([1, 2, 6, 4]), np.array([2, 3, 6, 0]))
    k = pool["runs"]["run0"]["kv"]["k"]
    assert k[:, :, 0, 0, 0][0].tolist() == [0, 1, 1, 2, 4, 5]


def test_purge_and_scatter_paged_drop_their_sentinels():
    pool = _arena()
    aot.purge_paged(pool, np.array([1, 3, 3]), np.array([0, 2, 6, 6]))
    k = pool["runs"]["run0"]["kv"]["k"]
    assert k[0, :, 0, 0, 0].tolist() == [0, 1, 0, 3, 4, 5]   # not block 0
    assert pool["pos"].tolist() == [0, -1, 0]
    # row 0 writes 4 live tokens from position 1 through table row 0,
    # the last of them into a null entry (dropped); row 1 is padding
    src_k = torch.full((2, 2, 4, 1, 2), 9.0)
    src = {"runs": {"run0": {"kv": {"k": src_k, "v": src_k.clone()}}},
           "pos": torch.tensor([5, 4], dtype=torch.int32)}
    table = np.array([[5, 4, 0], [1, 1, 1], [3, 3, 3]], dtype=np.int32)
    aot.scatter_paged(pool, src, np.array([0, 3]), table, np.array([1, 0]))
    k = pool["runs"]["run0"]["kv"]["k"][0, :, :, 0, 0]
    assert k[5].tolist() == [5, 9] and k[4].tolist() == [9, 9]
    assert k[0].tolist() == [0, 0] and k[1].tolist() == [1, 1]
    assert pool["pos"].tolist() == [5, -1, 0]


# ---------------------------------------------------------------------------
# batcher twins on the paged pool
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def regs():
    return shared_registries()


@pytest.fixture(scope="module")
def contiguous_outs():
    """Port contiguous-pool oracles (no JAX): uniform and mixed."""
    tp = weights()[3]
    _, r1 = run("port", tp, CONTIG, uniform_requests())
    _, r2 = run("port", tp, CONTIG, mixed_requests(), stagger=3)
    return outs(r1), outs(r2)


def test_paged_mixed_lengths_match_jax_and_contiguous(regs,
                                                      contiguous_outs):
    cb, res = twin(regs, PAGED, mixed_requests(), stagger=3)
    assert res.status == "drained"
    assert outs(res) == contiguous_outs[1]
    assert cb.pool.peak_in_use > 0
    assert_pool_drained(cb)
    m = cb.metrics()
    assert m["gauges"]["kv_blocks_in_use"] == 0
    assert cb.stats["decode_retraces"] == 1
    assert cb.stats["prefill_retraces"] <= 6


@pytest.mark.parametrize("name", list(CHAOS))
def test_paged_chaos_plan_matches_jax(regs, contiguous_outs, name):
    plan, acfg = CHAOS[name]
    cb, res = twin(regs, PAGED, uniform_requests(), plan=plan, acfg=acfg)
    assert res.status == "drained"
    failed = {r.rid for r in res.failed}
    assert outs(res) == {k: v for k, v in contiguous_outs[0].items()
                         if k not in failed}
    assert_pool_drained(cb)


def prefix_requests(seed=5):
    """tests/test_paged.py's prefix workload: r0 seeds the cache (2 full
    blocks), r1 reuses its header block exactly, r2 matches 5 tokens into
    r0's second block (a copy-on-write fork)."""
    rng = np.random.default_rng(seed)
    V = CFG.vocab_size
    H = rng.integers(0, V, size=(16,), dtype=np.int32)
    A_ = rng.integers(0, V, size=(16,), dtype=np.int32)
    t0 = np.concatenate([H, A_, rng.integers(0, V, size=(1,),
                                             dtype=np.int32)])
    tail_b = rng.integers(0, V, size=(10,), dtype=np.int32)
    tail_b[0] = (A_[0] + 1) % V
    tail_c = rng.integers(0, V, size=(9,), dtype=np.int32)
    tail_c[0] = (A_[5] + 1) % V
    return [(0, t0, 4, None), (1, np.concatenate([H, tail_b]), 4, None),
            (2, np.concatenate([H, A_[:5], tail_c]), 4, None)]


def shared_header_requests(n=6, seed=9):
    """Six requests over one 16-token header (one full block) with 7-token
    private tails, for the chaos plans under prefix reuse."""
    rng = np.random.default_rng(seed)
    H = rng.integers(0, CFG.vocab_size, size=(16,), dtype=np.int32)
    return [(i, np.concatenate([H, rng.integers(0, CFG.vocab_size, size=(7,),
                                                dtype=np.int32)]), 5, None)
            for i in range(n)]


def test_prefix_reuse_with_cow_fork_matches_jax(regs):
    reqs = prefix_requests()
    cb, res = twin(regs, SHARED, reqs, first_alone=True)
    _, r0 = run("port", weights()[3], CONTIG, reqs, first_alone=True)
    assert res.status == "drained" and outs(res) == outs(r0)
    m = cb.metrics()
    assert (m["prefix_misses"], m["prefix_hits"], m["cow_forks"]) == \
        (1, 2, 1)
    # only the 2 published entries still pin blocks; evicting them empties
    # the pool: the refcounted frees balance
    assert cb.pool.in_use == 2
    while cb.prefix.evict_lru(cb.pool):
        pass
    assert cb.pool.in_use == 0 and not cb._req_blocks


@pytest.mark.parametrize("name", list(CHAOS))
def test_prefix_chaos_plan_matches_jax(regs, name):
    plan, acfg = CHAOS[name]
    reqs = shared_header_requests()
    cb, res = twin(regs, SHARED, reqs, plan=plan, acfg=acfg, stagger=2)
    assert res.status == "drained"
    assert cb.metrics()["prefix_hits"] > 0
    _, clean = run("port", weights()[3], CONTIG, reqs, stagger=2)
    failed = {r.rid for r in res.failed}
    assert outs(res) == {k: v for k, v in outs(clean).items()
                         if k not in failed}
    assert cb.pool.in_use == len(cb.prefix) and not cb._req_blocks


def test_poison_purge_spares_shared_prefix_blocks(regs):
    """rid 1 shares r0's header block and fails typed at admission; its
    purge zeroes only its private blocks, so r0 (mid-decode through the
    shared header) and r2 (forked off the same cache) finish with the
    clean run's tokens."""
    reqs = prefix_requests()
    cb, res = twin(regs, SHARED, reqs, first_alone=True,
                   plan=dict(poison_rids=(1,)), acfg=dict(max_retries=0))
    assert [r.rid for r in res.failed] == [1]
    _, clean = run("port", weights()[3], CONTIG, reqs, first_alone=True)
    want = outs(clean)
    assert outs(res) == {0: want[0], 2: want[2]}
