"""The port's serve registries against the JAX package's, on the CPU.

* The decode step's write index lists have one entry per row and need no
  host sync; the cache bits they leave equal those of the ``nonzero``
  form they replace and of the JAX package's dropping scatter, for random
  positions that include dead rows, positions past the cache and past the
  block table.
* ``AotRegistry`` (on a CPU pool: the static-buffer path, run eagerly)
  drains the same workload as the port's ``TracedRegistry`` and as the JAX
  ``AotRegistry`` on bridged weights, with identical tokens and stats; its
  warm set is JAX's for the same ladder, buckets and pool (JAX's set is
  recorded by a subclass whose ``_resolve`` compiles nothing); a drain at
  full rank after ``warm()`` makes no entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.models import transformer as JT
from repro.serve import admission as jadm
from repro.serve import aot as jaot
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serve import admission as adm
from repro_torch.serve import aot as taot
from repro_torch.serve import engine as E
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
          d_ff=128, vocab_size=256, rank_multiple=1)
JCFG = jget_config("llama-mini").replace(**KW)
CFG = get_config("llama-mini").replace(**KW)
CONTIG = dict(batch=2, max_len=32)                 # tests/test_aot.py's
PAGED = dict(batch=2, max_len=32, kv_block=8)
SHARED = dict(batch=2, max_len=32, kv_block=8, prefix_cache=True)


# ---------------------------------------------------------------------------
# the fixed-length decode write index
# ---------------------------------------------------------------------------
def _nonzero_write(cache, new, pos, layout, table=None):
    """The write the port made before its lists were fixed-length: the
    rows that write found by ``nonzero`` (a host sync on the card)."""
    L = cache.shape[1]
    if layout == "ring":
        rows = torch.arange(pos.shape[0])
        cache[rows, torch.remainder(pos, L).long()] = new
    elif layout == "full":
        rows = torch.nonzero(pos < L).squeeze(1)
        cache[rows, pos[rows].clamp_min(0).long()] = new[rows]
    else:
        NB = table.shape[1]
        safe = pos.clamp_min(0).long()
        ok = (pos >= 0) & (torch.div(safe, L, rounding_mode="floor") < NB)
        rows = torch.nonzero(ok).squeeze(1)
        blk = table[rows, torch.div(safe[rows], L, rounding_mode="floor")]
        cache[blk.long(), safe[rows] % L] = new[rows]


def _jax_write(cache, new, pos, layout, table=None):
    """The JAX package's decode write (``models/attention.py``), its
    out-of-range targets dropped."""
    c, n, p = jnp.asarray(cache.numpy()), jnp.asarray(new.numpy()), \
        jnp.asarray(pos.numpy())
    rows = jnp.arange(p.shape[0])
    if layout == "paged":
        P, bk = c.shape[0], c.shape[1]
        tb = jnp.asarray(table.numpy())
        NB = tb.shape[1]
        safe = jnp.maximum(p, 0)
        pb = jnp.where((p >= 0) & (safe // bk < NB),
                       tb[rows, jnp.minimum(safe // bk, NB - 1)], P)
        return np.asarray(c.at[pb, safe % bk].set(n, mode="drop"))
    L = c.shape[1]
    slot = jnp.mod(p, L) if layout == "ring" else jnp.maximum(p, 0)
    return np.asarray(c.at[rows, slot].set(n))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", ["full", "ring", "paged"])
def test_fixed_length_write_index_matches_nonzero_and_jax(layout, seed):
    rng = np.random.default_rng(seed)
    B, L, KV, hd, NB, P = 12, 8, 2, 4, 3, 10
    if layout == "paged":
        # a dead row, rows past the table, rows at every block edge
        pos = rng.integers(-1, NB * L + 6, B)
        pos[:3] = (-1, NB * L, NB * L - 1)
        table = np.zeros((B, NB), dtype=np.int32)
        for b in range(B):           # live entries are allocated (> 0)
            table[b] = rng.choice(np.arange(1, P), NB, replace=False)
        table = torch.as_tensor(table)
        shape = (P, L, KV, hd)
    else:
        pos = rng.integers(-1, L + 5, B)
        pos[:3] = (-1, L, L - 1)
        table, shape = None, (B, L, KV, hd)
    pos = torch.as_tensor(pos, dtype=torch.int32)
    cache = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    if layout == "paged":
        cache[0] = 0.0                               # the null block
    new = torch.as_tensor(rng.standard_normal((B, KV, hd)),
                          dtype=torch.float32)
    want = cache.clone()
    _nonzero_write(want, new, pos, layout, table)
    got = cache.clone()
    if layout == "paged":
        index = A.paged_write_index(pos, table, L)
    else:
        index = A.cache_write_index(pos, L, L if layout == "ring" else 0)
    assert all(t.shape[0] == B for t in index if t is not None)
    A._write_rows(got, index, new)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), _jax_write(cache, new, pos, layout, table))
    if layout == "paged":
        assert got[0].abs().sum() == 0               # no new content


# the host reads a decode step must not make: each waits for the card, and
# a captured CUDA graph cannot hold one
_HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "cpu", "numpy")


@pytest.mark.parametrize("arch,paged", [("llama-mini", False),
                                        ("llama-mini", True),
                                        ("gemma3-12b", False)],
                         ids=["full", "paged", "ring"])
def test_decode_step_reads_nothing_on_the_host(monkeypatch, arch, paged):
    """A decode step over dead rows, live ones and one past the cache (or
    the table) runs with every host read of a tensor, and ``nonzero``,
    made to raise; gemma3's reduced stack has ring (sliding-window)
    layers."""
    cfg = get_config(arch).reduced()
    params, _ = T.init_model(cfg, seed=0, device="cpu")
    pos = torch.tensor([-1, 4, 20], dtype=torch.int32)
    if paged:
        cache = T.init_cache_paged(cfg, 3, 7, 8, device="cpu")
        table = torch.tensor([[0, 0], [1, 2], [3, 4]], dtype=torch.int32)
    else:
        cache, table = T.init_cache(cfg, 3, 16, device="cpu"), None
    cache["pos"].copy_(pos)
    pos_buf = cache["pos"]

    def host_read(*args, **kwargs):
        raise AssertionError("a host read in the decode step")
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, host_read)
    monkeypatch.setattr(torch, "nonzero", host_read)
    logits, out = T.decode_step(params, cfg, cache,
                                torch.zeros((3, 1), dtype=torch.int32),
                                table=table)
    monkeypatch.undo()
    assert out["pos"] is pos_buf                 # advanced in place
    assert out["pos"].tolist() == [-1, 5, 21]
    assert logits.shape == (3, 1, cfg.vocab_size)


# ---------------------------------------------------------------------------
# weights, the artifact, requests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    """(JAX dense params, port dense params bridged from them)."""
    jp, _ = JT.init_model(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, weights):
    """A JAX D-Rank artifact (tests/test_aot.py's compression)."""
    calib = [{"tokens": jax.random.randint(
        jax.random.PRNGKey(1), (2, 16), 0, JCFG.vocab_size)}]
    comp, plan = JC.build_plan_and_params(
        weights[0], JCFG, JC.CompressionConfig(ratio=0.4), calib)
    d = str(tmp_path_factory.mktemp("aot_art"))
    JC.save_plan(d, comp, plan, JCFG)
    return d


def _requests(n=4, n_new=5, seed=0, mixed=False, prefix=0):
    """tests/test_aot.py's workload (prompts of 7), or prompts of 1-30;
    with ``prefix`` the even rids start with one shared prefix of that
    many tokens."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, CFG.vocab_size, size=(prefix,), dtype=np.int32)
    out = []
    for i in range(n):
        toks = rng.integers(0, CFG.vocab_size,
                            size=(int(rng.integers(1, 31)) if mixed else 7,),
                            dtype=np.int32)
        if prefix and i % 2 == 0:
            toks = np.concatenate([shared, toks[:30 - prefix]])
        out.append((i, toks, n_new))
    return out


def _drain(cb, reqs, stagger=0):
    cb.warm_executables()
    warm = dict(cb.stats)
    mod = JE if isinstance(cb, JE.ContinuousBatcher) else E
    for i, (rid, toks, n_new) in enumerate(reqs):
        cb.submit(mod.Request(rid=rid, tokens=toks.copy(), n_new=n_new))
        if stagger and i % stagger == stagger - 1:
            cb.step()
    res = cb.run_until_drained()
    assert res.status == "drained"
    return {r.rid: list(r.out) for r in res}, warm, dict(cb.stats)


def _port(params, scfg, registry=None, artifact=None, **kw):
    sc = E.ServeConfig(**scfg)
    if registry == "aot":
        registry = taot.AotRegistry(CFG, sc, "test", stats=None)
    if artifact is not None:
        return E.from_compressed(artifact, CFG, sc, device="cpu",
                                 executables=registry, **kw)
    return E.ContinuousBatcher(params, CFG, sc, device="cpu",
                               executables=registry, **kw)


# ---------------------------------------------------------------------------
# AotRegistry against TracedRegistry and JAX's AotRegistry
# ---------------------------------------------------------------------------
def test_aot_registry_matches_traced_and_jax_aot(tmp_path, weights):
    reqs = _requests()
    jreg = jaot.AotRegistry(JCFG, JE.ServeConfig(**CONTIG), "test",
                            cache_dir=str(tmp_path))
    jout, jwarm, jstats = _drain(
        JE.ContinuousBatcher(weights[0], JCFG, JE.ServeConfig(**CONTIG),
                             executables=jreg), reqs)
    tout, _, tstats = _drain(_port(weights[1], CONTIG), reqs)
    cb = _port(weights[1], CONTIG, "aot")
    aout, awarm, astats = _drain(cb, reqs)
    assert aout == tout == jout
    assert astats == jstats, (astats, jstats)
    assert set(tstats) | set(taot.AOT_STAT_KEYS) == set(astats)
    # after warm() a full-rank drain makes no entry, as JAX compiles none
    assert awarm["aot_compiles"] == astats["aot_compiles"] == \
        jwarm["aot_compiles"] == len(cb.exec.entries())
    assert astats["aot_cache_hits"] == astats["aot_fallbacks"] == 0
    # a CPU pool has no graph: every call ran the static-buffer path
    assert cb.exec.replays == {} and cb.exec.graph_bytes() == {}
    assert cb.exec.calls["decode"] > 0


@pytest.mark.parametrize("scfg", [PAGED, SHARED], ids=["paged", "prefix"])
def test_aot_registry_paged_drain_matches_traced(weights, scfg):
    reqs = _requests(n=7, n_new=4, seed=3, mixed=True,
                     prefix=16 if scfg is SHARED else 0)
    tout, _, tstats = _drain(_port(weights[1], scfg), reqs, stagger=2)
    cb = _port(weights[1], scfg, "aot")
    aout, awarm, astats = _drain(cb, reqs, stagger=2)
    assert aout == tout
    assert awarm["aot_compiles"] == astats["aot_compiles"]
    assert {k: v for k, v in astats.items() if k in tstats and
            not k.endswith("_retraces")} == \
        {k: v for k, v in tstats.items() if not k.endswith("_retraces")}
    assert all(astats[k] == 0 for k in taot.RETRACE_KEYS)
    assert cb.pool.in_use == (len(cb.prefix) if cb.prefix else 0)


def test_elastic_drain_makes_only_late_low_rung_prefills(artifact):
    """Under queue pressure the ladder steps down; the only entries made
    after warm() are prefills at rungs >= 1, where JAX compiles late."""
    acfg = adm.AdmissionConfig(elastic=True, elastic_levels=2,
                               degrade_above=3, restore_below=1)
    reqs = _requests(n=10, n_new=3, seed=5, mixed=True)
    tout, _, _ = _drain(_port(None, CONTIG, artifact=artifact,
                              admission=acfg), reqs)
    cb = _port(None, CONTIG, "aot", artifact=artifact, admission=acfg)
    aout, awarm, astats = _drain(cb, reqs)
    assert aout == tout
    late = cb.exec.entries()[awarm["aot_compiles"]:]
    assert late and all(role == "prefill" and variant[0] >= 1
                        for role, variant in late)
    assert astats["aot_compiles"] == awarm["aot_compiles"] + len(late)
    assert set(cb.metrics()["rank_residency"]) - {"0"}


class _Recording(jaot.AotRegistry):
    """JAX's registry with a ``_resolve`` that records (role, variant) and
    compiles nothing."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.made = []

    def _resolve(self, role, variant, args):
        self.made.append((role, tuple(variant)))


@pytest.mark.parametrize("elastic", [False, True], ids=["rung0", "ladder"])
@pytest.mark.parametrize("scfg", [CONTIG, PAGED], ids=["contiguous",
                                                       "paged"])
def test_warm_set_equals_jax(tmp_path, artifact, scfg, elastic):
    acfg = dict(elastic=True) if elastic else {}
    jreg = _Recording(JCFG, JE.ServeConfig(**scfg), "test",
                      cache_dir=str(tmp_path))
    jcb = JE.from_compressed(artifact, JCFG, JE.ServeConfig(**scfg),
                             executables=jreg,
                             admission=jadm.AdmissionConfig(**acfg))
    jcb.warm_executables()
    cb = _port(None, scfg, "aot", artifact=artifact,
               admission=adm.AdmissionConfig(**acfg))
    cb.warm_executables()
    assert len(cb.ladder) == len(jcb.ladder) == (3 if elastic else 1)
    assert cb.exec.entries() == jreg.made
    assert cb.stats["aot_compiles"] == len(jreg.made)
    # warming on the empty pool left every slot dead
    assert (cb.cache["pos"] == -1).all()


def test_warm_refuses_a_live_pool(weights):
    cb = _port(weights[1], CONTIG, "aot")
    cb.cache["pos"][0] = 3
    with pytest.raises(ValueError, match="empty pool"):
        cb.warm_executables()


def test_rebuilt_pool_or_other_params_make_a_new_entry(weights):
    """An entry is bound to its params object and its pool's storage: a
    dispatch with another of either makes the entry again (counted in
    ``aot_fallbacks``), so nothing replays onto dead storage."""
    cb = _port(weights[1], CONTIG, "aot")
    cb.warm_executables()
    n = cb.stats["aot_compiles"]
    tok = np.zeros((2, 1), dtype=np.int32)
    cb.exec.decode(cb.params, cb.cache, tok)
    assert cb.stats["aot_compiles"] == n
    cb.cache = T.init_cache(CFG, 2, 32, device="cpu")
    cb.exec.decode(cb.params, cb.cache, tok)
    assert cb.stats["aot_compiles"] == n + 1
    assert cb.stats["aot_fallbacks"] == 1
    other = bridge.from_numpy(jax.tree.map(np.asarray, weights[0]),
                              device="cpu")
    cb.exec.decode(E.place_params(other, torch.float32, torch.device("cpu")),
                   cb.cache, tok)
    assert cb.stats["aot_fallbacks"] == 2
    assert len(cb.exec.entries()) == n


def test_cache_key_separates_roles_variants_and_config(weights):
    fp = taot.live_fingerprint(weights[1], CFG)
    sc = E.ServeConfig(**CONTIG)
    k = taot.cache_key(fp, "decode", (0,), "sig", sc, CFG)
    assert k != taot.cache_key(fp, "prefill", (0,), "sig", sc, CFG)
    assert k != taot.cache_key(fp, "decode", (1,), "sig", sc, CFG)
    assert k != taot.cache_key(fp, "decode", (0,), "sig",
                               E.ServeConfig(batch=4, max_len=32), CFG)
    assert k != taot.cache_key("sha256:other", "decode", (0,), "sig", sc,
                               CFG)
    assert k != taot.cache_key(fp, "decode", (0,), "sig", sc,
                               CFG.replace(dtype="bfloat16"))
    assert k == taot.cache_key(fp, "decode", (0,), "sig", sc, CFG)
    # the live fingerprint reads structure, shapes and dtypes, not values
    assert fp == taot.live_fingerprint(
        {k2: v for k2, v in weights[1].items()}, CFG)
    assert fp != taot.live_fingerprint(weights[1], CFG.replace(n_layers=3))
    assert fp.startswith("live-")
