"""The port's ``ContinuousBatcher`` against the JAX package's, on the CPU.

Both packages serve the same weights (the JAX ``init_model`` tree bridged
through numpy, and a JAX D-Rank artifact booted by each package's
``from_compressed``) with the same requests, schedule and fault plans. A
twin run compares everything the batcher reports: the tokens of every
request, the drain status, the shed / rejected / failed / undrained rid
sets with their statuses, the metrics (counters, gauges, rank residency,
histogram counts), the stats (admissions, retrace counts), the fault plan's
fired injectors and, on the paged pool, the pool's bookkeeping.

Every batcher of a module shares one registry per package (``Shared``), so
each JAX ``jax.jit`` compiles once per module instead of once per run; each
run's stats get exactly the traces (JAX) or new signatures (port) its own
calls caused, which both packages then report alike.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.dist import faultinject as JFI
from repro.models import transformer as JT
from repro.serve import admission as jadm
from repro.serve import aot as jaot
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import compress as CC
from repro_torch.dist import faultinject as FI
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
CONTIG = dict(batch=4, max_len=64)
PAGED = dict(batch=4, max_len=64, kv_block=16)
SHARED = dict(batch=4, max_len=64, kv_block=16, prefix_cache=True)

# the seeded chaos plans of tests/test_resilience.py and tests/test_paged.py
CHAOS = {
    "one_row": (dict(nan_decode_step=2, nan_rows=(1,)), None),
    "seeded_row": (dict(seed=7, nan_decode_step=3), None),
    "all_rows_bisect": (dict(nan_decode_step=1, nan_rows="all"), None),
    "prefill_admission": (dict(nan_prefill_admission=0, nan_rows=(0,)),
                          None),
    "persistent_poison": (dict(poison_rids=(2,)), dict(max_retries=1)),
}


# ---------------------------------------------------------------------------
# weights and the artifact (computed once per process)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def weights():
    """(JAX dense params, JAX D-Rank params, their plan, port dense
    params bridged from the JAX tree)."""
    jp, _ = JT.init_model(JCFG, jax.random.PRNGKey(0))
    calib = [{"tokens": jax.random.randint(
        jax.random.PRNGKey(1), (2, 16), 0, JCFG.vocab_size)}]
    jcomp, jplan = JC.build_plan_and_params(
        jp, JCFG, JC.CompressionConfig(ratio=0.4), calib)
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jcomp, jplan, tp


def save_artifact(path) -> str:
    _, jcomp, jplan, _ = weights()
    JC.save_plan(str(path), jcomp, jplan, JCFG)
    return str(path)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------
def uniform_requests(n=6, n_new=5, seed=0):
    """tests/test_resilience.py's workload: n prompts of 7 tokens."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, CFG.vocab_size, size=(7,), dtype=np.int32),
             n_new, None) for i in range(n)]


def mixed_requests(n=10, n_new=4, seed=11):
    """tests/test_paged.py's mixed-length workload: prompts of 1-39."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, CFG.vocab_size,
                             size=(int(rng.integers(1, 40)),),
                             dtype=np.int32), n_new, None)
            for i in range(n)]


# ---------------------------------------------------------------------------
# twin runs
# ---------------------------------------------------------------------------
class Shared:
    """A registry shared by every batcher of one package in a module: the
    wrapped registry's compiled (JAX) or seen (port) signatures persist,
    and each batcher's stats get the retrace counts its own calls add."""

    def __init__(self, inner):
        self.inner = inner
        self.stats = {}

    def bind_stats(self, stats):
        for k in ("prefill_retraces", "decode_retraces", "scatter_retraces"):
            stats.setdefault(k, 0)
        self.stats = stats

    def __getattr__(self, role):
        fn = getattr(self.inner, role)

        def call(*a, **kw):
            before = dict(self.inner.stats)
            out = fn(*a, **kw)
            for k, v in self.inner.stats.items():
                self.stats[k] = self.stats.get(k, 0) + v - before.get(k, 0)
            return out
        return call


def shared_registries():
    """One (JAX, port) pair of shared registries; serve configs of one
    module differ only in the pool, and the registries read max_len."""
    return (Shared(jaot.TracedRegistry(JCFG, JE.ServeConfig(**CONTIG))),
            Shared(taot.TracedRegistry(CFG, E.ServeConfig(**CONTIG))))


def run(side, params, scfg, reqs, *, registry=None, plan=None, acfg=None,
        stagger=0, first_alone=False, max_steps=100000, watchdog_s=None,
        artifact=None):
    """Drive one batcher of ``side`` ("jax" or "port") through ``reqs``
    ((rid, tokens, n_new, deadline_s) tuples). ``stagger``: one step after
    every ``stagger`` submissions; ``first_alone``: submit the first
    request, step once, then the rest (the prefix workload's schedule).
    ``artifact``: boot from that ``save_plan`` directory instead of
    ``params``."""
    jax_side = side == "jax"
    Emod, admmod, FImod = (JE, jadm, JFI) if jax_side else (E, adm, FI)
    cfg = JCFG if jax_side else CFG
    kw = dict(admission=admmod.AdmissionConfig(**(acfg or {})),
              faults=FImod.FaultPlan(**plan) if plan is not None else None,
              executables=registry)
    if not jax_side:
        kw["device"] = "cpu"
    sc = Emod.ServeConfig(**scfg)
    if artifact is not None:
        cb = Emod.from_compressed(artifact, cfg, sc, **kw)
    else:
        cb = Emod.ContinuousBatcher(params, cfg, sc, **kw)
    for i, (rid, toks, n_new, dl) in enumerate(reqs):
        cb.submit(Emod.Request(rid=rid, tokens=np.array(toks), n_new=n_new,
                               deadline_s=dl))
        if (stagger and i % stagger == stagger - 1) or \
                (first_alone and i == 0):
            cb.step()
    res = cb.run_until_drained(max_steps=max_steps, watchdog_s=watchdog_s)
    return cb, res


def outs(res):
    return {r.rid: list(r.out) for r in res}


def summary(cb, res):
    """Everything a twin run must agree on."""
    m = cb.metrics()
    s = {
        "tokens": outs(res),
        "status": res.status,
        "shed": [(r.rid, r.status) for r in res.shed],
        "rejected": [(r.rid, r.status) for r in res.rejected],
        "failed": [(r.rid, r.status, r.error) for r in res.failed],
        "undrained": sorted(r.rid for r in res.undrained),
        "truncated": sorted(r.rid for r in res if r.truncated),
        "counters": m["counters"],
        "gauges": m["gauges"],
        "rank_residency": m["rank_residency"],
        "hist_n": {k: h["n"] for k, h in m["histograms"].items()},
        "stats": dict(cb.stats),
        "fired": list(cb.faults.fired) if cb.faults is not None else None,
        "flight": [(e["kind"], e.get("rids", e.get("rid")), e.get("frm"),
                    e.get("to")) for e in cb.flight.events],
    }
    if cb.paged:
        s["pool"] = {"in_use": cb.pool.in_use, "peak": cb.pool.peak_in_use,
                     "table_clear": bool((cb.table == 0).all()),
                     "req_blocks": sorted(cb._req_blocks),
                     "prefix_entries": (len(cb.prefix)
                                        if cb.prefix is not None else None)}
    return s


def twin(regs, scfg, reqs, *, dense=True, **kw):
    """Run the JAX batcher and the port's on the same workload; assert
    that they agree on everything; return the port's (batcher, result)."""
    jp, jcomp, _, tp = weights()
    jparams, tparams = (jp, tp) if dense else (jcomp, None)
    jcb, jres = run("jax", jparams, scfg, reqs, registry=regs[0], **kw)
    cb, res = run("port", tparams, scfg, reqs, registry=regs[1], **kw)
    assert summary(cb, res) == summary(jcb, jres)
    return cb, res


def assert_pool_drained(cb):
    assert cb.pool.in_use == 0
    assert (cb.table == 0).all()
    assert not cb._req_blocks


# ---------------------------------------------------------------------------
# contiguous pool
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def regs():
    return shared_registries()


@pytest.fixture(scope="module")
def clean(regs):
    """The fault-free uniform run every chaos run must match."""
    cb, res = twin(regs, CONTIG, uniform_requests())
    assert res.status == "drained" and len(res) == 6
    return outs(res)


def test_mixed_length_bucketed_admission_matches_jax(regs):
    """Prompts of 1-39 tokens over many staggered admission rounds; the
    bucketing bound holds: ≤ ⌈log2 max_len⌉ prefill signatures and one
    decode signature (this module's first runs)."""
    cb, res = twin(regs, CONTIG, mixed_requests(), stagger=3)
    assert res.status == "drained" and len(res) == 10
    assert 1 <= cb.stats["prefill_retraces"] <= math.ceil(math.log2(64))
    assert cb.stats["decode_retraces"] == 1
    assert cb.stats["admissions"] > 1


@pytest.mark.parametrize("name", list(CHAOS))
def test_chaos_plan_matches_jax(regs, clean, name):
    plan, acfg = CHAOS[name]
    cb, res = twin(regs, CONTIG, uniform_requests(), plan=plan, acfg=acfg)
    assert res.status == "drained"
    assert cb.faults.fired or cb.faults.poison_rids
    failed = {r.rid for r in res.failed}
    assert outs(res) == {k: v for k, v in clean.items() if k not in failed}
    if name == "persistent_poison":
        assert failed == {2} and cb.metrics()["poison_failures"] == 1
    if name == "all_rows_bisect":
        assert cb.metrics()["poison_probes"] >= 1


def test_deadlines_and_backpressure_match_jax(regs, clean):
    """Overdue requests (deadline already passed at submit, as in
    tests/test_resilience.py) shed in FIFO order; a bounded queue rejects
    at submit. Both packages shed and reject the same rids."""
    reqs = [(rid, t, n, -1.0 if rid % 2 else None)
            for rid, t, n, _ in uniform_requests()]
    cb, res = twin(regs, CONTIG, reqs, acfg=dict(max_queue=5))
    assert [r.rid for r in res.rejected] == [5]
    assert sorted(r.rid for r in res.shed) == [1, 3]
    assert outs(res) == {k: clean[k] for k in (0, 2, 4)}


def test_overlong_prompt_truncation_matches_jax(regs):
    rng = np.random.default_rng(31)
    reqs = [(0, rng.integers(0, CFG.vocab_size, size=(80,), dtype=np.int32),
             3, None)]
    cb, res = twin(regs, CONTIG, reqs)
    assert cb.metrics()["prompt_truncations"] == 1


# ---------------------------------------------------------------------------
# the D-Rank artifact and the elastic ladder
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return save_artifact(tmp_path_factory.mktemp("drank") / "art")


def test_from_compressed_boots_a_batcher_by_default(artifact):
    cb = E.from_compressed(artifact, CFG, E.ServeConfig(**CONTIG),
                           verify=True, device="cpu")
    assert isinstance(cb, E.ContinuousBatcher) and cb.plan is not None
    eng = E.from_compressed(artifact, CFG, E.ServeConfig(**CONTIG),
                            batcher=False, device="cpu")
    assert isinstance(eng, E.Engine)
    cb2 = E.ContinuousBatcher.from_compressed(artifact, CFG,
                                              E.ServeConfig(**CONTIG),
                                              device="cpu")
    assert isinstance(cb2, E.ContinuousBatcher)


def test_elastic_rung0_token_identical_and_matches_jax(regs, artifact):
    """Ladder on, pressure never tripping: rung 0 is the params object
    itself and the tokens equal the engine without a ladder."""
    reqs = uniform_requests(n=8)
    acfg = dict(elastic=True, degrade_above=10**6)
    cb, res = twin(regs, CONTIG, reqs, dense=False, acfg=acfg,
                   artifact=artifact)
    assert cb.ladder[0] is cb.params and len(cb.ladder) == 3
    assert cb.metrics()["rank_residency"] == {"0": cb.metrics()["steps"]}
    _, res0 = run("port", None, CONTIG, reqs, artifact=artifact)
    assert outs(res) == outs(res0)


def test_elastic_levels_under_pressure_match_jax(regs, artifact):
    """Queue pressure steps the rung down and back up; the port walks the
    same sequence of levels as JAX (flight-recorded rung transitions and
    residency), with one decode signature per rung."""
    acfg = dict(elastic=True, elastic_levels=2, degrade_above=4,
                restore_below=1)
    cb, res = twin(regs, CONTIG, uniform_requests(n=16), dense=False,
                   acfg=acfg, artifact=artifact)
    assert res.status == "drained" and len(res) == 16
    rungs = [(e["frm"], e["to"]) for e in cb.flight.events
             if e["kind"] == "rung"]
    assert rungs and set(cb.metrics()["rank_residency"]) > {"0"}
    assert len(rungs) >= 2


def test_rank_ladder_matches_jax():
    _, jcomp, _, _ = weights()
    tcomp = bridge.from_numpy(jax.tree.map(np.asarray, jcomp), device="cpu")
    for r, lvl, mn in [(24, 0, 1), (24, 1, 1), (24, 2, 1), (16, 1, 1),
                       (1, 3, 1), (5, 1, 4)]:
        assert CC.rank_bucket(r, lvl, mn) == JC.rank_bucket(r, lvl, mn)
    jl = JC.slice_rank_ladder(jcomp, levels=2)
    tl = CC.slice_rank_ladder(tcomp, levels=2)
    assert tl[0] is tcomp and len(tl) == len(jl) == 3
    for jr, tr in zip(jl, tl):
        jleaves = jax.tree.leaves(jr)
        tleaves = list(_leaves(tr))
        assert [tuple(a.shape) for a in jleaves] == \
            [tuple(t.shape) for t in tleaves]
        for a, t in zip(jleaves, tleaves):
            np.testing.assert_array_equal(np.asarray(a), t.numpy())
            assert t.is_contiguous()          # the kernels' operand rule
    # a basis shared by two linears stays shared in every rung
    B = torch.randn(8, 6)
    tree = [{"B": B, "C": torch.randn(6, 3)}, {"B": B, "C": torch.randn(6, 5)}]
    for rung in CC.slice_rank_ladder(tree, levels=2):
        assert rung[0]["B"] is rung[1]["B"]
    assert CC.slice_rank_ladder(tree)[1][0]["B"].shape == (8, 4)
    tp = weights()[3]                    # dense params: the ladder collapses
    assert all(rung is tp for rung in CC.slice_rank_ladder(tp, levels=2))


def _leaves(tree):
    """Leaves in jax.tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# port-only behaviour
# ---------------------------------------------------------------------------
def test_watchdog_timeout_and_unported_exact_admission():
    tp = weights()[3]
    cb, res = run("port", tp, CONTIG, uniform_requests(),
                  plan=dict(wedge_from_step=1, wedge_s=0.0), watchdog_s=0.05)
    assert res.status == "stalled" and len(res.undrained) == 6
    cb, res = run("port", tp, CONTIG, uniform_requests(), max_steps=2)
    assert res.status == "timeout" and res.undrained
    # exact-length admission, once a stub, is ported (the recurrent
    # stacks' path, tests/test_torch_recurrent_serve.py); on an attention
    # stack it admits one row at its exact length into the given slot
    cb = E.ContinuousBatcher(tp, CFG, E.ServeConfig(**CONTIG), device="cpu")
    req = E.Request(rid=0, tokens=uniform_requests()[0][1], n_new=1)
    cb._admit_exact(req, 2)
    first = E.Engine(tp, CFG, E.ServeConfig(), device="cpu").generate(
        req.tokens[None], 1)[0, 0]
    assert cb.slots[2] is req and req.out == [first]
    assert cb.cache["pos"].tolist() == [-1, -1, len(req.tokens), -1]
    with pytest.raises(ValueError, match="prefix_cache requires"):
        E.ContinuousBatcher(tp, CFG, E.ServeConfig(batch=2, max_len=64,
                                                   prefix_cache=True),
                            device="cpu")
