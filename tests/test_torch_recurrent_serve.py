"""The port's ``ContinuousBatcher`` on the recurrent families against the
JAX package's, on the CPU (the twin of
``tests/test_decode_fast_path.py::test_batcher_exact_path_for_stateful_archs``
for hymba-1.5b and xlstm-350m, reduced, float32).

Recurrent state cannot be right-padded, so both batchers admit each request
through a single-row prefill at its prompt's exact length and scatter every
cache leaf into its slot. A twin run compares the tokens, statuses, metrics
and stats (one prefill signature per distinct prompt length, one decode
signature); the port's ``AotRegistry`` serves the same tokens with one
prefill entry per distinct length; under a NaN fault plan on one row (and
on every live row, bisected through one exact-length probe prefill per
suspect) the quarantined slot's every state leaf reads zero right after
its purge, and every request, the re-admitted ones included, gets the
clean run's tokens.
Slots are recycled (more requests than slots, of which some share a slot
after a dead row kept decoding): each request's tokens equal an
``Engine.generate`` of its prompt alone."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.dist import faultinject as JFI
from repro.models import transformer as JT
from repro.serve import aot as jaot
from repro.serve import engine as JE
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.dist import faultinject as FI
from repro_torch.serve import aot as taot
from repro_torch.serve import engine as E
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ARCHS = ("hymba-1.5b", "xlstm-350m")
SCFG = dict(batch=2, max_len=32)
LENS = (4, 5, 6, 5)               # 3 distinct lengths over 4 requests
N_NEW = 4
# one row; every live row at once (bisected through the exact-length
# poison probe, one single-row prefill per suspect)
FAULTS = {"one_row": dict(nan_decode_step=2, nan_rows=(1,)),
          "all_rows": dict(nan_decode_step=2, nan_rows="all")}


class Shared:
    """A registry shared by every batcher of one package and config: each
    JAX executable compiles once per module; each batcher's stats get the
    retrace counts its own calls add."""

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


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(JAX cfg, port cfg, JAX params, port params, JAX registry, port
    registry, requests)."""
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    jp, _ = JT.init_model(jc, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(0, tc.vocab_size, size=(n,), dtype=np.int32))
            for i, n in enumerate(LENS)]
    return (jc, tc, jp, tp,
            Shared(jaot.TracedRegistry(jc, JE.ServeConfig(**SCFG))),
            Shared(taot.TracedRegistry(tc, E.ServeConfig(**SCFG))), reqs)


def run(side, arch, *, plan=None, registry=None):
    jc, tc, jp, tp, jreg, treg, reqs = setup(arch)
    if side == "jax":
        cb = JE.ContinuousBatcher(
            jp, jc, JE.ServeConfig(**SCFG), executables=jreg,
            faults=JFI.FaultPlan(**plan) if plan else None)
        Emod = JE
    else:
        cb = E.ContinuousBatcher(
            tp, tc, E.ServeConfig(**SCFG), device="cpu",
            executables=registry if registry is not None else treg,
            faults=FI.FaultPlan(**plan) if plan else None)
        Emod = E
    assert not cb.bucketed
    for rid, toks in reqs:
        cb.submit(Emod.Request(rid=rid, tokens=np.array(toks), n_new=N_NEW))
    return cb, cb.run_until_drained()


def summary(cb, res, stats=True):
    m = cb.metrics()
    s = {"tokens": {r.rid: list(r.out) for r in res},
         "status": res.status,
         "failed": [(r.rid, r.status) for r in res.failed],
         "counters": m["counters"],
         "hist_n": {k: h["n"] for k, h in m["histograms"].items()},
         "fired": list(cb.faults.fired) if cb.faults is not None else None}
    if stats:
        s["stats"] = dict(cb.stats)
    return s


@functools.lru_cache(maxsize=None)
def clean(arch):
    """The fault-free twin runs: (port summary, JAX summary)."""
    jcb, jres = run("jax", arch)
    cb, res = run("port", arch)
    return summary(cb, res), summary(jcb, jres)


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_admission_matches_jax(arch):
    got, want = clean(arch)
    assert got == want
    assert got["status"] == "drained" and len(got["tokens"]) == len(LENS)
    st = got["stats"]
    assert st["prefill_retraces"] == len(set(LENS))
    assert st["decode_retraces"] == 1 and st["scatter_retraces"] == 1
    assert st["admitted"] == len(LENS)
    # a recycled slot starts from its own prefill's state: each request's
    # tokens are those of its prompt served alone
    _, tc, _, tp, _, _, reqs = setup(arch)
    eng = E.Engine(tp, tc, E.ServeConfig(), device="cpu")
    for rid, toks in reqs:
        assert got["tokens"][rid] == eng.generate(toks[None], N_NEW)[0]\
            .tolist(), rid


@pytest.mark.parametrize("arch", ARCHS)
def test_aot_registry_serves_the_same_tokens(arch):
    _, tc, _, tp, _, _, _ = setup(arch)
    reg = taot.AotRegistry(tc, E.ServeConfig(**SCFG),
                           taot.live_fingerprint(tp, tc))
    cb = E.ContinuousBatcher(tp, tc, E.ServeConfig(**SCFG), device="cpu",
                             executables=reg)
    cb.warm_executables()
    # JAX's warm set on an exact-length stack: decode per rung, purge
    assert reg.entries() == [("decode", (0,)), ("purge", ())]
    for rid, toks in setup(arch)[-1]:
        cb.submit(E.Request(rid=rid, tokens=np.array(toks), n_new=N_NEW))
    res = cb.run_until_drained()
    assert {r.rid: list(r.out) for r in res} == clean(arch)[0]["tokens"]
    roles = [role for role, _ in reg.entries()]
    assert roles.count("prefill") == len(set(LENS))
    assert roles.count("decode") == 1
    assert sorted(v for role, v in reg.entries() if role == "prefill") == \
        sorted((0, ("exact", 1, n)) for n in set(LENS))
    assert cb.stats["aot_fallbacks"] == 0


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_fault_plan_purges_state_and_matches_jax(arch, fault, monkeypatch):
    purged = []
    inner = taot.purge_rows

    def spy(pool, rows):
        out = inner(pool, rows)
        for r in np.asarray(rows):
            if r < pool["pos"].shape[0]:
                leaves = pytree.tensors(pool["runs"])
                purged.append((int(r), max(float(t[:, r].abs().max())
                                           for t in leaves),
                               int(pool["pos"][r])))
        return out
    monkeypatch.setattr(taot, "purge_rows", spy)
    jcb, jres = run("jax", arch, plan=FAULTS[fault])
    cb, res = run("port", arch, plan=FAULTS[fault])
    got, want = summary(cb, res, stats=False), summary(jcb, jres,
                                                       stats=False)
    assert got == want
    assert cb.faults.fired and res.status == "drained"
    assert purged and all(m == 0.0 and pos == -1 for _, m, pos in purged), \
        purged
    # the quarantined request is re-admitted and every request gets the
    # clean run's tokens
    assert got["tokens"] == clean(arch)[0]["tokens"]
    assert cb.metrics()["counters"].get("slot_purges", 0) >= 1
    if fault == "all_rows":
        assert cb.metrics()["counters"].get("poison_probes", 0) >= 1
