"""The port's front door (``repro_torch.serve.frontdoor``), twin of
``tests/test_frontdoor.py``: per-token streaming carries exactly the
drained output, which is the JAX batcher's on the same bridged weights;
intake backpressure rejects before the engine is involved; admission
rejects surface as terminal streams; the router places requests by replica
load and spills on pushback; ``merge_drain_results`` takes the worst
status. On the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serve import admission as adm
from repro_torch.serve import aot as taot
from repro_torch.serve.engine import (ContinuousBatcher, DrainResult,
                                      Request, ServeConfig)
from repro_torch.serve.frontdoor import FrontDoor, Router, merge_drain_results
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
          d_ff=128, vocab_size=256)
JCFG = jget_config("llama-mini").replace(**KW)
CFG = get_config("llama-mini").replace(**KW)
SCFG = ServeConfig(batch=2, max_len=32)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's bridged from them)."""
    jp, _ = JT.init_model(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _batcher(params, **kw):
    return ContinuousBatcher(params[1], CFG, SCFG, device="cpu", **kw)


def _prompts(n, seed=0, length=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=(length,), dtype=np.int32)
            for _ in range(n)]


def _drained(cb, prompts, n_new):
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=i, tokens=p.copy(), n_new=n_new))
    res = cb.run_until_drained()
    assert res.status == "drained"
    return {r.rid: list(r.out) for r in res}


def _oracle(params, prompts, n_new=5):
    """The port's drained tokens, which must be the JAX batcher's."""
    port = _drained(_batcher(params), prompts, n_new)
    jcb = JE.ContinuousBatcher(params[0], JCFG,
                               JE.ServeConfig(batch=2, max_len=32))
    for i, p in enumerate(prompts):
        jcb.submit(JE.Request(rid=i, tokens=p.copy(), n_new=n_new))
    jres = jcb.run_until_drained()
    assert {r.rid: list(r.out) for r in jres} == port
    return port


@pytest.mark.parametrize("registry", ["traced", "aot"])
def test_streamed_tokens_equal_drained_tokens_and_jax(params, registry):
    prompts = _prompts(6)
    oracle = _oracle(params, prompts)
    reg = (taot.AotRegistry(CFG, SCFG, "test") if registry == "aot"
           else None)
    cb = _batcher(params, executables=reg)
    cb.warm_executables()
    fd = FrontDoor(cb).start()
    streams = [fd.submit(p, 5, rid=i) for i, p in enumerate(prompts)]
    assert all(s is not None for s in streams)
    # iterate BEFORE drain: tokens must arrive as they are emitted
    collected = [[t for t in s] for s in streams]
    res = fd.drain(timeout=120)
    fd.close()
    assert res.status == "drained" and len(res) == len(prompts)
    for i, s in enumerate(streams):
        assert s.status == adm.DONE
        assert collected[i] == oracle[i]       # the live stream
        assert s.tokens() == oracle[i]         # the terminal snapshot
        assert s.result(1).rid == i
        assert s.rewinds == 0
    if reg is not None:                        # warmed: no entry made later
        assert cb.stats["aot_compiles"] == len(reg.entries())
        assert cb.stats["aot_fallbacks"] == 0


def test_intake_backpressure_rejects_before_the_engine(params):
    fd = FrontDoor(_batcher(params), intake_bound=2)
    # engine thread NOT started: the bound is the only admission control
    assert fd.submit(_prompts(1)[0], 2, rid=0) is not None
    assert fd.submit(_prompts(1)[0], 2, rid=1) is not None
    assert fd.submit(_prompts(1)[0], 2, rid=2) is None    # full intake
    assert fd.load() == 2


def test_admission_rejects_surface_as_terminal_streams(params):
    acfg = adm.AdmissionConfig(max_queue=1)
    fd = FrontDoor(_batcher(params, admission=acfg), intake_bound=16)
    prompts = _prompts(6, seed=3)
    streams = [fd.submit(p, 3, rid=i) for i, p in enumerate(prompts)]
    assert all(s is not None for s in streams)  # intake took everything
    fd.start()
    res = fd.drain(timeout=120)
    fd.close()
    # every stream reached a terminal state, sheds included, so a client
    # blocked on result() is never left hanging
    for s in streams:
        assert s.result(1).status in (adm.DONE, adm.SHED_QUEUE_FULL)
    shed = [s for s in streams if s.status == adm.SHED_QUEUE_FULL]
    assert shed and len(shed) == len(res.rejected)
    assert len(res) + len(shed) == len(prompts)


def test_router_balances_by_load_and_spills_on_pushback(params):
    doors = [FrontDoor(_batcher(params), intake_bound=4) for _ in range(2)]
    router = Router(doors)
    prompts = _prompts(8, seed=1)
    streams = [router.submit(p, 2) for p in prompts]
    assert all(s is not None for s in streams)
    # engines not started yet: load == intake depth, so placement is the
    # deterministic least-loaded alternation 4/4
    assert [d.load() for d in doors] == [4, 4]
    # both intakes full -> every replica pushes back -> None
    assert router.submit(prompts[0], 2) is None
    router.start()
    res = router.drain_all(timeout=120)
    router.close()
    assert res.status == "drained" and len(res) == len(prompts)
    oracle = _oracle(params, prompts, n_new=2)
    got = sorted([s.tokens() for s in streams])
    assert got == sorted(oracle.values())
    assert len(router.metrics()) == 2
    assert all("intake_depth" in m for m in router.metrics())


def test_merge_drain_results_takes_worst_status():
    a = type("R", (), {})  # stand-in rows are fine; merge only concatenates
    r1 = DrainResult([a], "drained", [], [], [], [])
    r2 = DrainResult([a, a], "timeout", [a], [], [], [])
    r3 = DrainResult([], "stalled", [a], [a], [], [a])
    m = merge_drain_results([r1, r2])
    assert m.status == "timeout"
    assert len(m) == 3 and len(m.undrained) == 1
    m = merge_drain_results([r1, r3, r2])
    assert m.status == "stalled"
    assert len(m.undrained) == 2 and len(m.shed) == len(m.failed) == 1
    assert merge_drain_results([]).status == "drained"


def test_router_needs_a_door():
    with pytest.raises(ValueError, match="at least one FrontDoor"):
        Router([])
