"""The port's training math against the JAX package's on the same bridged
weights and batches: ``lm_loss`` and its grads (stacked and D-Rank
list-form params), remat, AdamW under each schedule, the microbatched
``train_step``, PowerSGD, and ``launch.train``'s flags.

Tiers: loss 1e-5 and grads 1e-4 relative per leaf; AdamW 1e-6; five train
steps 1e-5 (losses and params); PowerSGD's reconstruction and error
feedback 1e-5, its rank allocation identical. Relative error is
max|a − b| / max|b| over a leaf."""
import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import ShardedLoader as JLoader
from repro.launch import train as jlaunch
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import powersgd as JPS
from repro.train import step as JTS
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.optim import powersgd as PS
from repro_torch.train import step as TS
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
# the JAX tests' training config (tests/test_train_serve_ckpt.py:22-24)
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256)
CFG = get_config("llama-mini").replace(**SMALL)
JCFG = jget_config("llama-mini").replace(**SMALL)


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def assert_trees_close(got, want, tol, what):
    """``got`` (the port's tree) leaf by leaf against ``want`` (JAX's), in
    the shared flattening order, with the same paths."""
    g = pytree.flatten_with_path(got)
    w, _ = jax.tree_util.tree_flatten_with_path(want)
    assert [pytree.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w], what
    for (p, a), (_, b) in zip(g, w):
        err = rel(a.detach().numpy(), np.asarray(b))
        assert err <= tol, (what, pytree.keystr(p), err)


@functools.lru_cache(maxsize=None)
def _params(form):
    """(JAX params, bridged params): stacked, or D-Rank 30% list form."""
    jp, _ = JT.init_model(JCFG, jax.random.PRNGKey(0))
    if form == "drank":
        rng = np.random.default_rng(1)
        calib = [{"tokens": jnp.asarray(rng.integers(
            0, JCFG.vocab_size, (2, 16), dtype=np.int32))}]
        jp, _ = JC.build_plan_and_params(
            jp, JCFG, JC.CompressionConfig(method="drank", ratio=0.3),
            calib, streaming=False)
    return jp, bridge.from_numpy(np_tree(jp), device=CPU)


def _batch(kind):
    """Tokens (2, 16), and for "labels" explicit labels with masked (-1)
    entries and a float loss_mask."""
    rng = np.random.default_rng(3)
    b = {"tokens": rng.integers(0, SMALL["vocab_size"], (2, 16),
                                dtype=np.int32)}
    if kind == "labels":
        lab = rng.integers(0, SMALL["vocab_size"], (2, 16), dtype=np.int32)
        lab[:, :3] = -1
        b["labels"] = lab
        b["loss_mask"] = (rng.random((2, 16)) > 0.25).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(form, kind):
    jp, _ = _params(form)
    fn = jax.jit(jax.value_and_grad(
        functools.partial(JT.lm_loss, cfg=JCFG), has_aux=True))
    batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
    (loss, metrics), grads = fn(jp, batch=batch)
    return float(loss), np_tree(metrics), grads


@pytest.mark.parametrize("kind", ["shift", "labels"])
@pytest.mark.parametrize("form", ["stacked", "drank"])
def test_lm_loss_and_grads_match_jax(form, kind):
    _, tp = _params(form)
    jloss, jmetrics, jgrads = _jax_value_and_grad(form, kind)
    batch = {k: torch.as_tensor(v) for k, v in _batch(kind).items()}
    loss, metrics, grads = TS.value_and_grad(tp, CFG, batch)
    assert rel(float(loss), jloss) <= 1e-5
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        assert rel(float(metrics[k]), jmetrics[k]) <= 1e-5, k
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    assert_trees_close(grads, jgrads, 1e-4, f"{form} grads")


def test_remat_changes_no_bit_on_the_cpu():
    _, tp = _params("stacked")
    batch = {k: torch.as_tensor(v) for k, v in _batch("labels").items()}
    runs = {m: TS.value_and_grad(tp, CFG.replace(remat=m), batch)
            for m in ("none", "block", "dots")}
    loss0, _, g0 = runs["none"]
    for m in ("block", "dots"):
        loss, _, g = runs[m]
        assert torch.equal(loss, loss0), m
        for a, b in zip(pytree.leaves(g), pytree.leaves(g0)):
            assert torch.equal(a, b), m


def test_remat_recomputes_only_stacked_training_runs(monkeypatch):
    """Each layer of a stacked run goes through ``checkpoint`` under grad;
    list-form runs, unrolled runs and no-grad forwards never do."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(T.ckpt, "checkpoint", counting)
    batch = {"tokens": torch.as_tensor(_batch("shift")["tokens"])}
    _, tp = _params("stacked")
    _, tl = _params("drank")
    TS.value_and_grad(tp, CFG, batch)
    assert len(calls) == SMALL["n_layers"]
    TS.value_and_grad(tl, CFG, batch)
    TS.value_and_grad(tp, CFG.replace(scan_layers=False), batch)
    TS.eval_step(tp, CFG, batch)
    assert len(calls) == SMALL["n_layers"]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_matches_jax_for_five_steps(schedule):
    """Warmup 2 of 4 total steps, so five steps cross warmup, decay and
    the end of the schedule; leaves of 1, 2 and 3 dims (decay on ndim ≥ 2,
    stacked norm scales included); one step's grads large enough to
    clip."""
    rng = np.random.default_rng(5)
    shapes = {"w": (8, 6), "scale": (2, 6), "b": (6,), "stack": (2, 4, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=4, schedule=schedule,
                weight_decay=0.1, clip_norm=1.0)
    jcfg, tcfg = JA.OptimizerConfig(**ocfg), A.OptimizerConfig(**ocfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    jst, tst = JA.adamw_init(jp), A.adamw_init(tp)
    jupd = jax.jit(functools.partial(JA.adamw_update, jcfg))
    for s in range(5):
        g = {k: (rng.normal(size=v.shape) * (3.0 if s == 2 else 0.1)
                 ).astype(np.float32) for k, v in params.items()}
        jp, jst, jstats = jupd({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp)
        tp, tst, tstats = A.adamw_update(
            tcfg, {k: torch.as_tensor(v) for k, v in g.items()}, tst, tp)
        for k in ("grad_norm", "lr"):
            assert rel(float(tstats[k]), float(jstats[k])) <= 1e-6, (s, k)
        assert int(tst.step) == int(jst.step) == s + 1
        assert tst.step.dtype == torch.int32
        for name, a, b in (("params", tp, jp), ("mu", tst.mu, jst.mu),
                           ("nu", tst.nu, jst.nu)):
            assert_trees_close(a, b, 1e-6, f"{schedule} step {s} {name}")


def test_schedule_takes_the_step_before_the_increment():
    cfg = A.OptimizerConfig(lr=1.0, warmup_steps=4, schedule="constant")
    sched = A.make_schedule(cfg)
    assert [float(sched(torch.tensor(s, dtype=torch.int32)))
            for s in range(5)] == [0.25, 0.5, 0.75, 1.0, 1.0]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_for_five_steps(microbatches):
    # lr 1e-4: Adam's first steps move an entry by ~lr whatever the size of
    # its grad, so an entry whose grad is near eps (1e-8) carries the two
    # packages' last-bit differences in reduction order into the params at
    # ~lr·1e-3; at lr 1e-3 that reached 1.1e-5 of a leaf's largest entry
    tcfg = dict(microbatches=microbatches)
    ocfg = dict(lr=1e-4, warmup_steps=2, total_steps=5)
    jstate, _ = JTS.init_train_state(JCFG, jax.random.PRNGKey(0))
    state = bridge.from_numpy(np_tree(jstate), device=CPU)
    assert isinstance(state, TS.TrainState)
    assert state.opt.step.dtype == torch.int32 and state.opt.step.ndim == 0
    jstep = jax.jit(JTS.make_train_step(JCFG, JTS.TrainConfig(
        optimizer=JA.OptimizerConfig(**ocfg), **tcfg)))
    step = TS.make_train_step(CFG, TS.TrainConfig(
        optimizer=A.OptimizerConfig(**ocfg), **tcfg))
    loader = JLoader(JDataConfig(vocab_size=SMALL["vocab_size"], seq_len=32,
                                 global_batch=4, seed=3))
    for s in range(5):
        b = loader.batch(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        assert sorted(m) == sorted(jm)
        assert all(v.device == CPU and v.ndim == 0 for v in m.values())
        assert rel(float(m["loss"]), float(jm["loss"])) <= 1e-5, s
        assert float(m["tokens"]) == float(jm["tokens"])
    assert_trees_close(state.params, jstate.params, 1e-5, "params")
    assert int(state.opt.step) == 5


def test_microbatch_slices_rows_and_mrope_positions():
    b = {"tokens": np.arange(24).reshape(4, 6),
         "positions": np.arange(72).reshape(3, 4, 6),
         "scalar": np.float32(2.0)}
    mb = TS._microbatch(b, 2, 1)
    jmb = JTS._microbatch({k: jnp.asarray(v) for k, v in b.items()}, 2, 1)
    for k in b:
        np.testing.assert_array_equal(np.asarray(mb[k]), np.asarray(jmb[k]))


def test_evaluate_ppl_matches_jax():
    jp, tp = _params("drank")
    rng = np.random.default_rng(8)
    batches = [{"tokens": rng.integers(0, SMALL["vocab_size"], (2, 16),
                                       dtype=np.int32)} for _ in range(2)]
    want = JTS.evaluate_ppl(jp, JCFG, [{k: jnp.asarray(v) for k, v in
                                        b.items()} for b in batches])
    got = TS.evaluate_ppl(tp, CFG, [{k: torch.as_tensor(v) for k, v in
                                     b.items()} for b in batches])
    for k in want:
        assert rel(got[k], want[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# PowerSGD
# ---------------------------------------------------------------------------
def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(96, 80)).astype(np.float32),
            "stack": rng.normal(size=(2, 72, 64)).astype(np.float32),
            "b": rng.normal(size=(80,)).astype(np.float32),
            "small": rng.normal(size=(8, 8)).astype(np.float32)}


@pytest.mark.parametrize("ef", [True, False])
def test_powersgd_reconstruction_matches_jax(ef):
    cfg = dict(rank=4, min_dim=16, ef=ef)
    jcfg, tcfg = JPS.PowerSGDConfig(**cfg), PS.PowerSGDConfig(**cfg)
    g0 = _grad_tree(0)
    jst = JPS.init_state({k: jnp.asarray(v) for k, v in g0.items()}, jcfg)
    tst = bridge.from_numpy(np_tree(jst), device=CPU)   # JAX's Q
    assert isinstance(tst, PS.PowerSGDState)
    assert sorted(tst.q) == ["['stack']", "['w']"]
    for r in range(3):
        g = _grad_tree(r)
        jout, jst, jstats = JPS.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, jst, jcfg)
        tout, tst, tstats = PS.compress_decompress(
            {k: torch.as_tensor(v) for k, v in g.items()}, tst, tcfg,
            reduce_fn=PS.cross_pod_mean(None))
        assert tstats == jstats
        assert_trees_close(tout, jout, 1e-5, f"round {r} Mhat")
        if ef:
            assert_trees_close(tst.error, jst.error, 1e-5,
                               f"round {r} error")


def test_powersgd_rank_allocation_matches_jax():
    rng = np.random.default_rng(2)
    g = {"low": (rng.normal(size=(64, 4)) @ rng.normal(size=(4, 64))
                 ).astype(np.float32),
         "high": rng.normal(size=(64, 64)).astype(np.float32),
         "mid": (rng.normal(size=(2, 48, 16)) @ rng.normal(size=(16, 80))
                 ).astype(np.float32)}
    cfg = dict(rank=4, min_dim=8)
    want = JPS.allocate_ranks_by_reff(
        {k: jnp.asarray(v) for k, v in g.items()}, 0.2,
        JPS.PowerSGDConfig(**cfg))
    got = PS.allocate_ranks_by_reff(
        {k: torch.as_tensor(v) for k, v in g.items()}, 0.2,
        PS.PowerSGDConfig(**cfg))
    assert got == want and got["['high']"] > got["['low']"]
    st = PS.init_state({k: torch.as_tensor(v) for k, v in g.items()},
                       PS.PowerSGDConfig(**cfg), ranks=got)
    assert {k: q.shape[1] for k, q in st.q.items()} == got


def test_cross_pod_mean_over_a_group_is_not_ported():
    """The identity without a mesh or without a pod axis; over a mesh's pod
    axis it needs the process group (the mean itself:
    tests/test_torch_dist.py)."""
    from repro_torch.launch.mesh import make_production_mesh
    x = torch.ones(3)
    assert PS.cross_pod_mean(None)(x) is x
    assert PS.cross_pod_mean(make_production_mesh())(x) is x
    with pytest.raises(RuntimeError, match="shapes-only"):
        PS.cross_pod_mean(make_production_mesh(multi_pod=True))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _actions(parser):
    return sorted((a.option_strings, a.dest, a.default, a.type,
                   a.required, type(a).__name__, a.help)
                  for a in parser._actions if a.dest != "help")


def test_train_cli_has_jaxs_flags(monkeypatch):
    seen = []

    def capture(self, argv=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jlaunch.main([])
    monkeypatch.undo()
    assert _actions(tlaunch.build_parser()) == _actions(seen[0])


def test_train_cli_runs_on_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "llama-mini", "--reduced", "--steps", "1"])


def test_a_train_step_leaves_no_tensor_to_the_cyclic_collector():
    """Every tensor a step drops is freed by its reference count, as the
    launch accounting's live bytes assume: nothing of the step's trees
    waits for Python's cyclic collector. The tree walkers once were
    closures that called themselves, and a train step's trees of grads and
    moments stayed alive until a collection: SmolLM-360M's train step then
    peaked on the H100 about 4 GiB above the counter's prediction
    (PERF.md §6)."""
    import gc
    state, _ = TS.init_train_state(CFG, seed=0, device="cpu")
    step = TS.make_train_step(CFG, TS.TrainConfig(microbatches=2))
    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32)}
    # the first checkpointed step of a process imports torch._dynamo, whose
    # import leaves a cycle through the frames then on the stack: once
    step(state, batch)
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        new, _ = step(state, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if was:
            gc.enable()
    assert held == []
