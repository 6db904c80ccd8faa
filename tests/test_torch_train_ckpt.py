"""The port's ``Trainer`` and step checkpoints, and serving a trained
checkpoint: the trainer descends and its resume is bit-identical to a
continuous run on the CPU; a step checkpoint written by either package
restores in the other with the same keys, shapes and dtypes; the
asynchronous checkpointer keeps what was submitted; and
``serve(ckpt=..., device="cpu")`` boots a JAX-written checkpoint with the
JAX ``serve``'s greedy tokens."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import store as jstore
from repro.configs import get_config as jget_config
from repro.data.synthetic import DataConfig as JDataConfig
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro.serve import api as japi
from repro.train import loop as jloop
from repro.train import step as JTS
from repro_torch import bridge, pytree
from repro_torch.ckpt import store
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.serve import api
from repro_torch.train import step as TS
from repro_torch.train.loop import LoopConfig, Trainer
from test_torch_serve_api import SMALL, _small
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
CFG = get_config("llama-mini").replace(**SMALL)
JCFG = jget_config("llama-mini").replace(**SMALL)
OPT = dict(lr=5e-3, warmup_steps=2, total_steps=12)


def _dcfg(cls=DataConfig):
    return cls(vocab_size=SMALL["vocab_size"], seq_len=32, global_batch=4,
               seed=3)


def _trainer(ckpt_dir, total, every=100, **kw):
    return Trainer(CFG, TS.TrainConfig(optimizer=OptimizerConfig(**OPT)),
                   _dcfg(), LoopConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                       ckpt_every=every, log_every=1, **kw),
                   seed=0, device="cpu")


def test_trainer_descends_and_resumes_bit_identically(tmp_path):
    full = _trainer(str(tmp_path / "full"), 10, every=5)
    out = full.run()
    assert out["final_step"] == 10 and not out["interrupted"]
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert store.latest_step(str(tmp_path / "full")) == 10
    assert sorted(os.listdir(tmp_path / "full")) == [
        "LATEST", "step_000000005", "step_000000010"]

    first = _trainer(str(tmp_path / "part"), 5)
    first.run()
    resumed = _trainer(str(tmp_path / "part"), 10)
    assert resumed.start_step == 5
    res = resumed.run()
    assert [h["step"] for h in res["history"]] == list(range(6, 11))
    assert [h["loss"] for h in res["history"]] == losses[5:]
    for a, b in zip(pytree.leaves(resumed.state), pytree.leaves(full.state)):
        assert torch.equal(a, b)
    with open(tmp_path / "part" / "step_000000010" / "manifest.json") as f:
        assert json.load(f)["meta"] == {"final": True, "interrupted": False}


def test_heartbeat_and_a_bridged_state(tmp_path):
    """``Trainer.state`` replaced before ``run()`` by a bridged JAX state
    (the JAX tests' idiom) trains from it; the heartbeat records the last
    step. (The JAX Trainer ends a heartbeat run with an AttributeError:
    its loop calls ``Heartbeat.close``, which does not exist.)"""
    jstate, _ = JTS.init_train_state(JCFG, jax.random.PRNGKey(0))
    tr = _trainer("", 2, heartbeat_path=str(tmp_path / "hb.json"))
    tr.state = bridge.from_numpy(jax.tree.map(np.asarray, jstate),
                                 device=CPU)
    out = tr.run()
    assert out["final_step"] == 2
    with open(tmp_path / "hb.json") as f:
        assert json.load(f)["step"] == 2
    jtr = jloop.Trainer(JCFG, JTS.TrainConfig(
        optimizer=JOptimizerConfig(**OPT)), _dcfg(JDataConfig),
        jloop.LoopConfig(total_steps=1, log_every=1,
                         heartbeat_path=str(tmp_path / "jhb.json")))
    with pytest.raises(AttributeError, match="close"):
        jtr.run()


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return m["keys"], m["shapes"], m["dtypes"]


def test_step_checkpoints_cross_both_ways(tmp_path):
    jstate, _ = JTS.init_train_state(JCFG, jax.random.PRNGKey(0))
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda x: x + 0.5, jstate.opt.mu)))
    jpath = jstore.save(str(tmp_path / "jax"), 7, jstate)
    template, _ = TS.init_train_state(CFG, seed=1, device="meta")
    step, state = store.restore(str(tmp_path / "jax"), template, device=CPU)
    assert step == 7 and isinstance(state, TS.TrainState)
    want = bridge.from_numpy(jax.tree.map(np.asarray, jstate), device=CPU)
    for a, b in zip(pytree.leaves(state), pytree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a part of the state restores alone (serve's ckpt= takes the params)
    _, part = store.restore(str(tmp_path / "jax"),
                            {"params": template.params}, device=CPU)
    for a, b in zip(pytree.leaves(part), pytree.leaves(want.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    tpath = store.save(str(tmp_path / "torch"), 7, state)
    assert _manifest(tpath) == _manifest(jpath)
    assert "params␟decoder␟run0␟attn␟wq␟w" in _manifest(tpath)[0]
    assert "opt␟step" in _manifest(tpath)[0]
    jstep, back = jstore.restore(str(tmp_path / "torch"), jstate)
    assert jstep == 7
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": (torch.linspace(-2, 2, 4)).to(torch.bfloat16)}}
    store.save(str(tmp_path), 3, tree)
    jtree = {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4, jnp.bfloat16)}}
    _, back = jstore.restore(str(tmp_path), jtree)
    assert back["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["b"]["c"], np.float32), tree["b"]["c"].float())
    jstore.save(str(tmp_path), 4, back)
    step, got = store.restore(str(tmp_path), tree)
    assert step == 4 and got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    # keep_last pruning, as the JAX store prunes
    for s in (11, 12, 13):
        store.save(str(tmp_path), s, tree, keep_last=2)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == ["step_000000012",
                                                "step_000000013"]


def test_restore_refuses_what_it_cannot_do(tmp_path):
    tree = {"x": torch.ones(3)}
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path), tree)
    store.save(str(tmp_path), 1, tree)
    # a None sharding is the whole leaf (the blocks of a mesh:
    # tests/test_torch_dist.py); shardings must match the template's leaves
    _, got = store.restore(str(tmp_path), tree, shardings={"x": None})
    assert torch.equal(got["x"], tree["x"])
    with pytest.raises(ValueError, match="shardings"):
        store.restore(str(tmp_path), tree, shardings={"x": None, "y": None})
    with pytest.raises(ValueError, match="meta"):
        store.restore(str(tmp_path), {"x": torch.ones(3, device="meta")})
    with pytest.raises(KeyError, match="y"):
        store.restore(str(tmp_path), {"y": torch.ones(3)})


def test_async_checkpointer_keeps_the_submitted_values(tmp_path):
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    step = torch.zeros((), dtype=torch.int32)
    ck = store.AsyncCheckpointer(str(tmp_path), keep_last=2)
    ck.submit(1, {"x": t, "s": step})
    t.add_(100.0)                # in place, as an optimizer may update
    step.add_(1)
    ck.close()
    assert store.latest_step(str(tmp_path)) == 1
    _, back = store.restore(str(tmp_path), {"x": t, "s": step})
    assert torch.equal(back["x"], torch.arange(64.0).reshape(8, 8))
    assert int(back["s"]) == 0


def test_serve_boots_a_jax_checkpoint_with_jaxs_tokens(tmp_path,
                                                       monkeypatch):
    _small(monkeypatch)
    jstate, _ = JTS.init_train_state(JCFG, jax.random.PRNGKey(3))
    jstore.save(str(tmp_path), 5, jstate)
    kw = dict(arch="llama-mini", ckpt=str(tmp_path), batch=2, max_len=32,
              requests=3, prompt_len=7, n_new=4)
    want = japi.serve(japi.ServeOptions(**kw))
    lines = []
    got = api.serve(api.ServeOptions(**kw), device="cpu", echo=lines.append)
    assert {r.rid: list(r.out) for r in got} == \
        {r.rid: list(r.out) for r in want}
    assert any(f"@ step 5" in ln for ln in lines)
