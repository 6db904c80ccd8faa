"""Prefill and decode with sharded parameters and a sequence-split KV cache
in the port, over a gloo process group of four ranks (data 2, model 2) on
the CPU, against the JAX package's mesh run and the port's one process.

Each case runs a prefill of 4 prompts and ``STEPS`` greedy decode steps in
float32 on bridged weights. JAX's side (one subprocess of four host
devices, ``--xla_force_host_platform_device_count=4``, started beside the
ranks) jits ``T.prefill`` and ``T.decode_step`` with the shardings that
``repro/launch/dryrun.py``'s ``lower_cell`` builds on a (2, 2)
``make_host_mesh``: the parameters' ``shardings_for_tree``, the batch's
``batch_shardings`` and the cache's ``CACHE_AXES``, and really executes
them. The port's ranks (``tests/torch_mesh_ranks.py``, job "serve") hold
their blocks of the parameters, of the batch and of the cache
(``dist.sharding.shard_tree``, ``shard_batch``, ``batch_rows``; the cache
as the step returns it) and run ``prefill`` and ``decode_step`` under a
``dist.sharding.Placement``.

Cases: llama-mini at ``tests/test_torch_dryrun.py``'s widths (heads 4 / 2
split over ``model``), granite ``.reduced()`` (expert parallelism),
gemma3-12b ``.reduced()`` (windowed layers: a ring of 8 rows, split 4 and
4, wrapped by the last steps), a uniform factorized llama-mini (ratio
0.2, ranks 24 of widths 64), llama-mini at ``max_len`` 15, which
``model`` does not divide (the cache stays whole on every rank),
qwen2-vl-72b ``.reduced()`` (M-RoPE, a vision-stub prefill with (3, B, S)
positions) and llama-mini on right-padded prompts (``lengths``: each
row's last live position on one model rank's half of the sequence, which
sends it to the others). Bars: every step's greedy tokens identical to JAX's mesh run
and to one process; logits within 2e-3 (``tests/test_kernels.py:141``) of
both; each rank's final cache block within the same bar of its block of
one process's cache (``shard_cache``), of the rules' shape; the model
ranks of a data shard bit-identical in their logits (the prefill's last
rows are summed over ``model`` from the rank that holds each, exact
zeros from the others).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

import torch_mesh_ranks as R
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
LLAMA = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256, dtype="float32",
             param_dtype="float32")           # tests/test_torch_dryrun.py:70
GRANITE = "granite-moe-1b-a400m"
STEPS = 6
B, S = 4, 6                  # 2 rows a data shard, 3 positions a model rank
ATOL = 2e-3                                  # tests/test_kernels.py:141
# name -> (arch, overrides or None for .reduced(), max_len, factor ratio)
CASES = {"llama": ("llama-mini", LLAMA, 16, 0.0),
         "granite": (GRANITE, None, 16, 0.0),
         "gemma": ("gemma3-12b", None, 16, 0.0),
         "factorized": ("llama-mini", LLAMA, 16, 0.2),
         "replicated": ("llama-mini", LLAMA, 15, 0.0),
         "mrope": ("qwen2-vl-72b", None, 16, 0.0),
         "uneven": ("llama-mini", LLAMA, 16, 0.0)}
# the uneven case's live prompt lengths: the last live positions 5, 1, 4,
# 2 fall on both model ranks' halves (3 positions each)
UNEVEN = (6, 2, 5, 3)


def _cfg(arch, over):
    return (get_config(arch).replace(**over) if over
            else get_config(arch).reduced())


def _factorized(params, specs, ratio, rng):
    """The factorized form of ``DR.factorized_shapes`` at ``ratio`` (rank a
    multiple of 8), every new B and C drawn from ``rng``; the other leaves
    the dense model's."""
    meta = pytree.tree_map(lambda t: t.to("meta"), params)
    shapes, fspecs = DR.factorized_shapes(meta, specs, ratio, multiple=8)
    dense = dict((pytree.keystr(p), t)
                 for p, t in pytree.flatten_with_path(params))
    flat = pytree.flatten_with_path(shapes)
    leaves = []
    for p, t in flat:
        have = dense.get(pytree.keystr(p))
        if have is not None and have.shape == t.shape:
            leaves.append(have)
        else:
            leaves.append(torch.tensor(rng.standard_normal(tuple(t.shape))
                                       / np.sqrt(t.shape[-2]),
                                       dtype=torch.float32))
    return pytree.unflatten(shapes, leaves), fspecs


def _case(name):
    """(cfg, whole params, specs, global batch, max_len) of a case, seeded."""
    arch, over, max_len, ratio = CASES[name]
    cfg = _cfg(arch, over)
    rng = np.random.default_rng(sorted(CASES).index(name))
    params, specs = T.init_model(cfg, seed=3, device="cpu")
    if ratio:
        params, specs = _factorized(params, specs, ratio, rng)
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        pos[1:, :, 2:5] += 1                        # an image's h, w offsets
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
                     np.float32),
                 "positions": pos}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                        dtype=np.int32)}
    if name == "uneven":
        batch["lengths"] = np.array(UNEVEN, dtype=np.int32)
    return cfg, params, specs, batch, max_len


def _one_process(cfg, params, batch, max_len):
    """The port's prefill and greedy steps on one process."""
    with torch.no_grad():
        lg, cache = T.prefill(params, cfg, bridge.from_numpy(
            batch, device="cpu"), max_len)
        tokens, logits = [lg[:, -1].argmax(-1)], [lg[:, -1]]
        for _ in range(STEPS):
            lg, cache = T.decode_step(params, cfg, cache,
                                      tokens[-1][:, None].to(torch.int32))
            tokens.append(lg[:, -1].argmax(-1))
            logits.append(lg[:, -1])
    return torch.stack(tokens), torch.stack(logits), cache


_JAX_SIDE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.dist import sharding as SH
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as T
CACHE_AXES = {5: ("layer_stack", "batch", "kv_seq_model", None, None),
              4: ("layer_stack", "batch", None, None),
              3: ("layer_stack", "batch", None), 2: ("layer_stack", "batch")}
cases, steps, out_path = pickle.load(open(sys.argv[1], "rb"))
mesh = make_host_mesh(2, 2)
NS = jax.sharding.NamedSharding

def batch_axes(k, v):                  # launch/dryrun.py batch_shardings
    if k == "positions" and v.ndim == 3:
        return (None, "batch", "seq")
    if v.ndim == 1:                    # lengths (B,)
        return ("batch",)
    return ("batch", "seq") + (None,) * (v.ndim - 2)

def cache_axes(v):                     # launch/dryrun.py cache_shardings
    nd = len(v.shape)
    return ("batch",) if nd == 1 else CACHE_AXES.get(
        nd, ("layer_stack", "batch") + (None,) * (nd - 2))

out = {}
for name, (arch, over, params, specs, batch, max_len) in cases.items():
    cfg = (get_config(arch).replace(**over) if over
           else get_config(arch).reduced())
    with mesh, SH.use_rules({}, mesh=mesh):
        p_sh = SH.shardings_for_tree(params, specs, mesh)
        params = jax.device_put(jax.tree.map(jnp.asarray, params), p_sh)
        b_sh = {k: NS(mesh, SH.shape_aware_spec(v.shape, batch_axes(k, v),
                                                mesh))
                for k, v in batch.items()}
        batch = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                               b_sh)
        pre = jax.jit(lambda p, b: T.prefill(p, cfg, b, max_len=max_len),
                      in_shardings=(p_sh, b_sh))
        lg, cache = pre(params, batch)
        c_sh = jax.tree.map(lambda v: NS(mesh, SH.shape_aware_spec(
            v.shape, cache_axes(v), mesh)), cache)
        cache = jax.device_put(cache, c_sh)
        nb = lg.shape[0]
        t_sh = NS(mesh, SH.shape_aware_spec((nb, 1), ("batch", None), mesh))
        dec = jax.jit(lambda p, c, t: T.decode_step(p, cfg, c, t),
                      in_shardings=(p_sh, c_sh, t_sh))
        toks, logits = [jnp.argmax(lg[:, -1], -1)], [lg[:, -1]]
        for _ in range(steps):
            t = jax.device_put(toks[-1][:, None].astype(jnp.int32), t_sh)
            lg, cache = dec(params, cache, t)
            cache = jax.device_put(cache, c_sh)
            toks.append(jnp.argmax(lg[:, -1], -1))
            logits.append(lg[:, -1])
        out[name] = (np.stack([np.asarray(t) for t in toks]),
                     np.stack([np.asarray(x, dtype=np.float32)
                               for x in logits]),
                     [str(s.spec) for s in jax.tree.leaves(c_sh)])
pickle.dump(out, open(out_path, "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' job and JAX's mesh run, started together; the port's one
    process in the test process meanwhile."""
    work = tmp_path_factory.mktemp("mesh_serve")
    cases = {name: _case(name) for name in CASES}
    started = R.start("serve", str(work), {"steps": STEPS, "cases": {
        name: {"cfg": cfg, "params": params, "specs": specs,
               "batch": bridge.from_numpy(batch, device="cpu"),
               "max_len": max_len}
        for name, (cfg, params, specs, batch, max_len) in cases.items()}})
    jin, jout = str(work / "jax_in.pkl"), str(work / "jax_out.pkl")
    with open(jin, "wb") as f:
        pickle.dump(({name: (CASES[name][0], CASES[name][1],
                             pytree.tree_map(lambda t: t.numpy(), params),
                             specs, batch, max_len)
                      for name, (_, params, specs, batch, max_len)
                      in cases.items()}, STEPS, jout), f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE, jin], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        one = {name: _one_process(cfg, params, batch, max_len)
               for name, (cfg, params, _, batch, max_len) in cases.items()}
        ranks = R.collect(started)
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(jout, "rb") as f:
        jax_out = pickle.load(f)
    return cases, ranks, one, jax_out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_jax_mesh_and_one_process(runs, name):
    cases, ranks, one, jax_out = runs
    cfg, _, _, _, max_len = cases[name]
    jtok, jlog, jspecs = jax_out[name]
    otok, olog, ocache = one[name]
    assert np.array_equal(otok.numpy(), jtok)           # one process = JAX
    L = cfg.sliding_window or max_len
    for r, out in enumerate(ranks):
        got = out[name]
        d, m = out["coords"]
        rows = slice(d * (B // 2), (d + 1) * (B // 2))
        assert torch.equal(got["tokens"], otok[:, rows]), (name, r)
        assert np.array_equal(got["tokens"].numpy(), jtok[:, rows]), (name, r)
        # sequence parallelism: the prefill's residual holds the rank's
        # half of every prompt
        assert got["rows"] == [S // 2], (name, got["rows"])
        assert float((got["logits"] - olog[:, rows]).abs().max()) <= ATOL
        assert float(np.abs(got["logits"].numpy() - jlog[:, rows]).max()) \
            <= ATOL
        # the cache block: the rules' shape and one process's values
        mesh = Mesh((2, 2), ("data", "model"), rank=r, build_groups=False)
        want, _ = SH.shard_cache(ocache, mesh)
        for a, b in zip(pytree.tensors(got["cache"]), pytree.tensors(want)):
            assert a.shape == b.shape, (name, r)
            if a.is_floating_point():
                assert float((a - b).abs().max()) <= ATOL, (name, r)
            else:
                assert torch.equal(a, b), (name, r)
        kv = got["cache"]["runs"]["run0"]["kv"]["k"]
        split = L % 2 == 0
        assert kv.shape[2] == (L // 2 if split else L), (name, kv.shape)
        assert any("'model'" in spec for spec in jspecs) == split
        if split:
            assert "all_gather" in got["collectives"]
        # the model ranks of a data shard: the same bits
        twin = next(o for o in ranks if o["coords"] == (d, 1 - m))
        assert torch.equal(got["logits"], twin[name]["logits"])
