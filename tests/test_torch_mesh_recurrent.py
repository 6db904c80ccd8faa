"""The recurrent and encoder-decoder stacks on a mesh in the port: the
Mamba-2, mLSTM and sLSTM sub-blocks computing on their ``ssm_inner`` (and
sLSTM ``mlp``) shares, in the sharded train step and in prefill and decode
under a ``dist.sharding.Placement``, and an encoder-decoder model's
``cross_kv`` split over ``model`` on its encoder rows. Over a gloo process
group of four ranks (data 2, model 2) on the CPU, against the JAX
package's mesh run and the port's one process.

Serving cases, each a prefill of 4 prompts and ``STEPS`` greedy decode
steps in float32 on the same seeded weights: hymba ``.reduced()`` (4
Mamba-2 heads: case A, the rank computes its 2 heads and holds their
state; its attention sequence-split as ``tests/test_torch_mesh_serve.py``
holds it), hymba at ``CUT_HYMBA`` (5 heads: case B, the split cuts a head,
the state whole), xlstm ``.reduced()`` (mLSTM case A, the sLSTM FFN whole
at ``dff`` 85), xlstm at ``CUT_XLSTM`` (mLSTM case B, the sLSTM FFN
tensor-parallel at ``dff`` 128), seamless ``.reduced()`` with 8 encoder
rows (``cross_kv`` split 4 and 4) and with 7 (whole). JAX's side is
``tests/test_torch_mesh_serve.py``'s script (one subprocess with four
host devices running ``T.prefill`` and ``T.decode_step`` jitted with the
parameters', the batch's and ``CACHE_AXES``' shardings), each case's
config given as the overrides of ``.reduced(...)`` on the full config.
Bars: every step's greedy tokens identical to JAX's mesh run and to one
process; logits within 2e-3 (``tests/test_kernels.py:141``) of both; each
rank's final cache block within the same bar of its ``shard_cache`` block
of one process's cache, of the rules' shape, and as many leaves split
over ``model`` as JAX's placement splits.

Train cases: the sharded step (``train.step.make_train_step(...,
mesh=)``) on both hymba and both xlstm configs and seamless (8 encoder
rows: its encoder's residual split too, its output gathered whole for
the cross blocks), ``TRAIN_STEPS`` steps at
lr 1e-4 (``tests/test_torch_mesh_train_moe.py``'s reason), against one
process on the same global batches: losses within 1e-5 relative, the
first step's reduced gradient blocks within 1e-4 of each leaf's largest
entry, and no parameter block gathered over ``model`` (a spy on
``Placement.use``: the ``ssm_inner`` and ``mlp`` weights stay shares).
Each rank takes its block of the batch under the rules (the sequence
split over ``model``) and the residual stream holds its half of each
sequence at every layer's entry (sequence parallelism; a spy on
``_block_fwd``). SmolLM reduced to 3 q heads over 1 kv head (its
attention computed whole on every model rank, the tied embedding
vocab-parallel) trains so too, and again under ``use_rules({"seq": ()})``
(every row at every layer, the same numbers), and factorized at 20%
(``launch.dryrun.factorized_shapes`` filled from a seed: every B and C
gathered whole, the step placed by the factorized specs).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import test_torch_mesh_serve as MS
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

import torch_mesh_ranks as R
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import step as TS

torch.set_num_threads(1)

STEPS = 4
B, S = 4, 6                  # 2 rows a data shard, 3 positions a model rank
ATOL = MS.ATOL
MESH = (2, 2)
CUT_HYMBA = dict(d_model=80, n_heads=5, n_kv_heads=1)
CUT_XLSTM = dict(d_model=96, n_heads=3, n_kv_heads=3, head_dim=32)
# name -> (arch, .reduced() overrides, max_len, encoder rows)
SERVE = {"hymba": ("hymba-1.5b", {}, 16, 0),
         "hymba_cut": ("hymba-1.5b", CUT_HYMBA, 16, 0),
         "xlstm": ("xlstm-350m", {}, 16, 0),
         "xlstm_cut": ("xlstm-350m", CUT_XLSTM, 16, 0),
         "seamless": ("seamless-m4t-medium", {}, 16, 8),
         "seamless_whole": ("seamless-m4t-medium", {}, 16, 7)}
TRAIN = ("hymba", "hymba_cut", "xlstm", "xlstm_cut", "seamless")
# train-only cases on SmolLM: name -> (use_rules overrides, factorized)
SMOLLM = dict(n_heads=3, n_kv_heads=1)
TRAIN_SMOLLM = {"smollm": (None, False), "smollm_noseq": ({"seq": ()}, False),
                "smollm_drank": (None, True)}
TRAIN_STEPS, TRAIN_ROWS, TRAIN_SEQ = 2, 8, 8
TRAIN_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)


def _over(arch, reduced):
    """``.reduced(**reduced)`` as overrides of the full config, the form
    JAX's script takes (``get_config(arch).replace(**over)``)."""
    full = get_config(arch)
    cut = full.reduced(**reduced)
    return {f.name: getattr(cut, f.name) for f in dataclasses.fields(full)
            if getattr(cut, f.name) != getattr(full, f.name)}


def _serve_case(name):
    """(cfg, overrides, whole params, specs, global batch, max_len)."""
    arch, reduced, max_len, enc = SERVE[name]
    over = _over(arch, reduced)
    cfg = get_config(arch).replace(**over)
    rng = np.random.default_rng(sorted(SERVE).index(name))
    params, specs = T.init_model(cfg, seed=3, device="cpu")
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if enc:
        batch["enc_embeds"] = rng.standard_normal(
            (B, enc, cfg.d_model)).astype(np.float32)
    return cfg, over, params, specs, batch, max_len


def _factorized(params, specs, seed: int):
    """``params`` with every compressible linear of the layer runs
    factorized at 20% (``factorized_shapes``), B and C drawn from
    ``seed``."""
    from repro_torch.launch.dryrun import factorized_shapes
    shapes, fspecs = factorized_shapes(params, specs, 0.2, multiple=4)
    gen = torch.Generator().manual_seed(seed)
    return pytree.tree_map(lambda t: torch.randn(
        t.shape, generator=gen) * 0.1 if t.is_meta else t, shapes), fspecs


def _train_case(name):
    if name in TRAIN_SMOLLM:
        rules, drank = TRAIN_SMOLLM[name]
        cfg = get_config("smollm-360m").reduced(**SMOLLM)
        seed = 20
    else:
        rules, drank = None, False
        arch, reduced, _, _ = SERVE[name]
        cfg = get_config(arch).reduced(**reduced)
        seed = 11 + TRAIN.index(name)
    params, specs = T.init_model(cfg, seed=0, device="cpu")
    if drank:
        params, specs = _factorized(params, specs, seed)
    rng = np.random.default_rng(seed)
    enc = 0 if name in TRAIN_SMOLLM else SERVE[name][3]
    batches = tuple(dict({"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (TRAIN_ROWS, TRAIN_SEQ), dtype=np.int32))},
        **({"enc_embeds": torch.as_tensor(rng.standard_normal(
            (TRAIN_ROWS, enc, cfg.d_model)).astype(np.float32))}
           if enc else {}))
        for _ in range(TRAIN_STEPS))
    return dict(cfg=cfg, params=params, batches=batches, rules=rules,
                specs=specs if drank else None,
                tcfg=dict(optimizer=TS.OptimizerConfig(**TRAIN_OPT)))


def _one_serve(cfg, params, batch, max_len):
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


def _one_train(case):
    """The port's one-process steps on the whole global batches: (losses,
    the first step's gradient)."""
    cfg = case["cfg"]
    _, _, grads = TS.loss_and_grads(case["params"], cfg, case["batches"][0])
    step = TS.make_train_step(cfg, TS.TrainConfig(**case["tcfg"]))
    state = TS.TrainState(params=case["params"],
                          opt=adamw_init(case["params"]))
    losses = []
    for b in case["batches"]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' job and JAX's mesh run, started together; the port's one
    process in the test process meanwhile."""
    work = tmp_path_factory.mktemp("mesh_recurrent")
    serve = {name: _serve_case(name) for name in SERVE}
    train = {name: _train_case(name) for name in TRAIN + tuple(TRAIN_SMOLLM)}
    started = R.start("recurrent", str(work), {
        "steps": STEPS, "train": train,
        "serve": {name: {"cfg": cfg, "params": params, "specs": specs,
                         "batch": bridge.from_numpy(batch, device="cpu"),
                         "max_len": max_len, "enc_len": SERVE[name][3]}
                  for name, (cfg, _, params, specs, batch, max_len)
                  in serve.items()}})
    jin, jout = str(work / "jax_in.pkl"), str(work / "jax_out.pkl")
    with open(jin, "wb") as f:
        pickle.dump(({name: (SERVE[name][0], over,
                             pytree.tree_map(lambda t: t.numpy(), params),
                             specs, batch, max_len)
                      for name, (_, over, params, specs, batch, max_len)
                      in serve.items()}, STEPS, jout), f)
    env = dict(os.environ, PYTHONPATH=MS.SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", MS._JAX_SIDE, jin],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        one = {name: _one_serve(cfg, params, batch, max_len)
               for name, (cfg, _, params, _, batch, max_len)
               in serve.items()}
        one_train = {name: _one_train(c) for name, c in train.items()}
        ranks = R.collect(started)
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(jout, "rb") as f:
        jax_out = pickle.load(f)
    return serve, train, ranks, one, one_train, jax_out


def _state_heads(cache):
    """The heads of every matrix-memory leaf (Mamba-2's and the mLSTM's
    ``S``) a cache holds."""
    return {leaf["state"].S.shape[2] for run in cache["runs"].values()
            for name, leaf in run.items() if name in ("ssm", "mlstm")}


@pytest.mark.parametrize("name", list(SERVE))
def test_serving_matches_jax_mesh_and_one_process(runs, name):
    serve, _, ranks, one, _, jax_out = runs
    cfg = serve[name][0]
    jtok, jlog, jspecs = jax_out[name]
    otok, olog, ocache = one[name]
    assert np.array_equal(otok.numpy(), jtok)           # one process = JAX
    for r, out in enumerate(ranks):
        got = out[name]
        d, m = out["coords"]
        rows = slice(d * (B // 2), (d + 1) * (B // 2))
        assert torch.equal(got["tokens"], otok[:, rows]), (name, r)
        assert np.array_equal(got["tokens"].numpy(), jtok[:, rows]), (name, r)
        assert got["rows"] == [S // 2], (name, got["rows"])   # SP
        assert float((got["logits"] - olog[:, rows]).abs().max()) <= ATOL
        assert float(np.abs(got["logits"].numpy() - jlog[:, rows]).max()) \
            <= ATOL
        # the cache block: the rules' shape and one process's values
        mesh = Mesh(MESH, ("data", "model"), rank=r, build_groups=False)
        want, shd = SH.shard_cache(ocache, mesh)
        for a, b in zip(pytree.tensors(got["cache"]), pytree.tensors(want)):
            assert a.shape == b.shape, (name, r)
            if a.is_floating_point():
                assert float((a - b).abs().max()) <= ATOL, (name, r)
            else:
                assert torch.equal(a, b), (name, r)
        # as many leaves split over model as JAX's placement splits
        split = sum("model" in str(s.spec) for s in pytree.leaves(shd))
        assert split == sum("'model'" in s for s in jspecs), (name, split)
        # case A holds its half of the heads' state, case B all of them
        if name.startswith(("hymba", "xlstm")):
            H = cfg.n_heads
            assert _state_heads(got["cache"]) == {
                H // 2 if H % 2 == 0 else H}, name
        if name.startswith("seamless"):
            enc = SERVE[name][3]
            held = got["cache"]["runs"]["run0"]["cross_kv"]["k"].shape[2]
            assert held == (enc // 2 if enc % 2 == 0 else enc), name
        # the model ranks of a data shard: the same bits
        twin = next(o for o in ranks if o["coords"] == (d, 1 - m))
        assert torch.equal(got["logits"], twin[name]["logits"])


@pytest.mark.parametrize("name", TRAIN + tuple(TRAIN_SMOLLM))
def test_sharded_train_step_matches_one_process(runs, name):
    _, train, ranks, _, one_train, _ = runs
    want_losses, want_grads = one_train[name]
    specs = (train[name]["specs"]
             or T.init_model(train[name]["cfg"], device="meta")[1])
    for r, out in enumerate(ranks):
        got = out[f"train/{name}"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(got["losses"], want_losses))
        assert rel <= 1e-5, (name, r, got["losses"], want_losses)
        mesh = Mesh(MESH, ("data", "model"), rank=r, build_groups=False)
        shd = SH.shardings_for_tree(want_grads, specs, mesh)
        for (p, g), w, s in zip(pytree.flatten_with_path(got["grads"]),
                                pytree.leaves(want_grads),
                                pytree.leaves(shd)):
            blk = SH.local_block(w, s.spec, mesh)
            assert g.shape == blk.shape, (name, pytree.keystr(p))
            top = max(float(w.abs().max()), 1e-30)
            assert float((g - blk).abs().max()) <= 1e-4 * top, \
                (name, r, pytree.keystr(p))
        # the residual's rows a sequence between sub-blocks: its half
        # under sequence parallelism, every row under {"seq": ()}
        assert got["rows"] == [TRAIN_SEQ if name == "smollm_noseq"
                               else TRAIN_SEQ // 2], (name, got["rows"])
        # no ssm_inner or mlp weight gathered over model: every block the
        # step gathers over it is none of those layers' (SmolLM's
        # attention is computed whole, its weights replicated: none). A
        # decoder layer's cross-attention is gathered, and a factorized
        # linear: each layer's three MLP C factors (their columns split
        # over model); both in the forward and the remat'd recompute
        n = train[name]["cfg"].n_layers
        if name == "smollm_drank":
            assert len(got["gathered"]) == n * 3 * 2 * TRAIN_STEPS
        elif name == "seamless":        # cross-attention's four, whole
            assert len(got["gathered"]) == n * 4 * 2 * TRAIN_STEPS
        else:
            assert got["gathered"] == [], (name, got["gathered"])


def test_sequence_parallelism_changes_no_number(runs):
    """SmolLM's sharded step with the sequence over ``model`` against the
    same step under ``{"seq": ()}``, rank by rank: losses 1e-5, every
    gradient block 1e-4 of its largest entry."""
    _, _, ranks, _, _, _ = runs
    for out in ranks:
        on, off = out["train/smollm"], out["train/smollm_noseq"]
        assert max(abs(a - b) / abs(b) for a, b in
                   zip(on["losses"], off["losses"])) <= 1e-5
        for a, b in zip(pytree.leaves(on["grads"]),
                        pytree.leaves(off["grads"])):
            top = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= 1e-4 * top
        # the pairing: reduce-scatters of the residual appear with it
        assert on["collectives"].get("reduce_scatter", 0) > \
            off["collectives"].get("reduce_scatter", 0)
