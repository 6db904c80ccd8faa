"""Data-parallel training and expert-parallel MoE in the port, over a gloo
process group of four ranks on the CPU, against the port's single process
and the JAX package.

* Training at data = 4: the losses of three steps within 1e-5 relative of
  the port's single-process ``Trainer`` on the same global batches (the
  reduce weighs sums by token counts), and within 5e-3 of JAX's
  single-device losses, the bar of ``tests/test_dist.py``.
* ``apply_moe`` at (data 2, model 2), ep = 2, in float32: each rank's
  output rows within 2e-5 of what JAX's mesh run returns (``shard_map``
  with two ``all_to_all``s; the model ranks' copies differ where their
  duplicate rows lose capacity, and JAX returns model rank 0's), every
  device's dispatches' slots and kept masks equal to the port rank's, and
  the aux loss of the data-0 ranks JAX's (its ``out_specs=P()`` returns
  device 0's). JAX's run needs four devices, so it runs once, in a
  subprocess of this file with ``--xla_force_host_platform_device_count
  =4``, as ``tests/test_dist.py`` does; ``jax.vmap`` cannot stand in
  (``lax.all_to_all(..., tiled=False)`` under ``vmap`` gives another
  shape).
* Sharded training (FSDP and tensor, vocab and expert parallelism of the
  parameters and AdamW's moments, ``train.step.sharded_train_step``) at
  (data 2, model 2), in float32 with TF32 off, each case its own test: (a)
  llama-mini at ``tests/test_dist.py``'s widths (heads split over
  ``model``) and (b) ``smollm-360m.reduced()`` (tied vocab-parallel
  logits, heads replicated, the global norm counting replicated leaves
  once), three steps each at lr 1e-4 (``SHARDED_OPT``), losses within
  1e-5 relative of the port's one process and 5e-3 of JAX's
  single-device ``jit(train_step)``, the
  gathered params within 1e-5 max-relative (max|a-b| / max|b| over the
  whole params) of the one process and 1e-4 of JAX's; (c) the MoE layer's
  gradient blocks (router and expert stacks, ``sum(out·w) + aux``) within
  1e-4 max-relative of JAX's mesh gradients, the backward through the two
  ``all_to_all``s and model rank 0's broadcast taking JAX's transpose of
  its replicated outputs, and an MoE train step at vocab 257 (which does
  not split over ``model``) against one process; (d) one
  ``hymba-1.5b.reduced()`` step (the Mamba-2 sub-block on its
  ``ssm_inner`` shares; ``tests/test_torch_mesh_recurrent.py`` holds the
  recurrent stacks' grads and cases further); (e) a checkpoint of
  the sharded state saved at (2, 2) and restored onto (4, 1) and onto one
  process, every block equal. JAX's mesh gradients and its single-device
  steps of (a) and (b) come from the same subprocess as its EP forward.
"""
import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
MOE = dict(num_experts=8, top_k=2, d_expert=32, capacity_factor=1.0,
           pad_to=8)
MESH = (2, 2)                  # (data, model)
ARCH = "granite-moe-1b-a400m"
KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
          d_ff=128, vocab_size=256, dtype="float32")
DCFG = dict(vocab_size=256, seq_len=32, global_batch=8)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# the sharded cases' optimizer: at lr 1e-4, as tests/test_torch_train.py
# takes it for the same reason, Adam's first steps move an entry whose
# grad is near eps by ~lr whatever its size, so the two reduction orders'
# last-bit differences reach the params at ~lr·1e-2; at 1e-3 that read
# 2.5e-06 to 1.08e-05 of the params' largest entry on llama-mini and
# smollm across JAX's inits (its draws differ between processes), every
# first-step gradient within 5e-7 of its leaf's largest entry
SHARDED_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)
STEPS = 3
# the cases whose JAX single-device steps (at SHARDED_OPT) run in the JAX
# subprocess, below the suite's priority, beside the ranks
TRAINED = ("llama", "smollm")


def _jax_cfg(name, jget_config):
    if name == "llama":
        return jget_config("llama-mini").replace(**KW)
    return jget_config("smollm-360m").reduced()


def _jax_ep_main(npz: str) -> None:
    """JAX's mesh run of ``apply_moe``: out, aux and every dispatch's slots
    and kept masks per (data, model) device, as JSON on stdout, and its
    mesh gradients; then, from the initial states and batches the test
    wrote (JAX's init differs between processes), JAX's single-device
    ``jit(train_step)`` of the ``TRAINED`` cases: losses on stdout, final
    params beside ``npz``. It runs at the suite's priority: ~26 s of CPU
    alone, and niced it starved for over its 300 s under a loaded suite."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    from repro.config import MoEConfig as JMoEConfig
    from repro.configs import get_config as jget_config
    from repro.dist import sharding as JSH
    from repro.launch.mesh import make_host_mesh
    from repro.models import mlp as JM

    z = np.load(npz)
    cfg = jget_config(ARCH).reduced().replace(moe=JMoEConfig(**MOE))
    p = {"moe": {"router": {"w": z["router"]},
                 **{k: z[k] for k in ("w_gate", "w_up", "w_down")}}}
    rec = []
    orig = JM._dispatch_to_buffers

    def record(x, dest, n_dest, cap):
        buf, slot, kept = orig(x, dest, n_dest, cap)
        jax.debug.callback(
            lambda d, m, s, k, dim=int(x.shape[-1]), n=n_dest, c=cap:
            rec.append([int(d), int(m), dim, n, c, np.asarray(s).tolist(),
                        np.asarray(k).tolist()]),
            jax.lax.axis_index("data"), jax.lax.axis_index("model"),
            slot, kept)
        return buf, slot, kept

    JM._dispatch_to_buffers = record
    mesh = make_host_mesh(*MESH)
    with JSH.use_rules({}, mesh=mesh):
        out, aux = jax.jit(lambda pp, x: JM.apply_moe(pp, cfg, x))(
            p, z["x"])
        out = np.asarray(out)
        aux = float(aux)
    jax.effects_barrier()
    JM._dispatch_to_buffers = orig

    # the mesh gradients of sum(out * w) + aux: the router and the stacks
    def f(pp):
        o, a = JM.apply_moe(pp, cfg, z["x"])
        return (o * z["w"]).sum() + a

    with JSH.use_rules({}, mesh=mesh):
        g = jax.jit(jax.grad(f))(p)["moe"]
    np.savez(npz[:-4] + "_grads.npz", router=np.asarray(g["router"]["w"]),
             **{k: np.asarray(g[k]) for k in ("w_gate", "w_up", "w_down")})

    import jax.numpy as jnp

    from repro.optim.adamw import OptimizerConfig as JOpt
    from repro.train import step as JTS
    t = np.load(npz[:-4] + "_train.npz")
    losses, final = {}, {}
    for name in TRAINED:
        jcfg = _jax_cfg(name, jget_config)
        treedef = jax.tree_util.tree_structure(jax.eval_shape(
            lambda k: JTS.init_train_state(jcfg, k)[0],
            jax.random.PRNGKey(0)))
        st = jax.tree_util.tree_unflatten(
            treedef, [t[f"{name}_{i}"] for i in range(treedef.num_leaves)])
        fn = jax.jit(JTS.make_train_step(jcfg, JTS.TrainConfig(
            optimizer=JOpt(**SHARDED_OPT))))
        losses[name] = []
        for s in range(STEPS):
            st, m = fn(st, {"tokens": jnp.asarray(t[f"tokens_{s}"])})
            losses[name].append(float(m["loss"]))
        for i, leaf in enumerate(jax.tree.leaves(st.params)):
            final[f"{name}_{i}"] = np.asarray(leaf)
    np.savez(npz[:-4] + "_trained.npz", **final)
    print(json.dumps({"out": out.tolist(), "aux": aux, "calls": rec,
                      "losses": losses}))


if __name__ == "__main__":
    _jax_ep_main(sys.argv[1])
    raise SystemExit(0)

import jax                                          # noqa: E402
import jax.numpy as jnp                             # noqa: E402

import torch_mesh_ranks as R                        # noqa: E402
from repro.config import MoEConfig as JMoEConfig    # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import ShardedLoader as JLoader   # noqa: E402
from repro.models import transformer as JT          # noqa: E402
from repro.optim.adamw import OptimizerConfig as JOpt  # noqa: E402
from repro.train import step as JTS                 # noqa: E402
from repro_torch import bridge                      # noqa: E402
from repro_torch import pytree                      # noqa: E402
from repro_torch.ckpt import store                  # noqa: E402
from repro_torch.config import MoEConfig            # noqa: E402
from repro_torch.configs import get_config          # noqa: E402
from repro_torch.data.synthetic import DataConfig   # noqa: E402
from repro_torch.optim.adamw import adamw_init      # noqa: E402
from repro_torch.train import step as TS            # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port_cfg(name):
    if name == "llama":
        return get_config("llama-mini").replace(**KW)
    return get_config("smollm-360m").reduced()


@functools.lru_cache(maxsize=None)
def jax_init(name="llama"):
    """JAX's config and initial state, and the port's config and bridged
    initial state, for llama-mini at ``KW`` or ``smollm-360m.reduced()``."""
    jcfg, cfg = _jax_cfg(name, jget_config), _port_cfg(name)
    jstate, _ = JTS.init_train_state(jcfg, jax.random.PRNGKey(0))
    params = bridge.from_numpy(jax.tree.map(np.asarray, jstate.params),
                               device=CPU)
    return jcfg, jstate, cfg, TS.TrainState(params=params,
                                            opt=adamw_init(params))


def _save_jax_starts(tmp):
    """The ``TRAINED`` cases' initial JAX states and the global batches,
    for the JAX subprocess (its own init would draw other weights)."""
    arrays = {}
    for name in TRAINED:
        _, jstate, _, _ = jax_init(name)
        for i, leaf in enumerate(jax.tree.leaves(jstate)):
            arrays[f"{name}_{i}"] = np.asarray(leaf)
    for s, b in enumerate(global_batches()):
        arrays[f"tokens_{s}"] = b["tokens"].numpy()
    np.savez(os.path.join(tmp, "moe_train.npz"), **arrays)


_JAX = {}                       # the JAX subprocess's results, by tmp dir


@functools.lru_cache(maxsize=None)
def _jax_train_here(name):
    """JAX's three single-device steps at ``OPT`` in this process (one
    compile): (losses, final params)."""
    jcfg, jstate, _, _ = jax_init(name)
    fn = jax.jit(JTS.make_train_step(jcfg, JTS.TrainConfig(
        optimizer=JOpt(**OPT))))
    st, losses = jstate, []
    for b in global_batches():
        st, m = fn(st, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, bridge.from_numpy(jax.tree.map(np.asarray, st.params),
                                     device=CPU)


def jax_train(name):
    """``jax_init``'s port side, with JAX's three single-device losses and
    final params at ``SHARDED_OPT`` (from the JAX subprocess that the
    ``ranks`` fixture ran)."""
    _, jstate, cfg, tstate = jax_init(name)
    tmp = _JAX["tmp"]
    z = np.load(os.path.join(tmp, "moe_trained.npz"))
    treedef = jax.tree_util.tree_structure(jstate.params)
    final = jax.tree_util.tree_unflatten(
        treedef, [z[f"{name}_{i}"] for i in range(treedef.num_leaves)])
    return (cfg, tstate, jax_ep(tmp)["losses"][name],
            bridge.from_numpy(final, device=CPU))


def train_setup():
    """llama-mini's config and bridged initial state, and JAX's three
    single-device losses at ``OPT`` (the data-parallel tests')."""
    _, _, cfg, tstate = jax_init("llama")
    return cfg, tstate, _jax_train_here("llama")[0]


@functools.lru_cache(maxsize=None)
def global_batches():
    """The three global batches of ``tests/test_dist.py`` (JAX's loader)."""
    loader = JLoader(JDataConfig(**DCFG))
    return tuple({k: torch.as_tensor(v) for k, v in loader.batch(s).items()}
                 for s in range(STEPS))


def _seeded_batches(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return tuple({"tokens": torch.as_tensor(rng.integers(
        0, vocab, (DCFG["global_batch"], DCFG["seq_len"]), dtype=np.int32))}
        for _ in range(n))


# the MoE train step: no assignment drops at this capacity, so the
# sharded step's rows equal one process's (JAX's EP drops differ across
# model ranks by design: held against JAX in the EP tests)
MOE_TRAIN = dict(MOE, capacity_factor=4.0)


@functools.lru_cache(maxsize=None)
def sharded_cases():
    """The sharded cases' configs, initial params, batches and steps."""
    cases = {}
    for name in ("llama", "smollm"):
        _, _, cfg, tstate = jax_init(name)
        cases[name] = dict(cfg=cfg, params=tstate.params,
                           batches=global_batches())
    for name, cfg, n in (
            ("moe", get_config(ARCH).reduced().replace(
                vocab_size=257, moe=MoEConfig(**MOE_TRAIN)), 2),
            ("hymba", get_config("hymba-1.5b").reduced(), 1)):
        params, _ = TT.init_model(cfg, seed=0, device=CPU)
        cases[name] = dict(cfg=cfg, params=params,
                           batches=_seeded_batches(cfg.vocab_size, n, 11))
    for name, c in cases.items():
        c["tcfg"] = dict(optimizer=TS.OptimizerConfig(**SHARDED_OPT))
        c["one_micro"] = MESH[0] if name == "moe" else 1
    return cases


def one_process(outs, name):
    """The port's one-process steps of a sharded case (metrics, params),
    which one rank of the job runs on the whole global batches. The MoE
    case's takes one microbatch a data shard (``one_micro``): its aux
    statistic is then each data shard's, as under JAX's EP body, where the
    aux of a shard's tokens enters the loss with a 1 / (data shards)
    share."""
    return next(o["one"][name] for o in outs if name in o["one"])


def whole_rel(a, b) -> float:
    """max|a - b| / max|b| over every leaf of two trees together."""
    la, lb = pytree.leaves(a), pytree.leaves(b)
    assert len(la) == len(lb)
    num = max(float((x - y).abs().max()) for x, y in zip(la, lb))
    return num / max(float(y.abs().max()) for y in lb)


def _seeded_ckpt(path, tstate):
    store.save(path, 0, tstate)
    return path


# the MoE layer's logical axes, as ``models.mlp.init_moe`` builds them
MOE_SPECS = {"moe": {"router": {"w": ("fsdp", None)},
                     "w_gate": ("experts", "fsdp", None),
                     "w_up": ("experts", "fsdp", None),
                     "w_down": ("experts", None, "fsdp")}}


def moe_p(z):
    return {"moe": {"router": {"w": torch.as_tensor(z["router"])},
                    **{k: torch.as_tensor(z[k])
                       for k in ("w_gate", "w_up", "w_down")}}}


def dp_grad_batch():
    """A global batch of 8 rows whose rank shards (2 rows each) hold
    unequal token counts: each row keeps a seeded prefix of its positions
    in the loss, and rank 3's second row none."""
    rng = np.random.default_rng(5)
    B, S = DCFG["global_batch"], DCFG["seq_len"]
    keep = rng.integers(4, S, B)
    keep[-1] = 0
    mask = (np.arange(S)[None] < keep[:, None]).astype(np.float32)
    return {"tokens": torch.as_tensor(rng.integers(0, DCFG["vocab_size"],
                                                   (B, S), dtype=np.int32)),
            "loss_mask": torch.as_tensor(mask)}


@functools.lru_cache(maxsize=None)
def moe_setup():
    """The MoE layer's float32 params and tokens, from a seed."""
    rng = np.random.default_rng(3)
    tcfg = get_config(ARCH).reduced().replace(moe=MoEConfig(**MOE))
    D, F, E = tcfg.d_model, MOE["d_expert"], MOE["num_experts"]
    arr = lambda *s: (0.2 * rng.normal(size=s)).astype(np.float32)
    z = {"router": arr(D, E), "w_gate": arr(E, D, F), "w_up": arr(E, D, F),
         "w_down": arr(E, F, D), "x": arr(4, 8, D)}
    z["w"] = arr(4, 8, D)
    return tcfg, z


_EP = {}


def _start_jax_ep(tmp):
    """JAX's mesh run of the EP layer, started in a subprocess beside the
    ranks."""
    _, z = moe_setup()
    npz = os.path.join(tmp, "moe.npz")
    np.savez(npz, **z)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    _EP[tmp] = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), npz], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@functools.lru_cache(maxsize=None)
def jax_ep(tmp):
    if tmp not in _EP:
        _start_jax_ep(tmp)
    proc = _EP.pop(tmp)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The world-4 job and JAX's mesh run, both started at once; JAX's
    single-device steps and the port's one-process steps run here
    meanwhile."""
    tmp = str(tmp_path_factory.mktemp("train_moe"))
    _, _, cfg, tstate = jax_init("llama")
    mcfg, z = moe_setup()
    inp = dict(
        cfg=cfg, tcfg=dict(optimizer=TS.OptimizerConfig(**OPT)),
        dcfg=DCFG,
        lcfg=dict(total_steps=STEPS, log_every=1, ckpt_every=1000,
                  ckpt_dir=_seeded_ckpt(os.path.join(tmp, "dp"), tstate),
                  heartbeat_path=os.path.join(tmp, "hb", "worker")),
        dp_params=tstate.params, dp_grad=dp_grad_batch(),
        moe_cfg=mcfg, moe_p=moe_p(z),
        moe_x=torch.as_tensor(z["x"]),
        sharded=sharded_cases(),
        ep_grad=dict(cfg=mcfg, x=torch.as_tensor(z["x"]),
                     w=torch.as_tensor(z["w"]), p=moe_p(z),
                     specs=MOE_SPECS),
        ckpt_dir=os.path.join(tmp, "sharded_ckpt"))
    _save_jax_starts(tmp)
    started = R.start("train_moe", tmp, inp)
    try:
        _start_jax_ep(tmp)
        _JAX["tmp"] = tmp
        _jax_train_here("llama")
        jax_ep(tmp)
    except BaseException:
        started[2].kill()
        started[2].wait()
        raise
    yield tmp, R.collect(started)
    proc = _EP.pop(tmp, None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def test_data_parallel_losses_match_one_process_and_jax(ranks):
    tmp, outs = ranks
    cfg, tstate, jax_losses = train_setup()
    single = os.path.join(tmp, "single")
    shutil.rmtree(single, ignore_errors=True)
    tr = Trainer(cfg, TS.TrainConfig(optimizer=TS.OptimizerConfig(**OPT)),
                 DataConfig(**DCFG),
                 LoopConfig(total_steps=STEPS, log_every=1, ckpt_every=1000,
                            ckpt_dir=_seeded_ckpt(single, tstate)),
                 device="cpu")
    want = [row["loss"] for row in tr.run()["history"]]
    assert len(want) == STEPS
    for out in outs:
        got = [row["loss"] for row in out["dp"]]
        assert rel(got, want) <= 1e-5, (got, want)
        assert rel(got, jax_losses) <= 5e-3, (got, jax_losses)
        assert [row["tokens"] for row in out["dp"]] == \
            [row["tokens"] for row in out["dp"][:1]] * STEPS
    # rank 0 alone checkpoints; every rank beats its own heartbeat
    assert store.latest_step(os.path.join(tmp, "dp")) == STEPS
    hb = sorted(os.listdir(os.path.join(tmp, "hb")))
    assert hb == [f"worker.rank{r}" for r in range(R.WORLD)]


def test_data_parallel_grads_weigh_ranks_by_their_tokens(ranks):
    """The reduced loss and grads of one step, on shards of unequal token
    counts, equal one process's on the global batch: each rank's mean
    weighed by its count. AdamW's update ignores a uniform scale of the
    grads, so the losses alone would not catch a wrong divisor; an
    unweighted mean of the ranks' grads misses here by far more than the
    tolerance."""
    _, outs = ranks
    cfg, tstate, _ = train_setup()
    batch = dp_grad_batch()
    want_loss, want_m, want_g = TS.value_and_grad(tstate.params, cfg, batch)
    counts = [float(o["dp_local"][1]) for o in outs]
    assert len(set(counts)) == R.WORLD, counts      # every count differs
    assert sum(counts) == float(want_m["tokens"])
    leaves = lambda t: [x.numpy() for x in pytree.leaves(t)]
    want = leaves(want_g)
    unweighted = [sum(ls) / R.WORLD for ls in
                  zip(*(leaves(o["dp_local"][2]) for o in outs))]
    assert max(np.abs(u - w).max() / np.abs(w).max()
               for u, w in zip(unweighted, want)) > 1e-2
    for out in outs:
        loss, metrics, grads = out["dp_reduced"]
        assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
        assert float(metrics["tokens"]) == float(want_m["tokens"])
        assert abs(float(metrics["accuracy"]) - float(want_m["accuracy"])) \
            <= 1e-6
        for g, w in zip(leaves(grads), want):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_expert_parallel_moe_matches_jax_mesh(ranks):
    tmp, outs = ranks
    want = jax_ep(tmp)
    jout = np.asarray(want["out"], dtype=np.float32)
    b = jout.shape[0] // MESH[0]
    for out in outs:
        o, aux, calls, d, m = out["moe"]
        assert rel(o.numpy(), jout[d * b:(d + 1) * b]) <= 2e-5
        if d == 0:
            assert abs(float(aux) - want["aux"]) <= 2e-5 * abs(want["aux"])
        jcalls = sorted((c[2], c[3], c[4], c[5], c[6])
                        for c in want["calls"] if c[:2] == [d, m])
        pcalls = sorted((c[0], c[1], c[2], c[3].tolist(), c[4].tolist())
                        for c in calls)
        assert len(pcalls) == 3 and pcalls == jcalls
    # the model ranks of a data shard return the same rows (model rank 0's)
    for d in range(MESH[0]):
        a, bb = [o["moe"][0] for o in outs if o["moe"][3] == d]
        assert torch.equal(a, bb)
    dropped = sum(int((~torch.as_tensor(c[4])).sum())
                  for o in outs for c in o["moe"][2] if c[0] != 2)
    assert dropped > 0              # capacity 1.0 drops rows, as in JAX


def test_expert_parallel_body_captures_no_expert_statistic(ranks):
    """JAX's mesh body passes no capture tag, so a calibration under ep > 1
    holds no expert Gram; the same tagged layer at ep = 1 captures one per
    expert and buffer."""
    from repro_torch.core.capture import Collector
    from repro_torch.models import mlp as M
    _, outs = ranks
    for out in outs:
        assert out["ep_capture"] == []
    mcfg, z = moe_setup()
    p = {"moe": {"router": {"w": torch.as_tensor(z["router"])},
                 **{k: torch.as_tensor(z[k])
                    for k in ("w_gate", "w_up", "w_down")},
                 "_tag": "layer/moe"}}
    with torch.no_grad(), Collector() as col:
        M.apply_moe(p, mcfg, torch.as_tensor(z["x"]))
    assert len(col.gram) == 2 * MOE["num_experts"]


def test_counted_collectives_equal_the_bytes_comm_reports(ranks):
    """A data-parallel step and an expert-parallel forward, counted on meta
    by the counting comm (``launch.op_analysis``; the EP forward on a
    shapes-only mesh), move the result bytes per family that the real run's
    ``Comm.report()`` shows: one all_reduce of the grad bucket; three
    all_to_alls (rows, routing metadata, rows back) and two broadcasts a
    forward."""
    _, outs = ranks
    for out in outs:
        assert out["dp_step_count"]["per_op"] == out["dp_step_bytes"]
        assert set(out["dp_step_bytes"]) == {"all_reduce"}
        assert out["dp_step_count"]["calls"] == {"all_reduce": 1}
        assert out["ep_count"]["per_op"] == out["ep_bytes"]
        assert out["ep_count"]["calls"] == {"all_to_all": 3, "broadcast": 2}
        assert out["comm"]["bytes"]["all_to_all"] >= \
            out["ep_bytes"]["all_to_all"] > 0
        assert out["comm"]["staged_bytes"] == 0


def _check_sharded(outs, name, jax_bars):
    """Every rank's losses (and grad norms) against one process, the
    gathered params against one process (and JAX's)."""
    want_m, want_p = one_process(outs, name)
    for out in outs:
        got = out[f"sh_{name}"]["metrics"]
        assert len(got) == len(want_m)
        assert rel([m["loss"] for m in got],
                   [m["loss"] for m in want_m]) <= 1e-5, (got, want_m)
        assert [m["tokens"] for m in got] == [m["tokens"] for m in want_m]
        if jax_bars is not None:
            jl = jax_bars[0]
            assert rel([m["loss"] for m in got], jl) <= 5e-3, (got, jl)
    params = outs[0][f"sh_{name}"]["params"]
    assert whole_rel(params, want_p) <= 1e-5, whole_rel(params, want_p)
    if jax_bars is not None:
        assert whole_rel(params, jax_bars[1]) <= 1e-4
    return want_m


def test_sharded_llama_matches_one_process_and_jax(ranks):
    """(a) Heads split over ``model`` (4 q / 2 kv heads on 2 ranks)."""
    _, outs = ranks
    _, _, jl, jp = jax_train("llama")
    _check_sharded(outs, "llama", (jl, jp))


def test_sharded_smollm_matches_one_process_and_jax(ranks):
    """(b) Tied vocab-parallel logits, heads replicated over ``model``
    (``shard_attn_heads=False``), and a global norm that counts each
    replicated leaf once: ``grad_norm`` within 1e-6 of one process's."""
    _, outs = ranks
    _, _, jl, jp = jax_train("smollm")
    want = _check_sharded(outs, "smollm", (jl, jp))
    for out in outs:
        got = out["sh_smollm"]["metrics"]
        assert rel([m["grad_norm"] for m in got],
                   [m["grad_norm"] for m in want]) <= 1e-6


def test_sharded_cases_split_the_sequence_over_model(ranks):
    """Sequence parallelism in every sharded case: given its data shard's
    whole rows, each rank's residual stream holds its half of every
    sequence at each layer's entry."""
    _, outs = ranks
    for out in outs:
        for name in sharded_cases():
            assert out[f"sh_{name}"]["rows"] == [DCFG["seq_len"] // 2], name


def test_each_rank_holds_only_its_blocks(ranks):
    """Every leaf of every rank's params and AdamW moments is its
    ``local_block`` under ``shape_aware_spec`` over (data, model): heads,
    mlp, vocab and experts split where they divide, replicated where not
    (smollm's heads, vocab 257)."""
    _, outs = ranks
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import Mesh
    for r, out in enumerate(outs):
        mesh = Mesh(MESH, ("data", "model"), rank=r, build_groups=False)
        for name, c in sharded_cases().items():
            _, specs = TT.init_model(c["cfg"], device="meta")
            state = TS.TrainState(params=c["params"],
                                  opt=adamw_init(c["params"]))
            shd = SH.shardings_for_tree(state, TS.state_specs(specs), mesh)
            want = {pytree.keystr(p): tuple(SH.local_block(
                t, s.spec, mesh).shape) for (p, t), s in zip(
                    pytree.flatten_with_path(state), pytree.leaves(shd))}
            assert out[f"sh_{name}"]["held"] == want, name
    held = outs[0]["sh_llama"]["held"]
    assert held[".params['decoder']['run0']['attn']['wq']['w']"] == \
        (2, 32, 32)                          # (layers, d/data, q/model)
    assert held[".opt.mu['embed']"] == (128, 32)   # vocab/model, d/data
    moe = outs[0]["sh_moe"]["held"]
    assert moe[".params['embed']"] == (257, 32)    # 257 does not split
    assert moe[".params['decoder']['run0']['moe']['w_gate']"][1] == \
        MOE["num_experts"] // MESH[1]


def test_expert_parallel_backward_matches_jax_mesh_grads(ranks):
    """(c) The gradient of ``sum(out·w) + aux`` through the EP body at
    capacity 1.0 (assignments drop, differently on the two model ranks):
    each rank's blocks of the router's and the expert stacks' gradients
    within 1e-4 max-relative of JAX's mesh gradients, whose transpose of
    the replicated ``out`` and ``aux`` hands every device the cotangent
    divided by the axes the output is replicated over."""
    tmp, outs = ranks
    jax_ep(tmp)
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import Mesh
    g = np.load(os.path.join(tmp, "moe_grads.npz"))
    want = {"moe": {"router": {"w": torch.as_tensor(g["router"])},
                    **{k: torch.as_tensor(g[k])
                       for k in ("w_gate", "w_up", "w_down")}}}
    for r, out in enumerate(outs):
        mesh = Mesh(MESH, ("data", "model"), rank=r, build_groups=False)
        shd = SH.shardings_for_tree(want, MOE_SPECS, mesh)
        for (p, got), w, s in zip(pytree.flatten_with_path(out["ep_grads"]),
                                  pytree.leaves(want), pytree.leaves(shd)):
            blk = SH.local_block(w, s.spec, mesh)
            assert got.shape == blk.shape, pytree.keystr(p)
            assert rel(got.numpy(), blk.numpy()) <= 1e-4, pytree.keystr(p)


def test_sharded_moe_step_matches_one_process(ranks):
    """(c) Two MoE train steps at (2, 2): the reduced granite with 8
    experts split 4 a rank, its 4 q / 2 kv heads split over ``model`` and
    vocab 257 replicated by the fallback, no assignment dropped
    (``MOE_TRAIN``), against one process with one microbatch a data shard
    (``one_process``): losses within 1e-5 and the gathered params within
    1e-5 max-relative, as in (a)."""
    _, outs = ranks
    _check_sharded(outs, "moe", None)


def test_sharded_hymba_step_matches_one_process(ranks):
    """(d) One step of ``hymba-1.5b.reduced()``: its Mamba-2 sub-block
    computes on its ``ssm_inner`` shares (4 heads, 2 a model rank)."""
    _, outs = ranks
    _check_sharded(outs, "hymba", None)


def test_sharded_checkpoint_round_trip(ranks):
    """(e) A sharded state saved at (2, 2) (whole leaves, gathered to rank
    0) restores onto (4, 1) as each rank's blocks and onto one process
    whole, every block equal. The save gathers one leaf at a time: a rank
    other than 0 never holds more than the largest whole leaf at once."""
    _, outs = ranks
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import Mesh
    whole = outs[0]["ckpt_whole"]
    sizes = [t.numel() * t.element_size() for t in pytree.leaves(whole)]
    assert max(sizes) < sum(sizes)
    for out in outs[1:]:
        assert 0 < out["ckpt_peak_gathered"] <= max(sizes)
    for a, b in zip(pytree.leaves(outs[0]["ckpt_one"]),
                    pytree.leaves(whole)):
        assert torch.equal(a, b)
    _, specs = TT.init_model(sharded_cases()["llama"]["cfg"], device="meta")
    for r, out in enumerate(outs):
        mesh = Mesh((4, 1), ("data", "model"), rank=r, build_groups=False)
        shd = SH.shardings_for_tree(whole, TS.state_specs(specs), mesh)
        for a, b, s in zip(pytree.leaves(out["ckpt_41"]),
                           pytree.leaves(whole), pytree.leaves(shd)):
            assert torch.equal(a, SH.local_block(b, s.spec, mesh))


def test_a_remat_recompute_in_another_thread_keeps_the_placement():
    """On the card the autograd engine runs the backward, and so a remat'd
    layer's recompute, in its device thread: the layer code reads its
    shares' groups from the marks the placement leaves on the parameters,
    nothing of the step's thread. Here the backward runs in another thread
    than the forward, on a (1, 1)
    mesh in one process (every leaf's ``model`` entry of size 1 keeps the
    tensor-parallel marks): the grads equal the plain step's."""
    import threading

    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import Mesh
    c = sharded_cases()["llama"]
    cfg, params, batch = c["cfg"], c["params"], c["batches"][0]
    pl = TS.placement(cfg, Mesh((1, 1), ("data", "model"), rank=0,
                                build_groups=False))
    leaves = [t.detach().requires_grad_() for t in pytree.leaves(params)]
    loss, _ = TT.lm_loss(pytree.unflatten(params, leaves), cfg, batch,
                         placement=pl)
    got = {}

    def backward():
        got["g"] = torch.autograd.grad(loss, leaves)
    th = threading.Thread(target=backward)
    th.start()
    th.join()
    _, _, want = TS.value_and_grad(params, cfg, batch)
    for g, w in zip(got["g"], pytree.leaves(want)):
        assert torch.allclose(g, w, rtol=0, atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("heads,kv,model", [(8, 1, 2), (32, 8, 16),
                                            (12, 3, 2), (12, 3, 4)])
def test_local_q_heads_read_their_own_kv_group(heads, kv, model):
    """Where the q heads split over ``model`` and the kv heads do not
    (qwen3-4b's 32 / 8 on the production model axis of 16), each rank's q
    heads read the kv heads of their own GQA group: the kv the flash
    kernel gets, expanded to one a local q head, equals the whole model's
    expansion at those heads."""
    from repro_torch.models.attention import _kv_of_local_heads
    cfg = get_config("llama-mini").replace(n_heads=heads, n_kv_heads=kv)
    k = torch.randn(2, 5, kv, 4, generator=torch.Generator().manual_seed(0))
    want = k.repeat_interleave(heads // kv, dim=2)
    hl = heads // model
    for m in range(model):
        got, _ = _kv_of_local_heads(cfg, k, k, m * hl, hl)
        assert hl % got.shape[2] == 0
        assert torch.equal(got.repeat_interleave(hl // got.shape[2], dim=2),
                           want[:, :, m * hl:(m + 1) * hl])
