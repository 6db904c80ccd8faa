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
  shape). A backward through the EP body raises (item 11, second part).
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

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
MOE = dict(num_experts=8, top_k=2, d_expert=32, capacity_factor=1.0,
           pad_to=8)
MESH = (2, 2)                  # (data, model)
ARCH = "granite-moe-1b-a400m"


def _jax_ep_main(npz: str) -> None:
    """JAX's mesh run of ``apply_moe``: out, aux and every dispatch's slots
    and kept masks per (data, model) device, as JSON on stdout."""
    os.nice(10)             # below the suite's other workers
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
    print(json.dumps({"out": out.tolist(), "aux": aux, "calls": rec}))


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
from repro_torch.train.loop import LoopConfig, Trainer  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
          d_ff=128, vocab_size=256, dtype="float32")
DCFG = dict(vocab_size=256, seq_len=32, global_batch=8)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 3


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def train_setup():
    """JAX's initial state, its three single-device losses, and the port's
    config and bridged initial state."""
    jcfg = jget_config("llama-mini").replace(**KW)
    cfg = get_config("llama-mini").replace(**KW)
    jstate, _ = JTS.init_train_state(jcfg, jax.random.PRNGKey(0))
    fn = jax.jit(JTS.make_train_step(jcfg, JTS.TrainConfig(
        optimizer=JOpt(**OPT))))
    loader = JLoader(JDataConfig(**DCFG))
    st, losses = jstate, []
    for s in range(STEPS):
        st, m = fn(st, {k: jnp.asarray(v)
                        for k, v in loader.batch(s).items()})
        losses.append(float(m["loss"]))
    params = bridge.from_numpy(jax.tree.map(np.asarray, jstate.params),
                               device=CPU)
    tstate = TS.TrainState(params=params, opt=adamw_init(params))
    return cfg, tstate, losses


def _seeded_ckpt(path, tstate):
    store.save(path, 0, tstate)
    return path


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
    return tcfg, z


@functools.lru_cache(maxsize=None)
def jax_ep(tmp):
    _, z = moe_setup()
    npz = os.path.join(tmp, "moe.npz")
    np.savez(npz, **z)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), npz],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("train_moe"))
    cfg, tstate, _ = train_setup()
    mcfg, z = moe_setup()
    inp = dict(
        cfg=cfg, tcfg=dict(optimizer=TS.OptimizerConfig(**OPT)),
        dcfg=DCFG,
        lcfg=dict(total_steps=STEPS, log_every=1, ckpt_every=1000,
                  ckpt_dir=_seeded_ckpt(os.path.join(tmp, "dp"), tstate),
                  heartbeat_path=os.path.join(tmp, "hb", "worker")),
        dp_params=tstate.params, dp_grad=dp_grad_batch(),
        moe_cfg=mcfg,
        moe_p={"moe": {"router": {"w": torch.as_tensor(z["router"])},
                       **{k: torch.as_tensor(z[k])
                          for k in ("w_gate", "w_up", "w_down")}}},
        moe_x=torch.as_tensor(z["x"]))
    return tmp, R.run("train_moe", tmp, inp)


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


def test_a_backward_through_expert_parallelism_raises(ranks):
    _, outs = ranks
    for out in outs:
        assert "item 11, second part" in out["ep_grad"]
