"""The port's launch accounting (``repro_torch.launch.dryrun`` and the op
counter ``launch.op_analysis``) against the JAX package's dry-run.

* (1) active matmul params, model FLOPs and applicability of every config
  at every shape, from shapes alone (``jax.eval_shape`` against the port's
  ``meta`` init);
* (2) ``factorized_shapes``' shapes and specs;
* (3, 4) ``account_cell``'s counted FLOPs and argument bytes against
  ``hlo_analysis.analyze`` and ``memory_analysis`` of JAX's compiled
  prefill, decode and train steps (``use_pallas()`` off, as in the
  dry-run), one compile per mode and model for the module. Prefill and
  decode agree exactly. The train step counts one more QKᵀ and PV a layer
  than JAX's: the port's flash backward (``kernels/ops.py``
  ``_Flash.backward``) recomputes its forward to differentiate it, where
  JAX's reference attention keeps the probabilities of the forward. Less
  those products the two agree to 1e-6;
* (5) each kernel wrapper's reported FLOPs against its plain version
  traced, and the resident bytes against a hand count;
* (6) ``rule_argument_bytes`` on a (2, 2) mesh against the sum of JAX's
  ``NamedSharding(...).shard_shape``, from one subprocess with four host
  devices (started by the module's first test, read by the last); a
  prefill or decode cell places exactly those bytes (the sharded serving
  step), and on the (16, 16) mesh smollm-360m's and qwen2-vl-72b's
  serving cells place the rules' bytes (the 72B decode fits a card), as
  do hymba-1.5b's, xlstm-350m's and seamless-m4t-medium's at 2 layers;
* (7) the CLI's JSON; and the counts on CPU tensors equal those on
  ``meta``, and the collectives of a data-parallel step and of an
  expert-parallel forward on shapes-only meshes;
* (8) a train cell runs the sharded step: the state as placed equals
  ``rule_state_bytes`` on the production mesh (smollm-360m, qwen3-4b,
  granite at full width, 2 layers), the arguments differ from the rules'
  by the batch's sequence over ``model`` alone, and the step's gathers
  and reduce-scatters move the bytes of their formula.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# JAX's dry-run module asks for 512 host devices when it is imported; keep
# this process's device count as it was
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JDR                      # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

import jax                                                  # noqa: E402

from repro.config import SHAPES as JSHAPES                  # noqa: E402
from repro.config import shape_applicable as jshape_applicable  # noqa: E402
from repro.configs import get_config as jget_config         # noqa: E402
from repro.models import transformer as JT                  # noqa: E402
from repro_torch import config as TC                        # noqa: E402
from repro_torch import pytree                              # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config        # noqa: E402
from repro_torch.dist import comm                           # noqa: E402
from repro_torch.kernels import ops, ref                    # noqa: E402
from repro_torch.launch import dryrun as DR                 # noqa: E402
from repro_torch.launch import op_analysis as OA            # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import transformer as T             # noqa: E402
from repro_torch.train import step as TS                    # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
LLAMA = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256)            # tests/test_dist.py:87-89
GRANITE = "granite-moe-1b-a400m"
TINY = {"tiny_train": TC.ShapeConfig("tiny_train", 32, 4, "train"),
        "tiny_prefill": TC.ShapeConfig("tiny_prefill", 32, 4, "prefill"),
        "tiny_decode": TC.ShapeConfig("tiny_decode", 32, 4, "decode")}
MODES = ("prefill", "decode", "train")


def _tiny(arch):
    """(JAX config, the port's overrides) of a tiny model."""
    if arch == "llama-mini":
        return jget_config(arch).replace(**LLAMA), LLAMA
    cfg = get_config(arch).reduced()
    return jget_config(arch).reduced(), {
        f: getattr(cfg, f) for f in ("name", "n_layers", "d_model",
                                     "n_heads", "n_kv_heads", "head_dim",
                                     "d_ff", "vocab_size", "dtype",
                                     "param_dtype", "rank_multiple",
                                     "sequence_parallel", "moe")}


@pytest.fixture(autouse=True)
def tiny_shapes(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(TC.SHAPES, k, v)


# ---------------------------------------------------------------------------
# shapes of both packages
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_shapes(arch, overrides=()):
    cfg = jget_config(arch).replace(**dict(overrides))
    holder = {}

    def _init(k):
        p, s = JT.init_model(cfg, k)
        holder["specs"] = s
        return p

    return cfg, jax.eval_shape(_init, jax.random.PRNGKey(0)), holder["specs"]


@functools.lru_cache(maxsize=None)
def port_shapes(arch):
    cfg = get_config(arch)
    p, s = T.init_model(cfg, device="meta")
    return cfg, p, s


def _flat(tree, prefix=()):
    """{path: leaf} over nested dicts and lists (a tuple is a leaf: a
    spec)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _sig(leaf):
    """(shape, dtype name) of a JAX shape struct or a torch tensor."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return tuple(leaf.shape), np.dtype(leaf.dtype).name


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCH_IDS
                                        for s in JSHAPES])
def test_model_flops_and_applicability_match_jax(arch, shape):
    """(1) From shapes alone: identical active matmul params, model FLOPs
    and applicability."""
    jcfg, jp, _ = jax_shapes(arch)
    cfg, p, _ = port_shapes(arch)
    assert DR.active_matmul_params(cfg, p) == \
        JDR.active_matmul_params(jcfg, jp)
    assert DR.model_flops(cfg, TC.SHAPES[shape], p) == \
        JDR.model_flops(jcfg, JSHAPES[shape], jp)
    assert TC.shape_applicable(cfg, TC.SHAPES[shape]) == \
        jshape_applicable(jcfg, JSHAPES[shape])


@pytest.mark.parametrize("arch", ["smollm-360m", GRANITE,
                                  "seamless-m4t-medium"])
def test_factorized_shapes_match_jax(arch):
    """(2) Ratio 0.2: the same {B, C} shapes, dtypes and specs (the expert
    stacks stay dense, the encoder's linears factorize)."""
    jcfg, jp, js = jax_shapes(arch)
    cfg, p, s = port_shapes(arch)
    jn, jspec = JDR.factorized_shapes(jp, js, 0.2)
    tn, tspec = DR.factorized_shapes(p, s, 0.2)
    want = {k: _sig(v) for k, v in _flat(jn).items()}
    got = {k: _sig(v) for k, v in _flat(tn).items()}
    assert got == want
    assert _flat(tspec) == _flat(jspec)
    names = {k[-1] for k in got}
    assert {"B", "C"} <= names
    if arch == GRANITE:
        assert any(k[-1] == "w_gate" and len(v[0]) == 4
                   for k, v in got.items())        # (n, E, D, F), dense
    if arch == "seamless-m4t-medium":
        assert any(k[0] == "encoder" and k[-1] == "B" for k in got)


# ---------------------------------------------------------------------------
# (3, 4): counted FLOPs and argument bytes against JAX's compiles
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def port_cell(arch, mode, mesh=(1, 1)):
    _, over = _tiny(arch)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TINY.items():
            mp.setitem(TC.SHAPES, k, v)
        return DR.account_cell(arch, "tiny_" + mode, Mesh(
            mesh, ("data", "model"), rank=0, build_groups=False),
            overrides=over)


def flash_backward_recompute(arch) -> float:
    """QKᵀ and PV of one flash forward a layer: what the port's flash
    backward recomputes."""
    _, over = _tiny(arch)
    cfg = get_config(arch).replace(**over)
    s = TINY["tiny_train"]
    return (4.0 * s.global_batch * cfg.n_heads * s.seq_len ** 2
            * cfg.head_dim * cfg.n_layers)


# ---------------------------------------------------------------------------
# (5): kernel wrappers by their own formula
# ---------------------------------------------------------------------------
def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


KERNEL_CALLS = {
    "lowrank_matmul_2d": (lambda: (_m(2, 80, 64), _m(64, 24), _m(24, 96)),
                          ops.lowrank_matmul, ref.lowrank_matmul),
    "lowrank_gemv": (lambda: (_m(8, 64), _m(64, 24), _m(24, 96)),
                     ops.lowrank_matmul, ref.lowrank_matmul),
    "flash_attention": (lambda: (_m(2, 40, 4, 16), _m(2, 40, 2, 16),
                                 _m(2, 40, 2, 16)),
                        functools.partial(ops.flash_attention, window=16),
                        functools.partial(ref.flash_attention, window=16)),
    "decode_attention": (lambda: (_m(3, 4, 16), _m(3, 48, 2, 16),
                                  _m(3, 48, 2, 16),
                                  _m(3, dtype=torch.int32)),
                         ops.decode_attention, ref.decode_attention),
    "decode_attention_state": (lambda: (_m(3, 4, 16), _m(3, 24, 2, 16),
                                        _m(3, 24, 2, 16),
                                        _m(3, dtype=torch.int32)),
                               lambda *a: ops.decode_attention_state(*a)[0],
                               lambda *a: ref.decode_attention_state(*a)[0]),
    "decode_attention_paged": (
        lambda: (_m(3, 4, 16), _m(9, 8, 2, 16), _m(9, 8, 2, 16),
                 _m(3, dtype=torch.int32), _m(3, 4, dtype=torch.int64)),
        ops.decode_attention_paged, ref.decode_attention_paged),
    "gram_blocked": (lambda: (_m(3, 50, 64),), ops.gram,
                     lambda x: ref.gram(x.reshape(-1, x.shape[-1]))),
}


@pytest.mark.parametrize("name", list(KERNEL_CALLS))
def test_kernel_flops_equal_their_plain_version_traced(name):
    """(5) What a wrapper reports equals what the counter traces through
    the plain version on the same operands; under the counter the wrapper
    runs nothing on meta and returns the plain version's shape."""
    make, wrapper, plain = KERNEL_CALLS[name]
    with OA.Counter() as c:
        out = wrapper(*make())
    assert c.per_op == {}            # nothing traced: the kernel reports
    assert set(c.kernels) == {name} and c.kernels[name]["calls"] == 1
    with OA.Counter() as p:
        want = plain(*make())
    assert p.kernels == {}
    assert c.kernels[name]["flops"] == p.flops > 0
    assert out.shape == want.shape
    assert c.kernels[name]["plain"] >= c.kernels[name]["resident"]


def test_resident_bytes_equal_a_hand_count():
    """(5) One low-rank linear and one flash call read their operands and
    write their output once: x (M, K), B (K, R), C (R, N), y (M, N); q, k,
    v, o."""
    M, K, R, N = 80, 64, 24, 96
    with OA.Counter(resident=True) as c:
        ops.lowrank_matmul(_m(M, K), _m(K, R), _m(R, N))
    assert c.bytes == 2 * (M * K + K * R + R * N + M * N)
    assert c.kernels["lowrank_matmul_2d"]["plain"] == \
        c.bytes + 2 * 2 * M * R                    # t written and read
    Bb, S, H, KV, hd = 2, 40, 4, 2, 16
    with OA.Counter(resident=True) as c:
        ops.flash_attention(_m(Bb, S, H, hd), _m(Bb, S, KV, hd),
                            _m(Bb, S, KV, hd))
    assert c.bytes == 2 * (2 * Bb * S * H * hd + 2 * Bb * S * KV * hd)
    k = c.kernels["flash_attention"]
    assert k["flops"] == 4 * Bb * H * S * S * hd
    assert k["flops_needed"] == 4 * Bb * H * (S * (S + 1) // 2) * hd


# ---------------------------------------------------------------------------
# device independence, collectives, the CLI
# ---------------------------------------------------------------------------
def test_counts_on_cpu_tensors_equal_counts_on_meta():
    """The same step counted on CPU tensors (the plain versions run, hidden)
    and on meta gives identical FLOPs and bytes."""
    cfg = get_config("llama-mini").replace(**LLAMA)
    got = {}
    for dev in ("cpu", "meta"):
        state, _ = TS.init_train_state(cfg, seed=0, device=dev)
        tok = torch.zeros((4, 32), dtype=torch.int32, device=dev)
        cache = T.init_cache(cfg, 4, 40, device=dev)
        step = TS.make_train_step(cfg, TS.TrainConfig())
        got[dev] = [(r["flops"], r["bytes"], r["per_op"], r["kernels"])
                    for r in (
            OA.count(lambda p, b: T.prefill(p, cfg, b, max_len=40),
                     state.params, {"tokens": tok}),
            OA.count(lambda p, c, t: T.decode_step(p, cfg, c, t),
                     state.params, cache, tok[:, :1]),
            OA.count(step, state, {"tokens": tok}))]
    assert got["cpu"] == got["meta"]


def test_data_parallel_step_counts_one_all_reduce_bucket():
    """At data = 2 the data-parallel step (``make_train_step(group=)``, the
    parameters whole on every rank) all-reduces one float32 bucket: every
    gradient, then the weighted loss, accuracy and token count."""
    cfg = get_config("llama-mini").replace(**LLAMA)
    state, _ = TS.init_train_state(cfg, device="meta")
    mesh = Mesh((2, 2), ("data", "model"), rank=0, build_groups=False)
    with comm.counting(4):
        group = mesh.group("data")
    s = TINY["tiny_train"]
    tok = torch.empty((s.global_batch // 2, s.seq_len), dtype=torch.int32,
                      device="meta")
    res = OA.count(TS.make_train_step(cfg, TS.TrainConfig(), group=group),
                   state, {"tokens": tok}, world=4)
    n = sum(t.numel() for t in pytree.tensors(state.params))
    assert res["collectives"]["per_op"] == {"all_reduce": 4 * (n + 3)}
    assert res["collectives"]["calls"] == {"all_reduce": 1}
    assert DR.roofline(res["flops"], res["bytes"],
                       res["collectives"]["total_bytes"], 1.0,
                       4)["collective_s"] == \
        4 * (n + 3) / DR.H100_SXM.link_bytes_per_s


# train cells on the production mesh at full width, cut to 2 layers (every
# leaf kind; a rank's blocks do not depend on the depth)
STATE_CELLS = ("smollm-360m", "qwen3-4b", GRANITE)


@pytest.mark.parametrize("arch", STATE_CELLS)
def test_train_cells_place_the_state_as_the_rules(arch):
    """A train cell's rank holds its block of every parameter and AdamW
    moment under the rules: the state's bytes as placed equal
    ``rule_state_bytes`` exactly (smollm's 15 heads and granite's vocab
    49155 replicated over ``model`` by the fallback, qwen3-4b's 8 kv heads
    replicated while its 32 q heads split), and the arguments equal the
    rules', the batch's sequence split over ``model`` too (sequence
    parallelism)."""
    mesh = make_production_mesh()
    res = DR.account_cell(arch, "train_4k", mesh,
                          overrides={"n_layers": 2})
    mem = res["memory"]
    assert mem["state_bytes"] == mem["rule_state_bytes"]
    s = TC.SHAPES["train_4k"]
    rows = s.global_batch // mesh.shape["data"]
    seq = s.seq_len
    per_row = seq * 4                                     # tokens, int32
    assert mem["argument_bytes"] == mem["rule_argument_bytes"]
    assert mem["argument_bytes"] - mem["state_bytes"] == \
        rows * per_row // mesh.shape["model"]
    # params, mu and nu in float32: a rank holds under 1/16 of them
    n = sum(t.numel() for t in pytree.tensors(T.init_model(
        get_config(arch).replace(n_layers=2), device="meta")[0]))
    assert 16 * mem["state_bytes"] < 12 * n


def test_train_4k_temporaries_under_sequence_parallelism():
    """SmolLM-360M's ``train_4k`` on (16, 16) at 2 layers: a rank's
    temporaries stay under 10e9 bytes (the attention's tiled backward
    holds (bq x bk) float32 tiles, never (S x T)), and replicating the
    sequence over ``model`` (``{"seq": ()}``) holds at least each layer
    boundary's residual rows again, the 15/16 of a (16, 4096, 960) bf16
    block that sequence parallelism leaves on the other ranks."""
    mesh = make_production_mesh()
    on = DR.account_cell("smollm-360m", "train_4k", mesh,
                         overrides={"n_layers": 2})["memory"]
    off = DR.account_cell("smollm-360m", "train_4k", mesh,
                          overrides={"n_layers": 2},
                          rules={"seq": ()})["memory"]
    cfg = get_config("smollm-360m")
    s = TC.SHAPES["train_4k"]
    rows = s.global_batch // mesh.shape["data"]
    boundary = rows * s.seq_len * cfg.d_model * 2         # bf16 residual
    assert on["temp_bytes"] < 10e9
    assert off["temp_bytes"] - on["temp_bytes"] >= \
        2 * boundary * (mesh.shape["model"] - 1) // mesh.shape["model"]


def test_a_factorized_train_cell_is_placed_by_its_own_specs():
    """A D-Rank-compressed model's train cell at (2, 2): the step's
    placement takes the factorized leaves' own specs (every B and C
    gathered whole on use), so the attention reads whole projections."""
    mesh = Mesh((2, 2), ("data", "model"), build_groups=False)
    res = DR.account_cell("smollm-360m", "train_4k", mesh,
                          overrides={"n_layers": 2}, compressed=0.2)
    mem = res["memory"]
    assert mem["state_bytes"] == mem["rule_state_bytes"]
    assert mem["argument_bytes"] == mem["rule_argument_bytes"]


def test_sharded_step_gathers_and_reduce_scatters_by_formula():
    """llama-mini's train cell at (data 2, model 2): each layer's
    data-split leaves gathered twice (the forward and the remat'd
    recompute), the leaves outside the runs once, and the loss's argmax
    across the vocab blocks (a float32 and an int64 (2, B, S)); each
    data-split leaf's gradient reduce-scattered once, to its block.
    Sequence parallelism adds the batch's tokens gathered over ``model``
    and, in place of each sub-block's all-reduce, an all-gather of its
    input A = (B, S, D) and a reduce-scatter of its output onto the rank's
    (B, S/2, D) rows: a layer's two sub-blocks gather twice forward
    (forward and recompute) and once backward (the exit's transpose), and
    reduce-scatter twice forward and once backward, but for the last
    exit, which the recompute does not reach (torch's checkpoint stops at
    the last tensor the backward needs); the embedding leaves and the
    logits enter the same way, once each."""
    res = port_cell("llama-mini", "train", mesh=(2, 2))
    cfg = get_config("llama-mini").replace(**LLAMA)
    params, specs = T.init_model(cfg, device="meta")
    mesh = Mesh((2, 2), ("data", "model"), rank=0, build_groups=False)
    pl = TS.placement(cfg, mesh)
    gathered = scattered = 0
    for path, t in pytree.flatten_with_path(params):
        keys = [k for _, k in path]
        spec = pl.spec_at(*keys)
        if not any(e == "data" for e in spec):
            continue
        model = 2 if "model" in spec else 1
        whole = t.numel() * 4 // model              # over data, float32
        scattered += whole // 2
        gathered += whole * (2 if keys[0] == "decoder" else 1)
    s = TINY["tiny_train"]
    gathered += 2 * (s.global_batch // 2) * s.seq_len * (4 + 8)
    L, A = cfg.n_layers, (s.global_batch // 2) * s.seq_len * cfg.d_model * 4
    gathered += (s.global_batch // 2) * s.seq_len * 4 + (6 * L + 2) * A
    scattered += (5 * L + 2) * A // 2
    per_op = res["collectives"]["per_op"]
    assert per_op["all_gather"] == gathered
    assert per_op["reduce_scatter"] == scattered


def test_expert_parallel_decode_counts_its_all_to_alls():
    """Granite at model = 2 holds half the experts a rank. Each MoE layer
    sends its rows and their routing metadata by all_to_all and takes the
    rows back the same way, then broadcasts the output and the aux loss
    (model rank 0's, as JAX returns device 0's). The sharded decode step
    around it: each layer's q, k, v and o projections all-gathered whole
    over ``model`` and the decode attention's float32 states (acc, m, l
    of every head) all-gathered over the cache's two row blocks; the
    vocab-parallel embedding's rows summed over ``model`` and the logits
    all-gathered over it."""
    from repro_torch.models.mlp import capacity
    res = port_cell(GRANITE, "decode", mesh=(1, 2))
    cfg = get_config(GRANITE).replace(**_tiny(GRANITE)[1])
    m, D, es = cfg.moe, cfg.d_model, 4                  # float32
    rows = TINY["tiny_decode"].global_batch              # data = 1
    cap1 = capacity(rows * m.top_k, 2, m.capacity_factor)
    a2a = 2 * cap1 * (2 * D + 2) * es
    H, hd = cfg.n_heads, cfg.head_dim
    attn = 2 * D * (cfg.q_dim + cfg.kv_dim) * es         # wq wk wv wo
    state = 2 * rows * H * (hd + 2) * es
    assert res["placed"]
    assert res["collectives"]["per_op"] == {
        "all_to_all": cfg.n_layers * a2a,
        "broadcast": cfg.n_layers * (rows * D * es + es),
        "all_gather": (cfg.n_layers * (attn + state)
                       + rows * cfg.vocab_size * es),
        "all_reduce": rows * D * es}
    with comm.counting(2) as cnt:
        mesh = Mesh((1, 2), ("data", "model"), rank=0, build_groups=False)
        assert isinstance(mesh.group("model"), comm.CountedGroup)
    assert cnt.calls == {}


# serving cells on the production mesh (16, 16), on meta: what a rank
# places, the rules' bytes exactly, and whether the cell fits an H100
SERVE_CELLS = {("smollm-360m", "decode_32k"): (695422784, True),
               ("smollm-360m", "prefill_32k"): (24350464, True),
               ("qwen2-vl-72b", "decode_32k"): (6510190656, True)}


@pytest.mark.parametrize("arch,shape", list(SERVE_CELLS))
def test_serving_cells_place_the_rules_bytes(arch, shape):
    """A prefill or decode cell runs the sharded serving step: the rank's
    blocks of the parameters, the batch and the cache are the rules'
    (``argument_bytes == rule_argument_bytes``), to the byte; qwen2-vl-72b's
    decode, whose parameters alone exceed a card, now fits one."""
    want, fits = SERVE_CELLS[(arch, shape)]
    res = DR.account_cell(arch, shape, make_production_mesh())
    mem = res["memory"]
    assert res["placed"]
    assert mem["argument_bytes"] == mem["rule_argument_bytes"] == want
    assert res["fits"] is fits


# the recurrent and encoder-decoder families' serving cells at 2 layers
RECURRENT_CELLS = [(a, s) for a in ("hymba-1.5b", "xlstm-350m",
                                    "seamless-m4t-medium")
                   for s, sh in TC.SHAPES.items() if sh.mode != "train"
                   and TC.shape_applicable(get_config(a), sh)[0]]


@pytest.mark.parametrize("arch,shape", RECURRENT_CELLS)
def test_recurrent_serving_cells_place_the_rules_bytes(arch, shape):
    """The recurrent and encoder-decoder families serve under a placement
    too: the rank's blocks of the parameters (the ``ssm_inner`` leaves
    split over ``model``), the batch and the cache (a state's heads split
    where ``model`` divides them, ``cross_kv``'s encoder rows split) are
    the rules', to the byte."""
    cell = DR.account_cell(arch, shape, make_production_mesh(),
                           overrides={"n_layers": 2})
    mem = cell["memory"]
    assert cell["placed"]
    assert mem["argument_bytes"] == mem["rule_argument_bytes"], \
        (arch, shape)


# ---------------------------------------------------------------------------
# (6): per-rank bytes under the sharding rules, against JAX's shard shapes
# ---------------------------------------------------------------------------
RULE_CELLS = [("llama-mini", "train"), ("llama-mini", "prefill"),
              ("llama-mini", "decode"), (GRANITE, "decode")]
_JAX_SIDE = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.dist import sharding as SH
from repro.launch import hlo_analysis as HA
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as T
from repro.optim.adamw import OptimizerConfig, adamw_init
from repro.train import step as TS
CELLS, COMPILES, LLAMA, B, S = {cells}, {compiles}, {llama}, {batch}, {seq}
CACHE_AXES = {{5: ("layer_stack", "batch", "kv_seq_model", None, None),
               4: ("layer_stack", "batch", None, None),
               3: ("layer_stack", "batch", None), 2: ("layer_stack", "batch")}}
mesh = make_host_mesh(2, 2)

def nbytes(shape, dtype, axes):
    spec = SH.shape_aware_spec(tuple(shape), axes, mesh)
    sh = jax.sharding.NamedSharding(mesh, spec).shard_shape(tuple(shape))
    return int(np.prod(sh)) * np.dtype(dtype).itemsize

def shapes(arch):
    cfg = (get_config(arch).replace(**LLAMA) if arch == "llama-mini"
           else get_config(arch).reduced())
    holder = {{}}
    def _init(k):
        p, s = T.init_model(cfg, k)
        holder["s"] = s
        return p
    return cfg, jax.eval_shape(_init, jax.random.PRNGKey(0)), holder["s"]

# single-device compiles of each tiny cell, as lower_cell builds them
sds = lambda s, d: jax.ShapeDtypeStruct(s, jnp.dtype(d))
cells = {{}}
for arch, mode in COMPILES:
    cfg, ps, _ = shapes(arch)
    tok = sds((B, S), jnp.int32)
    if mode == "prefill":
        lowered = jax.jit(lambda p, b: T.prefill(
            p, cfg, b, max_len=S + 128)).lower(ps, {{"tokens": tok}})
    elif mode == "decode":
        cache = jax.eval_shape(lambda: T.init_cache(cfg, B, S, enc_len=S))
        lowered = jax.jit(lambda p, c, t: T.decode_step(
            p, cfg, c, t)).lower(ps, cache, sds((B, 1), jnp.int32))
    else:
        st = jax.eval_shape(lambda p: TS.TrainState(
            params=p, opt=adamw_init(p)), ps)
        lowered = jax.jit(TS.make_train_step(cfg, TS.TrainConfig(
            optimizer=OptimizerConfig(total_steps=10 ** 5)))).lower(
                st, {{"tokens": tok}})
    compiled = lowered.compile()
    cells[arch + "/" + mode] = (
        HA.analyze(compiled.as_text())["flops"],
        compiled.memory_analysis().argument_size_in_bytes)

out = {{}}
for arch, mode in CELLS:
    cfg, ps, specs = shapes(arch)
    holder = {{"s": specs}}
    with SH.use_rules({{}}, mesh=mesh):
        shs = SH.shardings_for_tree(ps, holder["s"], mesh)
        leaves = list(zip(jax.tree.leaves(ps), jax.tree.leaves(shs)))
        total = sum(int(np.prod(s.shard_shape(tuple(l.shape))))
                    * np.dtype(l.dtype).itemsize for l, s in leaves)
        if mode == "train":
            total += 4 + 2 * sum(int(np.prod(s.shard_shape(tuple(l.shape))))
                                 * 4 for l, s in leaves)
        if mode in ("train", "prefill"):
            total += nbytes((B, S), np.int32, ("batch", "seq"))
        else:
            cache = jax.eval_shape(lambda: T.init_cache(cfg, B, S, enc_len=S))
            for l in jax.tree.leaves(cache):
                nd = len(l.shape)
                axes = (("batch",) if nd == 1 else CACHE_AXES.get(
                    nd, ("layer_stack", "batch") + (None,) * (nd - 2)))
                total += nbytes(l.shape, l.dtype, axes)
            total += nbytes((B, 1), np.int32, ("batch", None))
    out[arch + "/" + mode] = total
print(json.dumps({{"cells": cells, "rule_bytes": out}}))
"""


_PROC = {}


@pytest.fixture(scope="module", autouse=True)
def jax_procs():
    """JAX's side in two subprocesses with four host devices (one a model),
    started with the module's first test and running beside the port's
    counts: the single-device compiles of the tiny cells ((3), (4)) and the
    shard shapes on a (2, 2) mesh ((6))."""
    s = TINY["tiny_train"]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    for arch in ("llama-mini", GRANITE):
        code = _JAX_SIDE.format(
            cells=[c for c in RULE_CELLS if c[0] == arch], llama=LLAMA,
            compiles=[(arch, m) for m in MODES], batch=s.global_batch,
            seq=s.seq_len)
        _PROC[arch] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    yield
    for proc in list(_PROC.values()):
        if isinstance(proc, subprocess.Popen) and proc.poll() is None:
            proc.kill()
            proc.wait()
    _PROC.clear()


def jax_results() -> dict:
    if "out" not in _PROC:
        merged = {"cells": {}, "rule_bytes": {}}
        for arch in ("llama-mini", GRANITE):
            proc = _PROC[arch]
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got = json.loads(out.strip().splitlines()[-1])
            for k in merged:
                merged[k].update(got[k])
        _PROC["out"] = merged
    return _PROC["out"]


def test_cli_writes_a_cell_json(tmp_path, monkeypatch):
    """(7) ``main`` writes one JSON per cell with the dry-run's keys, and
    allocates nothing on a device (meta tensors only)."""
    monkeypatch.setattr(DR, "RESULT_DIR", str(tmp_path))
    assert DR.main(["--mesh", "single", "--arch", "smollm-360m",
                    "--shape", "decode_32k", "--resident"]) == 0
    res = json.loads((tmp_path / "single"
                      / "smollm-360m__decode_32k.json").read_text())
    for key in ("arch", "shape", "mesh", "mesh_axes", "devices", "mode",
                "compressed", "microbatches", "resident", "count_s",
                "model_flops", "fits"):
        assert key in res, key
    assert res["mesh"] == [16, 16] and res["devices"] == 256
    assert set(res["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "rule_argument_bytes"}
    assert set(res["cost"]) == {"counted_flops", "counted_bytes"}
    assert set(res["collectives"]) == {"total_bytes", "per_op"}
    assert set(res["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s", "useful_flops_ratio",
                                    "dominant"}
    assert res["memory"]["rule_argument_bytes"] == \
        res["memory"]["argument_bytes"]
    assert res["placed"]
    assert not torch.cuda.is_available() or \
        torch.cuda.memory_allocated() == 0


# ---------------------------------------------------------------------------
# (3, 4): against JAX's compiles (last: the subprocess runs meanwhile)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,mode", [(a, m) for a in ("llama-mini",
                                                        GRANITE)
                                       for m in MODES])
def test_counted_flops_match_jax_hlo(arch, mode):
    """(3) Prefill and decode within 1e-6 relative of JAX's analyzer; the
    train step within 1e-6 once the flash backward's recompute of its
    forward (one QKᵀ and PV a layer) is taken off, and that recompute is
    the whole difference."""
    want, _ = jax_results()["cells"][f"{arch}/{mode}"]
    res = port_cell(arch, mode)
    got = res["cost"]["counted_flops"]
    if mode == "train":
        extra = flash_backward_recompute(arch)
        assert abs(got - extra - want) <= 1e-6 * want, (got, extra, want)
        assert extra / want < 0.03           # 2.3% (llama), 1.5% (granite)
    else:
        assert abs(got - want) <= 1e-6 * want, (got, want)


@pytest.mark.parametrize("mode", MODES)
def test_argument_bytes_match_jax_memory_analysis(mode):
    """(4) The step's arguments: params (and AdamW state), batch, cache."""
    _, want = jax_results()["cells"][f"llama-mini/{mode}"]
    res = port_cell("llama-mini", mode)
    assert res["memory"]["argument_bytes"] == want
    assert res["memory"]["rule_argument_bytes"] == want    # one device
    assert res["memory"]["peak_bytes"] >= want
    assert res["fits"]


def test_rule_argument_bytes_match_jax_shard_shapes():
    """(6) On (data 2, model 2): params (and AdamW state), batch and cache
    under the sharding rules, summed per device as JAX's
    ``NamedSharding.shard_shape`` gives them."""
    want = jax_results()["rule_bytes"]
    for arch, mode in RULE_CELLS:
        res = port_cell(arch, mode, mesh=(2, 2))
        assert res["memory"]["rule_argument_bytes"] == \
            want[arch + "/" + mode], (arch, mode)
        # prefill and decode hold the rules' blocks of the parameters,
        # the batch and the cache; a train cell the rules' blocks of the
        # state and of the batch (its sequence over model too)
        if mode != "train":
            assert res["placed"]
        assert res["memory"]["argument_bytes"] == \
            res["memory"]["rule_argument_bytes"], (arch, mode)
