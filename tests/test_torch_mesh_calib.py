"""The port's mesh calibration and the spread device decomposition, at
data = 4 over a gloo process group on the CPU, against the JAX package:
the twin of ``tests/mesh_parity_main.py`` checks [1]-[4], on its config.

The ranks (``tests/torch_mesh_ranks.py``, job ``calib``) run once for the
module; the JAX side runs here in one process, single-device (its own
suite holds its mesh to that at 1e-6). Tiers: a tree-reduced factor within
1e-6 of the port's single-shard chain after the sign fix, and its RᵀR
within 1e-4 of JAX's fp64 oracle Gram (the Gram tier); sharded against
replicated accumulators 1e-5 and against the oracle 1e-4; flush cadence
1e-6; identical integer ranks; for the spread decomposition on the same
Grams, σ 1e-5 and B·C 1e-4 of the single-process one."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.configs import get_config as jget_config
from repro.core import capture as JCap
from repro.core import compress as JC
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import capture as Cap
from repro_torch.core import compress as CC
from repro_torch.serve import api
from repro_torch.serve.engine import Engine, ServeConfig
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

CPU = torch.device("cpu")
KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
          d_ff=128, vocab_size=256, rank_multiple=4, dtype="float32")
CCFG = dict(method="drank", ratio=0.3, group_size=2, beta=0.3)
REL_BAR = 1e-6


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def sign_fix(R_):
    R_ = np.asarray(R_, dtype=np.float64)
    s = np.sign(np.diag(R_)).copy()
    s[s == 0] = 1.0
    return s[:, None] * R_


@functools.lru_cache(maxsize=None)
def setup():
    cfg = get_config("llama-mini").replace(**KW)
    jcfg = jget_config("llama-mini").replace(**KW)
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, cfg.vocab_size, (8, 32), dtype=np.int32)
            for _ in range(3)]
    jbs = [{"tokens": jnp.asarray(t)} for t in toks]
    tbs = [{"tokens": torch.as_tensor(t)} for t in toks]
    return cfg, jcfg, jp, tp, jbs, tbs


@functools.lru_cache(maxsize=None)
def jax_side():
    cfg, jcfg, jp, tp, jbs, tbs = setup()
    jlp = JCap.to_list_params(jp, jcfg)
    oracle = JC.calibrate(jlp, jcfg, jbs, streaming=False)
    chain = JCap.streaming_calibrate(jlp, jcfg, jbs, whiten_tags=True)
    _, plan_o = JC.build_plan_and_params(jp, jcfg, JC.CompressionConfig(
        **CCFG), jbs, collector=oracle)
    return oracle, chain, plan_o


@functools.lru_cache(maxsize=None)
def port_single():
    """The port on one process: the single-shard chain, the streaming
    Grams, the eager oracle and the device plans from them."""
    cfg, jcfg, jp, tp, jbs, tbs = setup()
    lp = Cap.to_list_params(tp, cfg)
    chain = Cap.streaming_calibrate(lp, cfg, tbs, whiten_tags=True)
    ref = Cap.streaming_calibrate(lp, cfg, tbs)
    eager = CC.calibrate(lp, cfg, tbs, streaming=False)
    ccfg = CC.CompressionConfig(**CCFG)
    comp_d, plan_d = CC.build_plan_and_params(tp, cfg, ccfg, tbs,
                                              collector=ref, device=True)
    comp_o, plan_o = CC.build_plan_and_params(tp, cfg, ccfg, tbs,
                                              collector=eager)
    return chain, ref, comp_d, plan_d, comp_o, plan_o


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg, jcfg, jp, tp, jbs, tbs = setup()
    chain, ref, *_ = port_single()
    lp = Cap.to_list_params(tp, cfg)
    serve = dict(arch="llama-mini", compress="drank", ratio=0.2,
                 device_compress=True, calib_samples=8, calib_seq=16,
                 batch=2, max_len=32, requests=2, prompt_len=5, n_new=3)
    inp = dict(cfg=cfg, lp=lp, params=tp, batches=tbs, ccfg=CCFG,
               tags=sorted(ref.gram), ref_col=ref, serve=serve)
    return R.run("calib", str(tmp_path_factory.mktemp("calib")), inp)


def _plan(js):
    return json.loads(js)


def _ranks_of(plan):
    if isinstance(plan, str):
        plan = _plan(plan)
    if isinstance(plan, dict):
        return {g["gid"]: g["k"] for g in plan["groups"]}
    return {g.gid: g.k for g in plan.groups}


def test_tree_reduced_factor_matches_the_single_shard_chain(ranks):
    """[1] per-shard factors tree-reduced at finalize."""
    oracle, jchain, _ = jax_side()
    chain = port_single()[0]
    col = ranks[0]["col_w"]
    assert set(col.chol) == set(chain.chol) == set(jchain.chol)
    assert not col.gram
    worst_r = worst_j = worst_g = 0.0
    for tag in chain.chol:
        worst_r = max(worst_r, rel(sign_fix(col.chol[tag]),
                                   sign_fix(chain.chol[tag])))
        worst_j = max(worst_j, rel(sign_fix(col.chol[tag]),
                                   sign_fix(jchain.chol[tag])))
        worst_g = max(worst_g, rel(col.chol[tag].T @ col.chol[tag],
                                   oracle.gram[tag]))
        for r in ranks[1:]:
            assert np.array_equal(r["col_w"].chol[tag], col.chol[tag])
    assert worst_r <= REL_BAR, worst_r
    assert worst_g <= 1e-4, worst_g
    assert worst_j <= 1e-4, worst_j


def test_sharded_accumulators_hold_row_blocks_and_flush_equal(ranks):
    """[2] every tag row-sharded: each rank holds (D/4, D), never (D, D);
    the flushed Grams equal the replicated route's and the oracle's."""
    oracle = jax_side()[0]
    for r in ranks:
        assert set(r["routes"].values()) == {"sharded"}
        for tag, shape in r["acc_shapes"].items():
            d = oracle.gram[tag].shape[0]
            assert shape == (d // R.WORLD, d), (tag, shape)
    col_sh, col_rep = ranks[0]["col_sh"], ranks[0]["col_rep"]
    worst = worst_o = 0.0
    for tag in oracle.gram:
        worst = max(worst, rel(col_sh.gram[tag], col_rep.gram[tag]))
        worst_o = max(worst_o, rel(col_sh.gram[tag], oracle.gram[tag]))
        assert col_sh.count[tag] == oracle.count[tag]
        assert rel(col_sh.absmean[tag], oracle.absmean[tag]) <= 1e-4
        for r in ranks[1:]:
            assert np.array_equal(r["col_sh"].gram[tag], col_sh.gram[tag])
    assert worst <= 1e-5, worst
    assert worst_o <= 1e-4, worst_o


def test_flush_cadence_does_not_change_sharded_sums(ranks):
    """[3] flush_every = 1 against one flush at the end."""
    a, b = ranks[0]["col_f1"], ranks[0]["col_sh"]
    assert max(rel(a.gram[t], b.gram[t]) for t in a.gram) <= REL_BAR


def test_mesh_captured_plan_has_identical_ranks_and_tokens(ranks):
    """[4] a sharded + whitened mesh capture: the ranks of JAX's plan from
    its fp64 oracle, and the tokens of the port's own oracle plan."""
    _, _, jplan_o = jax_side()
    *_, comp_o, plan_o = port_single()
    cfg = setup()[0]
    want = _ranks_of(jplan_o)
    assert _ranks_of(plan_o) == want
    for r in ranks:
        assert _ranks_of(r["plan_m"]) == want
    prompts = np.arange(24, dtype=np.int32).reshape(2, 12) % cfg.vocab_size
    scfg = ServeConfig()
    out_o = Engine(comp_o, cfg, scfg, device="cpu").generate(prompts,
                                                             n_new=12)
    out_m = Engine(ranks[0]["comp_m"], cfg, scfg, device="cpu").generate(
        prompts, n_new=12)
    assert np.array_equal(np.asarray(out_o), np.asarray(out_m))


def _bc(comp, gid_layers, mtype):
    sub, name = {"q": ("attn", "wq"), "k": ("attn", "wk"),
                 "v": ("attn", "wv"), "o": ("attn", "wo"),
                 "gate": ("mlp", "w_gate"), "up": ("mlp", "w_up"),
                 "down": ("mlp", "w_down")}[mtype]
    node = comp["decoder"]["run0"][gid_layers[0]][sub][name]
    return (node["B"].double() @ node["C"].double()).numpy()


def test_spread_device_decomposition_matches_one_process(ranks):
    """Each rank decomposed its share of every bucket; the gathered plan
    equals the single-process device plan on the same Grams, on every
    rank."""
    _, _, comp_d, plan_d, _, _ = port_single()
    want = _ranks_of(plan_d)
    sig = {g.gid: g.sigma_head for g in plan_d.groups}
    for r in ranks:
        got = _plan(r["plan_d"])
        assert _ranks_of(got) == want
        for g in got["groups"]:
            assert rel(g["sigma_head"], sig[g["gid"]]) <= 1e-5, g["gid"]
            assert rel(_bc(r["comp_d"], g["layers"], g["mtype"]),
                       _bc(comp_d, g["layers"], g["mtype"])) <= 1e-4
    for g in _plan(ranks[0]["plan_d"])["groups"]:
        for r in ranks[1:]:
            assert np.array_equal(
                _bc(r["comp_d"], g["layers"], g["mtype"]),
                _bc(ranks[0]["comp_d"], g["layers"], g["mtype"]))


def test_mesh_refine_path_keeps_the_ranks(ranks):
    """calibrate + spread decomposition + spread refine, all on the mesh:
    the single-process ranks, on every rank."""
    want = _ranks_of(port_single()[3])
    for r in ranks:
        assert _ranks_of(r["plan_r"]) == want


def test_mesh_calibration_keeps_jaxs_errors(ranks):
    """Data axes the mesh lacks, and a batch whose rows do not split over
    the data shards, raise as JAX's StreamingCalibrator does."""
    for r in ranks:
        assert "share nothing with data_axes" in r["no_axes"]
        assert "does not split over 4 data shards" in r["bad_split"]


def test_calib_mesh_shards_runs_under_its_world_and_refuses_another(ranks):
    rep = ranks[0]["report"]
    assert rep["drain_status"] == "drained"
    assert rep["world"] == R.WORLD
    assert rep["comm"]["backend"] == "gloo"
    assert rep["comm"]["transport"] == "host"
    for r in ranks:
        assert "torchrun" in r["wrong_world"]
        assert "one of 4" in r["wrong_world"]
    with pytest.raises(ValueError, match="torchrun"):
        api.load_engine(api.ServeOptions(arch="llama-mini", compress="drank",
                                         calib_mesh_shards=2), device="cpu")
