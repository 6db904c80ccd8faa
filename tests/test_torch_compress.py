"""The port's calibration and host compression path against the JAX
package's, on the same bridged weights and calibration batches.

Tiers (DESIGN.md §1.3, §1.5): eager Grams within 1e-4 relative; identical
integer ranks for every group; σ heads within 1e-5 relative; rank-k factors
(the B·C product, which is free of the SVD's sign choice) within 1e-4
relative."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import capture as JCap
from repro.core import compress as JC
from repro.models import transformer as JT
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.core import capture as Cap
from repro_torch.core import compress as CC
from repro_torch.models import transformer as T
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

GRAM_TOL = 1e-4
SIG_TOL = 1e-5
FACTOR_TOL = 1e-4
CPU = torch.device("cpu")

# n_layers = 3 with group_size = 2 leaves a ragged final group (n = 1)
_KW = dict(n_layers=3, d_model=64, n_heads=4, head_dim=16, d_ff=128,
           vocab_size=256, rank_multiple=4, dtype="float32")
ARCHS = {
    "mha": ("llama-mini", dict(_KW, n_kv_heads=4)),
    "gqa3": ("smollm-360m", dict(_KW, n_heads=6, n_kv_heads=2)),
}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(cfg, JAX cfg, JAX params, bridged params, JAX batches, port
    batches), built once per arch; nothing below mutates them."""
    name, kw = ARCHS[arch]
    cfg = get_config(name).replace(**kw)
    jcfg = jget_config(name).replace(**kw)
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
            for _ in range(2)]
    return (cfg, jcfg, jp, tp, [{"tokens": jnp.asarray(t)} for t in toks],
            [{"tokens": torch.as_tensor(t)} for t in toks])


@functools.lru_cache(maxsize=None)
def _collectors(arch):
    """The eager calibration of both packages on the same batches."""
    cfg, jcfg, jp, tp, jcal, tcal = _setup(arch)
    jcol = JC.calibrate(JCap.to_list_params(jp, jcfg), jcfg, jcal,
                        streaming=False)
    tcol = CC.calibrate(Cap.to_list_params(tp, cfg), cfg, tcal,
                        streaming=False)
    return jcol, tcol


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


_MTYPE_PATH = {"q": ("attn", "wq"), "k": ("attn", "wk"),
               "v": ("attn", "wv"), "o": ("attn", "wo"),
               "gate": ("mlp", "w_gate"), "up": ("mlp", "w_up"),
               "down": ("mlp", "w_down")}


def _factors(lp, path):
    node = lp
    for k in path:
        node = node[k]
    B, C = node["B"], node["C"]
    if isinstance(B, torch.Tensor):
        return B.double().numpy(), C.double().numpy()
    return np.asarray(B, np.float64), np.asarray(C, np.float64)


def test_eager_grams_match_collector():
    jcol, tcol = _collectors("gqa3")
    assert sorted(tcol.gram) == sorted(jcol.gram)
    for tag, g in jcol.gram.items():
        assert tcol.gram[tag].dtype == np.float64
        assert _rel(tcol.gram[tag], g) < GRAM_TOL, tag
        assert _rel(tcol.mean_abs(tag), jcol.mean_abs(tag)) < GRAM_TOL, tag
        assert tcol.count[tag] == jcol.count[tag]


@pytest.mark.parametrize("arch,method", [
    ("mha", "drank"), ("gqa3", "drank"), ("mha", "svdllm"), ("mha", "svd"),
    ("mha", "basis"), ("mha", "asvd"), ("gqa3", "dranke"),
])
def test_plan_and_factors_match_jax(arch, method):
    cfg, jcfg, jp, tp, jcal, tcal = _setup(arch)
    jcol, tcol = _collectors(arch)
    ccfg = CC.CompressionConfig(method=method, ratio=0.3)
    jccfg = JC.CompressionConfig(method=method, ratio=0.3)
    tlp, plan = CC.build_plan_and_params(tp, cfg, ccfg, tcal,
                                         collector=tcol, streaming=False)
    jlp, jplan = JC.build_plan_and_params(jp, jcfg, jccfg, jcal,
                                          collector=jcol, streaming=False)
    assert [g.gid for g in plan.groups] == [g.gid for g in jplan.groups]
    if arch == "gqa3" and method.startswith("drank"):
        assert all(g.n == 1 for g in plan.groups)      # GQA n = 1 policy
    for g, jg in zip(plan.groups, jplan.groups):
        assert g.k == jg.k, (g.gid, g.k, jg.k)          # identical ranks
        assert g.kmax == jg.kmax and g.layers == jg.layers
        assert _rel(g.sigma_head, jg.sigma_head) < SIG_TOL, g.gid
    assert plan.summary == pytest.approx(jplan.summary, rel=1e-6)
    for gr in plan.groups:
        run, layer = "run0", gr.layers[0]
        sub, name = _MTYPE_PATH[gr.mtype]
        path = ("decoder", run, layer, sub, name)
        B, C = _factors(tlp, path)
        jB, jC = _factors(jlp, path)
        assert B.shape == jB.shape and C.shape == jC.shape
        assert _rel(B @ C, jB @ jC) < FACTOR_TOL, gr.gid
    # members of one group share their basis tensor, as in JAX
    if method == "drank" and arch == "mha":
        wq = [tlp["decoder"]["run0"][i]["attn"]["wq"]["B"] for i in (0, 1)]
        assert wq[0] is wq[1]
    # the plan serializes the same way
    assert CC.Plan.from_json(plan.to_json()).to_json() == plan.to_json()


def test_compressed_params_run_on_the_port():
    """The port's whole path: calibration inside build_plan_and_params."""
    cfg, _, _, tp, _, tcal = _setup("gqa3")
    lp, plan = CC.build_plan_and_params(
        tp, cfg, CC.CompressionConfig(method="drank", ratio=0.3), tcal,
        streaming=False)
    assert 0.25 < plan.summary["achieved_ratio"] < 0.35
    logits, _ = T.forward(lp, cfg, tcal[0])
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_fisher_rows_match_jax():
    cfg, jcfg, jp, tp, jcal, tcal = _setup("mha")
    want = JC.fisher_rows(JCap.to_list_params(jp, jcfg), jcfg, jcal)
    got = CC.fisher_rows(Cap.to_list_params(tp, cfg), cfg, tcal)
    assert sorted(got) == sorted(want) and len(got) == 7 * 3
    for tag, f in want.items():
        assert got[tag].dtype == np.float64 and got[tag].shape == f.shape
        assert _rel(got[tag], f) < 1e-4, tag
    # the stacked params are left as they were: no grads, no copies
    assert all(not t.requires_grad for t in pytree.tensors(tp))


@functools.lru_cache(maxsize=None)
def _jax_fwsvd():
    """The JAX host fwsvd plan (its Fisher pass runs eagerly: built once)."""
    _, jcfg, jp, _, jcal, _ = _setup("mha")
    return JC.build_plan_and_params(
        jp, jcfg, JC.CompressionConfig(method="fwsvd", ratio=0.3), jcal,
        collector=_collectors("mha")[0], streaming=False)


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_fwsvd_plan_matches_jax(device):
    """fwsvd (once refused as needing the backward pass): the Fisher pass
    inside ``build_plan_and_params``, then the host oracle or the device
    decomposition's diag mode, against the JAX host plan."""
    cfg, _, _, tp, _, tcal = _setup("mha")
    tlp, plan = CC.build_plan_and_params(
        tp, cfg, CC.CompressionConfig(method="fwsvd", ratio=0.3), tcal,
        collector=_collectors("mha")[1], streaming=False, device=device)
    jlp, jplan = _jax_fwsvd()
    assert [(g.gid, g.k, g.n) for g in plan.groups] == \
        [(g.gid, g.k, g.n) for g in jplan.groups]
    for g, jg in zip(plan.groups, jplan.groups):
        assert _rel(g.sigma_head, jg.sigma_head) < SIG_TOL, g.gid
        sub, name = _MTYPE_PATH[g.mtype]
        path = ("decoder", "run0", g.layers[0], sub, name)
        B, C = _factors(tlp, path)
        jB, jC = _factors(jlp, path)
        assert _rel(B @ C, jB @ jC) < FACTOR_TOL, g.gid


@pytest.mark.parametrize("kw,exc,match", [
    (dict(streaming=True, mesh=object()), TypeError, "launch.mesh.Mesh"),
    (dict(streaming=False, device=True, mesh=object()), TypeError,
     "launch.mesh.Mesh"),
    (dict(streaming=False, mesh="production"), ValueError, "shapes-only"),
])
def test_unported_options_raise(kw, exc, match):
    """The mesh paths are ported (see tests/test_torch_mesh_calib.py); what
    they refuse is a mesh that is not the port's, and a shapes-only mesh
    (no process group to run on)."""
    from repro_torch.launch.mesh import make_production_mesh
    if kw.get("mesh") == "production":
        kw = dict(kw, mesh=make_production_mesh())
    cfg = get_config("llama-mini").replace(**dict(_KW, n_kv_heads=4))
    tp, _ = T.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(exc, match=match):
        CC.build_plan_and_params(tp, cfg, CC.CompressionConfig(), [], **kw)
