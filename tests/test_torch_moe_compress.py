"""D-Rank on Mixture-of-Experts models: the port against the JAX package,
on the CPU, on granite-moe-1b-a400m reduced (weights bridged through
numpy).

Expert capture (tags, Grams, Σ|x|, counts; the eager and the streaming
capture) within 1e-4 of JAX's ``Collector``; ``build_plan_and_params``
on the host and the device paths: ranks identical to JAX's, the expert
factors restacked to (E, d, rmax) / (E, rmax, f) with zero rank padding,
every expert's B·C within 1e-4 of JAX's; the device decomposition in
chunks giving the whole bucket's results; ``pytree_v1`` MoE artifacts
booting across the packages; the port's ``ContinuousBatcher`` on a
compressed MoE model against JAX's, contiguous, paged and with the
elastic rank ladder (which slices the expert stacks' rank axis); and
``integerize`` giving JAX's ranks exactly on seeded spec sets, and
meeting its budget and bounds on a 1200-group granite-shaped set."""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import allocate as jalloc
from repro.core import capture as JCap
from repro.core import compress as JC
from repro.core.groups import BETA_MAP as JBETA_MAP
from repro.models import transformer as JT
from repro.serve import admission as jadm
from repro.serve import engine as JE
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import allocate as alloc
from repro_torch.core import capture as C
from repro_torch.core import compress as CC
from repro_torch.core.groups import BETA_MAP
from repro_torch.models import transformer as T
from repro_torch.serve import admission as adm
from repro_torch.serve import engine as E
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCH = "granite-moe-1b-a400m"
JCFG = jget_config(ARCH).reduced()
CFG = get_config(ARCH).reduced()
CCFG = dict(ratio=0.3)


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def calib_tokens():
    rng = np.random.default_rng(1)
    return [rng.integers(0, CFG.vocab_size, (2, 16), dtype=np.int32)
            for _ in range(2)]


@functools.lru_cache(maxsize=None)
def shared():
    """(JAX params, port params, JAX eager Collector, JAX D-Rank params and
    plan): one JAX model and one JAX compression for the module."""
    jp, _ = JT.init_model(JCFG, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    jbatches = [{"tokens": jnp.asarray(t)} for t in calib_tokens()]
    jcol = JC.calibrate(JCap.to_list_params(jp, JCFG), JCFG, jbatches,
                        streaming=False)
    jcomp, jplan = JC.build_plan_and_params(
        jp, JCFG, JC.CompressionConfig(**CCFG), jbatches, collector=jcol,
        streaming=False)
    return jp, tp, jcol, jcomp, jplan


def port_batches():
    return [{"tokens": torch.as_tensor(t)} for t in calib_tokens()]


# ---------------------------------------------------------------------------
# expert capture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("streaming", [False, True],
                         ids=["eager", "streaming"])
def test_expert_capture_matches_jax(streaming):
    _, tp, jcol, _, _ = shared()
    col = CC.calibrate(C.to_list_params(tp, CFG), CFG, port_batches(),
                       streaming=streaming, flush_every=1)
    assert sorted(col.gram) == sorted(jcol.gram)
    experts = [t for t in jcol.gram if "/expert" in t]
    E_ = CFG.moe.padded_experts
    assert len(experts) == CFG.n_layers * 2 * E_
    for tag in jcol.gram:
        assert rel(col.gram[tag], jcol.gram[tag]) <= 1e-4, tag
        assert rel(col.absmean[tag], jcol.absmean[tag]) <= 1e-4, tag
        assert col.count[tag] == jcol.count[tag], tag
    # an expert's rows are its capacity, zero rows included
    cap = jcol.count[experts[0]] // 2
    assert all(jcol.count[t] == 2 * cap for t in experts)


def test_tag_linears_tags_routed_expert_subtrees():
    _, tp, _, _, _ = shared()
    tagged = C.tag_linears(C.to_list_params(tp, CFG))
    moe = tagged["decoder"]["run0"][1]["moe"]
    assert moe["_tag"] == "decoder/run0/1/moe"
    assert moe["router"]["_tag"] == "decoder/run0/1/moe/router"
    dims = C.discover_capture_dims(tagged, CFG, port_batches()[0])
    assert dims["decoder/run0/1/moe/in/expert3"] == CFG.d_model
    assert dims["decoder/run0/1/moe/mid/expert3"] == CFG.moe.d_expert


# ---------------------------------------------------------------------------
# the plan and the restacked factors
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def port_plan(device: bool):
    _, tp, _, _, _ = shared()
    col = CC.calibrate(C.to_list_params(tp, CFG), CFG, port_batches(),
                       streaming=False)
    return CC.build_plan_and_params(
        tp, CFG, CC.CompressionConfig(**CCFG), port_batches(),
        collector=col, device=device)


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_build_plan_matches_jax(device):
    _, _, _, jcomp, jplan = shared()
    comp, plan = port_plan(device)
    ks = {g.gid: g.k for g in plan.groups}
    assert ks == {g.gid: g.k for g in jplan.groups}
    n_x = sum(g.mtype.startswith("x") for g in plan.groups)
    assert n_x == CFG.n_layers * 3 * CFG.moe.padded_experts
    assert plan.summary == pytest.approx(jplan.summary, rel=1e-6)
    padded = 0
    for i in range(CFG.n_layers):
        for name in ("w_gate", "w_up", "w_down"):
            node = comp["decoder"]["run0"][i]["moe"][name]
            jnode = jcomp["decoder"]["run0"][i]["moe"][name]
            mtype = "x" + name[2:]
            ranks = [ks[f"{mtype}:L{i}e{e}"]
                     for e in range(CFG.moe.padded_experts)]
            B, Cf = node["B"], node["C"]
            assert B.shape == jnode["B"].shape == (
                len(ranks), *jnode["B"].shape[1:2], max(ranks))
            assert Cf.shape == jnode["C"].shape
            for e, r in enumerate(ranks):
                assert not B[e, :, r:].any() and not Cf[e, r:].any()
                want = np.asarray(jnode["B"][e]) @ np.asarray(jnode["C"][e])
                assert rel((B[e] @ Cf[e]).numpy(), want) <= 1e-4, (i, name)
                padded += r < max(ranks)
    assert padded, "no expert's factors were rank-padded"


def test_chunked_device_decomposition_matches_whole_buckets(monkeypatch):
    comp, plan = port_plan(True)
    monkeypatch.setattr(CC, "_chunk_groups",
                        lambda n, per_group, dev: min(n, 3))
    _, tp, _, _, _ = shared()
    col = CC.calibrate(C.to_list_params(tp, CFG), CFG, port_batches(),
                       streaming=False)
    comp3, plan3 = CC.build_plan_and_params(
        tp, CFG, CC.CompressionConfig(**CCFG), port_batches(),
        collector=col, device=True)
    assert plan3.to_json() == plan.to_json()
    flat = C.strip_tags(comp)
    flat3 = C.strip_tags(comp3)
    for i in range(CFG.n_layers):
        for sub in ("moe", "attn"):
            for k, v in flat["decoder"]["run0"][i][sub].items():
                if isinstance(v, dict):
                    for kk in ("B", "C"):
                        if kk in v:
                            assert torch.equal(
                                v[kk], flat3["decoder"]["run0"][i][sub][k][kk])


def test_chunk_size_fits_a_share_of_the_free_memory(monkeypatch):
    """On the card a chunk takes as many groups as CHUNK_MEMORY_SHARE of
    the free memory (``mem_get_info``'s plus the allocator's unused cache)
    holds; off the card the whole bucket."""
    per = CC._group_bytes(1024, 512, 341)          # granite's xgate/xup
    assert CC._chunk_groups(1536, per, CPU) == 1536
    gib = 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (60 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 10 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 6 * gib)
    card = torch.device("cuda", 0)
    size = CC._chunk_groups(1536, per, card)
    assert size == int(0.25 * 64 * gib) // per < 1536
    assert CC._chunk_groups(100, per, card) == 100
    assert CC._chunk_groups(1536, 10 ** 12, card) == 1


# ---------------------------------------------------------------------------
# artifacts across packages, the batcher
# ---------------------------------------------------------------------------
def test_moe_artifacts_boot_across_the_packages(tmp_path):
    _, _, _, jcomp, jplan = shared()
    comp, plan = port_plan(False)
    toks = calib_tokens()[0]
    JC.save_plan(str(tmp_path / "jax"), jcomp, jplan, JCFG)
    CC.save_plan(str(tmp_path / "port"), comp, plan, CFG)
    # JAX's artifact in the port, the port's in JAX
    tlp, tplan = CC.load_plan(str(tmp_path / "jax"), CFG, verify=True,
                              device=CPU)
    jlp, jplan2 = JC.load_plan(str(tmp_path / "port"), JCFG, verify=True)
    assert tplan.to_json() == jplan.to_json()
    assert jplan2.to_json() == plan.to_json()
    want, _ = JT.forward(jcomp, JCFG, {"tokens": jnp.asarray(toks)})
    got, _ = T.forward(tlp, CFG, {"tokens": torch.as_tensor(toks)})
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
    want, _ = T.forward(comp, CFG, {"tokens": torch.as_tensor(toks)})
    got, _ = JT.forward(jlp, JCFG, {"tokens": jnp.asarray(toks)})
    assert np.abs(np.asarray(got) - want.numpy()).max() <= 1e-5


def requests(n=8, n_new=5, seed=11):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, CFG.vocab_size,
                             size=(int(rng.integers(1, 40)),),
                             dtype=np.int32), n_new) for i in range(n)]


ELASTIC = dict(elastic=True, elastic_levels=2, degrade_above=4,
               restore_below=1)


@pytest.mark.parametrize("pool,acfg", [
    (dict(), None), (dict(kv_block=16), None),
    (dict(kv_block=16, prefix_cache=True), None), (dict(), ELASTIC)],
    ids=["contiguous", "paged", "paged_prefix", "elastic"])
def test_batcher_on_a_compressed_moe_model_matches_jax(pool, acfg,
                                                       tmp_path):
    _, _, _, jcomp, jplan = shared()
    JC.save_plan(str(tmp_path), jcomp, jplan, JCFG)
    sc = dict(batch=4, max_len=64, **pool)
    jb = JE.ContinuousBatcher.from_compressed(
        str(tmp_path), JCFG, JE.ServeConfig(**sc),
        admission=jadm.AdmissionConfig(**(acfg or {})))
    tb = E.ContinuousBatcher.from_compressed(
        str(tmp_path), CFG, E.ServeConfig(**sc),
        admission=adm.AdmissionConfig(**(acfg or {})), device="cpu")
    n = 16 if acfg else 8
    for rid, p, k in requests(n):
        jb.submit(JE.Request(rid, p, k))
        tb.submit(E.Request(rid, p, k))
    jout = {r.rid: list(r.out) for r in jb.run_until_drained()}
    tout = {r.rid: list(r.out) for r in tb.run_until_drained()}
    assert len(tout) == n and tout == jout
    if acfg:
        residency = tb.metrics()["rank_residency"]
        assert set(residency) > {"0"}
        assert residency == jb.metrics()["rank_residency"]
        stacks = [rung["decoder"]["run0"][0]["moe"]["w_up"]
                  for rung in tb.ladder]
        R = stacks[0]["B"].shape[-1]
        for lvl, node in enumerate(stacks):
            assert node["B"].shape[-1] == node["C"].shape[-2] == \
                CC.rank_bucket(R, lvl)


# ---------------------------------------------------------------------------
# integerize
# ---------------------------------------------------------------------------
def granite_specs(module, layers: int, experts: int, seed: int):
    """Granite-shaped specs: per layer wq/wo 1024x1024, wk/wv 1024x512,
    and ``experts`` experts of 1024x512 (gate, up) and 512x1024 (down);
    seeded effective ranks."""
    rng = np.random.default_rng(seed)
    shapes = [("q", 1024, 1024), ("k", 1024, 512), ("v", 1024, 512),
              ("o", 1024, 1024)]
    shapes += [(t, a, b) for _ in range(experts) for t, a, b in
               (("xgate", 1024, 512), ("xup", 1024, 512),
                ("xdown", 512, 1024))]
    specs = []
    for layer in range(layers):
        for j, (t, d1, d2) in enumerate(shapes):
            omega = d1 + d2
            kmax = min(min(d1, d2), d1 * d2 // omega)
            specs.append(module.GroupSpec(
                gid=f"{t}:L{layer}#{j}", mtype=t, omega=omega, kmax=kmax,
                reff=float(rng.uniform(0.05, 0.9) * min(d1, d2)), kmin=1,
                dense_params=d1 * d2))
    return specs


def targets(module, beta_map, specs, ratio, beta):
    budget = (1 - ratio) * sum(s.dense_params for s in specs)
    kf = module.lagrange_allocate(specs, budget)
    for qk, v in beta_map:
        kf = module.beta_rebalance(specs, kf, beta, qk_types=qk, v_type=v)
    return kf, budget


@pytest.mark.parametrize("multiple", [1, 4])
@pytest.mark.parametrize("layers,experts,seed,ratio,beta",
                         [(2, 8, 0, 0.2, 0.35), (4, 8, 1, 0.4, 0.35),
                          (3, 2, 2, 0.2, 0.0), (1, 32, 3, 0.3, 0.35)])
def test_integerize_gives_jaxs_ranks(layers, experts, seed, ratio, beta,
                                     multiple):
    js = granite_specs(jalloc, layers, experts, seed)
    ts = granite_specs(alloc, layers, experts, seed)
    assert len(ts) <= 128
    jk, jb = targets(jalloc, JBETA_MAP, js, ratio, beta)
    tk, tb = targets(alloc, BETA_MAP, ts, ratio, beta)
    assert tk == jk and tb == jb
    assert (alloc.integerize(ts, tk, tb, multiple=multiple)
            == jalloc.integerize(js, jk, jb, multiple=multiple))


def test_integerize_scales_to_a_granite_sized_plan():
    specs = granite_specs(alloc, 12, 32, 7)
    assert len(specs) == 1200
    kf, budget = targets(alloc, BETA_MAP, specs, 0.2, 0.35)
    t0 = time.perf_counter()
    ks = alloc.integerize(specs, kf, budget, multiple=1)
    secs = time.perf_counter() - t0
    assert sum(ks[s.gid] * s.omega for s in specs) <= budget
    assert all(s.kmin <= ks[s.gid] <= s.kmax for s in specs)
    # the budget is spent to within one step of the smallest group
    assert budget - sum(ks[s.gid] * s.omega for s in specs) < max(
        s.omega for s in specs)
    assert secs < 20, secs
