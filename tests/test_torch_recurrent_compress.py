"""D-Rank on the recurrent families: the port's calibration, plan and
factors against the JAX package's, on the same bridged weights and
calibration batches (hymba-1.5b and xlstm-350m, reduced, float32).

Every new linear is tagged and captured (``w_dt`` and ``w_if`` too, which
no group takes); the non-linear leaves (conv, the sLSTM recurrences, the
SSM core, gate biases, head norms, the Hymba combine) pass through
``to_list_params``/``to_stacked_params`` untouched. Tiers (DESIGN.md §1.3,
§1.5): eager Grams within 1e-4 relative; identical integer ranks for every
group, the mLSTM, sLSTM and SSM types included; σ heads within 1e-5
relative; every factorized linear's B·C within 1e-4 relative. The
compressed models' greedy tokens equal JAX's, and a JAX ``save_plan``
artifact boots in the port with the same tokens."""
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
from repro.serve import engine as JE
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.core import capture as Cap
from repro_torch.core import compress as CC
from repro_torch.serve import engine as E
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

GRAM_TOL, SIG_TOL, FACTOR_TOL = 1e-4, 1e-5, 1e-4
CPU = torch.device("cpu")
ARCHS = ("hymba-1.5b", "xlstm-350m")
# the group types each family's plan must hold
TYPES = {
    "hymba-1.5b": {"q", "k", "v", "o", "gate", "up", "down", "ssm_in",
                   "ssm_z", "ssm_bc", "ssm_out"},
    "xlstm-350m": {"mup", "mgate", "mq", "mk", "mdown", "lin", "lfgate",
                   "lfup", "lfdown"},
}
# linears captured but taken by no group
UNGROUPED = {"hymba-1.5b": "ssm/w_dt", "xlstm-350m": "mlstm/w_if"}


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(cfg, JAX cfg, JAX params, bridged params, JAX batches, port
    batches)."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
            for _ in range(2)]
    return (cfg, jcfg, jp, tp, [{"tokens": jnp.asarray(t)} for t in toks],
            [{"tokens": torch.as_tensor(t)} for t in toks])


@functools.lru_cache(maxsize=None)
def collectors(arch):
    cfg, jcfg, jp, tp, jcal, tcal = setup(arch)
    jcol = JC.calibrate(JCap.to_list_params(jp, jcfg), jcfg, jcal,
                        streaming=False)
    tcol = CC.calibrate(Cap.to_list_params(tp, cfg), cfg, tcal,
                        streaming=False)
    return jcol, tcol


@functools.lru_cache(maxsize=None)
def plans(arch):
    """(port list params, port plan, JAX list params, JAX plan)."""
    cfg, jcfg, jp, tp, jcal, tcal = setup(arch)
    jcol, tcol = collectors(arch)
    tlp, plan = CC.build_plan_and_params(
        tp, cfg, CC.CompressionConfig(method="drank", ratio=0.3), tcal,
        collector=tcol, streaming=False)
    jlp, jplan = JC.build_plan_and_params(
        jp, jcfg, JC.CompressionConfig(method="drank", ratio=0.3), jcal,
        collector=jcol, streaming=False)
    return tlp, plan, jlp, jplan


@pytest.mark.parametrize("arch", ARCHS)
def test_every_linear_captured_and_leaves_pass_through(arch):
    cfg, _, _, tp, _, _ = setup(arch)
    jcol, tcol = collectors(arch)
    assert sorted(tcol.gram) == sorted(jcol.gram)
    assert any(t.endswith(UNGROUPED[arch]) for t in tcol.gram)
    for tag, g in jcol.gram.items():
        assert rel(tcol.gram[tag], g) < GRAM_TOL, tag
        assert rel(tcol.mean_abs(tag), jcol.mean_abs(tag)) < GRAM_TOL, tag
        assert tcol.count[tag] == jcol.count[tag]
    back = Cap.to_stacked_params(Cap.to_list_params(tp, cfg), cfg)
    a, b = pytree.flatten_with_path(back), pytree.flatten_with_path(tp)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), pytree.keystr(p)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_and_factors_match_jax(arch):
    tlp, plan, jlp, jplan = plans(arch)
    assert [g.gid for g in plan.groups] == [g.gid for g in jplan.groups]
    assert {g.mtype for g in plan.groups} == TYPES[arch]
    for g, jg in zip(plan.groups, jplan.groups):
        assert g.k == jg.k, (g.gid, g.k, jg.k)          # identical ranks
        assert g.kmax == jg.kmax and g.layers == jg.layers
        assert rel(g.sigma_head, jg.sigma_head) < SIG_TOL, g.gid
    assert plan.summary == pytest.approx(jplan.summary, rel=1e-6)
    t = {pytree.keystr(p[:-1]): x for p, x in pytree.flatten_with_path(tlp)
         if p[-1] == ("key", "B")}
    j = {jax.tree_util.keystr(p[:-1]): x for p, x in
         jax.tree_util.tree_flatten_with_path(jlp)[0]
         if getattr(p[-1], "key", None) == "B"}
    assert sorted(t) == sorted(j) and len(t) == sum(g.n for g in plan.groups)
    tflat = dict((pytree.keystr(p), x)
                 for p, x in pytree.flatten_with_path(tlp))
    jflat = dict((jax.tree_util.keystr(p), x) for p, x in
                 jax.tree_util.tree_flatten_with_path(jlp)[0])
    assert sorted(tflat) == sorted(jflat)
    for path in t:
        B, C = tflat[path + "['B']"], tflat[path + "['C']"]
        jB, jC = jflat[path + "['B']"], jflat[path + "['C']"]
        assert tuple(B.shape) == jB.shape and tuple(C.shape) == jC.shape
        assert rel((B.double() @ C.double()).numpy(),
                   np.asarray(jB, np.float64) @ np.asarray(jC, np.float64)
                   ) < FACTOR_TOL, path
    # every other leaf (norms, conv, recurrences, gates) is JAX's
    for path, x in tflat.items():
        if not (path.endswith("['B']") or path.endswith("['C']")):
            assert np.abs(x.numpy() - np.asarray(jflat[path])).max() \
                <= 1e-6, path


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_tokens_and_artifact_match_jax(arch, tmp_path):
    cfg, jcfg, _, _, _, _ = setup(arch)
    tlp, plan, jlp, jplan = plans(arch)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 10),
                                                dtype=np.int32)
    want = np.asarray(JE.Engine(jlp, jcfg, JE.ServeConfig()).generate(
        prompts, n_new=6))
    got = E.Engine(tlp, cfg, E.ServeConfig(), device=CPU).generate(prompts,
                                                                   6)
    np.testing.assert_array_equal(got, want)
    JC.save_plan(str(tmp_path), jlp, jplan, jcfg)
    booted = E.Engine.from_compressed(str(tmp_path), cfg, E.ServeConfig(),
                                      verify=True, device=CPU)
    assert booted.plan.to_json() == jplan.to_json()
    np.testing.assert_array_equal(booted.generate(prompts, 6), want)
