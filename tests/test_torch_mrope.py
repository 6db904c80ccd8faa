"""The port's M-RoPE and vision-stub input against the JAX package's, on the
CPU, on weights bridged through numpy: qwen2-vl-72b at ``reduced()`` size
(4 layers, d_model 64, 4 heads over 2 KV heads of 16, M-RoPE sections
(2, 3, 3), qkv bias) in float32, the qkv biases set to seeded nonzero
values in both packages (at init they are zeros, and a bias then proves
nothing).

Tiers: ``mrope_angles`` against JAX's with t ≠ h ≠ w; forward logits of a
vision-stub row (``embeds`` and explicit (3, B, S) positions), prefill
then decode (token and float-embeds steps) within atol 2e-3;
``lm_loss`` within 1e-5 and grads within 1e-4 of each leaf's largest;
every Gram within 1e-4; the D-Rank plan with identical ranks, σ within
1e-5, factors within 1e-4 and every bias carried; artifacts booted across
packages and the batcher's contiguous and paged pools token-identical to
JAX's. Decode positions are the cache index broadcast to t = h = w, and
prefix reuse is refused, both as in the JAX reference."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import capture as JCap
from repro.core import compress as JC
from repro.models import rotary as JR
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.core import capture as Cap
from repro_torch.core import compress as CC
from repro_torch.models import rotary
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E
from repro_torch.train import step as TS
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCH = "qwen2-vl-72b"
GRAM_TOL, SIG_TOL, FACTOR_TOL = 1e-4, 1e-5, 1e-4
TYPES = {"q", "k", "v", "o", "gate", "up", "down"}
SPLIT = 14


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def vision_positions(n_text: int, grid: tuple, n_tail: int, batch: int):
    """(3, batch, S) M-RoPE positions of ``n_text`` text tokens (t = h = w
    = 0..), a ``grid`` of patches at one t with h and w along the grid,
    then ``n_tail`` text tokens from the next free position on."""
    gh, gw = grid
    t = list(range(n_text))
    h, w = list(t), list(t)
    t += [n_text] * (gh * gw)
    h += [n_text + i for i in range(gh) for _ in range(gw)]
    w += [n_text + j for _ in range(gh) for j in range(gw)]
    start = n_text + max(gh, gw)
    for i in range(n_tail):
        t.append(start + i)
        h.append(start + i)
        w.append(start + i)
    pos = np.asarray([t, h, w], dtype=np.int32)[:, None]
    return np.repeat(pos, batch, axis=1)


@functools.lru_cache(maxsize=None)
def model():
    """(JAX cfg, port cfg, JAX params, bridged params, vision-stub batch)
    with the qkv biases set to seeded 0.02·N(0, 1) in both."""
    jc, tc = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp, _ = JT.init_model(jc, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(4)
    attn = tree["decoder"]["run0"]["attn"]
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        attn[name]["b"] = (0.02 * rng.standard_normal(b.shape)).astype(
            b.dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.from_numpy(tree, device=CPU)
    pos = vision_positions(3, (3, 4), 8, 2)           # S = 23
    S = pos.shape[-1]
    batch = {"embeds": (0.02 * rng.standard_normal(
        (2, S, tc.d_model))).astype(np.float32),
        "positions": pos,
        "labels": rng.integers(0, tc.vocab_size, (2, S), dtype=np.int32)}
    return jc, tc, jp, tp, batch


@functools.lru_cache(maxsize=None)
def compressed():
    """(port plan and list params from the port's Grams, the same from
    JAX's Grams, JAX list params and plan, collectors (port, JAX))."""
    jc, tc, jp, tp, _ = model()
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, tc.vocab_size, (2, 16), dtype=np.int32)
            for _ in range(2)]
    jcal = [{"tokens": jnp.asarray(t)} for t in toks]
    tcal = [{"tokens": torch.as_tensor(t)} for t in toks]
    jcol = JC.calibrate(JCap.to_list_params(jp, jc), jc, jcal,
                        streaming=False)
    tcol = CC.calibrate(Cap.to_list_params(tp, tc), tc, tcal,
                        streaming=False)
    ccfg = CC.CompressionConfig(method="drank", ratio=0.3)
    tlp, plan = CC.build_plan_and_params(tp, tc, ccfg, tcal, collector=tcol,
                                         streaming=False)
    col = Cap.Collector()
    col.gram, col.absmean = dict(jcol.gram), dict(jcol.absmean)
    col.count, col.chol = dict(jcol.count), dict(jcol.chol)
    tlp_j, plan_j = CC.build_plan_and_params(tp, tc, ccfg, tcal,
                                             collector=col, streaming=False)
    jlp, jplan = JC.build_plan_and_params(
        jp, jc, JC.CompressionConfig(method="drank", ratio=0.3), jcal,
        collector=jcol, streaming=False)
    return tlp, plan, tlp_j, plan_j, jlp, jplan, tcol, jcol


def test_mrope_angles_and_positions_match_jax():
    pos = vision_positions(5, (4, 6), 7, 2)
    assert len({tuple(c) for c in pos[:, 0].T.tolist()}) == pos.shape[-1]
    for hd, sections in ((16, (2, 3, 3)), (128, (16, 24, 24))):
        got = rotary.mrope_angles(torch.as_tensor(pos), hd, 1e6, sections)
        want = np.asarray(JR.mrope_angles(jnp.asarray(pos), hd, 1e6,
                                          sections))
        assert tuple(got.shape) == want.shape == (2, pos.shape[-1], hd // 2)
        # the frequencies' float32 ``pow`` may differ by an ulp between
        # torch and XLA; the section split itself is exact
        assert (np.abs(got.numpy() - want) <= 1e-6 * np.abs(want)).all()
    got = rotary.make_positions(2, 5, CPU, kind="mrope")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JR.make_positions(2, 5, "mrope")))
    with pytest.raises(ValueError, match="sum"):
        rotary.mrope_angles(torch.as_tensor(pos), 16, 1e6, (2, 3, 2))


def test_every_config_of_the_repo_is_supported():
    """``check_supported`` refuses none of the repo's configs (the JAX
    package's set): encoder-decoder, M-RoPE and both frontend stubs
    included."""
    from repro.configs import all_configs as jall
    from repro_torch.configs import all_configs
    cfgs = all_configs()
    assert sorted(cfgs) == sorted(jall())
    for cfg in cfgs.values():
        T.check_supported(cfg)
    assert {c.frontend for c in cfgs.values()} >= {"audio", "vision"}
    with pytest.raises(NotImplementedError):
        T.check_supported(cfgs[ARCH].replace(rope_kind="alibi"))


def test_param_tree_matches_jax_and_the_full_width_size():
    jc, tc, jp, _, _ = model()
    full = T.init_model(get_config(ARCH).replace(n_layers=2),
                        device="meta")[0]
    assert T.param_count(full) == 4_246_794_240
    tp, _ = T.init_model(tc, seed=0, device=CPU)
    js = [(jax.tree_util.keystr(p), x.shape) for p, x in
          jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [(pytree.keystr(p), tuple(x.shape)) for p, x in
            pytree.flatten_with_path(tp)] == js
    assert "['decoder']['run0']['attn']['wk']['b']" in dict(js)


def test_vision_stub_forward_prefill_and_decode_match_jax():
    jc, tc, jp, tp, batch = model()
    fb = {k: batch[k] for k in ("embeds", "positions")}
    with torch.no_grad():
        full, _ = T.forward(tp, tc, {k: torch.as_tensor(v)
                                     for k, v in fb.items()})
    jfull, _ = JT.forward(jp, jc, {k: jnp.asarray(v) for k, v in fb.items()})
    assert np.abs(full.numpy() - np.asarray(jfull)).max() <= 2e-3
    pb = {"embeds": batch["embeds"][:, :SPLIT],
          "positions": batch["positions"][..., :SPLIT]}
    jlg, jcache = JT.prefill(jp, jc, {k: jnp.asarray(v)
                                      for k, v in pb.items()}, max_len=32)
    with torch.no_grad():
        lg, cache = T.prefill(tp, tc, {k: torch.as_tensor(v)
                                       for k, v in pb.items()}, max_len=32)
    outs, jouts = [lg], [np.asarray(jlg)]
    jdec = jax.jit(lambda p, c, t: JT.decode_step(p, jc, c, t))
    steps = [batch["embeds"][:, t:t + 1] for t in range(SPLIT, SPLIT + 3)]
    steps += [np.full((2, 1), 5 + i, dtype=np.int32) for i in range(3)]
    for x in steps:                  # float embeds, then token ids
        jlg, jcache = jdec(jp, jcache, jnp.asarray(x))
        with torch.no_grad():
            lg, cache = T.decode_step(tp, tc, cache, torch.as_tensor(x))
        outs.append(lg)
        jouts.append(np.asarray(jlg))
    dec = torch.cat(outs, dim=1).numpy()
    assert np.abs(dec - np.concatenate(jouts, axis=1)).max() < 2e-3
    assert cache["pos"].tolist() == [SPLIT + 6] * 2


def test_decode_positions_are_the_cache_index_as_in_jax():
    """JAX's M-RoPE decode rotates the new token at its cache index,
    broadcast to t = h = w (``transformer.py:444-445`` there), not at
    Qwen2-VL's max-plus-one offset after an image; the port keeps it."""
    jc, tc, jp, tp, batch = model()
    pb = {"embeds": torch.as_tensor(batch["embeds"][:, :SPLIT]),
          "positions": torch.as_tensor(batch["positions"][..., :SPLIT])}
    tok = torch.full((2, 1), 9, dtype=torch.int32)
    runs = []
    for positions in (None, torch.full((3, 2, 1), SPLIT, dtype=torch.int32),
                      torch.full((3, 2, 1), SPLIT - 3, dtype=torch.int32)):
        with torch.no_grad():
            _, cache = T.prefill(tp, tc, pb, max_len=32)
            lg, _ = T.decode_step(tp, tc, cache, tok, positions=positions)
        runs.append(lg)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_lm_loss_and_grads_match_jax():
    jc, tc, jp, tp, batch = model()
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jc, {k: jnp.asarray(v)
                                     for k, v in batch.items()}),
        has_aux=True))(jp)
    loss, m, grads = TS.value_and_grad(
        tp, tc, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert rel(float(loss), float(jloss)) <= 1e-5
    assert sorted(m) == sorted(jm)
    g = pytree.flatten_with_path(grads)
    w, _ = jax.tree_util.tree_flatten_with_path(jg)
    assert [pytree.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert rel(a.detach().numpy(), np.asarray(b)) <= 1e-4, \
            pytree.keystr(p)


def test_grams_plan_factors_and_biases_match_jax():
    """Grams within 1e-4; the plan from the port's Grams with JAX's
    groups, identical ranks and σ within 1e-5; B·C from the same Grams
    as JAX's within 1e-4 (see ``tests/test_torch_encdec.py``); every
    compressed q/k/v keeps its bias, ``{"B", "C", "b"}``."""
    tlp, plan, tlp_j, plan_j, jlp, jplan, tcol, jcol = compressed()
    assert sorted(tcol.gram) == sorted(jcol.gram)
    for tag, g in jcol.gram.items():
        assert rel(tcol.gram[tag], g) < GRAM_TOL, tag
        assert tcol.count[tag] == jcol.count[tag], tag
    assert [g.gid for g in plan.groups] == [g.gid for g in jplan.groups]
    assert {g.mtype for g in plan.groups} == TYPES
    for g, gj, jg in zip(plan.groups, plan_j.groups, jplan.groups):
        assert g.k == gj.k == jg.k, (g.gid, g.k, jg.k)
        assert rel(g.sigma_head, jg.sigma_head) < SIG_TOL, g.gid
    tflat = dict((pytree.keystr(p), x)
                 for p, x in pytree.flatten_with_path(tlp_j))
    jflat = dict((jax.tree_util.keystr(p), x) for p, x in
                 jax.tree_util.tree_flatten_with_path(jlp)[0])
    assert sorted(tflat) == sorted(jflat)
    biases = [p for p in tflat if p.endswith("['b']")]
    assert len(biases) == 3 * 4
    for p in biases:
        assert p[:-len("['b']")] + "['B']" in tflat, p
        assert float(tflat[p].abs().max()) > 0.0
    for path, x in tflat.items():
        if path.endswith("['B']"):
            q = path[:-len("['B']")]
            assert rel((x.double() @ tflat[q + "['C']"].double()).numpy(),
                       np.asarray(jflat[path], np.float64)
                       @ np.asarray(jflat[q + "['C']"], np.float64)
                       ) < FACTOR_TOL, q
        elif not path.endswith("['C']"):
            assert np.abs(x.numpy() - np.asarray(jflat[path])).max() \
                <= 1e-6, path


def mixed_requests(vocab: int):
    """Five prompts of 5-8 tokens: one prefill bucket (8), so each package
    traces one prefill per pool."""
    rng = np.random.default_rng(11)
    return [(i, rng.integers(0, vocab, size=(int(n),), dtype=np.int32))
            for i, n in enumerate((5, 8, 6, 7, 5))]


def drain(mod, cb, reqs, n_new=4):
    for rid, toks in reqs:
        cb.submit(mod.Request(rid=rid, tokens=toks, n_new=n_new))
    res = cb.run_until_drained()
    assert res.status == "drained" and len(res) == len(reqs)
    return {r.rid: list(r.out) for r in res}


def test_artifacts_and_batcher_pools_match_jax(tmp_path):
    """The port's artifact booted by JAX, a JAX artifact booted by the port
    and the port's in-memory params give the same ``generate`` tokens
    (the two plans share their Grams); the batcher on the contiguous and
    the paged pool gives JAX's tokens for every request."""
    jc, tc, _, _, _ = model()
    _, _, tlp, plan, jlp, jplan = compressed()[:6]
    prompts = np.random.default_rng(9).integers(0, tc.vocab_size, (2, 10),
                                                dtype=np.int32)
    CC.save_plan(str(tmp_path / "port"), tlp, plan, tc)
    jbooted = JE.Engine.from_compressed(str(tmp_path / "port"), jc,
                                        JE.ServeConfig(), verify=True)
    want = np.asarray(jbooted.generate(prompts, 5))
    JC.save_plan(str(tmp_path / "jax"), jlp, jplan, jc)
    booted = E.Engine.from_compressed(str(tmp_path / "jax"), tc,
                                      E.ServeConfig(), verify=True,
                                      device=CPU)
    np.testing.assert_array_equal(booted.generate(prompts, 5), want)
    np.testing.assert_array_equal(
        E.Engine(tlp, tc, E.ServeConfig(), device=CPU).generate(prompts, 5),
        want)
    reqs = mixed_requests(tc.vocab_size)
    # one JAX registry for both pools: the prefill compiles once
    jreg = None
    for kw in (dict(batch=2, max_len=32), dict(batch=2, max_len=32,
                                               kv_block=8)):
        jcb = JE.ContinuousBatcher(jlp, jc, JE.ServeConfig(**kw),
                                   executables=jreg)
        jreg = jcb.exec
        cb = E.ContinuousBatcher(tlp, tc, E.ServeConfig(**kw), device=CPU)
        assert drain(E, cb, reqs) == drain(JE, jcb, reqs), kw


def test_prefix_reuse_is_refused_where_jax_fails():
    """The JAX batcher's tail prefill builds (B, S) positions, which its
    ``mrope_angles`` cannot take: a request over a cached prefix fails
    there. The port refuses ``prefix_cache`` under M-RoPE at
    construction, and its ``prefill_ext`` raises."""
    jc, tc, jp, tp, _ = model()
    kw = dict(batch=2, max_len=32, kv_block=4, prefix_cache=True)
    with pytest.raises(ValueError, match="M-RoPE"):
        E.ContinuousBatcher(tp, tc, E.ServeConfig(**kw), device=CPU)
    with pytest.raises(ValueError, match="M-RoPE"):
        T.prefill_ext(tp, tc, {"tokens": np.zeros((1, 4), np.int32),
                               "lengths": [4], "starts": [4]},
                      T.init_cache_paged(tc, 1, 5, 4, device=CPU),
                      torch.ones((1, 4), dtype=torch.int32))
    jcb = JE.ContinuousBatcher(jp, jc, JE.ServeConfig(**kw))
    shared = np.arange(8, dtype=np.int32)
    jcb.submit(JE.Request(rid=0, tokens=shared, n_new=2))
    jcb.run_until_drained()
    jcb.submit(JE.Request(rid=1, tokens=np.concatenate(
        [shared, np.asarray([3, 4], np.int32)]), n_new=2))
    with pytest.raises((TypeError, ValueError)):
        jcb.run_until_drained()
