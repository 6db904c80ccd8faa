"""The port's encoder-decoder wiring against the JAX package's, on the CPU,
on weights bridged through numpy: seamless-m4t-medium at ``reduced()``
size (2 encoder and 2 decoder layers, d_model 64, 4 heads over 2 KV
heads of 16) in float32,
its encoder fed seeded ``enc_embeds`` (the audio stub).

Tiers: the sinusoidal embedding and the plain non-causal flash attention
against JAX's (the latter against the Pallas kernel in interpret mode,
max-relative 2e-5); ``encode``, forward logits, prefill then decode within
atol 2e-3 (``tests/test_decode_consistency.py``); ``lm_loss`` within 1e-5
and grads within 1e-4 of each leaf's largest; every tag's Gram (encoder,
decoder and cross) within 1e-4; the D-Rank plan's 16 group types with
identical ranks, σ within 1e-5 and factors within 1e-4; artifacts booted
across packages with identical ``generate`` tokens. The batcher refuses
the model, where JAX's fails on the first admission."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import capture as JCap
from repro.core import compress as JC
from repro.kernels import ops as jops
from repro.models import rotary as JR
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.core import capture as Cap
from repro_torch.core import compress as CC
from repro_torch.kernels import ref
from repro_torch.models import attention as A
from repro_torch.models import rotary
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E
from repro_torch.train import step as TS
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCH = "seamless-m4t-medium"
S, SPLIT, T_ENC = 24, 12, 12
GRAM_TOL, SIG_TOL, FACTOR_TOL = 1e-4, 1e-5, 1e-4
TYPES = {"q", "k", "v", "o", "cq", "ck", "cv", "co", "up", "down",
         "eq", "ek", "ev", "eo", "eup", "edown"}


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def tree_sig(flat, keystr):
    return [(keystr(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in flat]


def enc_embeds(rng, batch, frames, d):
    return (0.02 * rng.standard_normal((batch, frames, d))).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def model():
    """(JAX cfg, port cfg, JAX params, bridged params, tokens, enc_embeds)."""
    jc, tc = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp, _ = JT.init_model(jc, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tc.vocab_size, (2, S), dtype=np.int32)
    return jc, tc, jp, tp, toks, enc_embeds(rng, 2, T_ENC, tc.d_model)


def port_collector(jcol) -> Cap.Collector:
    """A JAX ``Collector``'s float64 statistics in the port's."""
    col = Cap.Collector()
    col.gram, col.absmean = dict(jcol.gram), dict(jcol.absmean)
    col.count, col.chol = dict(jcol.count), dict(jcol.chol)
    return col


@functools.lru_cache(maxsize=None)
def compressed():
    """(port list params and plan from the port's Grams, port list params
    and plan from JAX's Grams, JAX list params, JAX plan, the collectors
    (port, JAX))."""
    jc, tc, jp, tp, _, _ = model()
    rng = np.random.default_rng(7)
    cal = [(rng.integers(0, tc.vocab_size, (2, 16), dtype=np.int32),
            enc_embeds(rng, 2, 10, tc.d_model)) for _ in range(2)]
    jcal = [{"tokens": jnp.asarray(t), "enc_embeds": jnp.asarray(e)}
            for t, e in cal]
    tcal = [{"tokens": torch.as_tensor(t), "enc_embeds": torch.as_tensor(e)}
            for t, e in cal]
    jcol = JC.calibrate(JCap.to_list_params(jp, jc), jc, jcal,
                        streaming=False)
    tcol = CC.calibrate(Cap.to_list_params(tp, tc), tc, tcal,
                        streaming=False)
    tlp, plan = CC.build_plan_and_params(
        tp, tc, CC.CompressionConfig(method="drank", ratio=0.3), tcal,
        collector=tcol, streaming=False)
    tlp_j, plan_j = CC.build_plan_and_params(
        tp, tc, CC.CompressionConfig(method="drank", ratio=0.3), tcal,
        collector=port_collector(jcol), streaming=False)
    jlp, jplan = JC.build_plan_and_params(
        jp, jc, JC.CompressionConfig(method="drank", ratio=0.3), jcal,
        collector=jcol, streaming=False)
    return tlp, plan, tlp_j, plan_j, jlp, jplan, tcol, jcol


def test_sinusoidal_embed_matches_jax():
    """Same exponents; torch's and XLA's float32 ``exp`` differ by one ulp
    on some frequencies, so the angle at position p may differ by p ulps
    of the frequency: held within 1e-7·p + 1e-6 per element."""
    pos = np.random.default_rng(0).integers(0, 400, (3, 7), dtype=np.int32)
    for dim in (64, 1024):
        got = rotary.sinusoidal_embed(torch.as_tensor(pos), dim)
        want = np.asarray(JR.sinusoidal_embed(jnp.asarray(pos), dim))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        bound = 1e-7 * pos[..., None] + 1e-6
        assert (np.abs(got.numpy() - want) <= bound).all()


@pytest.mark.parametrize("t", [12, 300])
def test_noncausal_flash_plain_version_matches_the_jax_kernel(t):
    """The plain non-causal flash (the kernel's CPU version and oracle)
    against JAX's Pallas kernel in interpret mode with its ``kv_len``
    mask: T ragged against every tile size at 300."""
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((1, t, 4, 16), (1, t, 2, 16), (1, t, 2, 16)))
    got = ref.flash_attention(*map(torch.as_tensor, (q, k, v)), causal=False)
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=False))
    assert rel(got.numpy(), want) <= 2e-5


def test_param_and_cache_trees_match_jax():
    jc, tc, jp, _, _, _ = model()
    full = T.init_model(get_config(ARCH), device="meta")[0]
    assert T.param_count(full) == 877_094_912
    assert sorted(full) == ["decoder", "embed", "encoder", "final_norm",
                            "lm_head"]
    tp, _ = T.init_model(tc, seed=0, device=CPU)
    js = jax.tree_util.tree_flatten_with_path
    assert tree_sig(pytree.flatten_with_path(tp), pytree.keystr) == \
        tree_sig(js(jp)[0], jax.tree_util.keystr)
    # a cross block has no q/k norms, in a qk-norm config too
    qk = tc.replace(qk_norm=True)
    leaves = [pytree.keystr(p) for p, _ in pytree.flatten_with_path(
        T.init_model(qk, device="meta")[0])]
    assert any("['attn']['q_norm']" in p for p in leaves)
    assert not any("['cross']['q_norm']" in p for p in leaves)
    tcache = T.init_cache(tc, 3, 20, device=CPU, enc_len=T_ENC)
    jcache = JT.init_cache(jc, 3, 20, enc_len=T_ENC)
    assert tree_sig(pytree.flatten_with_path(tcache), pytree.keystr) == \
        tree_sig(js(jcache)[0], jax.tree_util.keystr)
    with pytest.raises(ValueError, match="decoder-only"):
        T.init_cache_paged(tc, 2, 9, 8, device=CPU)


def test_encode_forward_prefill_and_decode_match_jax():
    jc, tc, jp, tp, toks, enc = model()
    jb = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}
    tb = {"tokens": torch.as_tensor(toks), "enc_embeds": torch.as_tensor(enc)}
    with torch.no_grad():
        got_enc = T.encode(tp, tc, tb)
        full, _ = T.forward(tp, tc, tb)
    assert np.abs(got_enc.numpy() - np.asarray(JT.encode(jp, jc, jb))).max() \
        < 2e-3
    jfull, _ = JT.forward(jp, jc, jb)
    assert np.abs(full.numpy() - np.asarray(jfull)).max() <= 2e-3

    jdec = jax.jit(lambda p, c, t: JT.decode_step(p, jc, c, t))
    jlg, jcache = JT.prefill(jp, jc, dict(jb, tokens=jb["tokens"][:, :SPLIT]),
                             max_len=S + 4)
    jouts = [np.asarray(jlg)]
    with torch.no_grad():
        lg, cache = T.prefill(tp, tc, dict(tb, tokens=tb["tokens"][:, :SPLIT]),
                              max_len=S + 4)
        outs = [lg]
        for t in range(SPLIT, S):
            jlg, jcache = jdec(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
            jouts.append(np.asarray(jlg))
            lg, cache = T.decode_step(tp, tc, cache,
                                      torch.as_tensor(toks[:, t:t + 1]))
            outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - full[:, SPLIT - 1:S]).abs().max()) < 2e-3
    assert np.abs(dec.numpy() - np.concatenate(jouts, axis=1)).max() < 2e-3
    # the cross K/V the prefill materialized, read-only through the decode
    ck = cache["runs"]["run0"]["cross_kv"]
    jck = jcache["runs"]["run0"]["cross_kv"]
    assert tuple(ck["k"].shape) == jck["k"].shape == (2, 2, T_ENC, 2, 16)
    for a in ("k", "v"):
        assert np.abs(ck[a].numpy() - np.asarray(jck[a])).max() < 2e-3


def test_cross_decode_gives_a_dead_row_no_exact_zero_as_jax():
    """JAX's cross-attention decode (``attention.py:397-401``) runs ``_sdpa``
    over the encoder's K/V for every row, a dead one (pos -1) included, and
    zeroes nothing; the port's cross block (``attend_cross``, which reads
    no position) keeps that."""
    from repro.models import attention as JA
    jc, tc, jp, tp, _, _ = model()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((2, T_ENC, 4, 16)).astype(np.float32)
            for _ in range(2))
    pos = np.asarray([-1, 4], dtype=np.int32)
    cross = T.tree_index(tp["decoder"]["run0"]["cross"], 0)
    jcross = jax.tree.map(lambda a: a[0], jp["decoder"]["run0"]["cross"])
    with torch.no_grad():
        got = A.attend_cross(cross, tc, torch.as_tensor(x),
                             torch.as_tensor(k), torch.as_tensor(v))
    want, _ = JA.attend_decode(jcross, jc, jnp.asarray(x), jnp.asarray(pos),
                               {}, None, cross_kv=(jnp.asarray(k),
                                                   jnp.asarray(v)))
    assert float(got[0].abs().max()) > 0.0
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


def test_lm_loss_and_grads_match_jax():
    jc, tc, jp, tp, toks, enc = model()
    assert tc.remat == "block" and tc.scan_layers     # remat'd stacked runs
    b = {"tokens": toks[:, :16], "enc_embeds": enc}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jc, {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True))(jp)
    loss, m, grads = TS.value_and_grad(
        tp, tc, {k: torch.as_tensor(v) for k, v in b.items()})
    assert rel(float(loss), float(jloss)) <= 1e-5
    assert sorted(m) == sorted(jm)
    g = pytree.flatten_with_path(grads)
    w, _ = jax.tree_util.tree_flatten_with_path(jg)
    assert [pytree.keystr(p) for p, _ in g] == \
        [jax.tree_util.keystr(p) for p, _ in w]
    for (p, a), (_, b2) in zip(g, w):
        assert rel(a.detach().numpy(), np.asarray(b2)) <= 1e-4, \
            pytree.keystr(p)


def test_calibration_grams_match_jax_for_every_tag():
    _, tc, _, tp, _, _ = model()
    tcol, jcol = compressed()[6:]
    assert sorted(tcol.gram) == sorted(jcol.gram)
    assert any(t.startswith("encoder/") for t in tcol.gram)
    for tag, g in jcol.gram.items():
        assert rel(tcol.gram[tag], g) < GRAM_TOL, tag
        assert rel(tcol.mean_abs(tag), jcol.mean_abs(tag)) < GRAM_TOL, tag
        assert tcol.count[tag] == jcol.count[tag], tag
    # the cross wk/wv see the encoder's rows (2 x 10 a batch), the rest the
    # decoder's (2 x 16)
    assert tcol.count["decoder/run0/0/cross/wk"] == 40
    assert tcol.count["decoder/run0/0/cross/wq"] == 64
    back = Cap.to_stacked_params(Cap.to_list_params(tp, tc), tc)
    a, b = pytree.flatten_with_path(back), pytree.flatten_with_path(tp)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), pytree.keystr(p)


def test_plan_and_factors_match_jax():
    """The plan from the port's own Grams: JAX's groups, identical ranks, σ
    within 1e-5. The factors from the same Grams as JAX's: B·C within
    1e-4. From the port's own Grams (within ~1e-7 of JAX's) the
    attention-output tags (``wo``, cross ``wo``) came out up to 2.6e-4
    apart over random JAX inits (the JAX ``Builder`` seeds each subtree
    by the process's string hash): their whitened spectra are nearly
    degenerate at the cut, so the kept subspace moves with the Grams'
    last bits, in either package alike."""
    tlp, plan, tlp_j, plan_j, jlp, jplan = compressed()[:6]
    assert [g.gid for g in plan.groups] == [g.gid for g in jplan.groups]
    assert {g.mtype for g in plan.groups} == TYPES
    for g, gj, jg in zip(plan.groups, plan_j.groups, jplan.groups):
        assert g.k == jg.k == gj.k, (g.gid, g.k, jg.k)   # identical ranks
        assert g.kmax == jg.kmax and g.layers == jg.layers
        assert rel(g.sigma_head, jg.sigma_head) < SIG_TOL, g.gid
        assert rel(gj.sigma_head, jg.sigma_head) < SIG_TOL, g.gid
    assert plan.summary == pytest.approx(jplan.summary, rel=1e-6)
    tlp = tlp_j
    tflat = dict((pytree.keystr(p), x)
                 for p, x in pytree.flatten_with_path(tlp))
    jflat = dict((jax.tree_util.keystr(p), x) for p, x in
                 jax.tree_util.tree_flatten_with_path(jlp)[0])
    assert sorted(tflat) == sorted(jflat)
    bs = [p[:-len("['B']")] for p in tflat if p.endswith("['B']")]
    assert any(p.startswith("['encoder']") for p in bs)
    assert len(bs) == sum(g.n for g in plan.groups)
    for path in bs:
        B, C = tflat[path + "['B']"], tflat[path + "['C']"]
        jB, jC = jflat[path + "['B']"], jflat[path + "['C']"]
        assert tuple(B.shape) == jB.shape and tuple(C.shape) == jC.shape
        assert rel((B.double() @ C.double()).numpy(),
                   np.asarray(jB, np.float64) @ np.asarray(jC, np.float64)
                   ) < FACTOR_TOL, path
    for path, x in tflat.items():
        if not (path.endswith("['B']") or path.endswith("['C']")):
            assert np.abs(x.numpy() - np.asarray(jflat[path])).max() \
                <= 1e-6, path


def test_artifacts_boot_across_packages_with_the_same_tokens(tmp_path):
    jc, tc, _, _, _, _ = model()
    _, _, tlp, plan, jlp, jplan = compressed()[:6]
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, tc.vocab_size, (2, 10), dtype=np.int32)
    enc = enc_embeds(rng, 2, 14, tc.d_model)
    CC.save_plan(str(tmp_path / "port"), tlp, plan, tc)
    jbooted = JE.Engine.from_compressed(str(tmp_path / "port"), jc,
                                        JE.ServeConfig(), verify=True)
    want = np.asarray(jbooted.generate(prompts, 6, enc_embeds=enc))
    got = E.Engine(tlp, tc, E.ServeConfig(), device=CPU).generate(
        prompts, 6, enc_embeds=enc)
    np.testing.assert_array_equal(got, want)
    JC.save_plan(str(tmp_path / "jax"), jlp, jplan, jc)
    booted = E.Engine.from_compressed(str(tmp_path / "jax"), tc,
                                      E.ServeConfig(), verify=True,
                                      device=CPU)
    assert booted.plan.to_json() == jplan.to_json()
    np.testing.assert_array_equal(booted.generate(prompts, 6,
                                                  enc_embeds=enc), want)
    r = booted.measure_decode_throughput(batch=2, prompt_len=4, n_new=2,
                                         warmup=1)
    assert r["tokens_per_s"] > 0


def test_batcher_refuses_encoder_decoder_where_jax_fails():
    """JAX's batcher admits through ``_admit_exact``, which passes only
    ``tokens``, so its first admission fails in ``encode`` with
    ``KeyError: 'enc_tokens'``; the port refuses at construction."""
    jc, tc, jp, tp, toks, _ = model()
    with pytest.raises(ValueError, match="decoder-only"):
        E.ContinuousBatcher(tp, tc, E.ServeConfig(batch=2, max_len=32),
                            device=CPU)
    jcb = JE.ContinuousBatcher(jp, jc, JE.ServeConfig(batch=2, max_len=32))
    jcb.submit(JE.Request(rid=0, tokens=toks[0, :5], n_new=2))
    with pytest.raises(KeyError, match="enc_tokens"):
        jcb.run_until_drained()
