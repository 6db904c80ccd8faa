"""The port's device compression math (``core.numerics_device``) against the
JAX package's (``core.numerics_jax``) and the host fp64 oracle, per stage
and at plan level, on the CPU.

Tiers (``tests/test_compress_device.py``): σ within 1e-5 relative, rank-k
factors (the B·C product, free of the eigenvectors' signs) within 1e-4,
the refine solve within 2e-4; randomized SVD within 1.05× of the exact
rank-k whitened error, with the total energy (trace identity) within 1e-4.
Each stage is held at its tier against JAX and against the oracle. Plan
level: integer ranks identical to JAX's device plans and to the port's host
plans."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compress as JC
from repro.core import numerics_jax as numj
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import compress as CC
from repro_torch.core import numerics as num
from repro_torch.core import numerics_device as numd
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, ServeConfig
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

SIG_TOL = 1e-5
FACTOR_TOL = 1e-4
REFINE_TOL = 2e-4
CPU = torch.device("cpu")


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.double().numpy()
    return np.asarray(t, dtype=np.float64)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _rand_spd(rng, d, rows=None):
    X = rng.normal(size=(rows or 2 * d, d))
    return X.T @ X


def _bc(B, C) -> np.ndarray:
    return np.einsum("bik,bkj->bij", _np(B), _np(C))


# ---------------------------------------------------------------------------
# Stages on synthetic matrices
# ---------------------------------------------------------------------------
def test_cholesky_escalate_matches_jax_tau():
    rng = np.random.default_rng(3)
    d = 24
    # an indefinite Gram whose smallest eigenvalue is -3e-5 fails at the
    # first two damping steps on any LAPACK and passes at the third
    Q = np.linalg.qr(rng.normal(size=(d, d)))[0]
    lam = np.linspace(1.0, 2.0, d)
    lam[0] = -3e-5
    G = np.stack([_rand_spd(rng, d), _rand_spd(rng, d, rows=d // 4),
                  np.zeros((d, d)), (Q * lam) @ Q.T])
    L, tau = numd.cholesky_escalate(_f32(G))
    jL, jtau = numj.cholesky_escalate(jnp.asarray(G, jnp.float32))
    tau0 = 1e-6 * np.trace(G[3]) / d
    assert np.allclose(_np(tau)[3], 100 * tau0, rtol=1e-5)   # escalated
    # equal damping steps; the trace's sum order moves tau by an ulp
    assert np.allclose(tau.numpy(), np.asarray(jtau), rtol=1e-6, atol=0)
    assert torch.isfinite(L).all()
    for i in range(len(G)):
        want = G[i] + _np(tau)[i] * np.eye(d)
        got = _np(L[i]) @ _np(L[i]).T
        assert np.abs(got - want).max() <= 1e-5 * max(want.max(), 1e-9)
    assert _rel(L[0], jL[0]) < 1e-5


def test_cholesky_escalate_nonfinite_gram_stays_nonfinite():
    G = np.eye(8)[None].repeat(2, 0)
    G[1, 0, 0] = np.nan
    L, _ = numd.cholesky_escalate(_f32(G))
    assert torch.isfinite(L[0]).all() and not torch.isfinite(L[1]).all()


@pytest.mark.parametrize("d1,nd2", [(48, 96), (96, 48), (64, 64),
                                    (32, 160)])
def test_decompose_gram_matches_jax_and_host(d1, nd2):
    rng = np.random.default_rng(0)
    b, k = 3, min(d1, nd2) // 3
    W = rng.normal(size=(b, d1, nd2))
    G = np.stack([_rand_spd(rng, d1) for _ in range(b)])
    sig, B, C = numd.decompose(_f32(W), gram=_f32(G), k=k)
    jsig, jB, jC = numj.decompose(W, gram=G, k=k)
    assert sig.shape == jsig.shape and B.shape == jB.shape
    assert _rel(sig, jsig) < SIG_TOL
    assert _rel(_bc(B, C), _bc(jB, jC)) < FACTOR_TOL
    for i in range(b):
        wh = num.cholesky_whitener(G[i])
        U, s0, Vt = num.whitened_svd(W[i], wh)
        B0, C0 = num.truncate_factors(U, s0, Vt, k, wh)
        assert _rel(_np(sig[i])[:len(s0)], s0) < SIG_TOL
        assert _rel(_bc(B, C)[i], B0 @ C0) < FACTOR_TOL


@pytest.mark.parametrize("mode", ["diag", "identity", "factor"])
def test_decompose_other_whiteners_match_jax_and_host(mode):
    rng = np.random.default_rng(2)
    b, d1, nd2, k = 2, 48, 80, 12
    W = rng.normal(size=(b, d1, nd2))
    kw, jkw = {}, {}
    if mode == "diag":
        scale = np.abs(rng.normal(size=(b, d1))) + 0.5
        kw, jkw = {"diag": _f32(scale)}, {"diag": scale}
        whs = [num.diag_whitener(scale[i]) for i in range(b)]
    elif mode == "identity":
        whs = [num.identity_whitener() for _ in range(b)]
    else:
        G = np.stack([_rand_spd(rng, d1) for _ in range(b)])
        # a QR-signed factor (negative rows) exercises _fix_factor
        R = np.stack([np.linalg.cholesky(G[i]).T for i in range(b)])
        R[:, ::3] *= -1
        kw, jkw = {"factor": _f32(R)}, {"factor": R}
        whs = [num.whitener_from_factor(R[i]) for i in range(b)]
    sig, B, C = numd.decompose(_f32(W), k=k, **kw)
    jsig, jB, jC = numj.decompose(W, k=k, **jkw)
    assert _rel(sig, jsig) < SIG_TOL, mode
    assert _rel(_bc(B, C), _bc(jB, jC)) < FACTOR_TOL, mode
    for i in range(b):
        U, s, Vt = num.whitened_svd(W[i], whs[i])
        assert _rel(_np(sig[i])[:len(s)], s) < SIG_TOL, mode
    for i in range(b):
        U, s, Vt = num.whitened_svd(W[i], whs[i])
        B0, C0 = num.truncate_factors(U, s, Vt, k, whs[i])
        assert _rel(_bc(B, C)[i], B0 @ C0) < FACTOR_TOL, mode


def test_decompose_near_duplicate_inputs_meets_the_factor_tier():
    """Inputs whose feature blocks nearly repeat (as a random-weight GQA
    model's ``wo`` inputs do: three query heads per KV head) give Grams of
    condition ~1e6. Rounding such a Gram to float32 moves the whitened
    factors by cond·eps: the JAX module's float32 math lands ~3e-1 from the
    oracle at k = 40 here. The port's float64 math holds the 1e-4 tier."""
    rng = np.random.default_rng(9)
    b, d, k = 2, 96, 40
    G = []
    for _ in range(b):
        A = rng.normal(size=(2048, 32))
        X = np.concatenate([A] + [A + 3e-3 * rng.normal(size=A.shape)
                                  for _ in range(2)], axis=1)
        G.append(X.T @ X)
    G = np.stack(G)
    assert np.linalg.cond(G[0]) > 1e5
    W = 0.02 * rng.normal(size=(b, d, d))
    sig, B, C = numd.decompose(torch.as_tensor(W), gram=torch.as_tensor(G),
                               k=k)
    for i in range(b):
        wh = num.cholesky_whitener(G[i])
        U, s0, Vt = num.whitened_svd(W[i], wh)
        B0, C0 = num.truncate_factors(U, s0, Vt, k, wh)
        assert _rel(_np(sig[i]), s0) < SIG_TOL
        assert _rel(_bc(B, C)[i], B0 @ C0) < FACTOR_TOL


def test_combine_and_tree_reduce_factors_match_jax():
    rng = np.random.default_rng(6)
    b, n, d = 2, 3, 20
    Gs = np.stack([[_rand_spd(rng, d) for _ in range(n)] for _ in range(b)])
    Rs = np.linalg.cholesky(Gs).swapaxes(-1, -2)
    R = _np(numd.combine_factors(_f32(Rs)))
    jR = np.asarray(numj.combine_factors(jnp.asarray(Rs, jnp.float32)),
                    np.float64)
    for i in range(b):
        rtr = R[i].T @ R[i]
        assert _rel(rtr, Gs[i].sum(0)) < 1e-5
        assert _rel(rtr, jR[i].T @ jR[i]) < 1e-5
    # five shards: an odd count carries a factor over a round
    Rm = np.linalg.cholesky(
        np.stack([_rand_spd(rng, d) for _ in range(5)])).swapaxes(-1, -2)
    Rt = _np(numd.tree_reduce_factors(_f32(Rm)))
    jRt = np.asarray(numj.tree_reduce_factors(jnp.asarray(Rm, jnp.float32)),
                     np.float64)
    want = np.einsum("sji,sjk->ik", Rm, Rm)
    assert _rel(Rt.T @ Rt, want) < 1e-5
    assert _rel(Rt.T @ Rt, jRt.T @ jRt) < 1e-5


@pytest.mark.parametrize("form", ["gram", "factor"])
def test_refine_solve_matches_jax_and_host(form):
    rng = np.random.default_rng(5)
    b, d, k, m = 3, 48, 10, 72
    B = rng.normal(size=(b, d, k))
    G = np.stack([_rand_spd(rng, d, rows=128) for _ in range(b)])
    W = rng.normal(size=(b, d, m))
    if form == "gram":
        C = numd.refine_solve(_f32(B), _f32(G), _f32(W))
        jC = numj.refine_solve(jnp.asarray(B, jnp.float32),
                               jnp.asarray(G, jnp.float32),
                               jnp.asarray(W, jnp.float32))
    else:
        R = np.linalg.cholesky(G).swapaxes(-1, -2)
        C = numd.refine_solve(_f32(B), None, _f32(W), factor=_f32(R))
        jC = numj.refine_solve(jnp.asarray(B, jnp.float32), None,
                               jnp.asarray(W, jnp.float32),
                               factor=jnp.asarray(R, jnp.float32))
    assert _rel(C, jC) < REFINE_TOL
    for i in range(b):
        BtGB = B[i].T @ G[i] @ B[i]
        BtGB += 1e-8 * np.trace(BtGB) / k * np.eye(k)
        C0 = np.linalg.solve(BtGB, B[i].T @ G[i] @ W[i])
        assert _rel(_np(C[i]), C0) < REFINE_TOL


def test_rsvd_close_to_exact_and_keeps_total_energy():
    rng = np.random.default_rng(4)
    b, d1, nd2, k = 2, 96, 192, 16
    W = np.einsum("bik,bkj->bij", rng.normal(size=(b, d1, 24)),
                  rng.normal(size=(b, 24, nd2)))
    W += 0.01 * rng.normal(size=(b, d1, nd2))
    G = np.stack([_rand_spd(rng, d1) for _ in range(b)])
    sig_x, _, _ = numd.decompose(_f32(W), gram=_f32(G), k=k)
    sig, B, C = numd.decompose(_f32(W), gram=_f32(G), k=k, rsvd=1,
                               rsvd_seed=3)
    jsig, _, _ = numj.decompose(W, gram=G, k=k, rsvd=1)
    assert sig.shape == jsig.shape == (b, min(d1, nd2))
    s, sx = _np(sig), _np(sig_x)
    assert (np.diff(s, axis=1) <= 1e-6 * s[:, :1]).all()   # non-increasing
    for i in range(b):
        wh = num.cholesky_whitener(G[i])
        U, s0, Vt = num.whitened_svd(W[i], wh)
        B0, C0 = num.truncate_factors(U, s0, Vt, k, wh)
        e0 = np.linalg.norm(wh.apply(W[i] - B0 @ C0))
        e1 = np.linalg.norm(wh.apply(W[i] - _bc(B, C)[i]))
        assert e1 <= e0 * 1.05 + 1e-9
        # the synthetic tail carries the exact truncated energy
        assert abs((s[i] ** 2).sum() - (sx[i] ** 2).sum()) \
            / (sx[i] ** 2).sum() < 1e-4
        rr, rx = num.effective_rank(s[i]), num.effective_rank(sx[i])
        assert abs(rr - rx) / rx < 0.12
        assert abs(rr - num.effective_rank(_np(jsig)[i])) / rx < 0.12


def test_tail_spectrum_matches_jax():
    rng = np.random.default_rng(8)
    sig_l = np.abs(rng.normal(size=4)) + 0.1
    tail = np.abs(rng.normal(size=4)) * 3
    got = numd._tail_spectrum(_f32(sig_l), _f32(tail), 40)
    want = numj._tail_spectrum(jnp.asarray(sig_l, jnp.float32),
                               jnp.asarray(tail, jnp.float32), 40)
    assert _rel(got, want) < 1e-5


# ---------------------------------------------------------------------------
# Plan level: identical ranks, token-identical serving
# ---------------------------------------------------------------------------
_KW = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
           d_ff=128, vocab_size=256, rank_multiple=4, dtype="float32")


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config("llama-mini").replace(**_KW)
    jcfg = jget_config("llama-mini").replace(**_KW)
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
            for _ in range(2)]
    jcal = [{"tokens": jnp.asarray(t)} for t in toks]
    tcal = [{"tokens": torch.as_tensor(t)} for t in toks]
    jcol = JC.calibrate(JC.to_list_params(jp, jcfg), jcfg, jcal,
                        streaming=False)
    tcol = CC.calibrate(CC.to_list_params(tp, cfg), cfg, tcal,
                        streaming=False)
    return cfg, jcfg, jp, tp, jcal, tcal, jcol, tcol


@pytest.mark.parametrize("method,refine", [
    ("drank", True), ("svd", False), ("asvd", False), ("svdllm", False),
    ("basis", False), ("dranke", False),
])
def test_device_plans_match_jax_device_and_port_host(method, refine):
    cfg, jcfg, jp, tp, jcal, tcal, jcol, tcol = _setup()
    beta = 0.3 if method == "drank" else 0.0
    ccfg = CC.CompressionConfig(method=method, ratio=0.3, beta=beta,
                                refine=refine)
    jccfg = JC.CompressionConfig(method=method, ratio=0.3, beta=beta,
                                 refine=refine)
    lp_d, plan_d = CC.build_plan_and_params(
        tp, cfg, ccfg, tcal, collector=tcol, streaming=False, device=True)
    lp_h, plan_h = CC.build_plan_and_params(
        tp, cfg, ccfg, tcal, collector=tcol, streaming=False)
    _, jplan_d = JC.build_plan_and_params(
        jp, jcfg, jccfg, jcal, collector=jcol, streaming=False, device=True)
    ks_d = {g.gid: g.k for g in plan_d.groups}
    assert ks_d == {g.gid: g.k for g in plan_h.groups}
    assert ks_d == {g.gid: g.k for g in jplan_d.groups}
    for gd, gh in zip(plan_d.groups, plan_h.groups):
        assert gd.reff == pytest.approx(gh.reff, rel=1e-4), gd.gid
        assert _rel(gd.sigma_head, gh.sigma_head) < SIG_TOL, gd.gid
    wq = [lp_d["decoder"]["run0"][i]["attn"]["wq"] for i in range(3)]
    if method in ("drank", "basis"):
        assert wq[0]["B"] is wq[1]["B"]             # shared group basis
    for i in range(3):
        hq = lp_h["decoder"]["run0"][i]["attn"]["wq"]
        assert wq[i]["B"].is_contiguous() and wq[i]["C"].is_contiguous()
        assert _rel((wq[i]["B"] @ wq[i]["C"]).double(),
                    (hq["B"] @ hq["C"]).double()) < FACTOR_TOL
    if refine:
        prompts = np.arange(12, dtype=np.int32).reshape(2, 6)
        th = Engine(lp_h, cfg, ServeConfig(), device=CPU).generate(prompts, 8)
        td = Engine(lp_d, cfg, ServeConfig(), device=CPU).generate(prompts, 8)
        assert (th == td).all()


def test_default_call_streams_and_runs_on_the_device_path():
    """The JAX default ``build_plan_and_params(params, cfg, ccfg, calib)``
    (streaming capture) runs in the port, and so does ``device=True``."""
    cfg, _, _, tp, _, tcal, _, _ = _setup()
    ccfg = CC.CompressionConfig(method="drank", ratio=0.3)
    lp, plan = CC.build_plan_and_params(tp, cfg, ccfg, tcal)
    lp_d, plan_d = CC.build_plan_and_params(tp, cfg, ccfg, tcal, device=True)
    assert [g.k for g in plan.groups] == [g.k for g in plan_d.groups]
    assert 0.25 < plan_d.summary["achieved_ratio"] < 0.35
    logits, _ = T.forward(lp_d, cfg, tcal[0])
    assert torch.isfinite(logits).all()
    assert CC.compressed_param_count(lp_d) < T.param_count(tp)


def test_device_rsvd_plan_runs():
    cfg, _, _, tp, _, tcal, _, tcol = _setup()
    ccfg = CC.CompressionConfig(method="drank", ratio=0.3,
                                rsvd_threshold=32)
    lp, plan = CC.build_plan_and_params(tp, cfg, ccfg, tcal, collector=tcol,
                                        device=True)
    assert abs(plan.summary["achieved_ratio"] - 0.3) < 0.05
    logits, _ = T.forward(lp, cfg, tcal[0])
    assert torch.isfinite(logits).all()


def test_device_nonfinite_gram_raises_linalg_error():
    cfg, _, _, tp, _, tcal, _, tcol = _setup()
    col = CC.Collector()
    col.gram = {t: g.copy() for t, g in tcol.gram.items()}
    col.absmean, col.count = tcol.absmean, tcol.count
    col.gram["decoder/run0/0/mlp/w_down"][0, 0] = np.nan
    with pytest.raises(np.linalg.LinAlgError, match="non-finite"):
        CC.build_plan_and_params(tp, cfg, CC.CompressionConfig(), tcal,
                                 collector=col, device=True)


def test_streaming_whitened_plan_matches_gram_plan():
    """Factor route (``whiten_tags``): host and device plans from streamed
    factors give the ranks of the Gram route, as in JAX."""
    cfg, _, _, tp, _, tcal, _, tcol = _setup()
    lp = CC.to_list_params(tp, cfg)
    colw = CC.calibrate(lp, cfg, tcal, whiten_tags=True)
    assert colw.chol and not colw.gram
    ccfg = CC.CompressionConfig(method="drank", ratio=0.3)
    _, ph = CC.build_plan_and_params(tp, cfg, ccfg, tcal, collector=tcol,
                                     streaming=False)
    _, pw = CC.build_plan_and_params(tp, cfg, ccfg, tcal, collector=colw)
    _, pwd = CC.build_plan_and_params(tp, cfg, ccfg, tcal, collector=colw,
                                      device=True)
    ks = [g.k for g in ph.groups]
    assert [g.k for g in pw.groups] == ks == [g.k for g in pwd.groups]
