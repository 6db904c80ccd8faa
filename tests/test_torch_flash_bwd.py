"""The tiled FlashAttention-2 backward of the port (``kernels.ref.
flash_bwd_rule``, taken by ``kernels.ops.flash_attention``'s backward where
JAX's model takes ``_sdpa_flash_jnp``) against the JAX package's
``_flash_core`` and its selection, on the same numpy inputs.

Tiers: dq, dk and dv within 2e-5 of the largest entry in float32
(``tests/test_kernels.py:15``); a tiny model's loss 1e-5 and grads 1e-4 of
each leaf's largest (``tests/test_torch_train.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import bridge, pytree
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.train import step as TS
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

TOL = 2e-5


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# (causal, window, KV, G): causal, windowed, GQA G > 1, non-causal
CASES = [(True, 0, 2, 1), (True, 12, 2, 2), (True, 0, 1, 3),
         (False, 0, 2, 2), (False, 20, 1, 2)]


def _inputs(KV, G, S=32, hd=8, B=2, seed=0):
    rng = np.random.default_rng(seed)
    qg = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    return qg * hd ** -0.5, k, v, do


@pytest.mark.parametrize("causal,window,KV,G", CASES)
def test_tiled_backward_matches_jax_flash_core_vjp(causal, window, KV, G):
    """S = T = 32 in (8 × 16) tiles: every live tile, the masked ones
    skipped by ``tile_pairs``."""
    bq, bk = 8, 16
    qg, k, v, do = _inputs(KV, G)
    core = functools.partial(JA._flash_core, causal, window, bq, bk, G)
    out, vjp = jax.vjp(core, *map(jnp.asarray, (qg, k, v)))
    want = vjp(jnp.asarray(do))
    _, lse = JA._flash_fwd_pass(causal, window, bq, bk, *map(
        jnp.asarray, (qg, k, v)))
    got = tref.flash_bwd_rule(
        causal, window, bq, bk, *map(torch.tensor, (
            qg, k, v, np.asarray(out), np.asarray(lse), do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g.numpy(), w) <= TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("causal,window,KV,G", CASES)
def test_plain_lse_matches_jax_flash_fwd_pass(causal, window, KV, G):
    qg, k, v, _ = _inputs(KV, G, seed=1)
    B, S, _, _, hd = qg.shape
    q = torch.tensor(qg / hd ** -0.5).reshape(B, S, KV * G, hd)
    out, lse = tref.flash_attention(q, torch.tensor(k), torch.tensor(v),
                                    causal=causal, window=window,
                                    return_lse=True)
    jout, jlse = JA._flash_fwd_pass(causal, window, 8, 16, *map(
        jnp.asarray, (qg, k, v)))
    assert lse.dtype == torch.float32 and lse.shape == (B, KV * G, S)
    assert _rel(lse.reshape(B, KV, G, S).numpy(), jlse) <= TOL
    assert _rel(out.numpy(), np.asarray(jout).reshape(B, S, KV * G, hd)
                ) <= TOL


@pytest.mark.parametrize("S,T,softcap", [
    (1024, 2048, 0.0), (1024, 1024, 0.0), (2048, 2048, 0.0),
    (4096, 4096, 0.0), (4096, 4096, 50.0), (1536, 1536, 0.0),
    (1600, 1600, 0.0), (2048, 1100, 0.0), (256, 8192, 0.0),
    (512, 4096, 0.0), (64, 64, 0.0), (8192, 8192, 30.0)])
def test_the_tiled_path_is_taken_where_jax_takes_it(S, T, softcap):
    want = not softcap and JA._use_flash_jnp(S, T)
    assert tops.flash_tiled(S, T, softcap) == want
    assert tref.FLASH_THRESHOLD == JA.FLASH_THRESHOLD


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_ops_backward_tiled_matches_dense(monkeypatch, causal, window):
    """``ops.flash_attention``'s gradients through the tiled path equal
    those of the dense plain version it replaces (float32, GQA)."""
    monkeypatch.setattr(tref, "FLASH_THRESHOLD", 64 * 64)
    monkeypatch.setattr(tref, "FLASH_BQ", 16)
    monkeypatch.setattr(tref, "FLASH_BK", 32)
    rng = np.random.default_rng(2)
    q, k, v, g = (torch.tensor(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 64, 6, 16), (2, 64, 2, 16), (2, 64, 2, 16),
                            (2, 64, 6, 16)))
    assert tops.flash_tiled(64, 64, 0.0)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    tops.flash_attention(*ins, causal, window).backward(g)
    dense = [t.clone().requires_grad_() for t in (q, k, v)]
    tref.flash_attention(*dense, causal=causal, window=window).backward(g)
    for a, b in zip(ins, dense):
        assert _rel(a.grad.numpy(), b.grad.numpy()) <= TOL


SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256)


def test_model_grads_match_jax_through_the_tiled_path(monkeypatch):
    """Both packages' thresholds lowered (in this test only) so that a
    tiny model at S = 64 takes the tiled attention, in (16 × 32) tiles:
    the loss and every leaf's grad against JAX's."""
    monkeypatch.setattr(JA, "FLASH_THRESHOLD", 64 * 64)
    monkeypatch.setattr(JA._sdpa_flash_jnp, "__kwdefaults__",
                        {"bq": 16, "bk": 32})
    monkeypatch.setattr(tref, "FLASH_THRESHOLD", 64 * 64)
    monkeypatch.setattr(tref, "FLASH_BQ", 16)
    monkeypatch.setattr(tref, "FLASH_BK", 32)
    calls = []
    monkeypatch.setattr(tref, "flash_bwd_rule", functools.partial(
        lambda f, *a: calls.append(a[2:4]) or f(*a), tref.flash_bwd_rule))
    jcfg = jget_config("llama-mini").replace(**SMALL)
    cfg = get_config("llama-mini").replace(**SMALL)
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(3).integers(
        0, SMALL["vocab_size"], (2, 64), dtype=np.int32)
    (jloss, _), jgrads = jax.value_and_grad(
        functools.partial(JT.lm_loss, cfg=jcfg), has_aux=True)(
            jp, batch={"tokens": jnp.asarray(tokens)})
    loss, _, grads = TS.value_and_grad(tp, cfg, {
        "tokens": torch.as_tensor(tokens)})
    assert calls and all(c == (16, 32) for c in calls)
    assert _rel(float(loss), float(jloss)) <= 1e-5
    g = pytree.flatten_with_path(grads)
    w, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    assert len(g) == len(w)
    for (p, a), (_, b) in zip(g, w):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-4, pytree.keystr(p)
