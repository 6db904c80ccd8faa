"""The port's streaming calibration against the JAX package's, on the same
bridged weights and calibration batches.

Tiers (DESIGN.md §1.3): the Gram op within 1e-4 of numpy fp64; streaming
Grams and mean |x| within 1e-4 relative of JAX's streaming capture and of
the port's eager fp64 ``Collector``, on every tag, with equal row counts;
the fp64 host fold independent of the flush cadence within 1e-6; streamed
whitening factors with RᵀR within 1e-5 of JAX's.

On the CPU ``kernels.ops.gram`` runs its plain version; the JAX
``kernels.ops.gram`` runs the Pallas kernel in interpret mode."""
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
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import capture as Cap
from repro_torch.core import compress as CC
from repro_torch.kernels import gram as kgram
from repro_torch.kernels import ops
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 1e-4
CPU = torch.device("cpu")
_KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
           d_ff=128, vocab_size=256, rank_multiple=4, dtype="float32")


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@functools.lru_cache(maxsize=None)
def _setup():
    """(cfg, JAX cfg, JAX list params, port list params, JAX batches, port
    batches); three batches of 2 x 32 tokens from one numpy seed."""
    cfg = get_config("llama-mini").replace(**_KW)
    jcfg = jget_config("llama-mini").replace(**_KW)
    jp, _ = JT.init_model(jcfg, jax.random.PRNGKey(0))
    tp = bridge.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
            for _ in range(3)]
    return (cfg, jcfg, JCap.to_list_params(jp, jcfg),
            Cap.to_list_params(tp, cfg),
            [{"tokens": jnp.asarray(t)} for t in toks],
            [{"tokens": torch.as_tensor(t)} for t in toks])


def _assert_parity(got, want, rtol=RTOL):
    assert sorted(got.gram) == sorted(want.gram)
    for tag in want.gram:
        assert _rel(got.gram[tag], want.gram[tag]) < rtol, tag
        assert _rel(got.mean_abs(tag), want.mean_abs(tag)) < rtol, tag
        assert got.count[tag] == want.count[tag], tag


# ---------------------------------------------------------------------------
# the Gram op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,D", [(7, 12), (100, 48), (513, 96), (1000, 97)])
def test_gram_op_matches_jax_kernel_and_fp64(N, D):
    x = np.random.default_rng(N).normal(size=(N, D)).astype(np.float32)
    g = ops.gram(torch.as_tensor(x)).numpy()
    assert g.dtype == np.float32 and g.shape == (D, D)
    jg = np.asarray(jops.gram(jnp.asarray(x)))      # Pallas, interpret mode
    xd = x.astype(np.float64)
    assert _rel(g, xd.T @ xd) < RTOL
    assert _rel(g, jg) < RTOL


def test_gram_op_accumulates_into_out_and_widens_bf16():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(3, 20, 16)).astype(np.float32))
    acc = torch.as_tensor(rng.normal(size=(16, 16)).astype(np.float32))
    want = acc.double() + ops.gram(x).double()
    got = ops.gram(x, out=acc)
    assert got is acc                                # in place
    assert _rel(got.numpy(), want.numpy()) < 1e-6
    xb = x.to(torch.bfloat16)
    assert torch.equal(ops.gram(xb), ops.gram(xb.float()))


def test_gram_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        kgram.gram_blocked(torch.zeros(4, 8))
    assert kgram.gram_blocked.launches == 0


# ---------------------------------------------------------------------------
# streaming capture
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _collectors():
    cfg, jcfg, jlp, tlp, jcal, tcal = _setup()
    return {
        "port": Cap.streaming_calibrate(tlp, cfg, tcal),
        "jax": JCap.streaming_calibrate(jlp, jcfg, jcal),
        "eager": CC.calibrate(tlp, cfg, tcal, streaming=False),
    }


def test_streaming_matches_jax_streaming_every_tag():
    cols = _collectors()
    _assert_parity(cols["port"], cols["jax"])


def test_streaming_matches_eager_fp64_collector_every_tag():
    cols = _collectors()
    _assert_parity(cols["port"], cols["eager"])
    assert not cols["port"].chol


def test_calibrate_defaults_to_streaming():
    cfg, _, _, tlp, _, tcal = _setup()
    col = CC.calibrate(tlp, cfg, tcal)
    _assert_parity(col, _collectors()["port"], rtol=1e-12)


def test_streaming_flush_boundary_invariance():
    cfg, _, _, tlp, _, tcal = _setup()
    col1 = Cap.streaming_calibrate(tlp, cfg, tcal, flush_every=1)
    col8 = Cap.streaming_calibrate(tlp, cfg, tcal, flush_every=8)
    for tag in col8.gram:
        assert _rel(col1.gram[tag], col8.gram[tag]) < 1e-6, tag
        assert col1.count[tag] == col8.count[tag]


def test_discover_capture_dims_matches_jax():
    cfg, jcfg, jlp, tlp, jcal, tcal = _setup()
    got = Cap.discover_capture_dims(Cap.tag_linears(tlp), cfg, tcal[0])
    want = JCap.discover_capture_dims(JCap.tag_linears(jlp), jcfg, jcal[0])
    assert got == want


def test_streaming_whitening_factor_matches_jax():
    cfg, jcfg, jlp, tlp, jcal, tcal = _setup()
    cal = Cap.StreamingCalibrator(tlp, cfg, whiten_tags=True)
    for b in tcal:
        cal.ingest(b)
    col = cal.finalize()
    jcol = JC.calibrate(jlp, jcfg, jcal, whiten_tags=True)
    assert set(cal.routes.values()) == {"whiten"}
    assert not col.gram and sorted(col.chol) == sorted(jcol.chol)
    eager = _collectors()["eager"]
    for tag, R in col.chol.items():
        assert np.allclose(R, np.triu(R))              # upper triangular
        jR = jcol.chol[tag]
        assert _rel(R.T @ R, jR.T @ jR) < 1e-5, tag    # free of row signs
        assert _rel(R.T @ R, eager.gram[tag]) < RTOL, tag
        assert col.count[tag] == jcol.count[tag]
        assert _rel(col.mean_abs(tag), jcol.mean_abs(tag)) < RTOL


def test_whiten_tags_subset_and_eager_refusal():
    cfg, _, _, tlp, _, tcal = _setup()
    tag = "decoder/run0/0/attn/wq"
    col = CC.calibrate(tlp, cfg, tcal, whiten_tags=[tag])
    assert list(col.chol) == [tag] and tag not in col.gram
    with pytest.raises(ValueError, match="streaming"):
        CC.calibrate(tlp, cfg, tcal, streaming=False, whiten_tags=[tag])


def test_to_stacked_params_inverts_to_list_params():
    cfg, _, _, tlp, _, _ = _setup()
    st = Cap.to_stacked_params(tlp, cfg)
    back = Cap.to_list_params(st, cfg)
    for i in range(cfg.n_layers):
        a = tlp["decoder"]["run0"][i]["attn"]["wq"]["w"]
        b = back["decoder"]["run0"][i]["attn"]["wq"]["w"]
        assert torch.equal(a, b)
    assert st["decoder"]["run0"]["mlp"]["w_up"]["w"].shape[0] == cfg.n_layers
