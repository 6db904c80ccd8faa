"""The port's kernel ops on the CPU (their plain PyTorch versions) against
the JAX package's ops (Pallas kernels in interpret mode) and its jnp
oracles, on the same numpy inputs. The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (
    decode_attention_bkgh, decode_attention_paged_bkgh)
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.lowrank_matmul import lowrank_gemv, lowrank_matmul_2d
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:15


def _rnd(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _rel_err(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


def _t(a, dtype="float32"):
    return torch.tensor(a).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,R,N", [
    (1, 96, 12, 80),          # decode-shaped single token, ragged K/N
    (5, 200, 24, 300),        # ragged everything, gemv route
    (130, 64, 8, 96),         # prefill route (M > 64)
])
def test_lowrank_matmul_matches_jax(M, K, R, N, dtype):
    rng = np.random.default_rng(0)
    x, B, C = _rnd(rng, (M, K)), _rnd(rng, (K, R), 0.1), _rnd(rng, (R, N), 0.1)
    y = _np(tops.lowrank_matmul(_t(x, dtype), _t(B, dtype), _t(C, dtype)))
    yk = jops.lowrank_matmul(_j(x, dtype), _j(B, dtype), _j(C, dtype))
    yr = jref.lowrank_matmul(_j(x, dtype), _j(B, dtype), _j(C, dtype))
    assert _rel_err(y, yk.astype(jnp.float32)) < TOL[dtype]
    assert _rel_err(y, yr.astype(jnp.float32)) < TOL[dtype]


def test_lowrank_matmul_leading_dims_and_grads():
    rng = np.random.default_rng(1)
    x = _t(_rnd(rng, (2, 3, 8, 32))).requires_grad_()
    B = _t(_rnd(rng, (32, 6), 0.2)).requires_grad_()
    C = _t(_rnd(rng, (6, 24), 0.2)).requires_grad_()
    y = tops.lowrank_matmul(x, B, C)
    assert y.shape == (2, 3, 8, 24)
    g1 = torch.autograd.grad((y ** 2).sum(), (x, B, C))
    g2 = torch.autograd.grad((((x @ B) @ C) ** 2).sum(), (x, B, C))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,cap", [
    (1, 40, 6, 2, 16, True, 0, 0.0),       # GQA G=3, ragged S
    (1, 48, 4, 4, 32, True, 16, 0.0),      # MHA sliding window
    (2, 24, 3, 1, 16, True, 0, 30.0),      # MQA G=3 + softcap
    (1, 20, 2, 2, 16, False, 0, 0.0),      # bidirectional, ragged keys
    (1, 20, 4, 2, 256, True, 8, 30.0),     # gemma3's hd 256, G=2, window
])
def test_flash_attention_matches_jax(B, S, H, KV, hd, causal, window, cap):
    rng = np.random.default_rng(2)
    q, k, v = (_rnd(rng, (B, S, H, hd)), _rnd(rng, (B, S, KV, hd)),
               _rnd(rng, (B, S, KV, hd)))
    o = _np(tops.flash_attention(_t(q), _t(k), _t(v), causal, window, cap))
    ok = jops.flash_attention(_j(q), _j(k), _j(v), causal, window, cap)
    orf = jref.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                               window=window, softcap=cap)
    assert np.max(np.abs(o - np.asarray(ok))) < TOL["float32"]
    assert np.max(np.abs(o - np.asarray(orf))) < TOL["float32"]


def test_flash_attention_grad_is_reference_formulation():
    rng = np.random.default_rng(3)
    q, k, v = (_t(_rnd(rng, (1, 16, 6, 16))).requires_grad_(),
               _t(_rnd(rng, (1, 16, 2, 16))), _t(_rnd(rng, (1, 16, 2, 16))))
    g1, = torch.autograd.grad((tops.flash_attention(q, k, v) ** 2).sum(), q)
    g2, = torch.autograd.grad((tref.flash_attention(q, k, v) ** 2).sum(), q)
    torch.testing.assert_close(g1, g2, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("L,window,lengths,hd", [
    # full layout: dead slot + mixed lengths
    pytest.param(48, 0, [0, 5, 17, 40], 16, id="48-0-lengths0"),
    # ring layout: dead, partial, full, wrapped
    pytest.param(16, 16, [0, 3, 16, 37], 16, id="16-16-lengths1"),
    # gemma3's hd 256, full and ring
    pytest.param(40, 0, [0, 7, 40], 256, id="40-0-hd256"),
    pytest.param(8, 8, [0, 5, 13], 256, id="8-8-hd256"),
])
def test_decode_attention_matches_jax(L, window, lengths, hd):
    rng = np.random.default_rng(4)
    B, H, KV = len(lengths), 6, 2
    q, k, v = (_rnd(rng, (B, H, hd)), _rnd(rng, (B, L, KV, hd)),
               _rnd(rng, (B, L, KV, hd)))
    ln = np.asarray(lengths, dtype=np.int32)
    o = _np(tops.decode_attention(_t(q), _t(k), _t(v), torch.tensor(ln),
                                  window=window))
    ok = jops.decode_attention(_j(q), _j(k), _j(v), jnp.asarray(ln),
                               window=window)
    orf = jref.decode_attention(_j(q), _j(k), _j(v), jnp.asarray(ln),
                                window=window)
    assert np.all(o[0] == 0.0)                       # dead slot: exact zeros
    assert np.max(np.abs(o - np.asarray(ok))) < TOL["float32"]
    assert np.max(np.abs(o - np.asarray(orf))) < TOL["float32"]


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its CUDA kernel or raises: it never computes on
    the CPU itself (that is the ops layer's plain route)."""
    x = torch.zeros(2, 8)
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError):
        lowrank_gemv(x, torch.zeros(8, 4), torch.zeros(4, 8))
    with pytest.raises(ValueError):
        lowrank_matmul_2d(x, torch.zeros(8, 4), torch.zeros(4, 8))
    with pytest.raises(ValueError):
        flash_attention_bshd(q, q, q)
    with pytest.raises(ValueError):
        decode_attention_bkgh(q, q, q, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_attention_paged_bkgh(q, q, q, torch.ones(1, dtype=torch.int32),
                                    torch.ones(1, 2, dtype=torch.int32))
    assert (lowrank_gemv.launches, lowrank_matmul_2d.launches,
            flash_attention_bshd.launches, decode_attention_bkgh.launches,
            decode_attention_paged_bkgh.launches) == (0, 0, 0, 0, 0)


def test_gram_plain_version():
    rng = np.random.default_rng(5)
    x = _rnd(rng, (100, 24))
    g = tref.gram(_t(x)).numpy()
    assert _rel_err(g, jref.gram(_j(x))) < 5e-6
