"""The port's chunked linear-recurrence engine
(``repro_torch.models.linear_scan``) against the JAX package's, on the CPU,
on the same numpy inputs.

``chunked_scan`` and ``step_scan`` with the normalizer on and off, a
sequence length that is not a multiple of the chunk, a non-zero initial
state and large positive log input gates (the stabilizer's case): outputs
and the final (S, n, m) within 1e-5 relative. The port's ``chunked_scan``
also against its own per-step ``reference_scan``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_scan as JL
from repro_torch.models import linear_scan as L
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

# test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

TOL = 1e-5
B, H, DK, DV = 2, 3, 8, 6


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def inputs(S: int, big_li: bool, seed: int = 0):
    """q, k, v, log_f (<= 0), log_i; with ``big_li`` the input gates sit
    around +25, where an unstabilized exp overflows float32. q and k are
    non-negative so that the normalizer n·q stays away from 0: a near-zero
    denominator amplifies float32 rounding past the tier in any two
    summation orders (the JAX package's chunked scan and its own per-step
    reference differ by 5e-4 relative on signed inputs)."""
    rng = np.random.default_rng(seed)
    q = np.abs(rng.standard_normal((B, S, H, DK))).astype(np.float32)
    k = np.abs(rng.standard_normal((B, S, H, DK))).astype(np.float32) \
        * DK ** -0.5
    v = rng.standard_normal((B, S, H, DV)).astype(np.float32)
    log_f = np.log(1.0 / (1.0 + np.exp(-(rng.standard_normal((B, S, H))
                                         + 2.0)))).astype(np.float32)
    log_i = (rng.standard_normal((B, S, H)) * 2.0
             + (25.0 if big_li else 0.0)).astype(np.float32)
    return q, k, v, log_f, log_i


def state(seed: int = 1):
    """A non-zero initial (S, n, m) as numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, DV, DK)).astype(np.float32),
            rng.standard_normal((B, H, DK)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def run_jax(fn, args, st, **kw):
    js = JL.ScanState(*(jnp.asarray(a) for a in st)) if st else None
    y, fin = fn(*(jnp.asarray(a) for a in args), js, **kw)
    return np.asarray(y), [np.asarray(a) for a in fin]


def run_port(fn, args, st, **kw):
    ts = L.ScanState(*(torch.as_tensor(a) for a in st)) if st else None
    y, fin = fn(*(torch.as_tensor(a) for a in args), ts, **kw)
    return y.numpy(), [a.numpy() for a in fin]


CASES = {   # id -> (S, chunk, normalize, initial state, big log_i)
    "ssd": (32, 16, False, False, False),
    "ssd_ragged_state": (37, 16, False, True, False),
    "mlstm": (32, 16, True, False, False),
    "mlstm_ragged_state": (37, 16, True, True, False),
    "mlstm_big_gates": (40, 16, True, True, True),
    "one_chunk_short": (5, 128, True, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_scan_matches_jax(case):
    S, chunk, normalize, with_state, big = CASES[case]
    args = inputs(S, big)
    if not normalize:                   # SSD gates: log_i = 0
        args = args[:4] + (np.zeros_like(args[4]),)
    st = state() if with_state else None
    jy, jfin = run_jax(JL.chunked_scan, args, st, chunk=chunk,
                       normalize=normalize)
    ty, tfin = run_port(L.chunked_scan, args, st, chunk=chunk,
                        normalize=normalize)
    assert ty.shape == (B, S, H, DV) and np.isfinite(ty).all()
    assert rel(ty, jy) < TOL
    for name, a, b in zip("Snm", tfin, jfin):
        assert a.shape == b.shape, name
        assert rel(a, b) < TOL, name


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["ssd", "mlstm"])
def test_step_scan_matches_jax(normalize):
    q, k, v, lf, li = (a[:, 0] for a in inputs(1, normalize, seed=3))
    st = state(seed=4)
    jy, jfin = run_jax(JL.step_scan, (q, k, v, lf, li), st,
                       normalize=normalize)
    ty, tfin = run_port(L.step_scan, (q, k, v, lf, li), st,
                        normalize=normalize)
    assert rel(ty, jy) < TOL
    for name, a, b in zip("Snm", tfin, jfin):
        assert rel(a, b) < TOL, name


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["ssd", "mlstm"])
def test_chunked_scan_matches_its_reference(normalize):
    args = inputs(45, normalize, seed=5)
    st = state(seed=6)
    ty, tfin = run_port(L.chunked_scan, args, st, chunk=16,
                        normalize=normalize)
    ry, rfin = run_port(L.reference_scan, args, st, normalize=normalize)
    assert rel(ty, ry) < TOL
    for name, a, b in zip("Snm", tfin, rfin):
        assert rel(a, b) < TOL, name
