"""Whitening + effective-rank numerics (host-side, fp64).

The paper (following SVD-LLM / Basis Sharing) whitens each weight with the
Cholesky factor of the calibration Gram matrix: with ``G = XᵀX = L Lᵀ``,
``‖X·ΔW‖²_F = ‖Lᵀ·ΔW‖²_F``, so the Eckart–Young-optimal activation-aware
rank-k approximation is the truncated SVD of ``S·W`` with ``S = Lᵀ``,
reconstructed as ``W ≈ S⁻¹ (U_k Σ_k) V_kᵀ = B C``.

All of this runs in numpy float64 on host — TPUs have no fp64, and the
paper explicitly keeps S in fp64 (DESIGN.md §7.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class Whitener:
    """Either a triangular matrix pair or a diagonal scale vector."""
    S: Optional[np.ndarray] = None          # (d, d) upper triangular
    S_inv: Optional[np.ndarray] = None      # (d, d)
    diag: Optional[np.ndarray] = None       # (d,) positive scale

    def apply(self, W: np.ndarray) -> np.ndarray:
        if self.diag is not None:
            return self.diag[:, None] * W
        if self.S is not None:
            return self.S @ W
        return W

    def unapply_basis(self, B: np.ndarray) -> np.ndarray:
        """Map a basis of the whitened space back: B_orig = S⁻¹ B."""
        if self.diag is not None:
            return B / self.diag[:, None]
        if self.S is not None:
            return self.S_inv @ B
        return B


def cholesky_whitener(G: np.ndarray, damp: float = 1e-6) -> Whitener:
    """G: (d, d) fp64 Gram. Damped for rank-deficient calibration sets;
    escalates damping ×10 until the factorization succeeds."""
    d = G.shape[0]
    if not np.isfinite(G).all():
        # LAPACK may "succeed" on NaN/inf input and hand back a NaN
        # factor; fail loudly instead of whitening with garbage
        raise np.linalg.LinAlgError(
            "cholesky whitener got a non-finite Gram; "
            + _gram_condition_report(G))
    G = 0.5 * (G + G.T)
    tau = damp * max(np.trace(G) / d, 1e-12)
    eye = np.eye(d)
    taus = []
    for _ in range(12):
        taus.append(tau)
        try:
            L = np.linalg.cholesky(G + tau * eye)
            S = L.T                                  # upper triangular
            S_inv = np.linalg.solve(S, eye)          # triangular solve
            return Whitener(S=S, S_inv=S_inv)
        except np.linalg.LinAlgError:
            tau *= 10.0
    raise np.linalg.LinAlgError(
        f"cholesky failed after {len(taus)} damping escalations "
        f"(taus tried: {taus[0]:.3e} .. {taus[-1]:.3e}); "
        + _gram_condition_report(G))


def _gram_condition_report(G: np.ndarray) -> str:
    """Diagnostic tail for the escalation failure message: a condition
    estimate when the Gram is finite, the non-finite count when it isn't
    (the only way damping can fail 12 times)."""
    bad = int(np.size(G) - np.isfinite(G).sum())
    if bad:
        return f"Gram has {bad} non-finite entries"
    try:
        lam = np.linalg.eigvalsh(G)
        cond = abs(lam).max() / max(abs(lam).min(), 1e-300)
        return (f"Gram condition estimate {cond:.3e} "
                f"(eig range [{lam.min():.3e}, {lam.max():.3e}])")
    except np.linalg.LinAlgError:
        return "Gram condition estimate unavailable (eigvalsh failed)"


def whitener_from_factor(R: np.ndarray) -> Whitener:
    """Whitener from an upper-triangular factor with ``RᵀR = G`` — the
    streaming-whitening output (capture.StreamingCalibrator whiten_tags /
    numerics_jax.combine_factors), which never materializes G. QR sign
    ambiguity is fixed by making the diagonal positive; a tiny diagonal
    floor guards rank-deficient streams the way damping does for Grams."""
    R = np.asarray(R, dtype=np.float64)
    d = R.shape[0]
    s = np.sign(np.diag(R))
    s[s == 0] = 1.0
    S = s[:, None] * R
    floor = 1e-7 * max(np.abs(np.diag(S)).max(), 1e-30)
    dia = np.diag(S).copy()
    S[np.arange(d), np.arange(d)] = np.maximum(dia, floor)
    S_inv = np.linalg.solve(S, np.eye(d))
    return Whitener(S=S, S_inv=S_inv)


def diag_whitener(scale: np.ndarray, floor: float = 1e-8) -> Whitener:
    s = np.maximum(np.asarray(scale, dtype=np.float64), floor)
    return Whitener(diag=s)


def identity_whitener() -> Whitener:
    return Whitener()


# ---------------------------------------------------------------------------
# Effective rank (the paper's metric, §3.2.1)
# ---------------------------------------------------------------------------
def effective_rank(singular_values: np.ndarray, eps: float = 1e-12) -> float:
    """exp(Shannon entropy of the normalized squared singular values).

    Properties (tested): scale-invariant; 1 <= R_eff <= #nonzero σ; equals
    the count for a flat spectrum.
    """
    lam = np.asarray(singular_values, dtype=np.float64) ** 2
    total = lam.sum()
    if total <= eps:
        return 1.0
    p = lam / total
    p = p[p > eps]
    return float(np.exp(-(p * np.log(p)).sum()))


def whitened_svd(W_cat: np.ndarray, wh: Whitener
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SVD of the whitened concatenated group matrix. Returns (U, σ, Vᵀ)."""
    M = wh.apply(np.asarray(W_cat, dtype=np.float64))
    return np.linalg.svd(M, full_matrices=False)


def truncate_factors(U: np.ndarray, sig: np.ndarray, Vt: np.ndarray, k: int,
                     wh: Whitener) -> Tuple[np.ndarray, np.ndarray]:
    """Rank-k factors in the ORIGINAL space: B (d1, k), C (k, n·d2),
    with W_cat ≈ B @ C."""
    B = wh.unapply_basis(U[:, :k] * sig[None, :k])
    return B, Vt[:k]
