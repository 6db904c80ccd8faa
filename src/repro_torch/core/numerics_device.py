"""Device-side compression math: batched whitening + whitened SVD + refine
(counterpart of ``repro/core/numerics_jax.py``).

``core.numerics`` stays the host fp64 precision oracle. Everything here runs
on the tensors' device (``torch.linalg`` on the card, cuSOLVER behind it)
and is batched over a leading group axis, so a whole bucket of same-shaped
matrices decomposes in one call instead of a host loop.

The decomposition avoids rectangular SVD: with ``M = S·W_cat`` the whitened
factorization comes from the eigendecomposition of the SMALL-side Gram,

    d1 <= n·d2 :  K = S (W Wᵀ) Sᵀ = M Mᵀ   (d1, d1)
                  B = S⁻¹ U_k Σ_k,   C = Σ_k⁻¹ U_kᵀ M = (S U_k)ᵀ W / σ
    d1 >  n·d2 :  K = Mᵀ M                  (n·d2, n·d2)
                  B = S⁻¹ M V_k = W V_k,    C = V_kᵀ

so the only cubic-cost op is a (min-side)² eigh and every large-dimension
contraction is a GEMM. The full singular spectrum comes out of the same
eigh, so effective-rank allocation sees the same input as the oracle.

Working precision: float64 (``DTYPE``), where the JAX module is float32
because a TPU has no fp64; the H100 runs fp64 natively, and the paper
keeps the whitening matrix S in fp64 (DESIGN.md §7.2). float32 does not
meet the tiers at SmolLM-360M's full width (measured on the card): the
Grams of its ``wo`` inputs reach condition numbers of ~4e5, so rounding
the Gram to float32 alone moves the whitened factors by up to cond·eps,
and the B·C products came out up to 8e-2 from the fp64 oracle (the JAX
module's float32 math gives the same on the same Grams, on the CPU); and
``torch.linalg.eigh`` runs float32 matrices of 33-512 rows through
cuSOLVER's Jacobi solver, whose eigenvalues were 1e-4 off. Inputs of any
float dtype are accepted; outputs are float64.

``rsvd > 0`` switches to a randomized range-finder (Gaussian sketch +
subspace iterations + small eigh) that pays only GEMMs in the large
dimensions; the truncated tail energy is restored through the trace
identity (``_dec_rsvd``). Its sketch draws from a ``torch.Generator``
seeded with ``rsvd_seed``: JAX's PRNG stream cannot be reproduced, so rsvd
results are held to tolerances, not to JAX's numbers.

The JAX module splits its pipeline into several jitted stages (XLA:CPU runs
GEMMs slower next to LAPACK calls); PyTorch runs eagerly, so each stage is
a plain function here. ``torch.linalg.cholesky_ex``'s ``info`` reports a
failed factorization where XLA returns NaNs; failures are turned into NaNs
so that callers see what JAX's see.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

MAX_DAMP_TRIES = 12          # matches numerics.cholesky_whitener
DTYPE = torch.float64        # working precision (see the module docstring)

Tensor = torch.Tensor


def _t(x: Tensor) -> Tensor:
    return x.transpose(-1, -2)


def _eye(d: int, like: Tensor) -> Tensor:
    return torch.eye(d, dtype=DTYPE, device=like.device)


def _cholesky_nan(A: Tensor) -> Tuple[Tensor, Tensor]:
    """Batched lower Cholesky factor and a per-member success mask; a
    failed member (LAPACK/cuSOLVER ``info != 0``, or a non-finite factor)
    comes out as NaNs, as XLA's cholesky reports failure."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1)
    L = torch.where(ok[..., None, None], L, torch.full_like(L, float("nan")))
    return L, ok


# ---------------------------------------------------------------------------
# Whitening: batched Cholesky with per-matrix damping escalation
# ---------------------------------------------------------------------------
def cholesky_escalate(G: Tensor, damp: float = 1e-6,
                      max_tries: int = MAX_DAMP_TRIES
                      ) -> Tuple[Tensor, Tensor]:
    """Batched damped Cholesky ``L Lᵀ = G + τI`` with the host oracle's ×10
    escalation, per batch member: members whose factorization failed get
    their τ bumped and are factored again while converged members keep
    theirs. Returns ``(L, tau)`` with L lower-triangular; a member still
    failing after ``max_tries`` escalations comes out non-finite (a
    non-finite Gram; the caller's factors surface it)."""
    lead = G.shape[:-2]
    d = G.shape[-1]
    G = G.to(DTYPE).reshape(-1, d, d)
    G = 0.5 * (G + _t(G))
    eye = _eye(d, G)
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / d
    tau = damp * torch.clamp(tr, min=1e-12)
    L, ok = _cholesky_nan(G + tau[..., None, None] * eye)
    for _ in range(max_tries):
        if bool(ok.all()):
            break
        bad = ~ok
        tau = torch.where(bad, tau * 10.0, tau)
        Lb, okb = _cholesky_nan(G[bad] + tau[bad][..., None, None] * eye)
        L[bad] = Lb
        ok = ok.clone()
        ok[bad] = okb
    return L.reshape(*lead, d, d), tau.reshape(lead)


def _fix_factor(R: Tensor) -> Tensor:
    """Normalize a streamed upper-triangular factor the way the host's
    ``numerics.whitener_from_factor`` does: fix the QR sign ambiguity by
    making the diagonal positive, and floor the diagonal so rank-deficient
    calibration streams (fewer rows than d) don't make the triangular
    solves blow up."""
    R = R.to(DTYPE)
    d = R.shape[-1]
    dia = torch.diagonal(R, dim1=-2, dim2=-1)
    s = torch.sign(dia)
    s = torch.where(s == 0, torch.ones_like(s), s)
    R = R * s[..., :, None]
    dia = dia.abs()
    floor = 1e-7 * torch.clamp(dia.amax(dim=-1, keepdim=True), min=1e-30)
    return R + (torch.maximum(dia, floor) - dia)[..., :, None] * _eye(d, R)


def _qr_r(A: Tensor) -> Tensor:
    return torch.linalg.qr(A, mode="r")[1]


def combine_factors(Rs: Tensor) -> Tensor:
    """Merge per-member streaming-whitening factors into one group factor:
    ``Rs (b, n, d, d)`` with ``R_iᵀR_i = G_i`` → R with ``RᵀR = Σ_i G_i``,
    via the R of a QR over the stacked factors (no Gram is ever formed)."""
    b, n, d, _ = Rs.shape
    return _qr_r(Rs.to(DTYPE).reshape(b, n * d, d))


def tree_reduce_factors(Rs: Tensor) -> Tensor:
    """Exact distributed-whitening reduction (DESIGN.md §1.6): merge
    per-shard factors ``Rs (m, d, d)`` into one R with ``RᵀR = Σ_i G_i``
    by PAIRWISE rounds ``R' = qr_r([R_a; R_b])``, the per-hop shape of a
    tree reduction. Any order gives the same RᵀR up to rounding and row
    signs."""
    Rs = Rs.to(DTYPE)
    m = Rs.shape[0]
    while m > 1:
        half = m // 2
        reduced = _qr_r(torch.cat([Rs[:half], Rs[half:2 * half]], dim=1))
        if m % 2:
            reduced = torch.cat([reduced, Rs[2 * half:]], dim=0)
        Rs = reduced
        m = Rs.shape[0]
    return Rs[0]


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------
def _eigh_desc(K: Tensor) -> Tuple[Tensor, Tensor]:
    """Eigenpairs in descending order. K is symmetrized first, as
    ``jnp.linalg.eigh`` does by default (``symmetrize_input``), where
    ``torch.linalg.eigh`` would read the lower triangle alone."""
    lam, V = torch.linalg.eigh(0.5 * (K + _t(K)))
    return lam.flip(-1), V.flip(-1)


def _solve_lower_t(L: Tensor, Y: Tensor) -> Tensor:
    """L⁻ᵀ Y batched (L lower-triangular)."""
    return torch.linalg.solve_triangular(_t(L), Y, upper=True)


def _cho_solve(Lk: Tensor, Y: Tensor) -> Tensor:
    """(Lk Lkᵀ)⁻¹ Y batched."""
    return _solve_lower_t(
        Lk, torch.linalg.solve_triangular(Lk, Y, upper=False))


def _whiten_big(W, L, sL):
    """M = S W for the given whitener (None/None = identity)."""
    if L is not None:
        return _t(L) @ W                     # Lᵀ W
    if sL is not None:
        return sL[:, :, None] * W
    return W


# ---------------------------------------------------------------------------
# Batched whitened decomposition
# ---------------------------------------------------------------------------
def _dec_left(W, L, sL, k):
    """d1 <= n·d2 case. Exactly one of L (cholesky lower factor) / sL
    (diag scale, (b, d1)) is given; both None means identity whitener."""
    WWt = W @ _t(W)
    if L is not None:
        K = _t(L) @ (WWt @ L)
    elif sL is not None:
        K = sL[:, :, None] * WWt * sL[:, None, :]
    else:
        K = WWt
    lam, U = _eigh_desc(K)
    sig = torch.sqrt(torch.clamp(lam, min=0.0))
    Uk = U[:, :, :k]
    sigk = sig[:, :k]
    inv_sig = (1.0 / torch.clamp(sigk, min=1e-20))[:, :, None]
    if L is not None:
        # C = (L Uk)ᵀ W / σ ; B = L⁻ᵀ (Uk Σ)  (S = Lᵀ ⇒ S⁻¹ = L⁻ᵀ)
        C = (_t(L @ Uk) @ W) * inv_sig
        B = _solve_lower_t(L, Uk * sigk[:, None, :])
    elif sL is not None:
        C = (_t(Uk * sL[:, :, None]) @ W) * inv_sig
        B = (Uk * sigk[:, None, :]) / sL[:, :, None]
    else:
        C = (_t(Uk) @ W) * inv_sig
        B = Uk * sigk[:, None, :]
    return sig, B, C


def _dec_right(W, L, sL, k):
    """d1 > n·d2 case: eigh on the (n·d2)-side Gram. B = S⁻¹ M V_k = W V_k
    for ANY whitener, so no solve is needed."""
    M = _whiten_big(W, L, sL)
    lam, V = _eigh_desc(_t(M) @ M)
    sig = torch.sqrt(torch.clamp(lam, min=0.0))
    Vk = V[:, :, :k]
    return sig, W @ Vk, _t(Vk)


def _tail_spectrum(sig_l: Tensor, tail_energy: Tensor,
                   n_tail: int) -> Tensor:
    """Synthetic spectrum for the n_tail singular values an rsvd sketch
    never saw: geometric decay ``σ²_{l+j} = σ²_l ρ^j`` continuing from the
    last estimated value, with ρ bisected per batch member so the tail sums
    to the (exactly known) truncated energy, then renormalized so the
    energy identity holds to roundoff. The final clamp at σ²_l keeps the
    full spectrum non-increasing (the allocators' ordering invariant) even
    when the sketch underestimated σ_l itself. Returns (b, n_tail)
    singular values."""
    s2 = torch.clamp(sig_l.to(DTYPE) ** 2, min=1e-30)           # (b,)
    x = tail_energy / s2                    # target Σρ^j in [0, n_tail]
    lo = torch.zeros_like(x)
    hi = torch.ones_like(x)
    for _ in range(30):                     # bisection on (0, 1)
        mid = 0.5 * (lo + hi)
        f = mid * (1.0 - mid ** n_tail) / (1.0 - mid + 1e-12)
        below = f < x
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    rho = 0.5 * (lo + hi)
    j = torch.arange(1, n_tail + 1, dtype=DTYPE, device=s2.device)
    t = s2[:, None] * rho[:, None] ** j                         # (b, n)
    t = t * (tail_energy / torch.clamp(t.sum(dim=1), min=1e-30))[:, None]
    return torch.sqrt(torch.minimum(t, s2[:, None]))


def _dec_rsvd(W, L, sL, k, oversample, iters, seed):
    """Randomized range-finder decomposition. Only GEMMs touch the large
    dimensions; the eigh is (k+oversample)². The returned spectrum is the
    top-l estimate extended by a synthetic geometric tail carrying the
    exact truncated energy (``‖M‖²_F − Σ_top-l σ̂²``, ``_tail_spectrum``),
    so effective-rank allocation stays honest for rsvd buckets."""
    b, d1, nd2 = W.shape
    ell = min(k + oversample, d1, nd2)
    M = _whiten_big(W, L, sL)
    gen = torch.Generator(device=W.device)
    gen.manual_seed(seed)
    omega = torch.randn((b, nd2, ell), generator=gen, dtype=DTYPE,
                        device=W.device)
    Q = torch.linalg.qr(M @ omega).Q
    for _ in range(iters):
        Q = torch.linalg.qr(M @ (_t(M) @ Q)).Q
    T = _t(M) @ Q                                   # Mᵀ Q : (b, nd2, l)
    lam, Uh = _eigh_desc(_t(T) @ T)
    sig = torch.sqrt(torch.clamp(lam, min=0.0))     # top-l spectrum
    n_tail = min(d1, nd2) - ell
    if n_tail > 0:
        total = (M * M).sum(dim=(1, 2))             # Σ σ², exact
        captured = torch.clamp(lam, min=0.0).sum(dim=1)
        tail = torch.clamp(total - captured, min=0.0)
        sig = torch.cat(
            [sig, _tail_spectrum(sig[:, ell - 1], tail, n_tail)], dim=1)
    Uk = Q @ Uh[:, :, :k]
    sigk = sig[:, :k]
    C = _t(T @ Uh[:, :, :k]) * (1.0 / torch.clamp(sigk, min=1e-20)
                                 )[:, :, None]
    if L is not None:
        B = _solve_lower_t(L, Uk * sigk[:, None, :])
    elif sL is not None:
        B = (Uk * sigk[:, None, :]) / sL[:, :, None]
    else:
        B = Uk * sigk[:, None, :]
    return sig, B, C


def decompose(W: Tensor, *, gram: Optional[Tensor] = None,
              factor: Optional[Tensor] = None,
              diag: Optional[Tensor] = None,
              k: int, damp: float = 1e-6, rsvd: int = 0,
              rsvd_oversample: int = 8, rsvd_iters: int = 2,
              rsvd_seed: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """Batched whitened rank-k decomposition of ``W (b, d1, n·d2)``.

    Whitener: ``gram`` (b, d1, d1) → damped Cholesky on the device;
    ``factor`` (b, d1, d1) upper-triangular R with RᵀR = G (streaming
    whitening, skips the Cholesky); ``diag`` (b, d1) scale; none →
    identity. Every input is a tensor on one device; the math runs there
    in ``DTYPE``.

    Returns ``(sig, B, C)`` with ``W ≈ B @ C`` at rank k in the ORIGINAL
    space, B (b, d1, k), C (b, k, n·d2), and sig the full whitened
    spectrum. With ``rsvd > 0`` only the top-(k+oversample) entries are
    estimated individually; the rest are a synthetic tail holding the exact
    truncated energy (``_tail_spectrum``).
    """
    assert sum(x is not None for x in (gram, factor, diag)) <= 1
    W = W.to(DTYPE)
    L = sL = None
    if gram is not None:
        L, _ = cholesky_escalate(gram, damp)
    elif factor is not None:
        L = _t(_fix_factor(factor))
    elif diag is not None:
        sL = diag.to(DTYPE)
    k = int(min(k, W.shape[-1], W.shape[-2]))
    if rsvd:
        return _dec_rsvd(W, L, sL, k, int(rsvd_oversample), int(rsvd_iters),
                         int(rsvd_seed))
    if W.shape[-2] <= W.shape[-1]:
        return _dec_left(W, L, sL, k)
    return _dec_right(W, L, sL, k)


# ---------------------------------------------------------------------------
# Batched refine solve: C* = (BᵀGB)⁻¹ BᵀGW
# ---------------------------------------------------------------------------
def refine_solve(B: Tensor, G: Optional[Tensor], W: Tensor,
                 eps: float = 1e-8,
                 factor: Optional[Tensor] = None) -> Tensor:
    """Batched closed-form coefficient update against a NEW Gram G (the
    refine pass re-captures G through the compressed model):

        C* = argmin_C ‖X(W − BC)‖_F = (BᵀGB + εI)⁻¹ BᵀGW.

    Factoring G = L₂L₂ᵀ once turns BᵀGB into FᵀF with F = L₂ᵀB and BᵀGW
    into (L₂ D)ᵀ W after the small solve D = (BᵀGB)⁻¹Fᵀ, so every
    large-dimension op is a GEMM and the solves are k×k / k×d only.
    B (b, d, k), G (b, d, d), W (b, d, m) → C (b, k, m).

    ``factor`` (upper-triangular R, RᵀR = G, the streaming-whitening form)
    replaces ``G``: L₂ = Rᵀ directly, so no Gram is formed.
    """
    assert (G is None) != (factor is None)
    B = B.to(DTYPE)
    W = W.to(DTYPE)
    if factor is not None:
        L2 = _t(_fix_factor(factor))
    else:
        L2, _ = cholesky_escalate(G, 1e-9)
    F = _t(L2) @ B
    BtGB = _t(F) @ F
    k = B.shape[-1]
    tr = torch.diagonal(BtGB, dim1=-2, dim2=-1).sum(-1) / max(1, k)
    BtGB = BtGB + (eps * torch.clamp(tr, min=1e-12))[:, None, None] \
        * _eye(k, B)
    Lk, _ = _cholesky_nan(BtGB)
    D = _cho_solve(Lk, _t(F))                       # (b, k, d) — small RHS
    Et = L2 @ _t(D)                                 # L₂ Dᵀ : (b, d, k)
    return _t(Et) @ W                               # Etᵀ W = C*
