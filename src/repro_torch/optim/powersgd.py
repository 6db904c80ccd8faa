"""PowerSGD-style low-rank gradient compression with error feedback
(counterpart of ``repro/optim/powersgd.py``; DESIGN.md §5).

Each >=2-D gradient leaf M (d1, d2) is factorized as M ≈ P Qᵀ with
P (d1, r), Q (d2, r): workers all-reduce the factors (r·(d1+d2) numbers)
instead of the dense gradient (d1·d2). The residual M − P Qᵀ is kept in
local *error feedback* state and re-injected next step (Vogels et al.,
2019). ``allocate_ranks_by_reff`` spends a factor budget across leaves with
the paper's effective-rank allocator (the port's ``core.allocate``).

Leaves are named by ``jax.tree_util.keystr`` of their path (``['w']``), as
in the JAX module, so the two packages' state and rank dicts share keys.
The orthonormalization is a float32 QR; LAPACK and cuSOLVER may choose
other column signs, which P·Qnᵀ, the error feedback and the stats do not
depend on. ``cross_pod_mean(mesh)`` is the reduce between the pods: a
mean over the mesh's ``pod`` axis (``dist.comm.all_reduce_mean``), the
identity without a mesh or without that axis, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core import allocate as alloc
from repro_torch.core.numerics import effective_rank


@dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 4
    min_dim: int = 64          # leaves smaller than this stay dense
    ef: bool = True            # error feedback
    warm_start: bool = True    # reuse Q across steps


class PowerSGDState(NamedTuple):
    error: Dict                # error-feedback residuals (dense leaves)
    q: Dict                    # warm-start Q factors


def _compressible(x) -> bool:
    return x.ndim >= 2 and min(x.shape[-2], x.shape[-1]) >= 2


def _as2d(x):
    return x.reshape(-1, x.shape[-1])


def _orthonormalize(P: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt via QR (fp32)."""
    q, _ = torch.linalg.qr(P.to(torch.float32))
    return q


def init_state(grads, cfg: PowerSGDConfig,
               ranks: Optional[Dict[str, int]] = None,
               generator: Optional[torch.Generator] = None) -> PowerSGDState:
    """Zero error feedback and a standard-normal Q (d2, r) per compressible
    leaf, drawn from ``generator`` (default: seed 17 on the CPU) in
    flattening order and placed on the leaf's device."""
    if generator is None:
        generator = torch.Generator()
        generator.manual_seed(17)
    err, qs = {}, {}
    for path, leaf in pytree.flatten_with_path(grads):
        name = pytree.keystr(path)
        if not _compressible(leaf) or min(
                _as2d(leaf).shape) < cfg.min_dim:
            continue
        r = (ranks or {}).get(name, cfg.rank)
        r = max(1, min(r, min(_as2d(leaf).shape)))
        err[name] = torch.zeros_like(leaf, dtype=torch.float32)
        qs[name] = torch.randn((_as2d(leaf).shape[1], r),
                               generator=generator, dtype=torch.float32,
                               device=generator.device).to(leaf.device)
    return PowerSGDState(error=err, q=qs)


def compress_decompress(grads, state: PowerSGDState, cfg: PowerSGDConfig,
                        reduce_fn=None
                        ) -> Tuple[Dict, PowerSGDState, Dict[str, float]]:
    """One round: per compressible leaf, factorize (grad + error), reduce the
    factors with `reduce_fn` (identity if None), reconstruct, update error
    feedback. Dense leaves pass through `reduce_fn` untouched."""
    flat = pytree.flatten_with_path(grads)
    out_leaves = []
    new_err = dict(state.error)
    new_q = dict(state.q)
    dense_bytes = 0
    comp_bytes = 0
    rf = reduce_fn if reduce_fn is not None else (lambda x: x)
    for path, leaf in flat:
        name = pytree.keystr(path)
        if name not in state.q:
            out_leaves.append(rf(leaf))
            continue
        M = _as2d(leaf.to(torch.float32))
        if cfg.ef:
            M = M + _as2d(state.error[name])
        Q = state.q[name]
        P = _orthonormalize(rf(M @ Q))           # (d1, r), reduced
        Qn = rf(M.T @ P)                          # (d2, r), reduced
        Mhat = P @ Qn.T
        if cfg.ef:
            new_err[name] = (M - Mhat).reshape(leaf.shape)
        new_q[name] = Qn if cfg.warm_start else Q
        out_leaves.append(Mhat.reshape(leaf.shape).to(leaf.dtype))
        dense_bytes += M.numel() * 4
        comp_bytes += (P.numel() + Qn.numel()) * 4
    out = pytree.unflatten(grads, out_leaves)
    stats = {"dense_bytes": float(dense_bytes),
             "compressed_bytes": float(comp_bytes),
             "byte_reduction": float(dense_bytes / max(1, comp_bytes))}
    return out, PowerSGDState(error=new_err, q=new_q), stats


def cross_pod_mean(mesh=None, axis: str = "pod"):
    """Returns the reduce_fn of ``compress_decompress``: the mean over the
    mesh's ``axis`` (JAX's ``lax.pmean`` inside ``shard_map``), each rank
    averaging with the ranks that share its other coordinates; the
    identity when there is no mesh or the axis is absent."""
    if mesh is None or axis not in getattr(mesh, "axis_names", ()):
        return lambda x: x
    from repro_torch.dist import comm
    group = mesh.group(axis)

    def rf(x):
        return comm.all_reduce_mean(x, group)
    return rf


def allocate_ranks_by_reff(grads, byte_budget_frac: float,
                           cfg: PowerSGDConfig) -> Dict[str, int]:
    """Spend a fixed factor-number budget across leaves in proportion to
    sqrt(R_eff(grad)/ω) — the paper's allocator applied to gradient
    spectra (float64 SVD on the host)."""
    specs = []
    names = []
    for path, leaf in pytree.flatten_with_path(grads):
        if not _compressible(leaf) or min(_as2d(leaf).shape) < cfg.min_dim:
            continue
        name = pytree.keystr(path)
        M = _as2d(leaf).detach().to(device="cpu",
                                    dtype=torch.float64).numpy()
        sig = np.linalg.svd(M, compute_uv=False)
        reff = effective_rank(sig)
        d1, d2 = M.shape
        specs.append(alloc.GroupSpec(
            gid=name, mtype="grad", reff=reff, omega=d1 + d2,
            kmax=min(d1, d2), kmin=1, dense_params=d1 * d2))
        names.append(name)
    if not specs:
        return {}
    budget = byte_budget_frac * sum(s.dense_params for s in specs)
    kf = alloc.lagrange_allocate(specs, budget)
    ki = alloc.integerize(specs, kf, budget, multiple=1)
    return {n: int(ki[n]) for n in names}
