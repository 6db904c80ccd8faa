"""Rank allocation: the paper's Lagrange-multiplier closed form (eq 13–19),
the β attention rebalance (eq 9–12), and the budget-exact integerization /
MXU-alignment layer (beyond-paper; DESIGN.md §7.1).

Optimization problem:   min Σ_g R_eff(g)/k_g   s.t.  Σ_g k_g ω_g = T_budget
Closed form:            k_g ∝ sqrt(R_eff(g) / ω_g)

with ω_g = d1 + n·d2 (params per unit rank of a shared-basis group). Groups
are clamped to [k_min, k_max] (k_max = rank cap AND cost-neutrality cap
n·d1·d2/ω) by iterative water-filling: clamped groups drop out and the
multiplier is re-solved on the rest.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np


@dataclass
class GroupSpec:
    gid: str
    mtype: str
    reff: float
    omega: int            # params per unit rank: d1 + n*d2
    kmax: int             # min(matrix rank cap, cost-neutral cap)
    kmin: int = 1
    dense_params: int = 0  # n * d1 * d2


def lagrange_allocate(groups: Sequence[GroupSpec],
                      budget: float) -> Dict[str, float]:
    """Water-filled closed-form allocation (float ranks)."""
    k: Dict[str, float] = {}
    clamped: Dict[str, float] = {}
    active = list(groups)
    for _ in range(len(groups) + 1):
        rem = budget - sum(clamped[g.gid] * g.omega for g in groups
                           if g.gid in clamped)
        denom = sum(math.sqrt(max(g.reff, 1e-9) * g.omega) for g in active)
        if not active or denom <= 0:
            break
        C = rem / denom
        changed = False
        for g in list(active):
            kg = C * math.sqrt(max(g.reff, 1e-9) / g.omega)
            if kg >= g.kmax:
                clamped[g.gid] = float(g.kmax)
                active.remove(g)
                changed = True
            elif kg <= g.kmin:
                clamped[g.gid] = float(g.kmin)
                active.remove(g)
                changed = True
            else:
                k[g.gid] = kg
        if not changed:
            break
    k.update(clamped)
    return k


def beta_rebalance(groups: Sequence[GroupSpec], k: Dict[str, float],
                   beta: float,
                   qk_types=("q", "k"), v_type: str = "v"
                   ) -> Dict[str, float]:
    """Paper eq (9)–(12): move a β-fraction of the Q/K rank budget to V,
    distributing the extracted rank evenly across V groups. Performed in
    *rank* units exactly as the paper defines (cost differences between Q/K
    and V groups are second-order; the integerization layer repairs the
    budget afterwards)."""
    if not beta:
        return dict(k)
    out = dict(k)
    by_type: Dict[str, List[GroupSpec]] = {}
    for g in groups:
        by_type.setdefault(g.mtype, []).append(g)
    vs = by_type.get(v_type, [])
    if not vs:
        return out
    extracted = 0.0
    for t in qk_types:
        for g in by_type.get(t, []):
            take = beta * out[g.gid]
            out[g.gid] -= take
            extracted += take
    t_add = extracted / len(vs)
    for g in vs:
        out[g.gid] = min(float(g.kmax), out[g.gid] + t_add)
    return out


def integerize(groups: Sequence[GroupSpec], k: Dict[str, float],
               budget: float, multiple: int = 1) -> Dict[str, int]:
    """Round ranks to `multiple` and repair the budget while staying as
    close as possible to the TARGET allocation `k` (which already encodes
    the Lagrange optimum *and* the β rebalance — the repair must preserve
    those proportions, not re-optimize them away).

    Greedy: shrink the group whose integer rank exceeds its target by the
    largest relative margin; grow the one furthest below target.
    """
    gm = {g.gid: g for g in groups}

    def clampk(g: GroupSpec, v: float) -> int:
        m = multiple
        vi = int(round(v / m)) * m
        lo = min(g.kmin, g.kmax)
        lo = max(lo, m if g.kmax >= m else 1)
        return int(max(lo, min(g.kmax, vi if vi > 0 else lo)))

    out = {gid: clampk(gm[gid], v) for gid, v in k.items()}
    # the integer cost Σ k·omega, kept as a running total: every term is an
    # int, so it equals a fresh sum exactly, at O(1) a step instead of O(G)
    cost = sum(out[g] * gm[g].omega for g in out)

    def over_target(g: GroupSpec) -> float:
        """Relative excess of the integer rank over its float target."""
        kg = out[g.gid]
        step = min(multiple, kg - max(1, min(g.kmin, kg)))
        if step <= 0:
            return -math.inf
        return (kg - k[g.gid]) / max(k[g.gid], 1.0)

    def under_target(g: GroupSpec) -> float:
        kg = out[g.gid]
        if kg + 1 > g.kmax:
            return -math.inf
        return (k[g.gid] - kg) / max(k[g.gid], 1.0)

    guard = 0
    while cost > budget and guard < 100000:
        guard += 1
        g = max(groups, key=over_target)
        if over_target(g) is -math.inf:
            break
        kg = out[g.gid]
        step = min(multiple, kg - max(1, min(gm[g.gid].kmin, kg)))
        out[g.gid] = kg - step
        cost -= step * g.omega
    guard = 0
    while guard < 100000:
        guard += 1
        cands = [g for g in groups if under_target(g) > 0]
        if not cands:
            break
        g = max(cands, key=under_target)
        step = multiple if out[g.gid] + multiple <= g.kmax \
            else g.kmax - out[g.gid]
        if step <= 0 or cost + step * g.omega > budget:
            break
        out[g.gid] += step
        cost += step * g.omega
    # top-up: if targets were capped (e.g. β pushed V to kmax) budget may be
    # left unspent — spend it on the relatively most-compressed groups so
    # the achieved ratio matches the requested one
    guard = 0
    while guard < 100000:
        guard += 1
        cands = [g for g in groups
                 if out[g.gid] < g.kmax
                 and cost + min(multiple, g.kmax - out[g.gid]) * g.omega
                 <= budget]
        if not cands:
            break
        g = min(cands, key=lambda g: out[g.gid] / max(k[g.gid], 1.0))
        step = min(multiple, g.kmax - out[g.gid])
        out[g.gid] += step
        cost += step * g.omega
    return out


def energy_allocate(groups: Sequence[GroupSpec],
                    sigmas: Dict[str, "np.ndarray"], budget: float,
                    multiple: int = 1) -> Dict[str, int]:
    """BEYOND-PAPER allocator: greedy water-filling on the measured
    whitened spectra — buy the rank block with the highest marginal
    RELATIVE energy recovered per parameter:

        argmax_g  Σ_{i=k_g}^{k_g+m} σ̂_{g,i}²  / (m·ω_g),
        σ̂_g = σ_g / ‖σ_g‖          (scale-invariant, like R_eff)

    Globally optimal for the separable normalized-energy objective (σ² is
    non-increasing). Normalization matters: raw energy starves small-scale
    groups whose downstream sensitivity is large (measured: unnormalized
    greedy catastrophically breaks the model at 50%; see EXPERIMENTS.md
    §Claims). Beats the paper's R_eff/k proxy at 20–30% compression.
    """
    k = {g.gid: 0 for g in groups}
    spent = 0.0
    norm2 = {}
    for g in groups:
        s2 = np.asarray(sigmas[g.gid], dtype=np.float64) ** 2
        norm2[g.gid] = s2 / max(s2.sum(), 1e-30)

    def marginal(g: GroupSpec):
        kg = k[g.gid]
        m = min(multiple, g.kmax - kg)
        if m <= 0:
            return None
        gain = float(norm2[g.gid][kg:kg + m].sum())
        return (-gain / (m * g.omega), m, g.gid)

    heap = []
    gm = {g.gid: g for g in groups}
    for g in groups:
        entry = marginal(g)
        if entry:
            heapq.heappush(heap, entry)
    while heap:
        neg, m, gid = heapq.heappop(heap)
        g = gm[gid]
        cur = marginal(g)
        if cur is None or abs(cur[0] - neg) > 1e-18 * max(1, abs(neg)):
            if cur:
                heapq.heappush(heap, cur)      # stale entry, reinsert fresh
            continue
        if spent + m * g.omega > budget:
            continue
        k[gid] += m
        spent += m * g.omega
        nxt = marginal(g)
        if nxt:
            heapq.heappush(heap, nxt)
    for g in groups:                            # floors
        k[g.gid] = max(k[g.gid], min(g.kmin, g.kmax), 1)
    return k


def uniform_allocate(groups: Sequence[GroupSpec], ratio: float,
                     multiple: int = 1) -> Dict[str, int]:
    """The baselines' allocator: every group keeps the same parameter
    fraction — k_g = (1-θ)·dense_params/ω, independently of content."""
    out: Dict[str, int] = {}
    for g in groups:
        kf = (1.0 - ratio) * g.dense_params / g.omega
        m = multiple
        kg = int(round(kf / m)) * m if m > 1 else int(math.floor(kf))
        out[g.gid] = max(min(g.kmin, g.kmax), min(g.kmax, max(1, kg)))
    return out


def allocation_summary(groups: Sequence[GroupSpec],
                       k: Dict[str, int]) -> Dict[str, float]:
    dense = sum(g.dense_params for g in groups)
    comp = sum(k[g.gid] * g.omega for g in groups)
    return {
        "dense_params": dense,
        "compressed_params": comp,
        "achieved_ratio": 1.0 - comp / max(1, dense),
        "total_loss_proxy": sum(g.reff / max(1, k[g.gid]) for g in groups),
    }
