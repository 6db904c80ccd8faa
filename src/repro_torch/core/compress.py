"""D-Rank compression pipeline + the baselines whose host path needs no
gradients (counterpart of ``repro/core/compress.py``).

Methods (all post-training, calibration-data-driven):
  svd      plain truncated SVD             (no whitening, n=1, uniform k)
  asvd     activation-aware SVD            (diag scale (mean|X|)^α)
  svdllm   whitened SVD                    (Cholesky of XᵀX, n=1, uniform)
  basis    Basis Sharing                   (whitened, grouped n>1, uniform)
  drank    THE PAPER: whitened, grouped (GQA→n=1), effective-rank Lagrange
           allocation + β attention rebalance.
  dranke   beyond-paper energy water-filling allocation.

Calibration is the eager fp64 capture (``streaming=False``). The
decomposition is the host oracle of the JAX package: per-group whitening,
SVD and truncation in numpy float64 on the host (``LINALG``), then the
factors go back to the device the params live on. The deploy artifact is a
list-form params tree whose linears are factorized {B, C} with a shared
basis per group, loadable straight into the model.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import allocate as alloc
from repro_torch.core import numerics as num
from repro_torch.core.capture import Collector, tag_linears, to_list_params
from repro_torch.core.groups import (BETA_MAP, Group, MatrixRef,
                                     build_groups, enumerate_matrices)
from repro_torch.models import transformer as T
from repro_torch.models.params import Params

METHODS = ("svd", "fwsvd", "asvd", "svdllm", "basis", "drank", "dranke")
# where the whitening, SVD and truncation run
LINALG = "numpy float64 on the host"

_NOT_YET = {
    "streaming": "streaming calibration is not ported yet (ROADMAP Queue 1, "
                 "item 4); pass streaming=False for the eager fp64 capture",
    "fwsvd": "fwsvd needs the Fisher pass (fisher_rows), not ported yet "
             "(ROADMAP Queue 1, item 4)",
    "refine": "refine_coefficients is not ported yet (ROADMAP Queue 1, "
              "item 4)",
    "device": "the device compression math (numerics_jax) is not ported "
              "yet (ROADMAP Queue 1, item 5)",
    "mesh": "mesh calibration is not ported yet (ROADMAP Queue 1, item 11)",
    "whiten_tags": "streaming whitening is not ported yet (ROADMAP Queue 1, "
                   "item 4)",
}


@dataclass(frozen=True)
class CompressionConfig:
    method: str = "drank"
    ratio: float = 0.2              # fraction of compressible params removed
    group_size: int = 2             # cross-layer group width (n)
    beta: float = 0.35              # Q/K -> V rank transfer (paper: 0.3-0.4)
    rank_multiple: int = 1          # MXU alignment (128 on TPU deploys)
    min_rank: int = 1
    asvd_alpha: float = 0.5
    damp: float = 1e-6
    gqa_group_one: bool = True      # paper §3.4 GQA policy
    include_experts: bool = True    # compress routed MoE experts too
    refine: bool = False            # closed-form C update on compressed acts
    type_filter: Tuple[str, ...] = ()   # restrict to these types (tests)
    # device path (numerics_jax): min-side size above which the exact
    # batched eigh switches to the randomized range-finder; 0 = never
    rsvd_threshold: int = 0
    rsvd_oversample: int = 8
    rsvd_iters: int = 2


# ---------------------------------------------------------------------------
# Calibration pass
# ---------------------------------------------------------------------------
def calibrate(list_params: Params, cfg: ModelConfig,
              batches: Iterable[Dict], *, streaming: bool = True,
              mesh=None, whiten_tags=None) -> Collector:
    """Collect per-tag fp64 Gram statistics over the calibration batches
    with the eager capture (``streaming=False``), running the forward pass
    where the params live."""
    if streaming:
        raise NotImplementedError(_NOT_YET["streaming"])
    if mesh is not None:
        raise NotImplementedError(_NOT_YET["mesh"])
    if whiten_tags:
        raise NotImplementedError(_NOT_YET["whiten_tags"])
    tagged = tag_linears(list_params)
    col = Collector()
    with torch.no_grad(), col:
        for batch in batches:
            T.forward(tagged, cfg, batch)
    return col


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------
@dataclass
class GroupResult:
    gid: str
    mtype: str
    layers: List[int]
    expert: Optional[int]
    d_in: int
    d_out: int
    n: int
    omega: int
    reff: float
    k: int
    kmax: int
    sigma_head: List[float] = field(default_factory=list)


@dataclass
class Plan:
    config: CompressionConfig
    groups: List[GroupResult]
    summary: Dict[str, float]

    def to_json(self) -> str:
        return json.dumps({
            "config": dataclasses.asdict(self.config),
            "groups": [dataclasses.asdict(g) for g in self.groups],
            "summary": self.summary,
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "Plan":
        d = json.loads(s)
        cfgd = d["config"]
        cfgd["type_filter"] = tuple(cfgd.get("type_filter", ()))
        return Plan(
            config=CompressionConfig(**cfgd),
            groups=[GroupResult(**g) for g in d["groups"]],
            summary=d["summary"])


# ---------------------------------------------------------------------------
# Weight access
# ---------------------------------------------------------------------------
def _get_node(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node


def _member_weight(lp: Params, ref: MatrixRef) -> np.ndarray:
    w = _get_node(lp, ref.path)["w"]
    return w.detach().to(device="cpu", dtype=torch.float64).numpy()


def _copy_tree(node):
    """New containers, same tensors (nothing here mutates a tensor)."""
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_tree(v) for v in node]
    return node


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------
def _whitener_for(group: Group, ccfg: CompressionConfig,
                  col: Collector) -> num.Whitener:
    if ccfg.method == "svd":
        return num.identity_whitener()
    if ccfg.method == "asvd":
        s = np.mean([col.mean_abs(m.tag) for m in group.members], axis=0)
        return num.diag_whitener(np.power(np.maximum(s, 1e-8),
                                          ccfg.asvd_alpha))
    # cholesky family: aggregate the group's Grams (DESIGN.md §1.2)
    G = None
    for m in group.members:
        g = col.gram[m.tag]
        G = g if G is None else G + g
    return num.cholesky_whitener(G, ccfg.damp)


def build_plan_and_params(
        params: Params, cfg: ModelConfig, ccfg: CompressionConfig,
        calib_batches: Sequence[Dict],
        collector: Optional[Collector] = None,
        streaming: bool = True,
        device: bool = False,
        mesh=None,
        whiten_tags=None,
) -> Tuple[Params, Plan]:
    """Compress. Returns (list-form compressed params, plan).

    ``streaming=False`` selects the eager fp64 capture when no ``collector``
    is supplied (the streaming capture is not ported yet). ``device`` keeps
    the JAX package's meaning — the ``numerics_jax`` backend — and is not
    ported yet; the factors are placed on the device the params live on.
    """
    assert ccfg.method in METHODS, ccfg.method
    if device:
        raise NotImplementedError(_NOT_YET["device"])
    if ccfg.method == "fwsvd":
        raise NotImplementedError(_NOT_YET["fwsvd"])
    if ccfg.refine:
        raise NotImplementedError(_NOT_YET["refine"])
    lp = to_list_params(params, cfg)
    dev = params["embed"].device

    col = collector
    if col is None and ccfg.method != "svd":
        col = calibrate(lp, cfg, calib_batches, streaming=streaming,
                        mesh=mesh, whiten_tags=whiten_tags)

    include_x = ccfg.include_experts and ccfg.method in (
        "basis", "drank", "dranke", "svdllm")
    refs = enumerate_matrices(lp, cfg, include_experts=include_x)
    if ccfg.type_filter:
        refs = [r for r in refs if r.mtype in ccfg.type_filter]

    group_size = ccfg.group_size if ccfg.method in ("basis", "drank",
                                                    "dranke") else 1
    gqa_one = ccfg.gqa_group_one and ccfg.method in ("drank", "dranke")
    groups = build_groups(refs, cfg, group_size, gqa_group_one=gqa_one)

    # ---- decompose every group on host in fp64, collect spectra ----------
    svds: Dict[str, Tuple] = {}
    sig_of: Dict[str, np.ndarray] = {}
    for g in groups:
        W_cat = np.concatenate(
            [_member_weight(lp, m) for m in g.members], axis=1)
        wh = _whitener_for(g, ccfg, col) if col else \
            num.identity_whitener()
        U, sig, Vt = num.whitened_svd(W_cat, wh)
        svds[g.gid] = (U, sig, Vt, wh)
        sig_of[g.gid] = sig
    gspecs: List[alloc.GroupSpec] = []
    for g in groups:
        gspecs.append(alloc.GroupSpec(
            gid=g.gid, mtype=g.mtype, reff=num.effective_rank(sig_of[g.gid]),
            omega=g.omega, kmax=g.cost_cap, kmin=ccfg.min_rank,
            dense_params=g.dense_params))

    # ---- allocate ---------------------------------------------------------
    budget = (1.0 - ccfg.ratio) * sum(s.dense_params for s in gspecs)
    if ccfg.method == "drank":
        kf = alloc.lagrange_allocate(gspecs, budget)
        for qk, v in BETA_MAP:
            kf = alloc.beta_rebalance(gspecs, kf, ccfg.beta,
                                      qk_types=qk, v_type=v)
        ks = alloc.integerize(gspecs, kf, budget,
                              multiple=ccfg.rank_multiple)
    elif ccfg.method == "dranke":
        ks = alloc.energy_allocate(gspecs, sig_of, budget,
                                   multiple=ccfg.rank_multiple)
    else:
        ks = alloc.uniform_allocate(gspecs, ccfg.ratio,
                                    multiple=ccfg.rank_multiple)

    # ---- build factorized params -----------------------------------------
    new_lp = _copy_tree(lp)
    pdt = T.dtype_of(cfg.param_dtype)
    results: List[GroupResult] = []

    for g, gs in zip(groups, gspecs):
        k = ks[g.gid]
        U, sig, Vt, wh = svds[g.gid]
        B, C = num.truncate_factors(U, sig, Vt, k, wh)
        Bt = torch.as_tensor(B, dtype=pdt, device=dev)
        for i, m in enumerate(g.members):
            Ci = torch.as_tensor(
                np.ascontiguousarray(C[:, i * g.d_out:(i + 1) * g.d_out]),
                dtype=pdt, device=dev)
            node = _get_node(new_lp, m.path)
            new_node = {"B": Bt, "C": Ci}
            if "b" in node:
                new_node["b"] = node["b"]
            parent = _get_node(new_lp, m.path[:-1])
            parent[m.path[-1]] = new_node
        results.append(GroupResult(
            gid=g.gid, mtype=g.mtype,
            layers=[m.layer for m in g.members],
            expert=g.members[0].expert,
            d_in=g.d_in, d_out=g.d_out, n=g.n, omega=g.omega,
            reff=gs.reff, k=k, kmax=gs.kmax,
            sigma_head=[float(s) for s in sig[:8]]))

    summary = alloc.allocation_summary(gspecs, ks)
    return new_lp, Plan(config=ccfg, groups=results, summary=summary)

