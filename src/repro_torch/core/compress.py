"""D-Rank compression pipeline + baselines (counterpart of
``repro/core/compress.py``).

Methods (all post-training, calibration-data-driven):
  svd      plain truncated SVD             (no whitening, n=1, uniform k)
  fwsvd    Fisher-weighted SVD             (diag Fisher row scale)
  asvd     activation-aware SVD            (diag scale (mean|X|)^α)
  svdllm   whitened SVD                    (Cholesky of XᵀX, n=1, uniform)
  basis    Basis Sharing                   (whitened, grouped n>1, uniform)
  drank    THE PAPER: whitened, grouped (GQA→n=1), effective-rank Lagrange
           allocation + β attention rebalance.
  dranke   beyond-paper energy water-filling allocation.

Calibration streams by default: float32 Gram partials on the device through
the ``gram_blocked`` kernel, folded into fp64 on the host
(``capture.StreamingCalibrator``); ``streaming=False`` is the eager fp64
oracle. The decomposition runs either on the host (``device=False``, the
precision oracle: per-group whitening, SVD and truncation in numpy float64,
``LINALG``) or batched on the params' device (``device=True``,
``numerics_device``, float64 ``torch.linalg``, one call per chunk of a
shape bucket, each chunk sized to a share of the card's free memory).
Routed MoE experts are groups of one matrix each (a slice of the layer's
(E, d, f) stack); their factors are restacked per layer into
{"B": (E, d, rmax), "C": (E, rmax, f)} with zero rank padding, the form
``models.mlp`` runs. The deploy artifact is a
list-form params tree whose linears are factorized {B, C} with a shared
basis per group, loadable straight into the model; ``save_plan`` writes it
as a ``pytree_v1`` artifact that either package boots.

On a mesh (``launch.mesh.Mesh``, one process a rank) calibration shards
its batches over the data axes (``capture.StreamingCalibrator``), and the
device decomposition and the device refine spread each same-shape bucket
over the ranks along the logical ``group_batch`` axis (JAX's
``_shard_group_batch``): rank ``i`` decomposes its share of the bucket and
the spectra and factors are gathered, so every rank ends with the same
factors, the same spectra and therefore the same integer ranks. A bucket
that does not divide runs whole on every rank, as JAX replicates it.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.config import ModelConfig
from repro_torch.core import allocate as alloc
from repro_torch.core import numerics as num
from repro_torch.core import numerics_device as numd
from repro_torch.core.capture import (Collector, streaming_calibrate,
                                      strip_tags, tag_linears,
                                      to_list_params)
from repro_torch.core.groups import (BETA_MAP, Group, MatrixRef,
                                     build_groups, enumerate_matrices)
from repro_torch.device import DeviceLike
from repro_torch.dist import comm
from repro_torch.dist.sharding import (axis_group_size, combined_axis_index,
                                       shape_aware_spec)
from repro_torch.models import transformer as T
from repro_torch.models.params import Params
from repro_torch.obs import trace

METHODS = ("svd", "fwsvd", "asvd", "svdllm", "basis", "drank", "dranke")
# where the host path's whitening, SVD and truncation run
LINALG = "numpy float64 on the host"


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
              mesh=None, whiten_tags=None, flush_every: int = 8,
              shard_grams_above: int = 4096) -> Collector:
    """Collect per-tag Gram statistics over the calibration batches, with
    the forward pass running where the params live.

    ``streaming=True`` (default) runs the device-side capture (float32
    partials through the ``gram_blocked`` kernel on the card, folded into
    fp64 on the host every ``flush_every`` batches; see
    ``capture.StreamingCalibrator``). The eager host path
    (``streaming=False``) is the fp64 oracle it is validated against.
    ``whiten_tags`` (streaming only) captures those tags as streaming
    Cholesky factors instead of Grams — on a mesh, per shard, tree-reduced
    at finalize. ``shard_grams_above`` routes tags whose feature dim
    reaches it to row-sharded (D, D) accumulators when a mesh is given.
    The eager oracle ignores the mesh, as JAX's does: every rank runs it
    over the whole batches.
    """
    if streaming:
        return streaming_calibrate(list_params, cfg, batches, mesh=mesh,
                                   flush_every=flush_every,
                                   whiten_tags=whiten_tags,
                                   shard_grams_above=shard_grams_above)
    if whiten_tags:
        raise ValueError(
            "whiten_tags requires streaming=True: the eager fp64 oracle "
            "materializes every Gram by construction, so a non-streaming "
            "whitened capture would silently void the memory guarantee")
    tagged = tag_linears(list_params)
    col = Collector()
    with torch.no_grad(), col:
        for batch in batches:
            T.forward(tagged, cfg, batch)
    return col


def fisher_rows(list_params: Params, cfg: ModelConfig,
                batches: Iterable[Dict]) -> Dict[str, np.ndarray]:
    """FWSVD row weights: w_i = sqrt(Σ_j E[g_ij²]) per weight matrix tag,
    g the gradient of ``lm_loss`` with respect to each list-form linear's
    ``w``. The squares accumulate in float64 on the params' device (one
    copy to the host at the end); returns numpy float64 (d_in,) per tag."""
    clean = strip_tags(list_params)
    refs = enumerate_matrices(list_params, cfg, include_experts=False)
    acc: Optional[List[torch.Tensor]] = None
    nb = 0
    for batch in batches:
        with torch.enable_grad():
            # per-layer leaves: a list-form run holds views of the stacked
            # tensors, which cannot take their own gradients
            tree = pytree.tree_map(lambda x: x, clean)
            ws = []
            for ref in refs:
                node = _get_node(tree, ref.path)
                node["w"] = node["w"].detach().requires_grad_()
                ws.append(node["w"])
            loss, _ = T.lm_loss(tree, cfg, batch)
            grads = torch.autograd.grad(loss, ws)
        g2 = [g.double() ** 2 for g in grads]
        acc = g2 if acc is None else [a + g for a, g in zip(acc, g2)]
        nb += 1
    fisher: Dict[str, np.ndarray] = {}
    if acc is None:
        return fisher
    for ref, a in zip(refs, acc):
        f = a / max(1, nb)
        fisher[ref.tag] = torch.sqrt(f.sum(dim=-1) + 1e-12).cpu().numpy()
    return fisher


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


def _member_w(lp: Params, ref: MatrixRef) -> torch.Tensor:
    """The member's (d_in, d_out) weight: a linear's ``w``, or one expert's
    slice of a stacked (E, d_in, d_out) expert array."""
    node = _get_node(lp, ref.path)
    if ref.expert is not None:                   # stacked expert array
        return node[ref.expert].detach()
    return node["w"].detach()


def _member_weight(lp: Params, ref: MatrixRef) -> np.ndarray:
    return _member_w(lp, ref).to(device="cpu", dtype=torch.float64).numpy()


# ---------------------------------------------------------------------------
# Device decomposition (numerics_device): bucket same-shaped groups, one
# batched call per chunk of a bucket
# ---------------------------------------------------------------------------
def _member_tensor(lp: Params, ref: MatrixRef) -> torch.Tensor:
    return _member_w(lp, ref).float()


# share of the free device memory one chunk's float64 operands may take
CHUNK_MEMORY_SHARE = 0.25


def _group_bytes(d1: int, nd2: int, kmax: int) -> int:
    """float64 bytes one group of a bucket holds during ``numd.decompose``:
    W and its whitened copy and product (3·d1·nd2); the Gram and the
    damped Cholesky's copies and factor (5·d1²); the small-side Gram, its
    symmetrized copy and eigenvectors (3·m²); B and C at kmax."""
    m = min(d1, nd2)
    return 8 * (3 * d1 * nd2 + 5 * d1 * d1 + 3 * m * m
                + kmax * (d1 + nd2))


def _chunk_groups(n_groups: int, per_group: int, dev: torch.device) -> int:
    """Groups a chunk of a bucket takes: as many as fit
    ``CHUNK_MEMORY_SHARE`` of the memory free on ``dev`` now (what
    ``mem_get_info`` reports free plus what PyTorch's allocator holds
    unused); the whole bucket off the card."""
    if dev.type != "cuda":
        return n_groups
    free, _ = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return max(1, min(n_groups, int(CHUNK_MEMORY_SHARE * free) // per_group))


def _share(mesh, n: int):
    """(lo, hi, group) of this rank's share of ``n`` stacked items along the
    logical ``group_batch`` axis; the whole range and no group where the
    mesh is absent or ``n`` does not divide (replicated, as
    ``shape_aware_spec`` leaves it in JAX)."""
    if mesh is None or n == 0:
        return 0, n, None
    entry = shape_aware_spec((n,), ("group_batch",), mesh)[0]
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    if not axes:
        return 0, n, None
    per = n // axis_group_size(mesh, axes)
    i = combined_axis_index(axes, mesh)
    return i * per, (i + 1) * per, mesh.group(axes)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's share of a bucket, stacked in bucket order."""
    return x if group is None else comm.all_gather_rows(x, group)


def _decompose_groups_device(
        lp: Params, groups: List[Group], ccfg: CompressionConfig,
        col: Optional[Collector], fisher: Optional[Dict[str, np.ndarray]],
        dev: torch.device, mesh=None
        ) -> Dict[str, Tuple[np.ndarray, torch.Tensor, torch.Tensor]]:
    """Whitened decomposition of every group at its cost cap, batched by
    shape bucket, on ``dev``. Returns gid -> (sig fp64, B
    (d1, kmax), C (kmax, n·d2)) with B/C in the ORIGINAL space on ``dev``;
    final ranks slice columns later.

    A bucket runs in chunks of ``_chunk_groups`` groups, each chunk's
    operands stacked on the host and moved to ``dev`` only when it runs
    (MoE's expert buckets hold over a thousand groups). Each group's math
    is its own batch member, so the chunking changes no result. An rsvd
    bucket runs whole: its sketch is drawn for the whole batch at once.

    On a mesh each rank decomposes its share of a bucket (``_share``) and
    the spectra and factors of the shares are gathered in bucket order;
    an rsvd bucket runs whole on every rank (the same seeded sketch)."""
    buckets: Dict[Tuple, List[Group]] = {}
    for g in groups:
        buckets.setdefault((g.d_in, g.n * g.d_out, g.n, g.cost_cap),
                           []).append(g)
    out: Dict[str, Tuple] = {}
    for (d1, nd2, n, kmax), bucket in sorted(buckets.items()):
        rsvd = int(bool(ccfg.rsvd_threshold)
                   and min(d1, nd2) >= ccfg.rsvd_threshold)
        lo, hi, group = _share(None if rsvd else mesh, len(bucket))
        mine: Dict[str, Tuple] = {}
        c0 = lo
        while c0 < hi:
            # sized at each chunk: the factors kept so far take memory too
            size = (hi - c0 if rsvd else _chunk_groups(
                hi - c0, _group_bytes(d1, nd2, kmax), dev))
            mine.update(_decompose_chunk(lp, bucket[c0:c0 + size], ccfg,
                                         col, fisher, dev, (d1, nd2, kmax),
                                         rsvd))
            c0 += size
        if group is None:
            out.update(mine)
            continue
        share = bucket[lo:hi]
        sig = _gather(torch.as_tensor(np.stack(
            [mine[g.gid][0] for g in share]), device=dev), group)
        B = _gather(torch.stack([mine[g.gid][1] for g in share]), group)
        C = _gather(torch.stack([mine[g.gid][2] for g in share]), group)
        sig = sig.cpu().numpy()
        for i, g in enumerate(bucket):
            out[g.gid] = (sig[i], B[i], C[i])
    return out


def _decompose_chunk(lp: Params, gs: List[Group], ccfg: CompressionConfig,
                     col: Optional[Collector],
                     fisher: Optional[Dict[str, np.ndarray]],
                     dev: torch.device, shape: Tuple[int, int, int],
                     rsvd: int) -> Dict[str, Tuple]:
    """One batched ``numd.decompose`` over the groups ``gs`` of a bucket."""
    d1, nd2, kmax = shape

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    out: Dict[str, Tuple] = {}
    with trace.span("decompose_bucket", d1=d1, nd2=nd2,
                    kmax=kmax, n_groups=len(gs)):
        W = torch.stack([
            torch.cat([_member_tensor(lp, m) for m in g.members], dim=1)
            for g in gs]).to(dev)
        kwargs: Dict = {}
        if ccfg.method == "fwsvd":
            # same floor as num.diag_whitener: zero Fisher rows (dead
            # units) must not divide the basis by zero
            kwargs["diag"] = put(np.maximum(np.stack(
                [fisher[g.members[0].tag] for g in gs]), 1e-8))
        elif ccfg.method == "asvd":
            kwargs["diag"] = put(np.stack([np.power(np.maximum(np.mean(
                [col.mean_abs(m.tag) for m in g.members], axis=0), 1e-8),
                ccfg.asvd_alpha) for g in gs]))
        elif ccfg.method != "svd":                   # cholesky family
            tags = [m.tag for g in gs for m in g.members]
            if col.chol and all(t in col.chol for t in tags):
                kwargs["factor"] = numd.combine_factors(put(np.stack(
                    [np.stack([col.chol[m.tag] for m in g.members])
                     for g in gs])))
            else:
                # buckets mixing whitened and plain tags fall back to
                # Grams, substituting RᵀR for factor-only tags
                kwargs["gram"] = put(np.stack(
                    [np.sum([_gram_of(col, m.tag) for m in g.members],
                            axis=0) for g in gs]))
                kwargs["damp"] = ccfg.damp
        sig, B, C = numd.decompose(
            W, k=kmax, rsvd=rsvd, rsvd_oversample=ccfg.rsvd_oversample,
            rsvd_iters=ccfg.rsvd_iters, **kwargs)
        sig = sig.double().cpu().numpy()
        if not np.isfinite(sig).all():
            # a member still failing Cholesky escalation comes out
            # as NaNs; fail as loudly as the host oracle does on
            # non-finite Grams
            bad = [gs[i].gid for i in range(len(gs))
                   if not np.isfinite(sig[i]).all()]
            raise np.linalg.LinAlgError(
                f"device decomposition produced non-finite spectra for "
                f"groups {bad} (bucket d1={d1}, n·d2={nd2}) — non-finite "
                f"calibration Grams or weights")
        for i, g in enumerate(gs):
            out[g.gid] = (sig[i], B[i], C[i])
    return out


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------
def _whitener_for(group: Group, ccfg: CompressionConfig, col: Collector,
                  fisher: Optional[Dict[str, np.ndarray]]) -> num.Whitener:
    if ccfg.method == "svd":
        return num.identity_whitener()
    if ccfg.method == "fwsvd":
        return num.diag_whitener(fisher[group.members[0].tag])
    if ccfg.method == "asvd":
        s = np.mean([col.mean_abs(m.tag) for m in group.members], axis=0)
        return num.diag_whitener(np.power(np.maximum(s, 1e-8),
                                          ccfg.asvd_alpha))
    # cholesky family. Streaming-whitened tags carry an upper-triangular
    # factor RᵀR = G instead of a Gram: members merge by stacked QR, never
    # forming G.
    tags = [m.tag for m in group.members]
    if col.chol and all(t in col.chol for t in tags):
        R = np.vstack([col.chol[t] for t in tags])
        return num.whitener_from_factor(np.linalg.qr(R, mode="r"))
    # otherwise aggregate the group's Grams (DESIGN.md §1.2); a group can
    # mix whitened and plain members — the factor's RᵀR stands in for the
    # missing Gram
    G = None
    for m in group.members:
        g = _gram_of(col, m.tag)
        G = g if G is None else G + g
    return num.cholesky_whitener(G, ccfg.damp)


def _gram_of(col: Collector, tag: str) -> np.ndarray:
    if tag in col.gram:
        return col.gram[tag]
    R = col.chol[tag]
    return R.T @ R


def build_plan_and_params(
        params: Params, cfg: ModelConfig, ccfg: CompressionConfig,
        calib_batches: Sequence[Dict],
        collector: Optional[Collector] = None,
        streaming: bool = True,
        device: bool = False,
        mesh=None,
        whiten_tags=None,
        shard_grams_above: int = 4096,
) -> Tuple[Params, Plan]:
    """Compress. Returns (list-form compressed params, plan).

    ``streaming`` selects the capture path when no ``collector`` is
    supplied (see ``calibrate``). ``device=True`` runs the decomposition
    math (whitening, whitened eigh-based SVD, truncation, refine) batched on
    the params' device (``numerics_device``): same-shaped groups
    decompose in one call, factors are kept at the cost cap and sliced to
    the final ranks; rank allocation is unchanged and works on the
    device-computed spectra. The host fp64 path (``device=False``) is the
    precision oracle it is validated against. The factors are placed on the
    device the params live on.

    With a ``mesh`` every rank of it calls this with the same arguments:
    calibration shards over the data axes, and with ``device=True`` each
    same-shape bucket's decomposition is spread over the ranks and
    gathered (see the module docstring), so every rank returns the same
    params and plan. ``whiten_tags`` (True = all; streaming capture only)
    streams whitening factors instead of Grams for those tags, mesh or
    not; ``shard_grams_above`` routes wide tags to row-sharded Gram
    accumulators on a mesh (see ``capture.StreamingCalibrator``).
    """
    assert ccfg.method in METHODS, ccfg.method
    _check_mesh(mesh)
    lp = to_list_params(params, cfg)
    dev = params["embed"].device

    col = collector
    if col is None and (ccfg.method != "svd" or ccfg.refine):
        with trace.span("calibrate", batches=len(calib_batches),
                        streaming=streaming):
            col = calibrate(lp, cfg, calib_batches, streaming=streaming,
                            mesh=mesh, whiten_tags=whiten_tags,
                            shard_grams_above=shard_grams_above)
    fisher = (fisher_rows(lp, cfg, calib_batches)
              if ccfg.method == "fwsvd" else None)

    include_x = ccfg.include_experts and ccfg.method in (
        "basis", "drank", "dranke", "svdllm")
    refs = enumerate_matrices(lp, cfg, include_experts=include_x)
    if ccfg.type_filter:
        refs = [r for r in refs if r.mtype in ccfg.type_filter]

    group_size = ccfg.group_size if ccfg.method in ("basis", "drank",
                                                    "dranke") else 1
    gqa_one = ccfg.gqa_group_one and ccfg.method in ("drank", "dranke")
    groups = build_groups(refs, cfg, group_size, gqa_group_one=gqa_one)

    # ---- decompose every group, collect spectra ---------------------------
    # host: per-group fp64 whitening + SVD (the oracle); device: batched
    # calls, one per shape bucket, factors kept at the cost cap
    svds: Dict[str, Tuple] = {}
    dec: Dict[str, Tuple] = {}
    sig_of: Dict[str, np.ndarray] = {}
    if device:
        dec = _decompose_groups_device(lp, groups, ccfg, col, fisher, dev,
                                       mesh)
        sig_of = {gid: d[0] for gid, d in dec.items()}
    else:
        with trace.span("decompose_host", n_groups=len(groups)):
            for g in groups:
                W_cat = np.concatenate(
                    [_member_weight(lp, m) for m in g.members], axis=1)
                wh = _whitener_for(g, ccfg, col, fisher) if col or fisher \
                    else num.identity_whitener()
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
    new_lp = pytree.tree_map(lambda x: x, lp)  # new containers
    pdt = T.dtype_of(cfg.param_dtype)
    results: List[GroupResult] = []
    expert_factors: Dict[Tuple, Dict[int, Tuple]] = {}

    for g, gs in zip(groups, gspecs):
        k = ks[g.gid]
        if device:
            sig, Bfull, Cfull = dec[g.gid]
            B, C = Bfull[:, :k], Cfull[:k]
        else:
            U, sig, Vt, wh = svds[g.gid]
            B, C = num.truncate_factors(U, sig, Vt, k, wh)
            B, C = torch.as_tensor(B), torch.as_tensor(C)
        Bt = B.to(device=dev, dtype=pdt).contiguous()
        for i, m in enumerate(g.members):
            Ci = C[:, i * g.d_out:(i + 1) * g.d_out].to(
                device=dev, dtype=pdt).contiguous()
            if m.expert is not None:
                expert_factors.setdefault(m.path, {})[m.expert] = (Bt, Ci)
                continue
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

    # routed experts: restack with zero rank padding (exact); experts
    # without factors keep zeros
    for path, factors in expert_factors.items():
        E, d_in, d_out = _get_node(lp, path).shape
        rmax = max(f[0].shape[1] for f in factors.values())
        Bs = torch.zeros((E, d_in, rmax), dtype=pdt, device=dev)
        Cs = torch.zeros((E, rmax, d_out), dtype=pdt, device=dev)
        for e, (Be, Ce) in factors.items():
            Bs[e, :, :Be.shape[1]] = Be
            Cs[e, :Ce.shape[0]] = Ce
        _get_node(new_lp, path[:-1])[path[-1]] = {"B": Bs, "C": Cs}

    summary = alloc.allocation_summary(gspecs, ks)
    plan = Plan(config=ccfg, groups=results, summary=summary)
    if ccfg.refine:
        # if calibration streamed whitening factors, the refine re-capture
        # must too — otherwise it would re-materialize the very Grams
        # whiten_tags exists to avoid
        wt = (frozenset(col.chol) if col is not None and col.chol
              and streaming else None)
        with trace.span("refine", n_groups=len(groups)):
            new_lp = refine_coefficients(
                lp, new_lp, cfg, groups, calib_batches, streaming=streaming,
                device=device, mesh=mesh, whiten_tags=wt,
                shard_grams_above=shard_grams_above)
    return new_lp, plan


def _check_mesh(mesh) -> None:
    """A mesh here is a ``launch.mesh.Mesh`` over the process group this
    process joined; a shapes-only mesh (``make_production_mesh``) has no
    ranks to run on."""
    if mesh is None:
        return
    from repro_torch.launch.mesh import Mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if mesh.rank is None:
        raise ValueError(f"{mesh} is a shapes-only mesh: no process group "
                         f"to calibrate or decompose over")


def refine_coefficients(orig_lp: Params, comp_lp: Params, cfg: ModelConfig,
                        groups: List[Group],
                        calib_batches: Sequence[Dict],
                        streaming: bool = True, device: bool = False,
                        mesh=None, whiten_tags=None,
                        shard_grams_above: int = 4096) -> Params:
    """Closed-form downstream update (the paper's ≥40% trick, after
    SVD-LLM): re-collect Grams THROUGH the compressed model (inputs now
    deviate from the originals) and re-solve each coefficient matrix

        C_i* = argmin_C ‖X_new (W_i − B C)‖_F = (Bᵀ G B)⁻¹ Bᵀ G W_i .

    ``device=True`` batches the solves: members are bucketed by
    (d_in, k, d_out) and each bucket runs one
    ``numerics_device.refine_solve`` on the params' device instead of a
    host loop. ``whiten_tags`` re-captures those tags as streaming
    Cholesky factors; the device solve then runs in factor form, so a
    fully whiten-streamed refine never materializes a Gram. On a mesh each
    bucket's solves spread over the ranks along ``group_batch`` and the
    coefficients are gathered, as in the decomposition.
    """
    _check_mesh(mesh)
    col2 = calibrate(comp_lp, cfg, calib_batches, streaming=streaming,
                     mesh=mesh, whiten_tags=whiten_tags,
                     shard_grams_above=shard_grams_above)
    members = [m for g in groups for m in g.members
               if m.expert is None
               and (m.tag in col2.gram or m.tag in col2.chol)]
    if device:
        buckets: Dict[Tuple, List[MatrixRef]] = {}
        for m in members:
            node = _get_node(comp_lp, m.path)
            buckets.setdefault(
                (m.d_in, int(node["B"].shape[1]), m.d_out), []).append(m)
        for _key, ms in sorted(buckets.items()):
            lo, hi, group = _share(mesh, len(ms))
            mine = ms[lo:hi]
            B = torch.stack([_get_node(comp_lp, m.path)["B"].float()
                             for m in mine])
            W = torch.stack([_member_tensor(orig_lp, m) for m in mine]
                            ).to(B.device)
            if all(m.tag in col2.chol for m in ms):
                R = torch.as_tensor(np.stack(
                    [col2.chol[m.tag] for m in mine]), device=B.device)
                C = numd.refine_solve(B, None, W, factor=R)
            else:
                G = torch.as_tensor(np.stack(
                    [_gram_of(col2, m.tag) for m in mine]), device=B.device)
                C = numd.refine_solve(B, G, W)
            C = _gather(C, group)
            for i, m in enumerate(ms):
                node = _get_node(comp_lp, m.path)
                node["C"] = C[i].to(node["C"].dtype).contiguous()
        return comp_lp
    for m in members:
        node = _get_node(comp_lp, m.path)
        B = node["B"].detach().double().cpu().numpy()
        G = _gram_of(col2, m.tag)
        W = _member_weight(orig_lp, m)
        BtGB = B.T @ G @ B
        BtGB += 1e-8 * np.trace(BtGB) / max(1, len(BtGB)) * np.eye(
            B.shape[1])
        C = np.linalg.solve(BtGB, B.T @ G @ W)
        node["C"] = torch.as_tensor(C, dtype=node["C"].dtype,
                                    device=node["C"].device)
    return comp_lp


# ---------------------------------------------------------------------------
# Compressed-checkpoint round trip (deploy artifact)
# ---------------------------------------------------------------------------
ARTIFACT_NAME = "compressed"


def _model_fingerprint(cfg: ModelConfig) -> Dict:
    return {"name": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads}


def save_plan(ckpt_dir: str, list_params: Params, plan: Plan,
              cfg: Optional[ModelConfig] = None) -> str:
    """Persist the factorized list-form params + allocation plan so serving
    can boot WITHOUT re-running compression, as a ``pytree_v1`` artifact
    that the JAX package's ``load_plan`` reads too. Shared group bases are
    stored once (``store.save_pytree`` aliases identical tensors), and the
    manifest records per-array content hashes for ``load_plan
    (verify=True)``."""
    from repro_torch.ckpt import store
    meta: Dict = {"plan": json.loads(plan.to_json())}
    if cfg is not None:
        meta["model"] = _model_fingerprint(cfg)
    return store.save_pytree(ckpt_dir, strip_tags(list_params), meta,
                             name=ARTIFACT_NAME)


def load_plan(ckpt_dir: str, cfg: Optional[ModelConfig] = None,
              verify: bool = False, retries: int = 0,
              quarantine: bool = False,
              device: DeviceLike = None) -> Tuple[Params, Plan]:
    """Load a compressed artifact saved by ``save_plan`` (of either package)
    onto ``device`` (the card by default). If ``cfg`` is given, its
    fingerprint must match the one recorded at save time. ``verify=True``
    re-hashes every stored array against the manifest content hashes first
    (see ``store.load_pytree``). ``retries > 0`` re-reads with exponential
    backoff on transient/integrity failures and, with ``quarantine=True``,
    moves a persistently failing artifact to ``<name>.quarantined`` before
    raising ``store.IntegrityError``."""
    from repro_torch.ckpt import store
    if retries > 0 or quarantine:
        params, meta = store.load_pytree_resilient(
            ckpt_dir, name=ARTIFACT_NAME, verify=verify, retries=retries,
            quarantine=quarantine, device=device)
    else:
        params, meta = store.load_pytree(ckpt_dir, name=ARTIFACT_NAME,
                                         verify=verify, device=device)
    plan = Plan.from_json(json.dumps(meta["plan"]))
    if cfg is not None and "model" in meta:
        want = _model_fingerprint(cfg)
        if want != meta["model"]:
            raise ValueError(
                f"compressed checkpoint was built for {meta['model']}, "
                f"got config {want}")
    return params, plan


# ---------------------------------------------------------------------------
# Serve-time elastic rank: pow2 bucket ladder over the saved factors
# ---------------------------------------------------------------------------
def _pow2_ceil(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def rank_bucket(r: int, level: int, min_rank: int = 1) -> int:
    """Rank served at degradation ``level`` for a factor of full rank
    ``r``: level 0 is the exact allocated rank; level ℓ ≥ 1 serves
    ``pow2_ceil(r) >> ℓ`` (clamped to [min_rank, r]) — roughly a halving
    per level, always a power of two, so the whole ladder adds at most
    ``levels`` decode signatures however many distinct ranks the plan
    allocated."""
    if level <= 0:
        return r
    return max(min_rank, min(r, _pow2_ceil(r) >> level))


def slice_rank_ladder(list_params: Params, levels: int = 2,
                      min_rank: int = 1) -> List[Params]:
    """Slice a factorized params tree into a serve-time degradation
    ladder ``[full, level1, ..., levelN]``.

    The factors are singular-value-ordered (B's columns and C's rows come
    out of the whitened SVD sorted by descending σ), so ``B[..., :k']`` /
    ``C[..., :k', :]`` is the rank-k' truncation of the same
    decomposition: one artifact serves any rank ≤ k with a slice. Level ℓ
    slices every factorized linear to ``rank_bucket(r, ℓ)``:

    * level 0 is ``list_params`` itself (the same tensors), so the
      full-rank rung is token-identical to the engine without a ladder;
    * shared bases stay shared: a basis B reused across a group's layers
      is sliced once per (tensor, rank) and re-aliased;
    * B's column slice is copied into a contiguous tensor, since the
      low-rank kernels read contiguous operands; C's row slice is a view;
      dense (``w``) linears, biases, LoRA adapters and norms pass through
      by reference.

    A level that slices nothing (dense params, or every rank already at
    its bucket) is ``list_params`` itself, so a degenerate ladder is
    detectable by identity.
    """
    ladder = [list_params]
    for lvl in range(1, levels + 1):
        sliced_b: Dict[Tuple[int, int], torch.Tensor] = {}

        def walk(node, lvl=lvl, sliced_b=sliced_b):
            if isinstance(node, dict):
                if "B" in node and "C" in node:
                    B, C = node["B"], node["C"]
                    r = int(B.shape[-1])
                    k = rank_bucket(r, lvl, min_rank)
                    out = dict(node)
                    if k < r:
                        key = (id(B), k)
                        if key not in sliced_b:
                            sliced_b[key] = B[..., :k].contiguous()
                        out["B"] = sliced_b[key]
                        out["C"] = C[..., :k, :]
                    return out
                return {kk: walk(v) for kk, v in node.items()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            if isinstance(node, tuple):
                return tuple(walk(v) for v in node)
            return node

        rung = walk(list_params)
        ladder.append(rung if sliced_b else list_params)
    return ladder


def compressed_param_count(list_params: Params) -> int:
    """Parameter count with shared bases deduped by tensor identity."""
    seen = set()
    total = 0
    for leaf in pytree.tensors(list_params):
        if id(leaf) not in seen:
            seen.add(id(leaf))
            total += leaf.numel()
    return total
