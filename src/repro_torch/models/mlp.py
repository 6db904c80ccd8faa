"""Dense FFN (SwiGLU / GeGLU / GeLU) and Mixture-of-Experts (counterpart of
``repro/models/mlp.py``).

MoE keeps the JAX layer's routing and capacity semantics exactly:

  * the router's logits in x's dtype, softmax in float32 over the padded
    expert axis (padding experts masked at -1e30), top-k, gates
    renormalised with +1e-9 and cast back to x's dtype;
  * each token's row repeated k times in top-k order and scattered into
    fixed-capacity buffers; a row's slot within its destination is its rank
    by a cumulative sum over a one-hot, so row order decides which
    assignments are dropped once a buffer is full, and a dropped row
    contributes zero (GShard capacity);
  * a second-level dispatch of the received rows into (E, C2, D) per-expert
    buffers, the operands of the batched expert products; the local expert
    id rides along in x's dtype (exact in bf16 below 256), and the buffer's
    empty rows, whose id reads 0, take expert 0's spare capacity as in JAX.

Capacities are Python ints computed from shapes and the dispatch is
gathers and scatters into a sentinel row (``n·cap + 1`` rows, the last
dropped), so nothing here reads the device on the host: a decode step with
MoE layers captures into a CUDA graph. Routing, dispatch and the expert
products are ``torch`` ops, as they are ``jnp`` ops outside Pallas in the
JAX package.

Expert parallelism (ep > 1) runs under a mesh pinned by
``dist.sharding.use_rules(mesh=...)`` whose ``model`` axis has ep ranks,
as JAX's ``shard_map`` branch does: a rank holds ``E/ep`` experts (its
``local_block`` of each expert stack, or ``ckpt.store.restore(
shardings=)``), its ``data`` shard of the tokens (replicated over
``model``) and the whole router. The body is JAX's: a first-level
dispatch to ``ep`` shards of ``cap1`` rows, ``comm.all_to_all`` over the
``model`` group, the second-level dispatch into the local experts'
``cap2`` rows, and the return trip, with both capacities computed per
shard exactly as JAX computes them (so the drops are JAX's at that ep).
JAX's behaviours are kept. Its mesh body passes no capture tag, so under
ep > 1 no expert statistic is captured. Each model rank routes the same
(replicated) tokens and sends them all, so an expert shard receives one
copy from every model rank, model rank 0's first: the later copies can
lose capacity that rank 0's never do, and the model ranks' outputs then
differ. JAX declares the output replicated over ``model`` and returns
device 0's copy; the port broadcasts model rank 0's output and aux to the
model group, so every rank holds what JAX returns (rank 0's result does
not depend on the other ranks' copies, which come after its rows). The
aux is declared replicated over the data axes too: JAX returns data
shard 0's, and each port rank keeps its own data shard's.

The EP body is differentiable, with JAX's transpose of its ``shard_map``
(``check_vma=False``): ``comm.all_to_all``'s backward is the inverse
exchange; x and the router enter through ``comm.tp_enter`` (each model
rank routes the same replicated tokens, so their gradients sum over
``model``, as JAX psums an input's cotangent over the axes its spec does
not name); the broadcast output and aux leave through
``comm.replicated_output``, whose backward hands every model rank the
cotangent divided by ``model``'s size, whatever its own copy held (JAX
divides an output's cotangent by the size of the axes its spec does not
name). ``train.step.sharded_train_step`` adds the aux's data share.

Under a ``dist.sharding.Placement`` (the sharded train step) the dense
MLP and the shared experts are tensor-parallel where the placement left
``w_gate``/``w_up`` column- and ``w_down`` row-parallel (JAX's
``constrain(h, "batch", None, "mlp")``): each rank computes its columns
of the hidden layer and its partial output, summed over ``model``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.dist import comm
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import current_mesh
from repro_torch.models.params import (Builder, apply_linear,
                                       apply_row_parallel, get_capture)


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------
def init_mlp(b: Builder, cfg: ModelConfig, d_ff: int,
             stack: Tuple[int, ...] = ()) -> None:
    out_scale = 0.02 / max(1, cfg.n_layers) ** 0.5
    if cfg.mlp_kind in ("swiglu", "geglu"):
        b.linear("w_gate", cfg.d_model, d_ff, ("fsdp", "mlp"), stack)
        b.linear("w_up", cfg.d_model, d_ff, ("fsdp", "mlp"), stack)
        b.linear("w_down", d_ff, cfg.d_model, ("mlp", "fsdp"), stack,
                 scale=out_scale)
    else:  # gelu
        b.linear("w_up", cfg.d_model, d_ff, ("fsdp", "mlp"), stack)
        b.linear("w_down", d_ff, cfg.d_model, ("mlp", "fsdp"), stack,
                 scale=out_scale)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _tp_group(p: Dict):
    """The ``model`` group where a placement left ``p``'s ``w_down``
    row-parallel (its ``w_gate``/``w_up`` column-parallel: JAX's
    ``constrain(h, "batch", None, "mlp")``), else None."""
    s = SH.share_of(p["w_down"], "row")
    return None if s is None else s.group


def apply_mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The dense FFN. Under tensor parallelism each rank computes its
    columns of the hidden layer and its partial output, summed over
    ``model``."""
    group = _tp_group(p)
    if group is not None:
        x = comm.tp_enter(x, group)
    if "w_gate" in p:
        act = _gelu if cfg.mlp_kind == "geglu" else F.silu
        h = act(apply_linear(p["w_gate"], x)) * apply_linear(p["w_up"], x)
    else:
        h = _gelu(apply_linear(p["w_up"], x))
    if group is not None:
        return apply_row_parallel(p["w_down"], h, group)
    return apply_linear(p["w_down"], h)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def init_moe(b: Builder, cfg: ModelConfig,
             stack: Tuple[int, ...] = ()) -> None:
    m = cfg.moe
    E = m.padded_experts
    sub = b.sub("moe")
    sub.linear("router", cfg.d_model, E, ("fsdp", None), stack)
    st_axes = (None,) * len(stack)
    # expert weights: (E, d, f) stacked
    sub.normal("w_gate", (*stack, E, cfg.d_model, m.d_expert),
               (*st_axes, "experts", "fsdp", None))
    sub.normal("w_up", (*stack, E, cfg.d_model, m.d_expert),
               (*st_axes, "experts", "fsdp", None))
    sub.normal("w_down", (*stack, E, m.d_expert, cfg.d_model),
               (*st_axes, "experts", None, "fsdp"),
               scale=0.02 / max(1, cfg.n_layers) ** 0.5)
    if m.num_shared:
        shared = b.sub("moe_shared")
        d_sh = m.d_shared * m.num_shared
        shared.linear("w_gate", cfg.d_model, d_sh, ("fsdp", "mlp"), stack)
        shared.linear("w_up", cfg.d_model, d_sh, ("fsdp", "mlp"), stack)
        shared.linear("w_down", d_sh, cfg.d_model, ("mlp", "fsdp"), stack)
        shared.linear("shared_gate", cfg.d_model, 1, ("fsdp", None), stack)


def capacity(rows: int, n_dest: int, factor: float) -> int:
    """Rows a destination's buffer holds: ``ceil(rows / n_dest · factor)``
    rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(rows / n_dest * factor))
    return max(8, -(-cap // 8) * 8)


def _dispatch_to_buffers(x: torch.Tensor, dest: torch.Tensor, n_dest: int,
                         capacity: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter rows of x (N, D) into (n_dest, capacity, D) buffers.

    dest: (N,) int destination id per row (>= n_dest means 'drop').
    Returns (buffers, slot_of_row (N,), kept_mask (N,)). Rows beyond a
    destination's capacity are dropped (GShard capacity semantics)."""
    N, D = x.shape
    onehot = (dest[:, None] == torch.arange(
        n_dest, device=dest.device)).to(torch.int32)        # (N, n_dest)
    pos_in_dest = torch.cumsum(onehot, dim=0) - onehot       # rank within dest
    slot = torch.sum(pos_in_dest * onehot, dim=1)            # (N,)
    kept = (slot < capacity) & (dest < n_dest)
    flat_idx = torch.where(kept, dest * capacity + slot,
                           torch.full_like(slot, n_dest * capacity))
    # every dropped row lands on the sentinel row, with zeros
    rows = torch.where(kept[:, None], x, torch.zeros_like(x))
    buf = x.new_zeros((n_dest * capacity + 1, D)).index_copy(
        0, flat_idx.long(), rows)
    return buf[:-1].reshape(n_dest, capacity, D), slot, kept


def _undispatch(buffers: torch.Tensor, dest: torch.Tensor, slot: torch.Tensor,
                kept: torch.Tensor) -> torch.Tensor:
    """Gather rows back: inverse of _dispatch_to_buffers."""
    n_dest, capacity, D = buffers.shape
    flat = buffers.reshape(n_dest * capacity, D)
    idx = torch.clamp(dest * capacity + slot, 0, n_dest * capacity - 1)
    rows = flat[idx.long()]
    return torch.where(kept[:, None], rows, torch.zeros_like(rows))


def _expert_mm(w, xs: torch.Tensor) -> torch.Tensor:
    """Per-expert batched matmul. w: (E, D, F) dense tensor OR factorized
    {"B": (E, D, R), "C": (E, R, F)} (D-Rank deploy form, rank-padded);
    the rank-space product is rounded to xs's dtype before ``@ C``."""
    if isinstance(w, dict):
        t = torch.bmm(xs, w["B"].to(xs.dtype))
        return torch.bmm(t, w["C"].to(xs.dtype))
    return torch.bmm(xs, w.to(xs.dtype))


def _expert_ffn(w_gate, w_up, w_down, xs: torch.Tensor,
                tag: Optional[str] = None) -> torch.Tensor:
    """xs: (E, C2, D); weights (E, D, F)/(E, F, D). With a capture target
    active, the buffers are reported as ``tag + "/in"`` and the hidden
    activations as ``tag + "/mid"`` (one statistic per expert)."""
    cap = get_capture()
    if cap is not None and tag:
        cap.add_expert_batch(tag + "/in", xs)
    h = F.silu(_expert_mm(w_gate, xs)) * _expert_mm(w_up, xs)
    if cap is not None and tag:
        cap.add_expert_batch(tag + "/mid", h)
    return _expert_mm(w_down, h)


def route(router_w: torch.Tensor, m: MoEConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: logits in x's dtype, padding experts masked at -1e30,
    softmax in float32, top-k, gates renormalised with +1e-9. x: (T, D).
    Returns (probs (T, E) float32, gates (T, k) float32, expert ids (T,
    k))."""
    E = m.padded_experts
    logits = x @ router_w.to(x.dtype)                         # (T, E)
    if m.num_experts < E:                                     # mask padding
        pad = torch.arange(E, device=x.device) >= m.num_experts
        logits = torch.where(pad[None, :],
                             torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1)
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)
    return probs, gate_vals, expert_ids


def _moe_local(p: Dict, m: MoEConfig, x: torch.Tensor, ep: int = 1,
               group=None, tag: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard MoE body. x: (T, D) local tokens; the experts are spread
    over ``group`` (the ``model`` axis) in ``ep`` shards of E/ep each, and
    ``p``'s expert stacks hold this rank's. Returns (out, aux_loss). At
    ep = 1 the first-level dispatch (to the one shard) and its meta buffer
    are kept as in JAX: they fix the received rows' order and the zero
    rows that reach the second level."""
    T, D = x.shape
    E = m.padded_experts
    e_local = E // ep
    k = m.top_k

    probs, gate_vals, expert_ids = route(p["router"], m, x)

    # load-balancing aux loss (Switch-style) over real experts
    me = torch.mean(probs[:, :m.num_experts], dim=0)
    chosen = (expert_ids[..., None] == torch.arange(
        E, device=x.device)).float().sum(1)                   # (T, E)
    ce = torch.mean(chosen[:, :m.num_experts], dim=0)
    aux = m.num_experts * torch.sum(me * ce)

    # ---- first-level dispatch (one shard) ---------------------------------
    xs = torch.repeat_interleave(x, k, dim=0)                 # (T*k, D)
    eids = expert_ids.reshape(-1)                             # (T*k,)
    gates = gate_vals.reshape(-1).to(x.dtype)
    cap1 = capacity(T * k, ep, m.capacity_factor)
    dest_shard = torch.div(eids, e_local, rounding_mode="floor")
    send, slot1, kept1 = _dispatch_to_buffers(xs, dest_shard, ep, cap1)
    send_meta = torch.stack([(eids % e_local).to(x.dtype),
                             torch.zeros_like(gates)], dim=-1)
    meta_buf, _, _ = _dispatch_to_buffers(send_meta, dest_shard, ep, cap1)
    if ep > 1:
        recv = comm.all_to_all(send, group)
        meta = comm.all_to_all(meta_buf, group)
    else:
        recv, meta = send, meta_buf
    recv = recv.reshape(ep * cap1, D)
    local_eid = meta.reshape(ep * cap1, 2)[:, 0].to(torch.int32)

    # ---- second-level dispatch: per-expert batched GEMM --------------------
    cap2 = capacity(ep * cap1, e_local, m.capacity_factor)
    ebuf, slot2, kept2 = _dispatch_to_buffers(recv, local_eid, e_local, cap2)
    eout = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], ebuf, tag=tag)
    back = _undispatch(eout, local_eid, slot2, kept2)         # (ep*cap1, D)

    # ---- return trip ------------------------------------------------------
    back = back.reshape(ep, cap1, D)
    if ep > 1:
        back = comm.all_to_all(back, group)
    rows = _undispatch(back, dest_shard, slot1, kept1)        # (T*k, D)
    out = torch.sum((rows * gates[:, None]).reshape(T, k, D), dim=1)
    return out, aux


def apply_moe(p: Dict, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss). ``p`` is a layer's tree holding
    ``moe`` (and ``moe_shared`` when the config has shared experts)."""
    m = cfg.moe
    B, S, D = x.shape
    moe_p = p["moe"]
    pp = {"router": moe_p["router"]["w"],
          **{k: moe_p[k] for k in ("w_gate", "w_up", "w_down")}}
    share = SH.share_of(moe_p, "experts")
    if share is not None:           # a placement's stacks: E/model a rank
        ep, group = share.size, share.group
    else:
        mesh = current_mesh()
        ep = (mesh.shape["model"] if mesh is not None
              and "model" in mesh.axis_names else 1)
        group = mesh.group("model") if ep > 1 else None
    if ep > 1:
        _check_ep(pp, m, ep)
        # JAX's body is a shard_map with x and the router replicated over
        # ``model`` (their gradients summed over it) and no capture tag
        pp["router"] = comm.tp_enter(pp["router"], group)
        out, aux = _moe_local(pp, m, comm.tp_enter(x, group).reshape(-1, D),
                              ep, group)
        # the output is replicated over ``model``, and the model ranks'
        # copies differ where their duplicate rows lost capacity: JAX
        # returns device 0's, so every model rank takes model rank 0's
        out = comm.replicated_output(out, group)
        aux = comm.replicated_output(aux, group)
    else:
        out, aux = _moe_local(pp, m, x.reshape(-1, D),
                              tag=moe_p.get("_tag"))
    out = out.reshape(B, S, D)
    if m.num_shared:
        sh = p["moe_shared"]
        group = _tp_group(sh)
        xs = x if group is None else comm.tp_enter(x, group)
        g = (F.silu(apply_linear(sh["w_gate"], xs))
             * apply_linear(sh["w_up"], xs))
        shared_out = (apply_linear(sh["w_down"], g) if group is None
                      else apply_row_parallel(sh["w_down"], g, group))
        sgate = torch.sigmoid(apply_linear(sh["shared_gate"], x))
        out = out + sgate * shared_out
    return out, aux


def _check_ep(pp: Dict, m: MoEConfig, ep: int) -> None:
    """The expert-parallel body's preconditions: E divides over ep and the
    rank holds E/ep experts."""
    E = m.padded_experts
    if E % ep:
        raise ValueError(f"{E} experts do not split over ep = {ep}")
    w = pp["w_gate"]
    held = (w["B"] if isinstance(w, dict) else w).shape[0]
    if held != E // ep:
        raise ValueError(f"expert parallelism {ep}: this rank holds {held} "
                         f"experts, not E/ep = {E // ep} (take its "
                         f"local_block of each expert stack)")
