"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, sequential with block-diagonal recurrence) (counterpart of
``repro/models/ssm.py``).

mLSTM block (xLSTM arXiv:2405.04517, pre-up-projection variant):
    x -> RMSNorm -> up-proj to (e*d) twice: branch u, gate z
      u -> causal conv (k=4, silu) -> q, k projections; v from u directly
      per-head scalar gates i (exp) / f (sigmoid) from the conv'd branch
      mLSTM cell (chunked_scan, normalize=True) -> per-head RMS norm
      -> * silu(z) -> down proj -> residual
sLSTM block:
    x -> RMSNorm -> sLSTM cell (4 gates, block-diagonal recurrence,
    stabilized exponential i/f gating) -> per-head RMS norm -> GeGLU FFN
    (proj factor 4/3) -> residual

Decode paths keep O(1) state per layer: mLSTM (S, n, m) per head and the
conv history; sLSTM (c, n, h, m). They return the new state; the caller
writes it into its cache (``transformer.decode_step`` does so in place).
The full-sequence sLSTM is a Python loop over time of plain torch ops, as
the JAX package's ``lax.scan`` is plain XLA ops (no Pallas kernel there).

Under a ``dist.sharding.Placement`` (the sharded train step, and
serving) the rules split the ``ssm_inner`` leaves and the sLSTM FFN's
``mlp`` over ``model``, and each rank computes on its shares; no weight
split over ``model`` is gathered over it. The mLSTM sub-block is marked
"inner" (``dist.sharding.Share``): ``w_up`` and ``w_gate`` are
column-parallel and the depthwise conv runs on the rank's columns. Where
``model`` divides the heads (case A, ``Share.splits``) the rank computes
its heads end to end: ``wq`` and ``wk`` are row-parallel and their
partial sums reduce-scattered onto its heads (the columns are
head-major), ``w_if`` is all-reduced, the scan, the per-head norm and
``* silu(z)`` run on its heads, and ``w_down`` is row-parallel. Where the
split cuts a head (case B) the projections stay on shares, ``q``, ``k``
and the gates are all-reduced, ``v`` is all-gathered, and the head-wise
core runs whole on every model rank before the rank keeps its columns.
The cache follows ``CACHE_AXES``: the matrix memory ``C`` holds the
rank's heads in case A and all of them in case B; the conv history, the
normalizer ``n`` and the stabilizer ``m`` are whole, all-gathered over
``model`` after the step. The sLSTM's ``w_in`` is column-parallel (its
split cuts the ``[z, i, f, o]`` layout, not heads) and its
pre-activations are all-gathered before the replicated cell; its FFN is
column- then row-parallel where ``dff`` splits. A sub-block holding a
factorized linear is gathered whole (marked "whole") and computes whole,
its matrix memory still held as the rules place it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.dist import comm
from repro_torch.dist import sharding as SH
from repro_torch.models import linear_scan as lscan
from repro_torch.models.mlp import _gelu
from repro_torch.models.params import (Builder, apply_linear,
                                       apply_row_parallel, enter_region,
                                       head_rms_norm, leave_region)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _inner(cfg: ModelConfig) -> Tuple[int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    hd = d_inner // cfg.n_heads
    return d_inner, hd


def init_mlstm(b: Builder, cfg: ModelConfig,
               stack: Tuple[int, ...] = ()) -> None:
    d, H = cfg.d_model, cfg.n_heads
    di, hd = _inner(cfg)
    st = (None,) * len(stack)
    b.linear("w_up", d, di, ("fsdp", "ssm_inner"), stack)
    b.linear("w_gate", d, di, ("fsdp", "ssm_inner"), stack)
    b.normal("conv", (*stack, 4, di), (*st, None, "ssm_inner"), scale=0.1)
    b.linear("wq", di, di, ("ssm_inner", None), stack)
    b.linear("wk", di, di, ("ssm_inner", None), stack)
    # per-head scalar gates from the conv'd branch
    b.linear("w_if", di, 2 * H, ("ssm_inner", None), stack)
    bif = torch.cat([torch.zeros(H), 3.0 * torch.ones(H)])
    b.sub("gate_bias").const("b_if", bif.expand(*stack, 2 * H),
                             st + (None,))
    b.ones("head_norm", (*stack, hd), st + (None,))
    b.linear("w_down", di, d, ("ssm_inner", "fsdp"), stack,
             scale=0.02 / max(1, cfg.n_layers) ** 0.5)


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 prev: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq. u: (B,S,D); w: (K,D).
    prev: (B,K-1,D) history for decode; returns (out, new history)."""
    K = w.shape[0]
    S = u.shape[1]
    if prev is None:
        prev = torch.zeros((u.shape[0], K - 1, u.shape[-1]), dtype=u.dtype,
                           device=u.device)
    full = torch.cat([prev.to(u.dtype), u], dim=1)
    wd = w.to(u.dtype)
    out = full[:, 0:S] * wd[0]
    for i in range(1, K):
        out = out + full[:, i:i + S] * wd[i]
    return out, full[:, -(K - 1):]


# ---------------------------------------------------------------------------
# A recurrent sub-block on its ``ssm_inner`` shares (Mamba-2 and mLSTM):
# ``tp`` is its "inner" mark (``dist.sharding.Share``), None off a
# placement or where the sub-block was gathered whole ("whole")
# ---------------------------------------------------------------------------
def local_heads(tp: Optional[SH.Share], heads: int) -> slice:
    """The heads a rank computes: its block in case A, all of them in case
    B and off a placement."""
    if tp is not None and tp.splits(heads):
        return tp.block(heads)
    return slice(None)


def enter(tp: Optional[SH.Share], *ts):
    """Tensors every model rank holds whole, used for the rank's own heads
    or columns (``comm.tp_enter``: their gradients sum over ``model``)."""
    if tp is None:
        return ts
    return tuple(comm.tp_enter(t, tp.group) for t in ts)


def reduced(tp: Optional[SH.Share], t: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over ``model`` for
    compute that keeps a part of the result (its heads; case B's whole
    core): an all-reduce forward and backward."""
    if tp is None:
        return t
    return comm.tp_enter(comm.tp_exit(t, tp.group), tp.group)


def out_columns(tp: Optional[SH.Share], y: torch.Tensor,
                heads: int) -> torch.Tensor:
    """Case B: the rank's columns of the whole core's output (B, S, di),
    for ``* silu(z)`` and the row-parallel output projection."""
    if tp is None or tp.splits(heads):
        return y
    return y[..., tp.block(y.shape[-1])]


def project_out(p: Dict, tp: Optional[SH.Share], y: torch.Tensor,
                sp=None) -> torch.Tensor:
    """The output projection: row-parallel on the rank's columns; under
    ``sp`` onto the rank's rows of the sequence."""
    if tp is None:
        return leave_region(apply_linear(p, y), None, sp)
    return apply_row_parallel(p, y, tp.group, sp)


def conv_in(tp: Optional[SH.Share], hist: torch.Tensor) -> torch.Tensor:
    """The rank's columns of a whole conv history (the cache's)."""
    if tp is None:
        return hist
    return hist[..., tp.block(hist.shape[-1])]


def state_split(p: Dict, heads: int) -> Optional[SH.Share]:
    """The mark whose group splits the sub-block's matrix memory on heads
    under the cache rules (case A, or a "whole" sub-block whose heads
    divide), else None."""
    s = p.get("_tp")
    if s is not None and s.kind in ("inner", "whole") and s.splits(heads):
        return s
    return None


def state_in(p: Dict, st: lscan.ScanState, heads: int) -> lscan.ScanState:
    """A cache's state (``CACHE_AXES``' block: S on the rank's heads in
    case A, n and m whole) as the step computes with it."""
    s = state_split(p, heads)
    if s is None:
        return st
    if s.kind == "inner":
        return lscan.ScanState(st.S, st.n[:, s.block(heads)],
                               st.m[:, s.block(heads)])
    return lscan.ScanState(comm.all_gather(st.S, 1, s.group), st.n, st.m)


def state_out(p: Dict, st: lscan.ScanState, heads: int) -> lscan.ScanState:
    """The step's state as the cache holds it (``state_in``'s inverse)."""
    s = state_split(p, heads)
    if s is None:
        return st
    if s.kind == "inner":
        return lscan.ScanState(st.S, comm.all_gather(st.n, 1, s.group),
                               comm.all_gather(st.m, 1, s.group))
    return lscan.ScanState(st.S[:, s.block(heads)], st.n, st.m)


def hist_out(tp: Optional[SH.Share], hist: torch.Tensor) -> torch.Tensor:
    """The conv history whole, as the cache holds it: the ranks' columns
    all-gathered over ``model``."""
    if tp is None:
        return hist
    return comm.all_gather(hist, hist.dim() - 1, tp.group)


def _mlstm_qkvif(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 conv_hist=None, sp=None):
    """q, k, v (B, S, Hh, hd) of the heads the rank computes, the gates
    li, lf (B, S, Hh), z (B, S, its columns), the conv history of its
    columns."""
    H = cfg.n_heads
    di, hd = _inner(cfg)
    tp = SH.share_of(p, "inner")
    heads = local_heads(tp, H)
    x = enter_region(x, None if tp is None else tp.group, sp)
    B, S, _ = x.shape
    b_if, = enter(tp, p["gate_bias"]["b_if"])
    u = apply_linear(p["w_up"], x)
    z = apply_linear(p["w_gate"], x)
    c, hist = _causal_conv(u, p["conv"], conv_hist)
    c = F.silu(c)
    q = apply_linear(p["wq"], c)
    k = apply_linear(p["wk"], c)
    if tp is not None and heads != slice(None):     # case A: its heads
        q = comm.tp_scatter(q, -1, tp.group)
        k = comm.tp_scatter(k, -1, tp.group)
    elif tp is not None:                            # case B: every head
        q, k = reduced(tp, q), reduced(tp, k)
        u = comm.gather(u, -1, tp.group)
    Hh = q.shape[-1] // hd
    q = q.reshape(B, S, Hh, hd)
    k = k.reshape(B, S, Hh, hd) * (hd ** -0.5)
    v = u.reshape(B, S, Hh, hd)
    gif = (reduced(tp, apply_linear(p["w_if"], c))
           + b_if.to(c.dtype)).to(torch.float32)
    li = gif[..., :H][..., heads]           # raw input gate (exp)
    lf = F.logsigmoid(gif[..., H:][..., heads])  # sigmoid forget, log space
    return q, k, v, li, lf, z, hist


def _mlstm_out(p: Dict, cfg: ModelConfig, y: torch.Tensor,
               z: torch.Tensor, sp=None) -> torch.Tensor:
    """The per-head norm of the scan's output (B, S, Hh, hd), ``*
    silu(z)`` on the rank's columns and the down projection."""
    tp = SH.share_of(p, "inner")
    B, S = y.shape[:2]
    norm, = enter(tp, p["head_norm"])
    y = head_rms_norm(norm, y, cfg.norm_eps).reshape(B, S, -1)
    return project_out(p["w_down"], tp,
                       out_columns(tp, y, cfg.n_heads) * F.silu(z), sp)


def apply_mlstm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                *, chunk: int = 128, return_cache: bool = False, sp=None):
    """Under ``sp`` x and the output are the rank's rows of the sequence;
    the scan runs over every row, so the state is the whole run's."""
    q, k, v, li, lf, z, hist = _mlstm_qkvif(p, cfg, x, sp=sp)
    y, st = lscan.chunked_scan(q, k, v, lf, li, chunk=chunk, normalize=True)
    out = _mlstm_out(p, cfg, y, z, sp)
    if return_cache:
        return out, {"state": state_out(p, st, cfg.n_heads),
                     "conv": hist_out(SH.share_of(p, "inner"), hist)}
    return out


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict:
    di, hd = _inner(cfg)
    return {
        "state": lscan.init_state(batch, cfg.n_heads, hd, hd,
                                  device=device),
        "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
    }


def decode_mlstm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,D) single step. Returns (out, new cache); ``cache`` and the
    new one are the rank's blocks under ``CACHE_AXES`` on a placement."""
    tp, H = SH.share_of(p, "inner"), cfg.n_heads
    q, k, v, li, lf, z, hist = _mlstm_qkvif(p, cfg, x,
                                            conv_in(tp, cache["conv"]))
    y, st = lscan.step_scan(q[:, 0], k[:, 0], v[:, 0], lf[:, 0], li[:, 0],
                            state_in(p, cache["state"], H), normalize=True)
    return _mlstm_out(p, cfg, y[:, None], z), {
        "state": state_out(p, st, H), "conv": hist_out(tp, hist)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
SLSTM_GATES = ("rz", "ri", "rf", "ro")


def init_slstm(b: Builder, cfg: ModelConfig,
               stack: Tuple[int, ...] = ()) -> None:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    st = (None,) * len(stack)
    b.linear("w_in", d, 4 * d, ("fsdp", "ssm_inner"), stack)  # z,i,f,o
    # block-diagonal recurrence: (H, hd, hd) per gate
    for g in SLSTM_GATES:
        b.normal(g, (*stack, H, hd, hd), (*st, None, None, None),
                 scale=1.0 / hd ** 0.5)
    bias = torch.cat([torch.zeros(2 * d), 3.0 * torch.ones(d),
                      torch.zeros(d)])
    b.sub("bias").const("b", bias.expand(*stack, 4 * d), st + (None,))
    b.ones("head_norm", (*stack, hd), st + (None,))
    dff = int(4 * d // 3)
    b.linear("ff_gate", d, dff, ("fsdp", "mlp"), stack)
    b.linear("ff_up", d, dff, ("fsdp", "mlp"), stack)
    b.linear("ff_down", dff, d, ("mlp", "fsdp"), stack,
             scale=0.02 / max(1, cfg.n_layers) ** 0.5)


def _slstm_cell(p: Dict, cfg: ModelConfig, pre: torch.Tensor,
                state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One step. pre: (B, 4d) input pre-activations (before recurrence).
    state: c,n,h (B,H,hd), m (B,H,hd)."""
    B = pre.shape[0]
    H = cfg.n_heads
    hd = cfg.d_model // H
    h = state["h"]                                        # (B,H,hd)
    rec = [torch.einsum("bhd,hde->bhe", h, p[g].to(h.dtype))
           for g in SLSTM_GATES]
    parts = pre.reshape(B, 4, H, hd)
    zt = torch.tanh(parts[:, 0] + rec[0])
    it = (parts[:, 1] + rec[1]).to(torch.float32)         # log input gate
    ft = (parts[:, 2] + rec[2]).to(torch.float32)         # log forget gate
    ot = torch.sigmoid(parts[:, 3] + rec[3])
    # stabilized exponential gating, per scalar memory cell
    m_new = torch.maximum(ft + state["m"], it)
    i_g = torch.exp(it - m_new)
    f_g = torch.exp(ft + state["m"] - m_new)
    c = f_g * state["c"] + i_g * zt.to(torch.float32)
    n = f_g * state["n"] + i_g
    h_new = ot * (c / torch.clamp(n, min=1e-6)).to(ot.dtype)
    return h_new, {"c": c, "n": n, "h": h_new, "m": m_new}


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict:
    """c, n, m in float32 and h in ``dtype``, (batch, H, hd) each: four
    tensors (the JAX package shares one zeros array between c, n and m,
    harmless there; a cache written in place needs its own storage per
    leaf)."""
    H = cfg.n_heads
    hd = cfg.d_model // H

    def z(dt):
        return torch.zeros((batch, H, hd), dtype=dt, device=device)
    return {"c": z(torch.float32), "n": z(torch.float32), "h": z(dtype),
            "m": z(torch.float32)}


def _slstm_ffn(p: Dict, x: torch.Tensor, sp=None) -> torch.Tensor:
    """The GeGLU FFN; column- then row-parallel where a placement left
    ``ff_down`` row-parallel (JAX's ``constrain(h, "batch", None,
    "mlp")``). x is whole (the cell's output); under ``sp`` the output is
    the rank's rows of the sequence."""
    tp = SH.share_of(p["ff_down"], "row")
    if tp is not None:
        x = comm.tp_enter(x, tp.group)
    h = _gelu(apply_linear(p["ff_gate"], x)) * apply_linear(p["ff_up"], x)
    if tp is None:
        return leave_region(apply_linear(p["ff_down"], h), None, sp)
    return apply_row_parallel(p["ff_down"], h, tp.group, sp)


def _slstm_pre(p: Dict, x: torch.Tensor, sp=None) -> torch.Tensor:
    """The cell's input pre-activations (..., 4d): where ``w_in`` is
    column-parallel, the rank's columns all-gathered over ``model`` for
    the replicated cell. Under ``sp`` x is the rank's rows of the
    sequence, and the pre-activations are every row's."""
    tp = SH.share_of(p["w_in"], "col")
    if tp is None:
        pre = apply_linear(p["w_in"], enter_region(x, None, sp))
    else:
        pre = comm.gather_replicated(apply_linear(
            p["w_in"], enter_region(x, tp.group, sp)), x.dim() - 1,
            tp.group, tp.index)
    return pre + p["bias"]["b"].to(x.dtype)


def apply_slstm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                *, return_cache: bool = False, sp=None):
    """Full-sequence sLSTM: a Python loop over time (under ``sp`` over
    every row of the sequence; x and the output are the rank's rows)."""
    pre = _slstm_pre(p, x, sp)
    B, S, d = pre.shape[0], pre.shape[1], x.shape[-1]
    st = init_slstm_cache(cfg, B, x.dtype, x.device)
    hs = []
    for t in range(S):
        h, st = _slstm_cell(p, cfg, pre[:, t], st)
        hs.append(h)
    y = torch.stack(hs, dim=1)                            # (B,S,H,hd)
    y = head_rms_norm(p["head_norm"], y, cfg.norm_eps).reshape(B, S, d)
    out = _slstm_ffn(p, y, sp)
    if return_cache:
        return out, st
    return out


def decode_slstm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    B, _, d = x.shape
    h, st = _slstm_cell(p, cfg, _slstm_pre(p, x[:, 0]), cache)
    y = head_rms_norm(p["head_norm"], h, cfg.norm_eps).reshape(B, 1, d)
    return _slstm_ffn(p, y), st
