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

In the sharded train step the rules split the ``ssm_inner`` leaves and
the sLSTM FFN's ``mlp`` over ``model``; they are gathered over it before
use and both blocks compute whole on every model rank
(``models.transformer._tp_keep``). Their tensor-parallel compute is
queued (ROADMAP, Queue 1, item 14).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import linear_scan as lscan
from repro_torch.models.mlp import _gelu
from repro_torch.models.params import Builder, apply_linear, head_rms_norm


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


def _mlstm_qkvif(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 conv_hist=None):
    B, S, _ = x.shape
    H = cfg.n_heads
    di, hd = _inner(cfg)
    u = apply_linear(p["w_up"], x)
    z = apply_linear(p["w_gate"], x)
    c, hist = _causal_conv(u, p["conv"], conv_hist)
    c = F.silu(c)
    q = apply_linear(p["wq"], c).reshape(B, S, H, hd)
    k = apply_linear(p["wk"], c).reshape(B, S, H, hd) * (hd ** -0.5)
    v = u.reshape(B, S, H, hd)
    gif = (apply_linear(p["w_if"], c)
           + p["gate_bias"]["b_if"].to(c.dtype)).to(torch.float32)
    li = gif[..., :H]                       # raw input gate (exp)
    lf = F.logsigmoid(gif[..., H:])         # sigmoid forget gate, log space
    return q, k, v, li, lf, z, hist


def apply_mlstm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                *, chunk: int = 128, return_cache: bool = False):
    B, S, _ = x.shape
    di, hd = _inner(cfg)
    q, k, v, li, lf, z, hist = _mlstm_qkvif(p, cfg, x)
    y, st = lscan.chunked_scan(q, k, v, lf, li, chunk=chunk, normalize=True)
    y = head_rms_norm(p["head_norm"], y, cfg.norm_eps)
    y = y.reshape(B, S, di) * F.silu(z)
    out = apply_linear(p["w_down"], y)
    if return_cache:
        return out, {"state": st, "conv": hist}
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
    """x: (B,1,D) single step. Returns (out, new cache)."""
    B = x.shape[0]
    di, hd = _inner(cfg)
    q, k, v, li, lf, z, hist = _mlstm_qkvif(p, cfg, x, cache["conv"])
    y, st = lscan.step_scan(q[:, 0], k[:, 0], v[:, 0], lf[:, 0], li[:, 0],
                            cache["state"], normalize=True)
    y = head_rms_norm(p["head_norm"], y, cfg.norm_eps)
    y = y.reshape(B, 1, di) * F.silu(z)
    return apply_linear(p["w_down"], y), {"state": st, "conv": hist}


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


def _slstm_ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    g = _gelu(apply_linear(p["ff_gate"], x))
    return apply_linear(p["ff_down"], g * apply_linear(p["ff_up"], x))


def apply_slstm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                *, return_cache: bool = False):
    """Full-sequence sLSTM: a Python loop over time."""
    B, S, d = x.shape
    pre = apply_linear(p["w_in"], x) + p["bias"]["b"].to(x.dtype)
    st = init_slstm_cache(cfg, B, x.dtype, x.device)
    hs = []
    for t in range(S):
        h, st = _slstm_cell(p, cfg, pre[:, t], st)
        hs.append(h)
    y = torch.stack(hs, dim=1)                            # (B,S,H,hd)
    y = head_rms_norm(p["head_norm"], y, cfg.norm_eps).reshape(B, S, d)
    out = _slstm_ffn(p, y)
    if return_cache:
        return out, st
    return out


def decode_slstm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    B, _, d = x.shape
    pre = apply_linear(p["w_in"], x[:, 0]) + p["bias"]["b"].to(x.dtype)
    h, st = _slstm_cell(p, cfg, pre, cache)
    y = head_rms_norm(p["head_norm"], h, cfg.norm_eps).reshape(B, 1, d)
    return _slstm_ffn(p, y), st
