"""Selective SSM (Mamba-2 / SSD formulation) and the Hymba parallel
attention+SSM block (counterpart of ``repro/models/mamba.py``).

Mamba-2's SSD form makes the decay a per-head scalar, which maps the whole
layer onto the shared chunked linear-recurrence engine
(``models.linear_scan``): batched matrix products plus an O(S/chunk) loop.

SSD step (head h):   S_t = exp(Δ_t A_h) S_{t-1} + (Δ_t u_t) ⊗ B_t
                     y_t = S_t C_t + D_h u_t
mapped as q := C_t (state readout), k := B_t, v := Δ_t u_t,
log_f := Δ_t A_h (A_h < 0), log_i := 0, normalize=False.

Hymba block (arXiv:2411.13676): attention and SSM run in *parallel* on the
same normed input; per-branch RMS norm then a learned per-channel convex
combination. Sliding-window attention on most layers, global on
{first, middle, last} (see ``ModelConfig.layer_kinds``).

In the sharded train step the rules split the ``ssm_inner`` leaves over
``model``; they are gathered over it before use and the SSM computes
whole on every model rank (``models.transformer._tp_keep``). Their
tensor-parallel compute is queued (ROADMAP, Queue 1, item 14).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import linear_scan as lscan
from repro_torch.models.params import Builder, apply_linear, rms_norm
from repro_torch.models.ssm import _causal_conv


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.n_heads
    hd = d_inner // heads
    return d_inner, heads, hd


def init_ssm(b: Builder, cfg: ModelConfig,
             stack: Tuple[int, ...] = ()) -> None:
    d = cfg.d_model
    di, H, hd = _dims(cfg)
    N = cfg.ssm_state
    st = (None,) * len(stack)
    b.linear("w_in", d, di, ("fsdp", "ssm_inner"), stack)      # u branch
    b.linear("w_z", d, di, ("fsdp", "ssm_inner"), stack)       # gate branch
    b.normal("conv", (*stack, cfg.ssm_conv, di), (*st, None, "ssm_inner"),
             scale=0.1)
    # selective params from the conv'd branch: B, C (per head, N each), Δ
    b.linear("w_bc", di, 2 * H * N, ("ssm_inner", None), stack)
    b.linear("w_dt", di, H, ("ssm_inner", None), stack)
    sub = b.sub("ssm_core")
    a_log = torch.log(torch.linspace(1.0, 16.0, H))
    sub.const("a_log", a_log.expand(*stack, H), st + (None,))  # A = -exp
    sub.zeros("dt_bias", (*stack, H), st + (None,))
    sub.ones("d_skip", (*stack, H), st + (None,))
    b.ones("head_norm", (*stack, hd), st + (None,))
    b.linear("w_out", di, d, ("ssm_inner", "fsdp"), stack,
             scale=0.02 / max(1, cfg.n_layers) ** 0.5)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus goes linear past 20
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_inputs(p: Dict, cfg: ModelConfig, x: torch.Tensor, conv_hist=None):
    """Shared by the full-sequence and decode paths. x: (B,S,d)."""
    B, S, _ = x.shape
    di, H, hd = _dims(cfg)
    N = cfg.ssm_state
    u = apply_linear(p["w_in"], x)
    z = apply_linear(p["w_z"], x)
    c, hist = _causal_conv(u, p["conv"], conv_hist)
    c = F.silu(c)
    bc = apply_linear(p["w_bc"], c).reshape(B, S, 2, H, N)
    k = bc[:, :, 0]                                            # B_t
    q = bc[:, :, 1]                                            # C_t
    dt_raw = (apply_linear(p["w_dt"], c)
              + p["ssm_core"]["dt_bias"].to(c.dtype))
    dt = _softplus(dt_raw.to(torch.float32))                   # (B,S,H)
    A = -torch.exp(p["ssm_core"]["a_log"].to(torch.float32))   # (H,)
    log_f = dt * A                                             # <= 0
    v = c.reshape(B, S, H, hd) * dt[..., None].to(c.dtype)     # Δ_t u_t
    return q, k, v, log_f, z, c, hist


def apply_ssm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              *, chunk: int = 128, return_cache: bool = False):
    B, S, _ = x.shape
    di, H, hd = _dims(cfg)
    q, k, v, log_f, z, c, hist = _ssm_inputs(p, cfg, x)
    li = torch.zeros_like(log_f)
    y, st = lscan.chunked_scan(q, k, v, log_f, li, chunk=chunk,
                               normalize=False)
    d_skip = p["ssm_core"]["d_skip"].to(y.dtype)               # (H,)
    y = y + c.reshape(B, S, H, hd) * d_skip[:, None]
    y = y.reshape(B, S, di) * F.silu(z)
    out = apply_linear(p["w_out"], y)
    if return_cache:
        return out, {"state": st, "conv": hist}
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> Dict:
    di, H, hd = _dims(cfg)
    return {
        "state": lscan.init_state(batch, H, cfg.ssm_state, hd,
                                  device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                            device=device),
    }


def decode_ssm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,d) single step. Returns (out, new cache)."""
    B = x.shape[0]
    di, H, hd = _dims(cfg)
    q, k, v, log_f, z, c, hist = _ssm_inputs(p, cfg, x, cache["conv"])
    li = torch.zeros_like(log_f)
    y, st = lscan.step_scan(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], li[:, 0],
                            cache["state"], normalize=False)
    y = y + c[:, 0].reshape(B, H, hd) * p["ssm_core"]["d_skip"].to(
        y.dtype)[:, None]
    y = y.reshape(B, 1, di) * F.silu(z)
    return apply_linear(p["w_out"], y), {"state": st, "conv": hist}


# ---------------------------------------------------------------------------
# Hymba parallel-head combine
# ---------------------------------------------------------------------------
def init_hymba_combine(b: Builder, cfg: ModelConfig,
                       stack: Tuple[int, ...] = ()) -> None:
    st = (None,) * len(stack)
    sub = b.sub("combine")
    for name in ("g_attn", "g_ssm", "norm_attn", "norm_ssm"):
        sub.ones(name, (*stack, cfg.d_model), st + (None,))


def hymba_combine(p: Dict, cfg: ModelConfig, attn_out: torch.Tensor,
                  ssm_out: torch.Tensor) -> torch.Tensor:
    c = p["combine"]
    a = rms_norm({"scale": c["norm_attn"]}, attn_out, cfg.norm_eps)
    s = rms_norm({"scale": c["norm_ssm"]}, ssm_out, cfg.norm_eps)
    return 0.5 * (c["g_attn"].to(a.dtype) * a + c["g_ssm"].to(s.dtype) * s)
