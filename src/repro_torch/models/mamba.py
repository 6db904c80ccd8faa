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

Under a ``dist.sharding.Placement`` (the sharded train step, and
serving) the rules split the ``ssm_inner`` leaves over ``model`` and the
sub-block, marked "inner", computes on the rank's shares: ``w_in`` and
``w_z`` column-parallel, the depthwise conv on the rank's columns,
``w_bc`` and ``w_dt`` row-parallel with one all-reduce of their
concatenated partial sums. Where ``model`` divides the heads (case A,
``dist.sharding.Share.splits``) the rank computes its heads end to end
(the chunked or step scan and ``d_skip`` on its heads, ``* silu(z)`` on
its columns); where the split cuts a head (case B) the conv'd branch is
all-gathered over ``model`` and the head-wise core runs whole on every
model rank before the rank keeps its columns. ``w_out`` is row-parallel
in both. The state follows ``CACHE_AXES`` as ``models.ssm``'s mLSTM does
(``ssm.state_in``, ``state_out``, ``hist_out``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.dist import comm
from repro_torch.dist import sharding as SH
from repro_torch.models import linear_scan as lscan
from repro_torch.models import ssm
from repro_torch.models.params import (Builder, apply_linear,
                                       enter_region, rms_norm, row_local)
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


def _ssm_inputs(p: Dict, cfg: ModelConfig, x: torch.Tensor, conv_hist=None,
                sp=None):
    """Shared by the full-sequence and decode paths. x: (B,S,d). Returns
    q, k (B,S,Hh,N), v (B,S,Hh,hd), log_f (B,S,Hh) of the heads the rank
    computes (``ssm.local_heads``), z (B,S, its columns), the conv'd
    branch c of those heads' columns, its ``ssm_core`` (``d_skip`` on
    those heads) and the conv history of its columns."""
    di, H, hd = _dims(cfg)
    N = cfg.ssm_state
    tp = SH.share_of(p, "inner")
    heads = ssm.local_heads(tp, H)
    core = p["ssm_core"]
    x = enter_region(x, None if tp is None else tp.group, sp)
    B, S, _ = x.shape
    a_log, dt_bias, d_skip = ssm.enter(
        tp, core["a_log"], core["dt_bias"], core["d_skip"])
    u = apply_linear(p["w_in"], x)
    z = apply_linear(p["w_z"], x)
    c, hist = _causal_conv(u, p["conv"], conv_hist)
    c = F.silu(c)
    bc = apply_linear(p["w_bc"], c)
    dt_raw = apply_linear(p["w_dt"], c)
    if tp is not None:
        # one all-reduce of the concatenated partial sums
        both = ssm.reduced(tp, torch.cat([bc, dt_raw], dim=-1))
        bc, dt_raw = both[..., :2 * H * N], both[..., 2 * H * N:]
        if heads == slice(None):                 # case B: every head
            c = comm.gather(c, -1, tp.group)
    bc = bc.reshape(B, S, 2, H, N)[:, :, :, heads]
    k = bc[:, :, 0]                                            # B_t
    q = bc[:, :, 1]                                            # C_t
    dt_raw = (dt_raw + dt_bias.to(c.dtype))[..., heads]
    dt = _softplus(dt_raw.to(torch.float32))                   # (B,S,Hh)
    A = -torch.exp(a_log.to(torch.float32))[heads]             # (Hh,)
    log_f = dt * A                                             # <= 0
    c = c.reshape(B, S, -1, hd)
    v = c * dt[..., None].to(c.dtype)                          # Δ_t u_t
    return q, k, v, log_f, z, c, d_skip[heads], hist


def _ssm_out(p: Dict, cfg: ModelConfig, y: torch.Tensor, c: torch.Tensor,
             d_skip: torch.Tensor, z: torch.Tensor, sp=None) -> torch.Tensor:
    """y (B,S,Hh,hd) plus the skip, ``* silu(z)`` on the rank's columns,
    the output projection."""
    tp = SH.share_of(p, "inner")
    B, S = y.shape[:2]
    y = (y + c * d_skip.to(y.dtype)[:, None]).reshape(B, S, -1)
    return ssm.project_out(p["w_out"], tp, ssm.out_columns(
        tp, y, cfg.n_heads) * F.silu(z), sp)


def apply_ssm(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              *, chunk: int = 128, return_cache: bool = False, sp=None):
    """Under ``sp`` x and the output are the rank's rows of the sequence;
    the scan runs over every row, so the state is the whole run's."""
    q, k, v, log_f, z, c, d_skip, hist = _ssm_inputs(p, cfg, x, sp=sp)
    li = torch.zeros_like(log_f)
    y, st = lscan.chunked_scan(q, k, v, log_f, li, chunk=chunk,
                               normalize=False)
    out = _ssm_out(p, cfg, y, c, d_skip, z, sp)
    if return_cache:
        return out, {"state": ssm.state_out(p, st, cfg.n_heads),
                     "conv": ssm.hist_out(SH.share_of(p, "inner"), hist)}
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
    """x: (B,1,d) single step. Returns (out, new cache); ``cache`` and the
    new one are the rank's blocks under ``CACHE_AXES`` on a placement."""
    tp, H = SH.share_of(p, "inner"), cfg.n_heads
    q, k, v, log_f, z, c, d_skip, hist = _ssm_inputs(
        p, cfg, x, ssm.conv_in(tp, cache["conv"]))
    li = torch.zeros_like(log_f)
    y, st = lscan.step_scan(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], li[:, 0],
                            ssm.state_in(p, cache["state"], H),
                            normalize=False)
    return _ssm_out(p, cfg, y[:, None], c, d_skip, z), {
        "state": ssm.state_out(p, st, H), "conv": ssm.hist_out(tp, hist)}


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
                  ssm_out: torch.Tensor, sp=None) -> torch.Tensor:
    """The two heads' outputs normed, gated and averaged, row by row (the
    rank's rows under ``sp``: its leaves ``row_local``)."""
    c = row_local(p["combine"], sp)
    a = rms_norm({"scale": c["norm_attn"]}, attn_out, cfg.norm_eps)
    s = rms_norm({"scale": c["norm_ssm"]}, ssm_out, cfg.norm_eps)
    return 0.5 * (c["g_attn"].to(a.dtype) * a + c["g_ssm"].to(s.dtype) * s)
