"""Dense FFN, SwiGLU / GeGLU / GeLU (counterpart of the dense half of
``repro/models/mlp.py``). Mixture-of-Experts comes with its model
families."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.params import Builder, apply_linear


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


def apply_mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        act = _gelu if cfg.mlp_kind == "geglu" else F.silu
        h = act(apply_linear(p["w_gate"], x)) * apply_linear(p["w_up"], x)
    else:
        h = _gelu(apply_linear(p["w_up"], x))
    return apply_linear(p["w_down"], h)
