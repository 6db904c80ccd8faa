"""Model / run configuration system.

Every assigned architecture is expressed as a single ``ModelConfig``; the
model substrate (``repro.models``) interprets it. Configs are plain frozen
dataclasses so they hash/compare cleanly and can key jit caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


# ---------------------------------------------------------------------------
# Layer-kind schedule
# ---------------------------------------------------------------------------
# A model is a sequence of layer "kinds". Consecutive runs of the same kind
# are stacked and executed with lax.scan (compile-time compactness); distinct
# kinds break the stack. Kinds:
#   "attn"        full-attention transformer block
#   "swa"         sliding-window-attention transformer block
#   "mlstm"       xLSTM mLSTM block (matrix memory)
#   "slstm"       xLSTM sLSTM block (scalar memory)
#   "hymba"       parallel attention+mamba block (window attn)
#   "hymba_g"     parallel attention+mamba block (global attn)
ATTN_KINDS = ("attn", "swa", "hymba", "hymba_g")
SSM_KINDS = ("mlstm", "slstm")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # per-expert FFN hidden dim
    num_shared: int = 0          # shared (always-on) experts
    d_shared: int = 0            # hidden dim of each shared expert
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # pad experts so EP divides evenly (router masks padding to -inf)
    pad_to: int = 0

    @property
    def padded_experts(self) -> int:
        return max(self.num_experts, self.pad_to)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # --- attention flavour ---
    rope_kind: str = "rope"      # rope | mrope | none
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0    # gemma3 local layers use a different theta
    mrope_sections: Tuple[int, ...] = ()   # per-component head_dim split (t,h,w)
    qk_norm: bool = False
    sliding_window: int = 0      # >0 enables SWA for "swa"/"hymba" kinds
    local_global_pattern: Tuple[int, int] = (0, 0)  # (n_local, n_global) per superblock
    attn_logit_softcap: float = 0.0

    # --- FFN / MoE ---
    mlp_kind: str = "swiglu"     # swiglu | gelu | none
    moe: MoEConfig = field(default_factory=MoEConfig)
    moe_every: int = 1           # MoE layer frequency (1 = every layer)

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mlstm_every_slstm: int = 0   # xlstm: one sLSTM per this many layers (0 = none)

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- modality frontend stub ---
    frontend: str = ""           # "" | vision | audio

    # --- numerics / embeddings ---
    tie_embeddings: bool = False
    scale_embed: bool = False    # multiply embeddings by sqrt(d_model) (gemma)
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"
    logit_softcap: float = 0.0
    norm_eps: float = 1e-6

    # --- distribution knobs (perf-iteration surface) ---
    remat: str = "block"         # none | block | full
    scan_layers: bool = True
    shard_attn_heads: bool = True   # TP over head dims (uneven dims padded by SPMD)
    sequence_parallel: bool = True  # shard residual-stream seq dim over model axis

    # --- D-Rank / low-rank deployment ---
    # When a compression plan is attached (see repro.core.plan), linears are
    # FactorizedLinear{B,C}. rank_multiple MXU-aligns allocated ranks.
    rank_multiple: int = 128

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived ----------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind schedule for the decoder stack."""
        kinds = []
        nl, ng = self.local_global_pattern
        for i in range(self.n_layers):
            if self.family == "ssm":
                if self.mlstm_every_slstm and (i % self.mlstm_every_slstm
                                               == self.mlstm_every_slstm - 1):
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.family == "hybrid":
                # Hymba: global full attention at first/middle/last layer
                if i in (0, self.n_layers // 2, self.n_layers - 1):
                    kinds.append("hymba_g")
                else:
                    kinds.append("hymba")
            elif nl and ng:
                # gemma3-style: nl local then ng global, repeating
                kinds.append("swa" if (i % (nl + ng)) < nl else "attn")
            elif self.sliding_window:
                kinds.append("swa")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def layer_runs(self) -> Tuple[Tuple[str, int], ...]:
        """Consecutive same-kind runs: ((kind, length), ...)."""
        runs = []
        for k in self.layer_kinds():
            if runs and runs[-1][0] == k:
                runs[-1][1] += 1
            else:
                runs.append([k, 1])
        return tuple((k, n) for k, n in runs)

    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k decode shape."""
        if self.family in ("ssm", "hybrid"):
            return True
        nl, ng = self.local_global_pattern
        return bool(nl and ng)  # local:global mix (gemma3) qualifies

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            dtype="float32",
            param_dtype="float32",
            rank_multiple=4,
            sequence_parallel=False,
        )
        if self.moe.num_experts:
            changes["moe"] = MoEConfig(
                num_experts=4, top_k=2, d_expert=32,
                num_shared=min(self.moe.num_shared, 1), d_shared=32,
                capacity_factor=2.0, pad_to=4)
        if self.mrope_sections:
            changes["mrope_sections"] = (2, 3, 3)   # sums to head_dim 16 // 2
        if self.local_global_pattern != (0, 0):
            changes["local_global_pattern"] = (1, 1)
            changes["n_layers"] = 4
        if self.sliding_window:
            changes["sliding_window"] = 8
        if self.is_encoder_decoder:
            changes["n_encoder_layers"] = 2
            changes["n_layers"] = 2
        if self.mlstm_every_slstm:
            changes["mlstm_every_slstm"] = 2
        if self.ssm_state:
            changes["ssm_state"] = 4
        changes.update(overrides)
        return dataclasses.replace(self, **changes)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for LM-family archs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason-if-not). Mirrors DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, "pure full-attention arch; long_500k needs sub-quadratic attention"
    return True, ""
