"""Gemma-3-12B [hf:google/gemma-3-1b-pt family; unverified].

48L d_model=3840 16H (GQA kv=8) head_dim=256 d_ff=15360 vocab=262144.
5 local (sliding-window 1024) : 1 global attention pattern, 128k ctx,
qk-norm, dual rope thetas (local 10k / global 1M).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    qk_norm=True,
    sliding_window=1024,
    local_global_pattern=(5, 1),
    mlp_kind="geglu",
    tie_embeddings=True,
    scale_embed=True,
    dtype="bfloat16",
    param_dtype="float32",
)
