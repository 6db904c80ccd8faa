"""Qwen3-4B [hf:Qwen/Qwen3-8B family; hf].

36L d_model=2560 32H (GQA kv=8) head_dim=128 d_ff=9728 vocab=151936, qk-norm.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="float32",
)
