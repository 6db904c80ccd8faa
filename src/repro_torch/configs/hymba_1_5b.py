"""Hymba-1.5B [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Parallel attention + mamba heads per block; sliding-window attention except
global attention at layers {first, middle, last}. Meta-tokens are omitted
(frontend-stub policy, see DESIGN.md).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    rope_theta=10_000.0,
    sliding_window=1024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dtype="bfloat16",
    param_dtype="float32",
    shard_attn_heads=False,   # 25 heads vs model=16: shard FFN/SSM dims instead
)
