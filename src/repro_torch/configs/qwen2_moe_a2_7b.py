"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (MHA kv=16) vocab=151936. MoE: 60 routed experts top-4
(padded to 64 for EP divisibility; router masks the padding) + shared
experts worth 4x d_expert=1408.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared=4, d_shared=1408,
                  capacity_factor=1.25, pad_to=64),
    dtype="bfloat16",
    param_dtype="float32",
)
