"""Granite-3.0-1B-A400M MoE [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) vocab=49155. MoE: 32 experts, top-8,
d_expert=512, no shared experts.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,                     # FFN is fully MoE
    vocab_size=49155,
    rope_theta=10_000.0,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512,
                  capacity_factor=1.25, pad_to=32),
    dtype="bfloat16",
    param_dtype="float32",
)
