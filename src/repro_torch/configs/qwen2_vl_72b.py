"""Qwen2-VL-72B language backbone [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, M-RoPE.
The vision frontend is a STUB: ``input_specs`` feeds precomputed patch
embeddings + 3-component M-RoPE position ids.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # t/h/w split of head_dim//2
    frontend="vision",
    dtype="bfloat16",
    param_dtype="float32",
)
