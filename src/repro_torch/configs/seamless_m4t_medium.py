"""SeamlessM4T-medium transformer backbone [arXiv:2308.11596; hf].

Enc-dec: 12L encoder + 12L decoder, d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=256206. The audio frontend is a STUB: ``input_specs`` feeds
precomputed frame embeddings to the encoder.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope_kind="none",          # learned/sinusoidal positions; we use sinusoidal
    mlp_kind="gelu",
    frontend="audio",
    dtype="bfloat16",
    param_dtype="float32",
)
