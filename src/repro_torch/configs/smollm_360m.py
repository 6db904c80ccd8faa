"""SmolLM-360M (llama-arch small) [hf:HuggingFaceTB/SmolLM-135M; hf].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="float32",
    # 15 heads / 2560 ff are small vs model=16 axis: shard FFN+vocab only
    shard_attn_heads=False,
)
