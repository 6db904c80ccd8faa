"""LLaMA-family mini config — the paper's evaluation family at
experiment scale (the D-Rank paper compresses LLaMA-7B/13B/30B, LLaMA-2/3,
Mistral-7B). Used by EXPERIMENTS.md §Claims for the faithful small-scale
reproduction: train on the synthetic corpus, compress with all six methods,
compare PPL. MHA (kv == heads) so cross-layer grouping (n>1) is exercised
exactly as in the paper; a GQA variant is derived in the experiments to
exercise the paper's n=1 GQA policy.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-mini",
    family="dense",
    n_layers=8,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,           # MHA like LLaMA-1/2 7B
    head_dim=32,
    d_ff=688,
    vocab_size=2048,
    rope_theta=10_000.0,
    dtype="float32",
    param_dtype="float32",
    rank_multiple=8,
    sequence_parallel=False,
)
