"""xLSTM-350M [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (no separate FFN; blocks carry their own
up/down projection) vocab=50304. sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    mlp_kind="none",
    vocab_size=50304,
    rope_kind="none",
    mlstm_every_slstm=8,   # layers 7, 15, 23 are sLSTM
    ssm_expand=2,
    dtype="bfloat16",
    param_dtype="float32",
)
