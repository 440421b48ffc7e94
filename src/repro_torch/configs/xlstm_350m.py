"""xLSTM-350M. [arXiv:2405.04517]

24L d_model=1024 4H d_ff=0 vocab=50304. sLSTM + mLSTM blocks (one sLSTM
per 8 blocks, rest mLSTM, proj factor 2.0). No KV cache exists — mLSTM
carries a fixed-size matrix memory per head — so DistAttention does not
apply: the serving engine keeps each request's recurrent state in a
batch slot (non-pooled path), and decode state is O(1) in the sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    norm_type="layernorm",
    activation="gelu",
    positional="none",
    slstm_every=8,
    mlstm_proj_factor=2.0,
)
