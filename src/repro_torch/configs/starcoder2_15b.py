"""StarCoder2-15B. [arXiv:2402.19173; hf]

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152. LayerNorm + GELU
MLP (gpt-bigcode style), RoPE.  kv=4 < TP=16 makes this the showcase for
DistAttention-over-model-axis replacing head-TP (paper Fig. 11).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    norm_type="layernorm",
    activation="gelu",
    rope_theta=100_000.0,
)
