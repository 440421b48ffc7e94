"""Qwen3-0.6B. [hf:Qwen/Qwen3-0.6B]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
QK-norm (RMSNorm on per-head q/k before RoPE), head_dim=128 explicit,
tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    norm_type="rmsnorm",
    activation="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
