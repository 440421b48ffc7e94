"""Qwen1.5-MoE-A2.7B. [hf:Qwen/Qwen1.5-MoE-A2.7B]

24L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts (shared width 4x1408=5632).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    norm_type="rmsnorm",
    activation="swiglu",
    rope_theta=1_000_000.0,
)
