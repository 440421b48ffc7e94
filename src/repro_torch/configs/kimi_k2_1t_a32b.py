"""Kimi K2 — trillion-param MoE. [arXiv:2501.kimi2; paper-table]

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 routed experts top-8 + 1 shared expert, first layer dense.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,                 # 7168 / 64
    d_ff=18432,                   # dense FFN for the first_k_dense layer
    vocab_size=163_840,
    num_experts=384,
    num_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_k_dense=1,
    norm_type="rmsnorm",
    activation="swiglu",
    rope_theta=50_000.0,
)
