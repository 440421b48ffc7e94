"""Chameleon-34B. [arXiv:2405.09818]

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early-fusion mixed-modal decoder over VQ image tokens + text tokens; the
image tokenizer frontend is a STUB — ``input_specs`` feeds precomputed
patch-token embeddings. QK-norm as in the paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    modality="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=65_536,
    norm_type="rmsnorm",
    activation="swiglu",
    qk_norm=True,
    rope_theta=10_000.0,
)
