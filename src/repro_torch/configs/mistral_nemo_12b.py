"""Mistral-Nemo-12B (128k ctx). [hf:mistralai/Mistral-Nemo-Base-2407]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128
(explicit: attention inner dim 4096 != d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    norm_type="rmsnorm",
    activation="swiglu",
    rope_theta=1_000_000.0,
)
