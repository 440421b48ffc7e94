"""MusicGen-medium. [arXiv:2306.05284; hf]

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB —
``input_specs`` feeds precomputed frame embeddings. LayerNorm + GELU,
sinusoidal positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    modality="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    norm_type="layernorm",
    activation="gelu",
    positional="sinusoidal",
)
