"""OLMo-1B. [arXiv:2402.00838; hf]

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm (no scale/bias), SwiGLU, RoPE, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    norm_type="nonparametric_ln",
    activation="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
