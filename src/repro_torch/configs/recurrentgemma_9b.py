"""RecurrentGemma-9B (Griffin). [arXiv:2402.19427]

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Block pattern 1 local-attention per 2 RG-LRU blocks; window 2048; GeGLU.
Recurrent state is O(1) in sequence length and the local-attention KV is
bounded by the window, so DistAttention KV pooling does not apply: the
serving engine keeps each request's state in a batch slot, and the
local attention layers of every admission prefill run the flash-prefill
kernel with the window.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    norm_type="rmsnorm",
    activation="geglu",
    rope_theta=10_000.0,
    block_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    lru_width=4096,
)
