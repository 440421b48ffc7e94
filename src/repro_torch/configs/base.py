"""Config dataclasses for models, shapes, and the serving/training runtime.

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input shapes are ``ShapeConfig`` instances in ``SHAPES``.  Reduced
("smoke") variants for CPU tests are derived with ``reduce_config`` so they
preserve the structural family (MoE routing, hybrid layer pattern, sLSTM
placement) while shrinking every dimension.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # "dense" | "moe" | "hybrid" | "ssm"
    modality: str = "text"           # "text" | "vlm" | "audio"
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # explicit; not always d_model // num_heads
    d_ff: int = 0                    # dense FFN width (0 for pure-SSM archs)
    vocab_size: int = 0

    # --- MoE ---
    num_experts: int = 0             # routed experts (0 => dense FFN)
    num_shared_experts: int = 0      # always-on experts (Qwen-MoE / Kimi style)
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert FFN width
    first_k_dense: int = 0           # leading layers that use a dense FFN

    # --- normalization / activation / positional ---
    norm_type: str = "rmsnorm"       # "rmsnorm" | "layernorm" | "nonparametric_ln"
    activation: str = "swiglu"       # "swiglu" | "geglu" | "gelu"
    qk_norm: bool = False
    positional: str = "rope"         # "rope" | "sinusoidal" | "none"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # --- hybrid (RecurrentGemma): repeating block pattern ---
    # e.g. ("rglru", "rglru", "attn"): one attention layer per two recurrent.
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 0            # sliding-window size for local attention
    lru_width: int = 0               # RG-LRU recurrent width (0 => d_model)

    # --- ssm (xLSTM): which layer indices are sLSTM (rest mLSTM) ---
    slstm_every: int = 0             # i % slstm_every == slstm_every-1 => sLSTM
    mlstm_proj_factor: float = 2.0

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def layer_kind(self, i: int) -> str:
        """Block type at layer index i: 'attn' | 'rglru' | 'mlstm' | 'slstm'."""
        if self.family == "ssm":
            if self.slstm_every and (i % self.slstm_every == self.slstm_every - 1):
                return "slstm"
            return "mlstm"
        if self.block_pattern:
            return self.block_pattern[i % len(self.block_pattern)]
        return "attn"

    # --- sizing helpers (used by the perf model and roofline) ----------- #
    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes per token across ALL layers (0 for O(1)-state archs)."""
        per_layer = 2 * self.num_kv_heads * self.head_dim * bytes_per_el
        n_attn = sum(1 for i in range(self.num_layers) if self.layer_kind(i) == "attn")
        return per_layer * n_attn

    def param_count(self) -> int:
        """Total parameter count (approximate for ssm/hybrid internals)."""
        d, hd = self.d_model, self.head_dim
        n_emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = n_emb
        glu = self.activation in ("swiglu", "geglu")
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += d * self.num_heads * hd * 2            # q, o
                total += d * self.num_kv_heads * hd * 2         # k, v
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + w * d + 3 * w              # in x2, out, gates
            elif kind in ("mlstm", "slstm"):
                pf = self.mlstm_proj_factor if kind == "mlstm" else 4.0 / 3.0
                up = int(d * pf)
                total += 2 * d * up + up * d + 4 * up           # up/gate/down + gates
            # FFN
            if kind in ("attn", "rglru"):
                if self.is_moe and i >= self.first_k_dense:
                    n_e = self.num_experts + self.num_shared_experts
                    per = (3 if glu else 2) * d * self.moe_d_ff
                    total += n_e * per + d * self.num_experts   # + router
                elif self.d_ff:
                    total += (3 if glu else 2) * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k + shared experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        glu = self.activation in ("swiglu", "geglu")
        per = (3 if glu else 2) * d * self.moe_d_ff
        n_moe_layers = self.num_layers - self.first_k_dense
        inactive = (self.num_experts - self.top_k) * per * n_moe_layers
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                        # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    "train",   4_096,   256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  ShapeConfig("decode_32k",  "decode",  32_768,  128),
    "long_500k":   ShapeConfig("long_500k",   "decode",  524_288, 1),
}


def reduce_config(cfg: ModelConfig, *, layers: Optional[int] = None) -> ModelConfig:
    """Shrink a config to CPU-smoke size while preserving family structure."""
    pat = len(cfg.block_pattern) or 1
    n_layers = layers if layers is not None else max(2, pat)
    if cfg.block_pattern:
        n_layers = max(n_layers, pat)          # at least one full pattern
    if cfg.slstm_every:
        n_layers = max(n_layers, cfg.slstm_every)
    heads = 4
    kv = max(1, heads * cfg.num_kv_heads // max(1, cfg.num_heads))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 8),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=0 if cfg.moe_d_ff == 0 else 32,
        first_k_dense=min(cfg.first_k_dense, 1),
        local_window=0 if cfg.local_window == 0 else 32,
        lru_width=0 if cfg.lru_width == 0 else 64,
        slstm_every=cfg.slstm_every,
    )
