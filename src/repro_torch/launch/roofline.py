"""Roofline model of a config: useful FLOPs and mandatory bytes.

The half of the JAX package's ``repro.launch.roofline`` that reads only
a ``ModelConfig`` and a ``ShapeConfig``: ``model_useful_flops`` and
``model_mandatory_bytes``, the same formulas, here held against the
H100's data-sheet peaks (``distributed.hardware.H100``). Its other half
parses XLA's compiled HLO (collective bytes, per-device FLOPs and bytes
from ``cost_analysis``) and has no PyTorch counterpart.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.hardware import H100, HardwareSpec


def model_useful_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N_active*D for train, 2*N_active*D forward-only (+ attention)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        base = 6.0 * n * D
    elif shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        base = 2.0 * n * D
    else:                                  # decode: one token per request
        D = shape.global_batch
        base = 2.0 * n * D
    # Attention score/value FLOPs (not in N):
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.layer_kind(i) == "attn")
    h, hd = cfg.num_heads, cfg.head_dim
    if shape.kind in ("train", "prefill"):
        w = cfg.local_window or shape.seq_len
        ctx = min(w, shape.seq_len)
        att = 4.0 * shape.global_batch * shape.seq_len * ctx / 2 * h * hd \
            * n_attn
        att *= 3 if shape.kind == "train" else 1
    else:
        w = cfg.local_window or shape.seq_len
        ctx = min(w, shape.seq_len)
        att = 4.0 * shape.global_batch * ctx * h * hd * n_attn
    return base + att


def model_mandatory_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          bpe: int = 2) -> float:
    """Minimum HBM traffic a perfect implementation must move (global).

    decode : active params once + the whole KV pool once (+ tiny I/O).
    prefill: params once + KV written once + ~2 activation passes.
    train  : params + grads + moments r/w (8N f32-equiv @4B treated as
             6N*bpe + 8N*4 conservative) + ~4 activation passes w/ remat.
    """
    n = cfg.active_param_count()
    act_bytes = (shape.global_batch * shape.seq_len * cfg.d_model * bpe)
    kv = cfg.kv_bytes_per_token(bpe)
    if shape.kind == "decode":
        ctx = min(cfg.local_window or shape.seq_len, shape.seq_len)
        return n * bpe + shape.global_batch * ctx * kv
    if shape.kind == "prefill":
        return n * bpe + shape.global_batch * shape.seq_len * kv \
            + 2 * act_bytes * cfg.num_layers
    return (2 * n * bpe + 8 * n * 4.0 / 4.0          # p,g bf16 + m,v f32
            + 4 * act_bytes * cfg.num_layers)


def ideal_step_s(cfg: ModelConfig, shape: ShapeConfig,
                 hw: HardwareSpec = H100) -> float:
    """The least time one card could take for ``shape``'s work: the
    larger of the useful FLOPs at the bf16 peak and the mandatory bytes
    at the memory rate."""
    return max(model_useful_flops(cfg, shape) / hw.peak_flops_bf16,
               model_mandatory_bytes(cfg, shape) / hw.hbm_bw)


def mfu(cfg: ModelConfig, shape: ShapeConfig, step_s: float,
        hw: HardwareSpec = H100) -> float:
    """Model FLOPs utilization of one card: useful FLOPs of a step over
    its time and the card's bf16 peak."""
    return model_useful_flops(cfg, shape) / step_s / hw.peak_flops_bf16
