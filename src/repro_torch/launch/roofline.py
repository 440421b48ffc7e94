"""Roofline model of a config: useful FLOPs and mandatory bytes.

The half of the JAX package's ``repro.launch.roofline`` that reads only
a ``ModelConfig`` and a ``ShapeConfig``: ``model_useful_flops`` and
``model_mandatory_bytes``, the same formulas, here held against the
H100's data-sheet peaks (``distributed.hardware.H100``), and the
analytic fields of its ``RooflineReport`` with ``report_row`` /
``REPORT_HEADER`` for ``launch.dryrun``'s planned cells. Its other half
parses XLA's compiled HLO (collective bytes, per-device FLOPs and bytes
from ``cost_analysis``) and has no PyTorch counterpart: a report here
has no ``flops_per_device``, ``bytes_per_device`` or collective
breakdown, and its compute and memory terms are the ideal ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

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


@dataclass
class RooflineReport:
    """One planned cell: the analytic fields of the JAX package's
    ``RooflineReport`` plus what the port plans without a compiler —
    the bytes one process holds (``memory_breakdown``: parameters,
    optimizer state, KV pool or decode state, inputs, the prefill's
    output pool; no temporaries) and whether they fit the card."""
    arch: str
    shape: str
    mesh: str
    chips: int
    model_flops: float                  # 6ND train / 2ND serve (useful)
    model_bytes: float                  # mandatory traffic (global)
    peak_memory_per_device: float = 0.0
    memory_breakdown: Dict[str, int] = field(default_factory=dict)
    hw: str = H100.name
    t_compute: float = 0.0              # useful FLOPs at the bf16 peak
    t_memory: float = 0.0               # mandatory bytes at the HBM rate
    ideal_step_s: float = 0.0
    bottleneck: str = ""
    fits: bool = False

    def finalize(self, hw: HardwareSpec = H100):
        """Fill the ideal terms, the bottleneck and the fit on ``hw``."""
        self.hw = hw.name
        self.t_compute = self.model_flops / (self.chips * hw.peak_flops_bf16)
        self.t_memory = self.model_bytes / (self.chips * hw.hbm_bw)
        self.ideal_step_s = max(self.t_compute, self.t_memory)
        self.bottleneck = ("compute" if self.t_compute >= self.t_memory
                           else "memory")
        self.fits = self.peak_memory_per_device <= hw.hbm_bytes
        return self


def report_row(r: RooflineReport) -> str:
    """One CSV row of ``REPORT_HEADER``'s columns."""
    return (f"{r.arch},{r.shape},{r.mesh},{r.chips},"
            f"{r.model_flops:.3e},{r.model_bytes:.3e},"
            f"{r.t_compute:.3e},{r.t_memory:.3e},{r.ideal_step_s:.3e},"
            f"{r.bottleneck},{r.peak_memory_per_device:.3e},"
            f"{int(r.fits)}")


REPORT_HEADER = ("arch,shape,mesh,chips,model_flops,model_bytes,"
                 "t_compute,t_memory,ideal_step_s,bottleneck,"
                 "peak_mem_dev,fits")
