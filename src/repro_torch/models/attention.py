"""Attention layer: QKV projection, qk-norm, RoPE, backend-pluggable core.

The attention *core* (score/softmax/value) is injected so the same layer
definition serves the full-sequence forward, dense prefill and the paged
decode (``repro_torch.models.prefill``). Backend names follow the JAX
package: ``"xla"`` is its chunked online-softmax core (here plain
PyTorch), ``"ref"`` the naive full-matrix reference, and ``"flash"`` the
port's counterpart of its ``"pallas"`` core: the hand-written
flash-prefill kernel behind ``kernels.ops.flash_prefill``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.online_softmax import (combine, empty_partial,
                                             finalize,
                                             micro_attention_prefill)
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, dense_init,
                                       rms_norm_headwise, row_parallel,
                                       torch_dtype, tp_split)


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, device,
                   lead=()):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg)
    p = {
        "wq": dense_init(gen, d, H * hd, dt, device=device, lead=lead),
        "wk": dense_init(gen, d, K * hd, dt, device=device, lead=lead),
        "wv": dense_init(gen, d, K * hd, dt, device=device, lead=lead),
        "wo": dense_init(gen, H * hd, d, dt, device=device, lead=lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(tuple(lead) + (hd,), device=device)
        p["k_norm"] = torch.ones(tuple(lead) + (hd,), device=device)
    return p


def qkv_project(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> q [B,T,H,hd], k/v [B,T,K,hd] with qk-norm + RoPE.
    Placed weights whose columns are split over the TP axis give this
    process's heads only (whole heads: q/norm/RoPE act head by head)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = (x @ params["wq"]).reshape(B, T, -1, hd)
    k = (x @ params["wk"]).reshape(B, T, -1, hd)
    v = (x @ params["wv"]).reshape(B, T, -1, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, params["q_norm"])
        k = rms_norm_headwise(k, params["k_norm"])
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# Attention core signature: (q[B,T,H,hd], k[B,S,K,hd], v[B,S,K,hd]) -> [B,T,H,hd]
AttnCore = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------- #
# Heads under tensor parallelism
# --------------------------------------------------------------------- #
def split_heads(t: torch.Tensor, split: bool, n_total: int, lo: int, n: int,
                tp) -> torch.Tensor:
    """Heads ``[lo, lo + n)`` of a projection ``t [..., heads, hd]``: of
    all ``n_total`` heads, or — its weight's columns split over the TP
    axis — of this process's own ``n_total / tp.count`` (gathered over
    the axis when others' are asked for)."""
    if not split:
        return t[..., lo:lo + n, :]
    own = t.shape[-2]
    if own * tp.count != n_total:
        raise NotImplementedError(f"{n_total} heads split over a TP axis of "
                                  f"{tp.count} cut inside a head")
    if (lo, n) == (tp.index * own, own):
        return t
    return tp.cat(t, -2)[..., lo:lo + n, :]


def kv_range(cfg: ModelConfig, h0: int, n: int):
    """(lo, hi, idx): the kv heads ``[lo, hi)`` query heads ``[h0, h0 +
    n)`` read under GQA, and None when each of them serves an equal run
    of those query heads (the attention's own grouping), else the index
    that expands them to one a query head."""
    if n == cfg.num_heads:
        return 0, cfg.num_kv_heads, None
    G = cfg.num_heads // cfg.num_kv_heads
    lo, hi = h0 // G, -(-(h0 + n) // G)
    idx = torch.arange(h0, h0 + n) // G - lo
    m = hi - lo
    if n % m == 0 and torch.equal(idx, torch.arange(m).repeat_interleave(
            n // m)):
        return lo, hi, None
    return lo, hi, idx


def expand_kv(kv: torch.Tensor, idx) -> torch.Tensor:
    """kv heads as ``kv_range`` gives them, expanded to one a query head
    where their grouping is not uniform (``idx``)."""
    return kv if idx is None else kv[..., idx.to(kv.device), :]


def query_heads(specs, cfg: ModelConfig, tp) -> Tuple[int, int]:
    """(h0, n): the query heads ``[h0, h0 + n)`` a process makes in an
    attention layer placed by ``specs`` (its own with ``wq``'s columns
    split over the TP axis, else all)."""
    if specs is not None and tp_split(specs["wq"], 1, tp):
        n = cfg.num_heads // tp.count
        return tp.index * n, n
    return 0, cfg.num_heads


def heads_qkv(params, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, specs=None, tp=None):
    """``qkv_project`` for this process's query heads: (q, k, v, h0, idx)
    with k/v the kv heads those read (``kv_range``; every head of a
    plain tree), ``h0`` the first query head and ``idx`` the expansion
    of ``expand_kv``."""
    q, k, v = qkv_project(params, x, positions, cfg)
    h0, n = query_heads(specs, cfg, tp)
    lo, hi, idx = kv_range(cfg, h0, n)
    sk = specs is not None and tp_split(specs["wk"], 1, tp)
    K = cfg.num_kv_heads
    return (q, split_heads(k, sk, K, lo, hi - lo, tp),
            split_heads(v, sk, K, lo, hi - lo, tp), h0, idx)


def heads_out(params, out: torch.Tensor, h0: int, cfg: ModelConfig, dtype,
              specs=None, tp=None) -> torch.Tensor:
    """The output projection of heads ``out [..., n, hd]`` (heads ``[h0,
    h0 + n)``): with ``wo``'s rows split over the TP axis, this
    process's own heads by its rows, summed over the axis; else every
    head by the whole ``wo``."""
    wo = params["wo"]
    split = specs is not None and tp_split(specs["wo"], 0, tp)
    if split:
        own = wo.shape[0] // cfg.head_dim
        lo = tp.index * own - h0
        out = out[..., lo:lo + own, :]
    return row_parallel(out.flatten(-2).to(dtype), wo, split, tp)


def apply_attention_train(params, x: torch.Tensor, positions: torch.Tensor,
                          cfg: ModelConfig, core: AttnCore, *, specs=None,
                          tp=None):
    """Full-sequence causal self-attention. Returns (out [B,T,d], (k, v)).
    Placed weights (``specs``, ``tp``): this process's query heads, the
    kv heads they read (the (k, v) returned) and ``wo``'s rows summed
    over the TP axis."""
    q, k, v, h0, idx = heads_qkv(params, x, positions, cfg, specs, tp)
    out = core(q, expand_kv(k, idx), expand_kv(v, idx))
    return heads_out(params, out, h0, cfg, x.dtype, specs, tp), (k, v)


def make_causal_core(cfg: ModelConfig, *, backend: str = "xla",
                     window: int = 0, chunk: int = 512) -> AttnCore:
    """Build the full-sequence causal attention core.

    backend "xla": chunked online softmax over KV chunks (memory-bounded);
    backend "ref": one full-matrix partial (tests/tiny shapes only);
    backend "flash": the flash-prefill kernel (its plain twin for CPU
    tensors). ``window`` > 0 makes every core local (sliding window).
    """
    scale = cfg.head_dim ** -0.5
    if backend == "flash":
        def flash_core(q, k, v):
            return ops.flash_prefill(q.contiguous(), k.contiguous(),
                                     v.contiguous(), scale=scale,
                                     window=window)
        return flash_core
    if backend not in ("xla", "ref"):
        hint = " (the port's kernel core is 'flash')" \
            if backend == "pallas" else ""
        raise ValueError(f"unknown attention backend {backend!r}{hint}")

    def core(q, k, v):
        B, T, H, hd = q.shape
        S = k.shape[1]
        dev = q.device
        q_pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
        step = S if backend == "ref" else chunk
        acc = empty_partial((B, T, H, hd), (B, T, H), device=dev)
        for s0 in range(0, max(S, 1), step):
            kv_pos = torch.arange(s0, s0 + step, dtype=torch.int32,
                                  device=dev)[None].expand(B, step)
            kc, vc = k[:, s0:s0 + step], v[:, s0:s0 + step]
            pad = step - kc.shape[1]
            if pad:
                kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
                vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
            part = micro_attention_prefill(q, kc, vc, q_pos, kv_pos,
                                           kv_pos < S, scale=scale,
                                           window=window)
            acc = combine(acc, part)
        return finalize(acc[0], acc[2]).to(q.dtype)

    return core
