"""Attention layer: QKV projection, qk-norm, RoPE, backend-pluggable core.

The attention *core* (score/softmax/value) is injected so the same layer
definition serves the full-sequence forward, dense prefill and the paged
decode (``repro_torch.models.prefill``). Backend names follow the JAX
package: ``"xla"`` is its chunked online-softmax core (here plain
PyTorch), ``"ref"`` the naive full-matrix reference.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.online_softmax import (combine, empty_partial,
                                             finalize,
                                             micro_attention_prefill)
from repro_torch.models.common import (apply_rope, dense_init,
                                       rms_norm_headwise, torch_dtype)


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
    """x: [B, T, d] -> q [B,T,H,hd], k/v [B,T,K,hd] with qk-norm + RoPE."""
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, T, H, hd)
    k = (x @ params["wk"]).reshape(B, T, K, hd)
    v = (x @ params["wv"]).reshape(B, T, K, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, params["q_norm"])
        k = rms_norm_headwise(k, params["k_norm"])
    if cfg.positional == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# Attention core signature: (q[B,T,H,hd], k[B,S,K,hd], v[B,S,K,hd]) -> [B,T,H,hd]
AttnCore = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def apply_attention_train(params, x: torch.Tensor, positions: torch.Tensor,
                          cfg: ModelConfig, core: AttnCore):
    """Full-sequence causal self-attention. Returns (out [B,T,d], (k, v))."""
    q, k, v = qkv_project(params, x, positions, cfg)
    out = core(q, k, v)
    B, T = x.shape[:2]
    out = out.reshape(B, T, -1).to(x.dtype) @ params["wo"]
    return out, (k, v)


def make_causal_core(cfg: ModelConfig, *, backend: str = "xla",
                     window: int = 0, chunk: int = 512) -> AttnCore:
    """Build the full-sequence causal attention core.

    backend "xla": chunked online softmax over KV chunks (memory-bounded);
    backend "ref": one full-matrix partial (tests/tiny shapes only);
    backend "pallas" (the JAX package's flash-prefill kernel) is not
    ported yet.
    """
    scale = cfg.head_dim ** -0.5
    if backend == "pallas":
        raise NotImplementedError(
            "the flash-prefill kernel (JAX kernels/flash_prefill.py) is "
            "not ported yet; it comes with a later slice of the port")
    if backend not in ("xla", "ref"):
        raise ValueError(f"unknown attention backend {backend!r}")

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
