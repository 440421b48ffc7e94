"""Reference attention over a whole (possibly windowed) KV, single device.

``full_attention_decode`` and ``full_attention_prefill`` are one
MicroAttention partial over all of the KV, finalized — the dense
oracle's attention (paper Eq. 1). ``sliding_window_mask_decode`` is the
local-attention validity mask of a decode step (the hybrid family's
attention layers).
"""
from __future__ import annotations

import torch

from repro_torch.core.online_softmax import (finalize,
                                             micro_attention_decode,
                                             micro_attention_prefill)


def full_attention_decode(q, k, v, mask, *, scale=None) -> torch.Tensor:
    """Single-shot decode attention. q [B,H,D], k/v [B,S,K,D], mask
    [B,S] -> [B,H,D] in q's dtype."""
    o, _, l = micro_attention_decode(q, k, v, mask, scale=scale)
    return finalize(o, l).to(q.dtype)


def full_attention_prefill(q, k, v, *, q_offset=0, kv_valid=None,
                           scale=None, window=0) -> torch.Tensor:
    """Causal prefill attention. q [B,T,H,D], k/v [B,S,K,D] -> [B,T,H,D].

    ``q_offset`` positions the queries at [offset, offset+T) against KV
    at [0, S) (chunked prefill, where the KV includes the past);
    ``window`` > 0 limits each query to the last ``window`` positions.
    """
    B, T = q.shape[:2]
    S = k.shape[1]
    dev = q.device
    q_pos = (q_offset + torch.arange(T, device=dev))[None].expand(B, T)
    kv_pos = torch.arange(S, device=dev)[None].expand(B, S)
    if kv_valid is None:
        kv_valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    o, _, l = micro_attention_prefill(q, k, v, q_pos, kv_pos, kv_valid,
                                      scale=scale, window=window)
    return finalize(o, l).to(q.dtype)


def sliding_window_mask_decode(kv_pos, cur_pos, window) -> torch.Tensor:
    """Valid-mask for local attention at decode: the last ``window``
    positions up to and including ``cur_pos``. kv_pos [B,S], cur_pos
    [B] -> [B,S] bool."""
    return (kv_pos > cur_pos[:, None] - window) & (kv_pos <= cur_pos[:, None])
