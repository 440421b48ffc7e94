"""Attention over a whole KV, and DistAttention over a partition of it.

``full_attention_decode`` and ``full_attention_prefill`` are one
MicroAttention partial over all of the KV, finalized — the dense
oracle's attention (paper Eq. 1). ``dist_attention_decode`` and
``dist_attention_prefill`` evaluate the same attention over an
arbitrary partition of the KV sequence (the paper's MA blocks,
conceptually on different instances, §4) and merge the partials (Eq.
3) — equal to the full attention over the concatenated KV. The
mesh-parallel merge is ``core.online_softmax.merge_partials_collective``;
the paged kernels are in ``repro_torch.kernels``.
``sliding_window_mask_decode`` is the local-attention validity mask of
a decode step (the hybrid family's attention layers).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.online_softmax import (combine, empty_partial,
                                             finalize,
                                             micro_attention_decode,
                                             micro_attention_prefill)


def full_attention_decode(q, k, v, mask, *, scale=None) -> torch.Tensor:
    """Single-shot decode attention. q [B,H,D], k/v [B,S,K,D], mask
    [B,S] -> [B,H,D] in q's dtype."""
    o, _, l = micro_attention_decode(q, k, v, mask, scale=scale)
    return finalize(o, l).to(q.dtype)


def dist_attention_decode(
        q: torch.Tensor,
        kv_parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
        *, scale=None) -> torch.Tensor:
    """Decode attention over a sequence partition of the KV. q [B,H,D];
    ``kv_parts``: (k [B,S_i,K,D], v, mask [B,S_i]) slices in any order.
    Equal to ``full_attention_decode`` over the concatenated KV."""
    B, H, D = q.shape
    acc = empty_partial((B, H, D), (B, H), device=q.device)
    for k, v, mask in kv_parts:
        acc = combine(acc, micro_attention_decode(q, k, v, mask, scale=scale))
    return finalize(acc[0], acc[2]).to(q.dtype)


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


def dist_attention_prefill(
        q: torch.Tensor,
        kv_parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]],
        q_pos: torch.Tensor, *, scale=None) -> torch.Tensor:
    """Causal prefill over a partition of KV slices. q [B,T,H,D]; q_pos
    [B,T]; ``kv_parts``: (k [B,S_i,K,D], v, kv_pos [B,S_i], kv_valid
    [B,S_i]) — absolute positions, so a slice may hold any part of the
    sequence, in any order."""
    B, T, H, D = q.shape
    acc = empty_partial((B, T, H, D), (B, T, H), device=q.device)
    for k, v, kv_pos, kv_valid in kv_parts:
        acc = combine(acc, micro_attention_prefill(q, k, v, q_pos, kv_pos,
                                                   kv_valid, scale=scale))
    return finalize(acc[0], acc[2]).to(q.dtype)


def sliding_window_mask_decode(kv_pos, cur_pos, window) -> torch.Tensor:
    """Valid-mask for local attention at decode: the last ``window``
    positions up to and including ``cur_pos``. kv_pos [B,S], cur_pos
    [B] -> [B,S] bool."""
    return (kv_pos > cur_pos[:, None] - window) & (kv_pos <= cur_pos[:, None])
