"""Online-softmax partials and the DistAttention merge (paper Eq. 1-3).

A *partial* is the triple ``(o, m, l)`` over some slice of the sequence:

    m = max_i s_i                      (running max of attention scores)
    l = sum_i exp(s_i - m)             (paper's e_j)
    o = sum_i exp(s_i - m) * v_i       (paper's MA_j, unnormalized)

Partials form a commutative monoid under ``combine`` — the identity is
``(0, -inf, 0)`` — which is what lets DistAttention evaluate attention over
arbitrary sub-blocks of the KVCache placed on arbitrary instances and merge
with only per-head scalars + one value-vector of traffic (paper Fig. 4b).

Precision follows the JAX reference: q and the probabilities are cast to
the KV storage dtype before each product, and every product accumulates
in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (o, m, l)

NEG_INF = float("-inf")


def empty_partial(out_shape, stat_shape, *, device,
                  dtype=torch.float32) -> Partial:
    """Identity element: contributes nothing to the merge."""
    return (torch.zeros(out_shape, dtype=dtype, device=device),
            torch.full(stat_shape, NEG_INF, dtype=dtype, device=device),
            torch.zeros(stat_shape, dtype=dtype, device=device))


def _safe_scale(m: torch.Tensor, m_new: torch.Tensor) -> torch.Tensor:
    """exp(m - m_new), defined as 0 when both are -inf (empty slices)."""
    scale = torch.exp(m - m_new)
    return torch.where(torch.isneginf(m), torch.zeros_like(scale), scale)


def combine(a: Partial, b: Partial) -> Partial:
    """Associative+commutative merge of two partials (paper Eq. 3, pairwise)."""
    o_a, m_a, l_a = a
    o_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    sa = _safe_scale(m_a, m)
    sb = _safe_scale(m_b, m)
    l = l_a * sa + l_b * sb
    o = o_a * sa[..., None] + o_b * sb[..., None]
    return o, m, l


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   axis: int = 0) -> Partial:
    """Merge a stacked set of partials along ``axis`` (paper Eq. 3).

    o: [..., P, ..., D] stacked unnormalized outputs, m/l: stats without D.
    Returns a single (o, m, l).
    """
    m_g = torch.amax(m, dim=axis)
    scale = _safe_scale(m, m_g.unsqueeze(axis))
    l_g = torch.sum(l * scale, dim=axis)
    o_g = torch.sum(o * scale[..., None], dim=axis)
    return o_g, m_g, l_g


def finalize(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Normalize a merged partial into the attention output.

    Empty attention (l == 0, e.g. fully-masked slice) yields zeros rather
    than NaN so padded requests stay inert.
    """
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return o / denom[..., None]


def _masked_softmax_parts(s: torch.Tensor, ok: torch.Tensor):
    """(m, p, l) of scores ``s`` under the boolean mask ``ok``."""
    s = s.masked_fill(~ok, NEG_INF)
    m = torch.amax(s, dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None]).masked_fill(~ok, 0.0)
    return m, p, torch.sum(p, dim=-1)


def micro_attention_decode(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mask: torch.Tensor, *,
                           scale: float | None = None) -> Partial:
    """MicroAttention for one decode step over a slice of KV (paper Eq. 2).

    q [B,H,D], k/v [B,S,K,D], mask [B,S] bool (True where the slot is
    valid). Supports MHA/GQA/MQA: H query heads grouped over K kv heads.
    Returns (o [B,H,D] f32 unnormalized, m [B,H] f32, l [B,H] f32).
    """
    B, H, D = q.shape
    K = k.shape[2]
    G = H // K
    if scale is None:
        scale = D ** -0.5
    qc = q.to(k.dtype).float().reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qc, k.float()) * scale
    ok = mask[:, None, None, :]
    m, p, l = _masked_softmax_parts(s, ok)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(k.dtype).float(), v.float())
    return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def micro_attention_prefill(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_pos: torch.Tensor,
                            kv_pos: torch.Tensor, kv_valid: torch.Tensor,
                            *, scale: float | None = None,
                            window: int = 0) -> Partial:
    """Causal MicroAttention over a KV slice for a block of queries.

    q [B,T,H,D] at absolute positions q_pos [B,T]; k/v [B,S,K,D] at
    kv_pos [B,S] with validity kv_valid [B,S]. ``window`` > 0 restricts
    each query to the last ``window`` positions (local attention).
    Returns (o [B,T,H,D], m [B,T,H], l [B,T,H]) in f32, mergeable across
    KV slices with ``merge_partials``/``combine``.
    """
    B, T, H, D = q.shape
    K = k.shape[2]
    G = H // K
    if scale is None:
        scale = D ** -0.5
    qc = q.to(k.dtype).float().reshape(B, T, K, G, D)
    s = torch.einsum("btkgd,bskd->btkgs", qc, k.float()) * scale
    ok = (kv_pos[:, None, :] <= q_pos[:, :, None]) & kv_valid[:, None, :]
    if window:
        ok = ok & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    m, p, l = _masked_softmax_parts(s, ok[:, :, None, None, :])
    o = torch.einsum("btkgs,bskd->btkgd", p.to(k.dtype).float(), v.float())
    return (o.reshape(B, T, H, D), m.reshape(B, T, H), l.reshape(B, T, H))
