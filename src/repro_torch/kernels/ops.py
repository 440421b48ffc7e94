"""Dispatching wrappers of the port's attention kernels.

``paged_micro_attention`` (decode) and ``paged_prefill_attention``
(prefill chunk) keep the JAX package's signatures and ``(o, m, l)``
float32 outputs, and so do their rank forms over a stack of rank pools,
``paged_micro_attention_ranks`` and ``paged_prefill_attention_ranks``
(ONE launch of a rank kernel over every rank, where the JAX package
vmaps the Pallas kernel: stacked partials, one a rank). The merged rank
forms, ``paged_micro_attention_ranks_merged`` and
``paged_prefill_attention_ranks_merged`` (the global pool's path), give
what ``merge_partials(axis=0)`` of the stacked forms gives, the ranks
merged in the same launch. ``flash_prefill`` (causal, optionally
sliding-window, whole-prompt attention) keeps its signature and returns
the normalized output in q's dtype. All seven dispatch on the device of
``q``: a CUDA
tensor launches the hand-written kernel — or raises, never falling back
— and a CPU tensor runs the kernel's plain PyTorch twin. The TPU-only
wrapper work of the reference (padding D to 128 lanes and S to the tile,
the kv-head-major query layout) has no counterpart: the CUDA kernels
index heads and rows and mask the ragged end themselves. ``scale``
defaults to ``true_head_dim ** -0.5``.

Precision. The paged kernels return what their float32 plain twins
return, within 1e-4, in both storage dtypes. They cut each request's
valid tokens into units over several blocks (the rank forms: over
every rank) and LSE-merge the parts in float32. float32 decode computes
on the CUDA cores; bf16 decode and the bf16 prefill chunk (both forms)
run on the tensor cores: q K^T products of bf16 values
are exact in float32, each float32 probability p enters P V as two bf16
halves ``hi = bf16(p)`` and ``lo = bf16(p - hi)`` (one rounding of p
would exceed 1e-4 over a few thousand keys), and ``l`` is summed from
the float32 p. The float32 prefill chunk (both forms) and float32
flash prefill run
on the tf32 tensor cores in 3xTF32: each operand x as hi (its raw
value, whose low 13 bits the tensor cores ignore) and ``lo = x -
trunc_tf32(x)``, each product as hi hi + hi lo + lo hi (one tf32 product
would miss 1e-4), ``l`` from the float32 p. Flash prefill
with bf16 inputs returns what its float32 plain twin returns within
1e-4 plus one bf16 ulp of the output (both are rounded to bf16); with
float32 inputs within 1e-4.

Each kernel carries plain integer launch counters on its launcher
(``*_cuda``): ``launches``, incremented right after a successful launch
and nowhere else, and ``float32_launches``, the launches with float32
inputs among them; each wrapper counts its dispatches to the plain twin
in ``plain_calls``. ``reset_counts`` and ``counts`` clear and read them,
so a run can show which path served it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels.micro_attn_decode import (
    paged_micro_attention_cuda, paged_micro_attention_plain,
    paged_micro_attention_ranks_cuda,
    paged_micro_attention_ranks_merged_cuda,
    paged_micro_attention_ranks_merged_plain,
    paged_micro_attention_ranks_plain)
from repro_torch.kernels.micro_attn_prefill import (
    paged_prefill_attention_cuda, paged_prefill_attention_plain,
    paged_prefill_attention_ranks_cuda,
    paged_prefill_attention_ranks_merged_cuda,
    paged_prefill_attention_ranks_merged_plain,
    paged_prefill_attention_ranks_plain)


def _route(q: torch.Tensor) -> str:
    if q.device.type == "cuda":
        return "cuda"
    if q.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no attention kernel path for device {q.device}")


def paged_micro_attention(q, pool_k, pool_v, table, tail_len, *,
                          scale=None):
    """Paged DistAttention MicroAttention partial (decode).

    q [R,H,D]; pool_k/v [NB,bs,K,D]; table [R,MB] (-1 padded, seq order);
    tail_len [R] valid tokens in each request's LAST local slot.
    Returns (o [R,H,D] f32 unnormalized, m [R,H] f32, l [R,H] f32).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return paged_micro_attention_cuda(q, pool_k, pool_v, table,
                                          tail_len, scale=scale)
    paged_micro_attention.plain_calls += 1
    return paged_micro_attention_plain(q, pool_k, pool_v, table, tail_len,
                                       scale=scale)


def paged_prefill_attention(q, pool_k, pool_v, table, tail_len, *,
                            scale=None):
    """Paged DistAttention MicroAttention partial (prefill chunk).

    q [C,H,D] — chunk query rows, all positioned AFTER the addressed
    prefix; pool_k/v [NB,bs,K,D]; table [MB] (-1 padded, seq order)
    shared by every query; tail_len [] valid tokens in the prefix's final
    block. Returns (o [C,H,D] f32 unnormalized, m [C,H] f32, l [C,H] f32)
    — LSE-mergeable with the chunk-internal causal partial.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return paged_prefill_attention_cuda(q, pool_k, pool_v, table,
                                            tail_len, scale=scale)
    paged_prefill_attention.plain_calls += 1
    return paged_prefill_attention_plain(q, pool_k, pool_v, table,
                                         tail_len, scale=scale)


def paged_micro_attention_ranks(q, pools_k, pools_v, tables, tails, *,
                                scale=None):
    """Decode MicroAttention partials over a stack of rank pools.

    q [R,H,D] shared by every rank; pools_k/v [NR,NB,bs,K,D] (a strided
    view is fine: each rank's slab must be contiguous); tables
    [NR,R,MB]; tails [NR,R]. Returns stacked partials (o [NR,R,H,D],
    m [NR,R,H], l [NR,R,H]) — merge with ``merge_partials(axis=0)``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return paged_micro_attention_ranks_cuda(q, pools_k, pools_v, tables,
                                                tails, scale=scale)
    paged_micro_attention_ranks.plain_calls += 1
    return paged_micro_attention_ranks_plain(q, pools_k, pools_v, tables,
                                             tails, scale=scale)


def paged_prefill_attention_ranks(q, pools_k, pools_v, tables, tails, *,
                                  scale=None):
    """Prefill-chunk MicroAttention partials over a stack of rank pools.

    q [C,H,D] chunk queries shared by every rank; pools_k/v
    [NR,NB,bs,K,D]; tables [NR,MB]; tails [NR]. Returns stacked partials
    (o [NR,C,H,D], m [NR,C,H], l [NR,C,H]).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return paged_prefill_attention_ranks_cuda(q, pools_k, pools_v,
                                                  tables, tails, scale=scale)
    paged_prefill_attention_ranks.plain_calls += 1
    return paged_prefill_attention_ranks_plain(q, pools_k, pools_v, tables,
                                               tails, scale=scale)


def paged_micro_attention_ranks_merged(q, pools_k, pools_v, tables, tails,
                                       *, scale=None):
    """Decode MicroAttention over a stack of rank pools, the ranks merged.

    Inputs as ``paged_micro_attention_ranks``. Returns what
    ``merge_partials(*paged_micro_attention_ranks(...), axis=0)`` does:
    (o [R,H,D], m [R,H], l [R,H]) float32, (0, -inf, 0) for a request
    with no valid token on any rank.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return paged_micro_attention_ranks_merged_cuda(
            q, pools_k, pools_v, tables, tails, scale=scale)
    paged_micro_attention_ranks_merged.plain_calls += 1
    return paged_micro_attention_ranks_merged_plain(
        q, pools_k, pools_v, tables, tails, scale=scale)


def paged_prefill_attention_ranks_merged(q, pools_k, pools_v, tables,
                                         tails, *, scale=None):
    """Prefill-chunk MicroAttention over a stack of rank pools, the ranks
    merged.

    Inputs as ``paged_prefill_attention_ranks``. Returns what
    ``merge_partials(*paged_prefill_attention_ranks(...), axis=0)`` does:
    (o [C,H,D], m [C,H], l [C,H]) float32.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return paged_prefill_attention_ranks_merged_cuda(
            q, pools_k, pools_v, tables, tails, scale=scale)
    paged_prefill_attention_ranks_merged.plain_calls += 1
    return paged_prefill_attention_ranks_merged_plain(
        q, pools_k, pools_v, tables, tails, scale=scale)


def flash_prefill(q, k, v, *, scale=None, window=0):
    """Causal flash attention, optionally sliding-window (local layers).

    q [B,S,H,D]; k/v [B,S,K,D] -> [B,S,H,D] in q's dtype. ``window`` > 0
    keeps, for query position qp, the keys kp with qp - window < kp <= qp.
    """
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return flash_prefill_cuda(q, k, v, scale=scale, window=window)
    flash_prefill.plain_calls += 1
    return flash_prefill_plain(q, k, v, scale=scale, window=window)


# wrapper name -> (wrapper, its kernel's launcher)
WRAPPERS = {
    "paged_micro_attention": (paged_micro_attention,
                              paged_micro_attention_cuda),
    "paged_prefill_attention": (paged_prefill_attention,
                                paged_prefill_attention_cuda),
    "paged_micro_attention_ranks": (paged_micro_attention_ranks,
                                    paged_micro_attention_ranks_cuda),
    "paged_prefill_attention_ranks": (paged_prefill_attention_ranks,
                                      paged_prefill_attention_ranks_cuda),
    "paged_micro_attention_ranks_merged": (
        paged_micro_attention_ranks_merged,
        paged_micro_attention_ranks_merged_cuda),
    "paged_prefill_attention_ranks_merged": (
        paged_prefill_attention_ranks_merged,
        paged_prefill_attention_ranks_merged_cuda),
    "flash_prefill": (flash_prefill, flash_prefill_cuda),
}


def reset_counts() -> None:
    """Set every kernel's launch counters and wrapper's ``plain_calls``
    to 0."""
    for wrapper, launcher in WRAPPERS.values():
        launcher.launches = 0
        launcher.float32_launches = 0
        wrapper.plain_calls = 0


def counts() -> Dict[str, Dict[str, int]]:
    """``{wrapper: {"launches": n, "plain_calls": n, "float32_launches":
    n}}``, the last the float32 launches among ``launches``."""
    return {name: {"launches": launcher.launches,
                   "plain_calls": wrapper.plain_calls,
                   "float32_launches": launcher.float32_launches}
            for name, (wrapper, launcher) in WRAPPERS.items()}


reset_counts()
