"""Paged-pool helpers of DistAttention: gather a rank's KV and mask it.

Every rank computes a MicroAttention partial over whatever KV blocks it
locally holds (possibly none — empty partials are the monoid identity and
merge away); the per-rank partials are LSE-merged (paper Eq. 2-3).
``distattn_decode_paged`` merges the partials of the ranks this process
holds and, given a process ``group``, merges the result across the
group's processes (``merge_over_axes``: one all-reduce MAX and two SUMs,
the query's scalars and one value vector of traffic, never the KV).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.online_softmax import (combine, empty_partial,
                                             finalize,
                                             merge_partials_collective)


def merge_over_axes(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                    group) -> torch.Tensor:
    """Collective LSE-merge of per-process partials (paper Eq. 3) over
    ``group``; returns the NORMALIZED output. Traffic: MAX(m) + SUM(l')
    + SUM(o') = (2 * |m| + |o|) elements."""
    o_g, _, l_g = merge_partials_collective(o, m, l, group)
    return finalize(o_g, l_g)


def gather_local_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                    local_table: torch.Tensor):
    """Materialize [B, S_local, K, D] KV from a paged pool.

    pool_k/pool_v: [num_blocks_local, block_size, K, D] — this rank's pool.
    local_table:   [B, max_local_blocks] int32 — local block ids, -1 = none.

    Invalid entries gather block 0 and are masked by the caller via
    ``local_mask_from_table``.
    """
    nb, bs, K, D = pool_k.shape
    safe = torch.clamp(local_table, min=0).long()
    k = pool_k[safe].reshape(local_table.shape[0], -1, K, D)
    v = pool_v[safe].reshape(local_table.shape[0], -1, K, D)
    return k, v


def local_mask_from_table(local_table: torch.Tensor, block_size: int,
                          last_block_len: torch.Tensor | None = None):
    """[B, max_local_blocks*block_size] bool validity mask for gathered KV.

    ``last_block_len``: optional [B] — number of valid tokens in each
    request's final (partially filled) block; the fill block id must be
    the last valid entry of the row (tables are prefix-contiguous).
    """
    B, MB = local_table.shape
    valid_block = local_table >= 0
    mask = valid_block.repeat_interleave(block_size, dim=1)
    if last_block_len is not None:
        dev = local_table.device
        within = torch.arange(block_size, device=dev).repeat(MB)[None, :]
        n_valid = valid_block.sum(dim=1)                        # [B]
        block_idx = torch.arange(MB, device=dev).repeat_interleave(
            block_size)[None, :]
        is_last = block_idx == (n_valid - 1)[:, None]
        mask = mask & torch.where(is_last,
                                  within < last_block_len[:, None], True)
    return mask


def distattn_decode_paged(
    q: torch.Tensor,
    rank_pools: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    tables: torch.Tensor,
    tails: torch.Tensor,
    *,
    scale: float | None = None,
    group=None,
) -> torch.Tensor:
    """Paged DistAttention decode for one layer over several ranks' pools.

    q [B,H,D]; rank_pools: ((pool_k, pool_v) [NB_p, bs, K, D]) per rank
    held by this process (possibly none); tables [P, B, MB] -1-padded;
    tails [P, B]. Each rank's MicroAttention partial (the paged kernel on
    the card, its plain version on the CPU) is LSE-merged, then across
    ``group``'s processes when one is given (the JAX package's
    ``shard_map`` body); returns the normalized output in q's dtype.
    """
    from repro_torch.kernels.ops import paged_micro_attention
    B, H, D = q.shape
    part = empty_partial((B, H, D), (B, H), device=q.device)
    for p, (pk, pv) in enumerate(rank_pools):
        part = combine(part, paged_micro_attention(q, pk, pv, tables[p],
                                                   tails[p], scale=scale))
    if group is not None:
        part = merge_partials_collective(*part, group)
    return finalize(part[0], part[2]).to(q.dtype)
