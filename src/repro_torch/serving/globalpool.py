"""One cluster-wide KV pool tensor: the paper's distributed KVCache.

``GlobalKVPool`` folds the per-instance ``pool_k/pool_v`` tensors into
ONE pair of tensors ``k/v: [ranks, L, NB, bs, K, hd]`` on one device.
Rank ``i``'s slice ``k[i]`` plays exactly the role engine ``i``'s private
pool plays — same block ids, same tables — but every cross-rank KV
access is a slice of one tensor:

  * a creditor READ during decode/prefill is one rank-form kernel launch
    per layer over every rank's slab (``sharded_step.decode_step_global``)
    whose per-rank partials LSE-merge (paper Eq. 3) — the KV never moves;
  * a ``StripedMove`` leg and a streaming-prefill creditor write are
    row copies inside the tensor (``copy_blocks``, ``scatter_rows``);
  * allocator state stays HOST metadata: ``ranks[i]`` is the same
    ``RankKVPool`` (block allocator + per-request chains) each engine's
    ``RManager`` would otherwise own privately — engines in global-pool
    mode alias these, so the cluster and the global step share one
    layout and allocator view.

In-place discipline: every updater writes the tensors in place
(``index_copy_``/``index_put_`` into a rank's view), the counterpart of
the JAX package's buffer donation, so ``k.data_ptr()`` never changes;
``CommStats.pool_copy_steps`` checks it. No mesh in this port yet: the
rank axis lives on one card (the multi-device half is a later slice).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import POOLED_FAMILIES, require_family
from repro_torch.serving.kvpool import (RankKVPool, read_pool_rows,
                                        scatter_pool_rows, write_pool_rows)


class GlobalKVPool:
    """The cluster-wide pool tensors + the per-rank allocator views."""

    def __init__(self, n_ranks: int, num_blocks: int, block_size: int,
                 cfg: ModelConfig, *, device):
        require_family(cfg, POOLED_FAMILIES)
        self.n_ranks = n_ranks
        self.num_blocks = num_blocks
        self.block_size = block_size
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        shape = (n_ranks, L, num_blocks, block_size, K, hd)
        self.k = torch.zeros(shape, dtype=torch_dtype(cfg), device=device)
        self.v = torch.zeros_like(self.k)
        # THE shared allocator view: engine i's RManager aliases ranks[i].
        self.ranks: List[RankKVPool] = [RankKVPool(num_blocks, block_size)
                                        for _ in range(n_ranks)]

    def write_blocks(self, rank: int, block_ids: Sequence[int],
                     k_rows, v_rows) -> None:
        """Fill whole blocks of one rank from [L, n, K, hd] token rows
        (n <= len(block_ids) * bs; a partial final block zero-pads)."""
        write_pool_rows(self.k[rank], block_ids, k_rows, self.block_size)
        write_pool_rows(self.v[rank], block_ids, v_rows, self.block_size)

    def scatter_rows(self, rank: int, block_ids, offsets, k, v) -> None:
        """Row-addressed scatter into one rank's blocks (may land
        mid-block). k/v: [L, n, K, hd]."""
        scatter_pool_rows(self.k[rank], block_ids, offsets, k)
        scatter_pool_rows(self.v[rank], block_ids, offsets, v)

    def read_blocks(self, rank: int, block_ids: Sequence[int]):
        """Whole blocks of one rank as ([L, nb*bs, K, hd], same) — a
        gather, safe to hold after the frames are freed."""
        return (read_pool_rows(self.k[rank], block_ids, self.block_size),
                read_pool_rows(self.v[rank], block_ids, self.block_size))

    def copy_blocks(self, src_rank: int, src_blocks: Sequence[int],
                    dst_rank: int, dst_blocks: Sequence[int]) -> None:
        """One StripedMove leg: block i of ``src_blocks`` lands in block
        i of ``dst_blocks`` — a copy inside the tensor, no host trip."""
        k, v = self.read_blocks(src_rank, src_blocks)
        self.write_blocks(dst_rank, dst_blocks, k, v)


__all__ = ["GlobalKVPool"]
