"""One cluster-wide KV pool tensor: the paper's distributed KVCache.

``GlobalKVPool`` folds the per-instance ``pool_k/pool_v`` tensors into
ONE pair of tensors ``k/v: [ranks, L, NB, bs, K, hd]`` on one device
(or sharded over processes: see below).
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
``CommStats.pool_copy_steps`` checks it.

With a ``mesh`` (``distributed.mesh``; JAX: ``NamedSharding(mesh,
P(pool_axes))``) the rank axis is sharded over the processes of
``pool_axes``: this process allocates only its slab ``k/v: [NR/shards,
L, NB, bs, K, hd]`` of ranks ``[rank_base, rank_base + n_local)``, while
the ``ranks`` allocator views stay global host metadata, equal in every
process (replicated control). A write lands on the owner only; a block
read runs on the owner and is broadcast from its process to the pool
group, which every process of the group joins in the same order; a
``StripedMove`` leg between two shards is such a read and a write on the
destination's owner (the remote DMA GSPMD would emit), a leg inside one
shard stays an in-tensor copy. ``traffic`` counts the broadcasts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import pool_shards
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import POOLED_FAMILIES, require_family
from repro_torch.serving.kvpool import (RankKVPool, read_pool_rows,
                                        scatter_pool_rows, write_pool_rows)


@dataclass
class MeshTraffic:
    """Block traffic between the processes of a sharded pool."""
    broadcasts: int = 0        # block reads broadcast from their owner
    broadcast_bytes: int = 0   # K and V bytes of those reads
    remote_copies: int = 0     # StripedMove legs between two shards
    local_copies: int = 0      # legs inside one shard (no collective)


class GlobalKVPool:
    """The cluster-wide pool tensors (or this process's slab of them) +
    the per-rank allocator views."""

    def __init__(self, n_ranks: int, num_blocks: int, block_size: int,
                 cfg: ModelConfig, *, device, mesh=None,
                 pool_axes: Tuple[str, ...] = ("data",)):
        require_family(cfg, POOLED_FAMILIES)
        self.n_ranks = n_ranks
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.mesh = mesh
        self.pool_axes = tuple(pool_axes)
        self.shards = (pool_shards(mesh, self.pool_axes)
                       if mesh is not None else None)
        self.n_local = (self.shards.local_ranks(n_ranks)
                        if self.shards is not None else n_ranks)
        self.rank_base = (self.shards.index * self.n_local
                          if self.shards is not None else 0)
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        shape = (self.n_local, L, num_blocks, block_size, K, hd)
        self.k = torch.zeros(shape, dtype=torch_dtype(cfg), device=device)
        self.v = torch.zeros_like(self.k)
        self.traffic = MeshTraffic()
        # THE shared allocator view: engine i's RManager aliases ranks[i].
        self.ranks: List[RankKVPool] = [RankKVPool(num_blocks, block_size)
                                        for _ in range(n_ranks)]

    def is_local(self, rank: int) -> bool:
        """True when this process holds rank ``rank``'s slab."""
        return self.rank_base <= rank < self.rank_base + self.n_local

    def _shard(self, rank: int) -> int:
        return rank // self.n_local

    def write_blocks(self, rank: int, block_ids: Sequence[int],
                     k_rows, v_rows) -> None:
        """Fill whole blocks of one rank from [L, n, K, hd] token rows
        (n <= len(block_ids) * bs; a partial final block zero-pads). Only
        the rank's owner writes."""
        if not self.is_local(rank):
            return
        r = rank - self.rank_base
        write_pool_rows(self.k[r], block_ids, k_rows, self.block_size)
        write_pool_rows(self.v[r], block_ids, v_rows, self.block_size)

    def scatter_rows(self, rank: int, block_ids, offsets, k, v) -> None:
        """Row-addressed scatter into one rank's blocks (may land
        mid-block). k/v: [L, n, K, hd]. Only the rank's owner writes."""
        if not self.is_local(rank):
            return
        r = rank - self.rank_base
        scatter_pool_rows(self.k[r], block_ids, offsets, k)
        scatter_pool_rows(self.v[r], block_ids, offsets, v)

    def _read_local(self, rank: int, block_ids: Sequence[int]):
        r = rank - self.rank_base
        return (read_pool_rows(self.k[r], block_ids, self.block_size),
                read_pool_rows(self.v[r], block_ids, self.block_size))

    def read_blocks(self, rank: int, block_ids: Sequence[int]):
        """Whole blocks of one rank as ([L, nb*bs, K, hd], same) — a
        gather, safe to hold after the frames are freed. Under a mesh
        the owner reads and broadcasts to its pool group: a collective
        that every process of the group must call, in the same order."""
        if self.shards is None:
            return self._read_local(rank, block_ids)
        if self.is_local(rank):
            kv = torch.stack(self._read_local(rank, block_ids))
        else:
            L, _, _, K, hd = self.k.shape[1:]
            kv = torch.empty((2, L, len(block_ids) * self.block_size, K, hd),
                             dtype=self.k.dtype, device=self.k.device)
        dist.broadcast(kv, src=self.shards.owner(rank, self.n_local),
                       group=self.shards.group)
        self.traffic.broadcasts += 1
        self.traffic.broadcast_bytes += kv.numel() * kv.element_size()
        return kv[0], kv[1]

    def copy_blocks(self, src_rank: int, src_blocks: Sequence[int],
                    dst_rank: int, dst_blocks: Sequence[int]) -> None:
        """One StripedMove leg: block i of ``src_blocks`` lands in block
        i of ``dst_blocks`` — a copy inside the tensor, no host trip.
        Between two shards of a mesh: a broadcast read, then the
        destination owner's write."""
        if self.shards is not None:
            if self._shard(src_rank) != self._shard(dst_rank):
                self.traffic.remote_copies += 1
                k, v = self.read_blocks(src_rank, src_blocks)
                self.write_blocks(dst_rank, dst_blocks, k, v)
                return
            self.traffic.local_copies += 1
            if not self.is_local(dst_rank):
                return
        k, v = self._read_local(src_rank, src_blocks)
        self.write_blocks(dst_rank, dst_blocks, k, v)


__all__ = ["GlobalKVPool", "MeshTraffic"]
