"""Paged KVCache block pool — allocator, tables, pool-row readers/writers.

Each serving rank (an ``InstanceEngine``) owns a fixed pool of
``num_blocks`` blocks of ``block_size`` tokens: the device tensors
``pool_k/pool_v: [L, num_blocks, block_size, K, hd]``, with this module's
host-side allocator handing out the block ids that index them.
Per-request *local tables* (sequence-ordered local block ids, -1 padded,
built by ``build_local_tables``) are what the paged MicroAttention
kernels consume. Placement across ranks is pure metadata: moving a block
= copying pool rows (``read_pool_rows`` -> ``write_pool_rows``) + editing
tables. Tables are padded to the bucketed widths of ``table_bucket``, the
widths the JAX package uses.

Tail-append convention (one scheme, everywhere)
-----------------------------------------------
Every paged step writes the step's new KV rows at ``(wblk, woff)``
where the sentinel for "this row writes nothing" is the out-of-range
block index ``NB`` (one past the last real block). The JAX package drops
such writes with ``mode="drop"``; PyTorch has no drop mode, so the paged
steps remove sentinel rows on the host before writing (see
``repro_torch.models.prefill``). The writers here update the pool IN
PLACE and return it: a pool tensor is allocated once per engine and
never reallocated.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class BlockAllocator:
    """Fixed-capacity, REFCOUNTED block allocator for one rank's pool.

    Since the cross-request prefix cache, one block frame can be
    referenced by several holders at once — the radix cache (one ref per
    device replica) plus every live request whose chain shares the
    frame. ``alloc`` hands a frame out with refcount 1; ``incref`` adds
    a holder; ``free`` drops one reference per call and only returns the
    frame to the free list when the count reaches zero. Every holder
    therefore keeps its exact single-release discipline (the double-free
    guard still raises on a frame with no live references) while shared
    prefixes never copy.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owner: Dict[int, int] = {}          # block -> allocating id
        self._ref: Dict[int, int] = {}            # block -> live references
        self.reserved = 0                         # try_move reservations

    @property
    def free_count(self) -> int:
        """Allocatable blocks (free list minus move reservations)."""
        return len(self._free) - self.reserved

    @property
    def used_count(self) -> int:
        """Blocks currently owned by some request/cache."""
        return self.num_blocks - len(self._free)

    def alloc(self, n: int, req_id: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks for ``req_id`` (None if short)."""
        if n > self.free_count:
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._owner[b] = req_id
            self._ref[b] = 1
        return blocks

    def reserve(self, n: int) -> bool:
        """Reserve capacity ahead of a KV move (try_move_kvcache)."""
        if n > self.free_count:
            return False
        self.reserved += n
        return True

    def commit_reservation(self, n: int, req_id: int) -> List[int]:
        """Turn a prior ``reserve(n)`` into real blocks."""
        assert self.reserved >= n
        self.reserved -= n
        blocks = self.alloc(n, req_id)
        assert blocks is not None
        return blocks

    def cancel_reservation(self, n: int) -> None:
        """Return reserved headroom without allocating."""
        self.reserved = max(0, self.reserved - n)

    def incref(self, blocks: Sequence[int]) -> None:
        """Add one reference per block (prefix-cache sharing)."""
        for b in blocks:
            if b not in self._ref:
                raise KeyError(f"incref of unallocated block {b}")
            self._ref[b] += 1

    def refcount(self, block: int) -> int:
        """Live references on ``block`` (0 if unallocated)."""
        return self._ref.get(block, 0)

    def rebind(self, block: int, new_id: int) -> None:
        """Reassign a block's informational owner id (cache adoption)."""
        if block in self._owner:
            self._owner[block] = new_id

    def free(self, blocks: Sequence[int]) -> None:
        """Drop ONE reference per block; frames return to the free list
        only at refcount zero. Freeing a frame with no live references
        raises (the double-free guard)."""
        for b in blocks:
            refs = self._ref.get(b)
            if refs is None:
                raise KeyError(f"double free of block {b}")
            if refs > 1:
                self._ref[b] = refs - 1
                continue
            del self._ref[b]
            self._owner.pop(b, None)
            self._free.append(b)

    def blocks_of(self, req_id: int) -> List[int]:
        """Blocks whose informational owner is ``req_id``."""
        return [b for b, r in self._owner.items() if r == req_id]


@dataclass
class RequestBlocks:
    """Sequence-ordered block list of one request on one rank."""
    req_id: int
    blocks: List[int] = field(default_factory=list)
    tail_tokens: int = 0       # valid tokens in the LAST block (1..bs)

    def n_tokens(self, block_size: int) -> int:
        """Valid tokens across this request's blocks."""
        if not self.blocks:
            return 0
        return (len(self.blocks) - 1) * block_size + self.tail_tokens


class RankKVPool:
    """One rank's pool: allocator + per-request ordered block lists."""

    def __init__(self, num_blocks: int, block_size: int):
        self.alloc = BlockAllocator(num_blocks, block_size)
        self.block_size = block_size
        self.requests: Dict[int, RequestBlocks] = {}

    # ----------------------------------------------------------------- #
    def append_tokens(self, req_id: int, n: int) -> bool:
        """Extend a request by n tokens, allocating blocks as needed."""
        bs = self.block_size
        rb = self.requests.setdefault(req_id, RequestBlocks(req_id))
        while n > 0:
            if rb.blocks and rb.tail_tokens < bs:
                take = min(n, bs - rb.tail_tokens)
                rb.tail_tokens += take
                n -= take
                continue
            blocks = self.alloc.alloc(1, req_id)
            if blocks is None:
                return False
            rb.blocks.extend(blocks)
            rb.tail_tokens = 0
        return True

    def pop_prefix_blocks(self, req_id: int, n_blocks: int) -> List[int]:
        """Remove the OLDEST n full blocks (for migration to a creditor)."""
        rb = self.requests[req_id]
        n_full = len(rb.blocks) - (1 if rb.tail_tokens < self.block_size
                                   else 0)
        n_blocks = min(n_blocks, max(0, n_full))
        popped, rb.blocks = rb.blocks[:n_blocks], rb.blocks[n_blocks:]
        self.alloc.free(popped)
        if not rb.blocks:
            rb.tail_tokens = 0
        return popped

    def adopt_blocks(self, req_id: int, n_blocks: int,
                     at_front: bool = False) -> Optional[List[int]]:
        """Allocate blocks for KV arriving from another rank (full blocks)."""
        blocks = self.alloc.alloc(n_blocks, req_id)
        if blocks is None:
            return None
        rb = self.requests.setdefault(req_id, RequestBlocks(req_id))
        if at_front:
            rb.blocks = blocks + rb.blocks
            if rb.tail_tokens == 0:
                rb.tail_tokens = self.block_size
        else:
            if rb.blocks and rb.tail_tokens < self.block_size:
                raise ValueError("cannot append full blocks after a "
                                 "partial tail")
            rb.blocks.extend(blocks)
            rb.tail_tokens = self.block_size
        return blocks

    def attach_shared(self, req_id: int, blocks: Sequence[int],
                      tail_tokens: int) -> None:
        """Start a request's chain from already-resident shared blocks
        (prefix-cache hit). Each block gains one reference, so the
        request's normal ``release`` decrefs it without disturbing the
        cache pin or other sharers."""
        rb = self.requests.setdefault(req_id, RequestBlocks(req_id))
        assert not rb.blocks, "attach_shared on a non-empty chain"
        self.alloc.incref(blocks)
        rb.blocks = list(blocks)
        rb.tail_tokens = tail_tokens

    def release(self, req_id: int) -> None:
        """Drop the request's block references (refcounted free)."""
        rb = self.requests.pop(req_id, None)
        if rb and rb.blocks:
            self.alloc.free(rb.blocks)

    def tokens_of(self, req_id: int) -> int:
        """Valid tokens ``req_id`` holds in this pool (0 if none)."""
        rb = self.requests.get(req_id)
        return rb.n_tokens(self.block_size) if rb else 0

    @property
    def memory_utilization(self) -> float:
        """Fraction of pool blocks in use (Algorithm-1 input)."""
        return self.alloc.used_count / self.alloc.num_blocks


TABLE_BUCKET_MIN = 8


def table_bucket(n_blocks: int, lo: int = TABLE_BUCKET_MIN) -> int:
    """Smallest power-of-two table width >= max(n_blocks, lo).

    Bucketing the ``max_blocks`` dimension of the block tables keeps the
    paged decode step's compile count bounded by the number of buckets
    (log2 of the longest context) instead of the number of distinct
    span lengths.
    """
    m = max(int(n_blocks), lo, 1)
    return 1 << (m - 1).bit_length()


def _index(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64)).to(device)


def write_pool_rows(pool: torch.Tensor, block_ids: Sequence[int],
                    rows: torch.Tensor, block_size: int) -> torch.Tensor:
    """Write token rows into pool blocks, IN PLACE; returns ``pool``.

    pool: [L, NB, bs, K, hd]; rows: [L, n, K, hd] with
    n <= len(block_ids) * block_size, filling ``block_ids`` in sequence
    order from offset 0 (a partial final block is zero-padded; readers
    mask it via the table's tail length).
    """
    L, n = rows.shape[:2]
    nb = len(block_ids)
    pad = nb * block_size - n
    if pad:
        rows = torch.cat([rows, rows.new_zeros((L, pad) + rows.shape[2:])], 1)
    rows = rows.reshape((L, nb, block_size) + rows.shape[2:])
    pool.index_copy_(1, _index(block_ids, pool.device), rows.to(pool.dtype))
    return pool


def read_pool_rows(pool: torch.Tensor, block_ids: Sequence[int],
                   block_size: int) -> torch.Tensor:
    """Gather full blocks out of a pool: [L, len(block_ids)*bs, K, hd]
    (a copy: safe to keep after the frames are freed and reused)."""
    rows = pool.index_select(1, _index(block_ids, pool.device))
    L = rows.shape[0]
    return rows.reshape((L, len(block_ids) * block_size) + rows.shape[3:])


def rows_for_token_range(blocks: Sequence[int], block_size: int,
                         t0: int, t1: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token (block id, in-block offset) for rank-local tokens [t0, t1).

    ``blocks`` is a request's sequence-ordered block list on ONE rank;
    token ``t`` of that rank-local span lives at
    ``(blocks[t // bs], t % bs)``. This is the addressing the streaming
    prefill chunk writer uses to scatter KV rows into pre-reserved
    blocks without ever materializing a dense cache.
    """
    pos = np.arange(t0, t1)
    blk = np.asarray(blocks, np.int32)[pos // block_size]
    off = (pos % block_size).astype(np.int32)
    return blk, off


def scatter_pool_rows(pool: torch.Tensor, block_ids, offsets,
                      rows: torch.Tensor) -> torch.Tensor:
    """Row-addressed scatter into a pool, IN PLACE; returns ``pool``.

    pool: [L, NB, bs, K, hd]; rows: [L, n, K, hd] written at
    ``(block_ids[i], offsets[i])`` per row — unlike ``write_pool_rows``
    this can land mid-block, which is what per-chunk streaming writes
    into already-committed creditor blocks need.
    """
    blk = _index(block_ids, pool.device)
    off = _index(offsets, pool.device)
    pool[:, blk, off] = rows.to(pool.dtype)
    return pool


def prefix_tables(pools: Sequence[RankKVPool], req_id: int,
                  covered: Sequence[int], max_blocks: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Tables/tails addressing only the first ``covered[p]`` tokens of one
    request on each rank — the streaming-prefill view of a request whose
    blocks are all reserved up front but only partially written.

    Returns (tables [n_ranks, 1, max_blocks] int32 -1-padded,
             tail_len [n_ranks, 1] int32); a rank with zero coverage gets
    an empty table (its MicroAttention partial is the monoid identity).
    """
    P = len(pools)
    tables = -np.ones((P, 1, max_blocks), np.int32)
    tails = np.zeros((P, 1), np.int32)
    for p, pool in enumerate(pools):
        bs = pool.block_size
        c = int(covered[p])
        rb = pool.requests.get(req_id)
        if not rb or c <= 0:
            tails[p, 0] = bs
            continue
        nb = -(-c // bs)
        tables[p, 0, :nb] = rb.blocks[:nb]
        tails[p, 0] = c - (nb - 1) * bs
    return tables, tails


def build_local_tables(pools: Sequence[RankKVPool], req_ids: Sequence[int],
                       max_blocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """Device inputs for the paged kernel across ranks.

    Returns (tables [n_ranks, R, max_blocks] int32 -1-padded,
             tail_len [n_ranks, R] int32).
    """
    n_ranks, R = len(pools), len(req_ids)
    tables = -np.ones((n_ranks, R, max_blocks), np.int32)
    tails = np.full((n_ranks, R), 0, np.int32)
    for p, pool in enumerate(pools):
        for r, rid in enumerate(req_ids):
            rb = pool.requests.get(rid)
            if not rb or not rb.blocks:
                tails[p, r] = pool.block_size
                continue
            n = min(len(rb.blocks), max_blocks)
            tables[p, r, :n] = rb.blocks[:n]
            tails[p, r] = (rb.tail_tokens if n == len(rb.blocks)
                           else pool.block_size)
    return tables, tails
