"""rManager: per-instance local manager (paper §6.1).

Owns the instance's block pool, answers try_move_kvcache reservations
FCFS, emits delta heartbeats, and executes movement instructions. The
actual KV bytes live in the engine's device pool tensors; every row of
those tensors is addressed exclusively through the block ids this
metadata hands out, so a stale gManager plan can never corrupt state —
a reservation that never commits is just cancelled numbers.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from repro_torch.serving.kvpool import RankKVPool
from repro_torch.serving.protocol import Heartbeat, RequestPlacementEntry


class RManager:
    """Per-instance resource manager: the paper's rManager role.

    Owns the instance's ``RankKVPool`` view, tracks which requests this
    rank OWNS (debtor) vs merely hosts (creditor), and emits the
    delta-compressed ``Heartbeat`` stream Algorithm 1 plans from.
    """

    def __init__(self, inst_id: int, num_blocks: int, block_size: int,
                 pool: Optional[RankKVPool] = None):
        self.inst_id = inst_id
        # In global-pool mode the cluster hands every rManager its slice
        # of ``GlobalKVPool.ranks`` — the SAME allocator object the
        # sharded step's table builders read, so placement metadata is
        # identical whether steps run in-process or under shard_map.
        self.pool = pool if pool is not None else RankKVPool(num_blocks,
                                                             block_size)
        self.block_size = block_size
        self._seq = 0
        self._last_reported: Dict[int, RequestPlacementEntry] = {}
        self._owned: Set[int] = set()       # req_ids this instance owns
        self.batch_size = 0
        # Prefix-cache hooks (cluster-installed when caching is on):
        # evict_hook(n) frees up to n unpinned cached frames on demand;
        # cache_blocks_fn() reports how many such frames exist — the
        # heartbeat carries it so Algorithm 1 treats cached-but-unpinned
        # memory as reclaimable creditor capacity.
        self.evict_hook: Optional[Callable[[int], int]] = None
        self.cache_blocks_fn: Optional[Callable[[], int]] = None

    @property
    def effective_free(self) -> int:
        """Allocatable blocks counting evictable cache replicas."""
        free = self.pool.alloc.free_count
        if self.cache_blocks_fn is not None:
            free += self.cache_blocks_fn()
        return free

    # --- placement metadata ------------------------------------------- #
    def set_owner(self, req_id: int, owned: bool = True) -> None:
        """Mark/unmark this rank as ``req_id``'s owner (debtor)."""
        (self._owned.add if owned else self._owned.discard)(req_id)

    def entries(self) -> List[RequestPlacementEntry]:
        """Current placement entries (one per request with blocks)."""
        out = []
        for rid, rb in self.pool.requests.items():
            if not rb.blocks:
                continue
            out.append(RequestPlacementEntry(
                req_id=rid, inst_id=self.inst_id,
                num_blocks=len(rb.blocks), local=rid in self._owned))
        return out

    # --- heartbeat (delta unless full resync requested) ---------------- #
    def heartbeat(self, full: bool = False) -> Heartbeat:
        """Build the next heartbeat (delta unless ``full`` resync)."""
        self._seq += 1
        cur = {e.req_id: e for e in self.entries()}
        if full:
            send = list(cur.values())
            removed: List[int] = []
        else:
            send = [e for rid, e in cur.items()
                    if self._last_reported.get(rid) != e]
            removed = [rid for rid in self._last_reported if rid not in cur]
        self._last_reported = cur
        return Heartbeat(
            inst_id=self.inst_id, seq=self._seq, full=full, entries=send,
            batch_size=self.batch_size,
            mem_blocks_total=self.pool.alloc.num_blocks,
            mem_blocks_used=self.pool.alloc.used_count,
            removed_req_ids=removed,
            cache_blocks=(self.cache_blocks_fn()
                          if self.cache_blocks_fn is not None else 0))

    # --- try_move_kvcache: FCFS reservation on the DESTINATION --------- #
    def try_move_kvcache(self, req_id: int, num_blocks: int) -> bool:
        """Called by a SOURCE instance before shipping KV here. When the
        pool is short, unpinned prefix-cache replicas are evicted on
        demand (spilling to the host tier) before refusing."""
        if self.pool.alloc.reserve(num_blocks):
            return True
        if self.evict_hook is not None:
            self.evict_hook(num_blocks - self.pool.alloc.free_count)
            return self.pool.alloc.reserve(num_blocks)
        return False

    def commit_move_in(self, req_id: int, num_blocks: int,
                       at_front: bool = True) -> Optional[List[int]]:
        """Receive KV previously reserved. Returns local block ids."""
        self.pool.alloc.reserved -= num_blocks
        blocks = self.pool.adopt_blocks(req_id, num_blocks,
                                        at_front=at_front)
        return blocks

    def cancel_move_in(self, num_blocks: int) -> None:
        """Roll back a refused move's capacity reservation."""
        self.pool.alloc.cancel_reservation(num_blocks)

    def move_out_prefix(self, req_id: int, num_blocks: int) -> int:
        """Release the oldest n blocks of req (after shipping). Returns
        the number actually released."""
        popped = self.pool.pop_prefix_blocks(req_id, num_blocks)
        return len(popped)

    def is_hosting(self, req_id: int) -> bool:
        """True iff this rank holds blocks for a request it does NOT own
        (i.e. it is a creditor for that request)."""
        return req_id in self.pool.requests and req_id not in self._owned

    def release_request(self, req_id: int) -> None:
        """Free every block and ownership record of ``req_id``."""
        self.pool.release(req_id)
        self._owned.discard(req_id)
