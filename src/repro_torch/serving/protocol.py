"""The paper's §6 protocol objects (Listing 1) + message structs.

heartbeat:            rManager -> gManager, delta-encoded placement entries
move_kvcache:         gManager -> rManager (src), a planned movement
try_move_kvcache:     src rManager -> dst rManager, FCFS space reservation
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List


@dataclass(frozen=True)
class RequestPlacementEntry:
    """One request's KVCache footprint on one instance (paper Listing 1)."""
    req_id: int
    inst_id: int
    num_blocks: int
    local: bool            # True if this instance is the request's debtor
                           # (owner) instance


@dataclass
class Heartbeat:
    """Periodic rManager -> gManager state report (delta or full).

    Carries this instance's placement entries, batch size, and memory
    occupancy — the inputs Algorithm 1 plans from.
    """

    inst_id: int
    seq: int                                   # monotone per instance
    full: bool                                 # full resync vs delta
    entries: List[RequestPlacementEntry]
    batch_size: int = 0
    mem_blocks_total: int = 0
    mem_blocks_used: int = 0
    removed_req_ids: List[int] = field(default_factory=list)
    # Unpinned prefix-cache replicas: used blocks the instance can
    # reclaim on demand (evict/spill). Algorithm 1 counts them as
    # creditor capacity — minus a spill-cost penalty.
    cache_blocks: int = 0


@dataclass(frozen=True)
class MoveLeg:
    """One stripe of a movement plan: whole blocks onto one instance."""
    dst_inst: int
    num_blocks: int


@dataclass
class MoveKVCache:
    """gManager instruction: move req_id's oldest blocks from src_inst
    onto one or MORE destinations (a striped span plan).

    The runtime must execute the legs all-or-nothing: every destination
    is reserved (try_move_kvcache, FCFS) before any KV byte moves; if
    any leg is refused every reservation is cancelled and the plan is
    REJECTED — a stale global view can waste a plan, never corrupt
    state. ``kind`` is "offload" (debtor -> creditors) or "reclaim"
    (a stressed creditor evicts a hosted span back to its owner or
    sideways to other creditors).
    """
    req_id: int
    src_inst: int
    legs: List[MoveLeg]
    kind: str = "offload"

    @property
    def num_blocks(self) -> int:
        """Total blocks moved across all legs."""
        return sum(leg.num_blocks for leg in self.legs)


class MoveResult(enum.Enum):
    """Outcome of executing one ``MoveKVCache`` plan."""

    OK = "ok"
    REJECTED = "rejected"          # dst out of space (stale global view)
    # Request reached a terminal state (finished / failed / CANCELLED)
    # between planning and execution: the plan is invalidated before any
    # reservation is made, so a cancel racing a striped move can never
    # leave orphan reservations.
    GONE = "gone"
