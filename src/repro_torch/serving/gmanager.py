"""gManager: centralized global planner (paper §6.1-6.2).

Maintains the request placement map from periodic rManager heartbeats
(delta-encoded; full on gManager failover), detects dead instances via
heartbeat timeouts, runs Algorithm 1 periodically, and emits MoveKVCache
instructions. The map is deliberately allowed to go stale — safety comes
from the try_move reservation on the destination (paper Fig. 8 step 4-5).

Striped-plan protocol: since the multi-creditor generalization each
``MoveKVCache`` carries a LIST of legs (destination, whole blocks) for
one source request — ``plan_moves`` translates the scheduler's
``StripedMove``s one-to-one. The per-request placement map is
cross-referenced when building scheduler views: every owner view gets
``req_spans`` (req_id -> {creditor: blocks}, rebuilt fresh from the
heartbeat entries each planning round), and because the scheduler plans
against COPIES, ``_views`` stays consistent with the heartbeat state no
matter how many times planning runs between beats.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.serving.perfmodel import InstancePerfModel
from repro_torch.serving.protocol import (Heartbeat, MoveKVCache, MoveLeg,
                                    RequestPlacementEntry)
from repro_torch.serving.scheduler import GreedyScheduler, InstanceView


class ArrivalEstimator:
    """EWMA estimator of the live arrival stream (paper §6.2's online
    "average length of new requests", generalized with a rate term).

    ``observe(now, n_tokens)`` folds one arrival in: ``n_tokens`` is
    the request's expected KV footprint (prompt + max_new_tokens — the
    worst case the pool must plan for) and ``now`` feeds an EWMA of the
    inter-arrival gap. The length estimate starts at the static
    ``avg_new_req_len`` config prior and converges to the traffic; the
    rate is 0 ("unknown") until two arrivals have been seen. The
    gManager pushes both into ``GreedyScheduler`` before each planning
    round, replacing the static knob in Algorithm 1's batch-growth
    credit."""

    def __init__(self, alpha: float = 0.3, init_len: int = 512):
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        self._avg_len = float(init_len)
        self._avg_gap: Optional[float] = None
        self._last_t: Optional[float] = None
        self.samples = 0

    def observe(self, now: float, n_tokens: int) -> None:
        """Fold one arrival (at monotonic ``now``, ``n_tokens`` of
        expected KV footprint) into the EWMA state."""
        a = self.alpha
        self._avg_len += a * (float(n_tokens) - self._avg_len)
        if self._last_t is not None:
            gap = max(1e-6, now - self._last_t)
            self._avg_gap = gap if self._avg_gap is None else \
                self._avg_gap + a * (gap - self._avg_gap)
        self._last_t = now
        self.samples += 1

    @property
    def avg_new_req_len(self) -> int:
        """Current length estimate (tokens), floored at one."""
        return max(1, int(round(self._avg_len)))

    @property
    def rate_hz(self) -> float:
        """EWMA arrival rate in req/s (0.0 until two arrivals seen)."""
        if self._avg_gap is None:
            return 0.0
        return 1.0 / self._avg_gap


@dataclass
class _InstanceStatus:
    inst_id: int
    last_seq: int = 0
    last_beat: float = 0.0
    batch_size: int = 0
    mem_blocks_total: int = 0
    mem_blocks_used: int = 0
    cache_blocks: int = 0          # unpinned (reclaimable) cache replicas
    alive: bool = True
    missed_beats: int = 0          # consecutive silent cluster steps
    # req_id -> entry (this instance's slice of the request)
    entries: Dict[int, RequestPlacementEntry] = field(default_factory=dict)


class GManager:
    """Centralized planner: heartbeat map + Algorithm 1 + placement.

    Owns the ``GreedyScheduler`` (and feeds it the live
    ``ArrivalEstimator`` state before every planning round), detects
    dead instances, and answers placement queries for new arrivals."""

    def __init__(self, perf: InstancePerfModel, block_size: int,
                 heartbeat_timeout: float = 3.0,
                 beta_thres: int = 64, mem_util_thres: float = 0.8,
                 avg_new_req_len: int = 512, max_stripes: int = 8,
                 reclaim_horizon_s: float = 1.0,
                 arrival_alpha: float = 0.3,
                 heartbeat_timeout_steps: int = 0):
        self.scheduler = GreedyScheduler(perf, block_size,
                                         beta_thres=beta_thres,
                                         mem_util_thres=mem_util_thres,
                                         avg_new_req_len=avg_new_req_len,
                                         max_stripes=max_stripes,
                                         reclaim_horizon_s=reclaim_horizon_s)
        self.block_size = block_size
        self.timeout = heartbeat_timeout
        self.timeout_steps = heartbeat_timeout_steps  # 0 = step check off
        self.instances: Dict[int, _InstanceStatus] = {}
        self.bootstrapping = True     # new gManager needs full heartbeats
        self.arrivals = ArrivalEstimator(alpha=arrival_alpha,
                                         init_len=avg_new_req_len)

    # --- arrival stream ------------------------------------------------ #
    def observe_arrival(self, now: float, n_tokens: int) -> None:
        """Feed one frontend arrival (expected KV footprint in tokens)
        into the EWMA estimator; the next ``plan_moves`` round plans
        with the updated ``avg_new_req_len``/rate instead of the static
        config knob."""
        self.arrivals.observe(now, n_tokens)

    # --- heartbeat ingestion ------------------------------------------ #
    def on_heartbeat(self, hb: Heartbeat, now: Optional[float] = None
                     ) -> bool:
        """Returns False if a FULL heartbeat is required (failover resync
        or out-of-order delta)."""
        now = time.monotonic() if now is None else now
        st = self.instances.get(hb.inst_id)
        if st is None:
            st = _InstanceStatus(hb.inst_id)
            self.instances[hb.inst_id] = st
            if not hb.full:
                return False                      # need full state first
        if not hb.full and hb.seq != st.last_seq + 1:
            return False                          # lost a delta -> resync
        if hb.full:
            st.entries = {}
        for e in hb.entries:
            st.entries[e.req_id] = e
        for rid in hb.removed_req_ids:
            st.entries.pop(rid, None)
        st.last_seq = hb.seq
        st.last_beat = now
        st.batch_size = hb.batch_size
        st.mem_blocks_total = hb.mem_blocks_total
        st.mem_blocks_used = hb.mem_blocks_used
        st.cache_blocks = hb.cache_blocks
        st.alive = True
        st.missed_beats = 0
        return True

    # --- failure detection / elasticity -------------------------------- #
    def check_liveness(self, now: Optional[float] = None) -> List[int]:
        """Mark instances dead on heartbeat timeout; return newly dead."""
        now = time.monotonic() if now is None else now
        dead = []
        for st in self.instances.values():
            if st.alive and now - st.last_beat > self.timeout:
                st.alive = False
                dead.append(st.inst_id)
        return dead

    def check_liveness_steps(self, beat_insts) -> List[int]:
        """Step-count liveness: every alive instance NOT in
        ``beat_insts`` (the set that heartbeat this cluster step) gets
        one missed beat; ``heartbeat_timeout_steps`` consecutive misses
        mark it dead. Deterministic companion to the wall-clock
        ``check_liveness`` — a single beat resets the counter, so a
        silence gap shorter than the timeout is tolerated. Returns the
        newly dead instance ids (empty when the step check is off)."""
        if self.timeout_steps <= 0:
            return []
        dead = []
        for st in self.instances.values():
            if not st.alive:
                continue
            if st.inst_id in beat_insts:
                continue
            st.missed_beats += 1
            if st.missed_beats >= self.timeout_steps:
                st.alive = False
                dead.append(st.inst_id)
        return dead

    def deregister(self, inst_id: int) -> None:
        """Forget a (dead or drained) instance entirely."""
        self.instances.pop(inst_id, None)

    def requests_touching(self, inst_id: int) -> List[int]:
        """Request ids with any KV (local or hosted) on ``inst_id``."""
        st = self.instances.get(inst_id)
        return sorted(st.entries) if st else []

    def owner_of(self, req_id: int) -> Optional[int]:
        """Instance id owning ``req_id``'s local span, if any."""
        for st in self.instances.values():
            e = st.entries.get(req_id)
            if e is not None and e.local:
                return st.inst_id
        return None

    # --- planning ------------------------------------------------------ #
    def _views(self) -> List[InstanceView]:
        # Cross-instance placement: req_id -> {creditor_inst: blocks}
        # (every non-local slice), and req_id -> total blocks anywhere.
        spans: Dict[int, Dict[int, int]] = {}
        total_blocks: Dict[int, int] = {}
        for st in self.instances.values():
            for rid, e in st.entries.items():
                total_blocks[rid] = total_blocks.get(rid, 0) + e.num_blocks
                if not e.local:
                    spans.setdefault(rid, {})[st.inst_id] = e.num_blocks
        views = []
        for st in self.instances.values():
            reqs = {}
            off = 0
            req_spans: Dict[int, Dict[int, int]] = {}
            for rid, e in st.entries.items():
                # The owner sees the request's TRUE total length (its
                # local slice plus every creditor span); a creditor only
                # sees its own slice.
                n = total_blocks[rid] if e.local else e.num_blocks
                reqs[rid] = (n * self.block_size, e.num_blocks, e.local)
                if e.local and rid in spans:
                    req_spans[rid] = dict(spans[rid])
                    off += sum(spans[rid].values()) * self.block_size
            hosted = sum(e.num_blocks for e in st.entries.values()
                         if not e.local) * self.block_size
            views.append(InstanceView(
                inst_id=st.inst_id, batch_size=st.batch_size,
                mem_blocks_total=st.mem_blocks_total,
                mem_blocks_used=st.mem_blocks_used,
                requests=reqs, offloaded_tokens=off,
                hosted_tokens=hosted, alive=st.alive,
                req_spans=req_spans, cache_blocks=st.cache_blocks))
        return views

    def plan_moves(self, urgency: Optional[Dict[int, float]] = None
                   ) -> List[MoveKVCache]:
        """Run Algorithm 1 against the current heartbeat views.

        ``urgency`` (req_id -> score, from the serving frontend's
        priority/deadline lifecycle) biases the planner: higher-urgency
        requests are picked for memory relief first.
        """
        # Push the live arrival estimate into Algorithm 1: the
        # batch-growth credit plans with observed traffic, not the
        # static config prior.
        if self.arrivals.samples > 0:
            self.scheduler.avg_new_len = self.arrivals.avg_new_req_len
        self.scheduler.arrival_rate_hz = self.arrivals.rate_hz
        moves = self.scheduler.plan(self._views(), urgency=urgency)
        return [MoveKVCache(m.req_id, m.src,
                            [MoveLeg(leg.dst, leg.num_blocks)
                             for leg in m.legs], kind=m.kind)
                for m in moves]

    # --- placement queries for new requests ----------------------------- #
    def pick_instance_for_new_request(self) -> Optional[int]:
        """Paper policy: dispatch to the instance with most free memory."""
        alive = [s for s in self.instances.values() if s.alive]
        if not alive:
            return None
        return max(alive, key=lambda s: s.mem_blocks_total -
                   s.mem_blocks_used).inst_id
