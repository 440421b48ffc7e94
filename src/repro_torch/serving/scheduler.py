"""Cluster-level DistAttention scheduling — the paper's Algorithm 1,
generalized to STRIPED span plans.

Greedy debtor/creditor pairing driven by the Eq. 5-7 performance model:
debtors = instances with small batch (big marginal gain from freeing
memory), creditors = instances with low memory utilization. For each
debtor (ascending batch size), take its longest request and place its
movable prefix across one or MORE creditors: the planner searches the
TOTAL moved-block count over the combined capacity of up to
``max_stripes`` creditors, splits each candidate total greedily into
per-(creditor, k-blocks) legs (emptiest creditor first), and scores the
whole striped placement at once — per-leg marginal gains would miss
moves that only pay off past one creditor's capacity, which is exactly
the striping case. A request whose prefix exceeds any single creditor's
free blocks thus stripes across several, turning the per-instance pools
into the paper's cluster-wide memory pool. Each stripe is charged its
per-step query/merge traffic (``InstancePerfModel.t_span_merge``) and
credited its share of the parallel remote-slice speedup, so more
creditors is a modeled trade-off, never free.

Striped-plan protocol
---------------------
``plan()`` returns ``StripedMove``s: one source instance, one request,
and an ordered list of ``SpanLeg``s (destination, whole blocks). The
runtime must execute a plan all-or-nothing: reserve every leg on its
destination first (try_move_kvcache, FCFS), roll every reservation back
if any leg is refused, and only then copy pool rows + edit tables.
Legs of one plan never repeat a destination and never over-commit a
destination's free blocks as seen in the heartbeat views.

Reclaim path
------------
A creditor that itself becomes memory-stressed (its utilization rises
past the threshold, or it turns into a debtor while hosting others'
spans) is relieved symmetrically: ``plan()`` emits reclaim
``StripedMove``s that evict hosted spans BACK to their owner (when the
owner has headroom again) or SIDEWAYS to other creditors, again
all-or-nothing per plan.

``plan()`` never mutates the caller's views — it works on copies, so a
``GManager`` can re-plan from the same heartbeat state.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.perfmodel import InstancePerfModel


@dataclass
class InstanceView:
    """Scheduler's (possibly stale — heartbeat-fed) view of one instance."""
    inst_id: int
    batch_size: int
    mem_blocks_total: int
    mem_blocks_used: int
    # req_id -> (total_len_tokens, local_blocks_here, is_owner)
    requests: Dict[int, Tuple[int, int, bool]] = field(default_factory=dict)
    offloaded_tokens: int = 0          # owner's KV held remotely
    hosted_tokens: int = 0             # others' KV held here
    alive: bool = True
    # Unpinned prefix-cache replicas: blocks that count in
    # mem_blocks_used but are reclaimable on demand (evicted/spilled to
    # the host tier). Algorithm 1 treats them as creditor capacity,
    # charged a spill-cost penalty when a plan would displace them.
    cache_blocks: int = 0
    # Owned requests' creditor spans: req_id -> {creditor_inst: blocks}.
    # Populated by GManager._views from the cross-instance placement map;
    # drives the per-span merge-cost and parallel-slice terms.
    req_spans: Dict[int, Dict[int, int]] = field(default_factory=dict)

    @property
    def mem_util(self) -> float:
        """Fraction of this instance's pool blocks in use."""
        return self.mem_blocks_used / max(1, self.mem_blocks_total)

    @property
    def free_blocks(self) -> int:
        """Unused pool blocks in this view."""
        return self.mem_blocks_total - self.mem_blocks_used

    def copy(self) -> "InstanceView":
        """Deep-enough copy: planning mutates it, heartbeats stay pristine."""
        return replace(
            self, requests=dict(self.requests),
            req_spans={r: dict(s) for r, s in self.req_spans.items()})


@dataclass
class SpanLeg:
    """One stripe of a striped plan: whole blocks onto one destination."""
    dst: int
    num_blocks: int


@dataclass
class StripedMove:
    """One all-or-nothing planned movement of a request's KV blocks.

    ``kind`` is "offload" (debtor -> creditors) or "reclaim" (a stressed
    creditor evicts a hosted span back to its owner / sideways).
    """
    req_id: int
    src: int
    legs: List[SpanLeg]
    kind: str = "offload"

    @property
    def num_blocks(self) -> int:
        """Total blocks this striped move transfers."""
        return sum(leg.num_blocks for leg in self.legs)


# Backwards-compatible alias: a single-leg plan is the old MoveDecision.
MoveDecision = StripedMove


class GreedyScheduler:
    """Algorithm 1 with striped spans. Thresholds are the paper's
    beta^thres / U^thres; ``max_stripes`` caps how many creditors one
    request's plan may fan out to per round (1 = the paper's original
    single-creditor greedy)."""

    def __init__(self, perf: InstancePerfModel, block_size: int,
                 beta_thres: int = 64, mem_util_thres: float = 0.8,
                 max_moves_per_round: int = 64,
                 avg_new_req_len: int = 512,
                 max_stripes: int = 8,
                 reclaim_horizon_s: float = 1.0):
        self.perf = perf
        self.bs = block_size
        self.beta_thres = beta_thres
        self.mem_util_thres = mem_util_thres
        self.max_moves = max_moves_per_round
        self.max_stripes = max_stripes
        # Typical length of a newly-admitted request. The config value
        # is only the PRIOR: the gManager's EWMA ``ArrivalEstimator``
        # overwrites it from the live arrival stream before every
        # planning round, so the batch-growth credit (paper Fig. 7a
        # slope) tracks the traffic actually hitting the cluster.
        self.avg_new_len = avg_new_req_len
        # EWMA arrival rate (req/s) from the same estimator; 0 means
        # "unknown" (no frontend feeding us) and disables the cap below.
        self.arrival_rate_hz = 0.0
        # Amortization window of the reclaim gain check: undoing a
        # stripe must win back its own movement cost within this many
        # seconds of modeled decode, or the eviction is not planned.
        self.reclaim_horizon_s = reclaim_horizon_s

    # ------------------------------------------------------------------ #
    def _span_stats(self, v: InstanceView) -> Tuple[int, int]:
        """(span_entries, max single-creditor slice in tokens) of v."""
        entries = sum(len(s) for s in v.req_spans.values())
        mx = max((blk for s in v.req_spans.values()
                  for blk in s.values()), default=0)
        return entries, mx * self.bs

    def _inst_tps(self, v: InstanceView) -> float:
        lengths = [ln for (ln, _, own) in v.requests.values() if own]
        entries, mx = self._span_stats(v)
        return self.perf.tps(v.batch_size, lengths,
                             offloaded_tokens=v.offloaded_tokens,
                             hosted_tokens=v.hosted_tokens,
                             span_entries=entries, max_span_tokens=mx)

    # --- SLO-aware preemption scoring --------------------------------- #
    def predicted_finish_s(self, v: InstanceView,
                           remaining_tokens: int) -> float:
        """Eq. 5-7 horizon: modeled seconds until a request running on
        instance ``v`` with ``remaining_tokens`` left to decode
        finishes, given v's current batch/lengths/spans."""
        lengths = [ln for (ln, _, own) in v.requests.values() if own]
        entries, _ = self._span_stats(v)
        return self.perf.predicted_finish_s(
            v.batch_size, lengths, remaining_tokens,
            offloaded_tokens=v.offloaded_tokens,
            hosted_tokens=v.hosted_tokens, span_entries=entries)

    def victim_slack_s(self, v: InstanceView, resident_tokens: int,
                       remaining_tokens: int,
                       deadline_at: Optional[float],
                       now: float) -> float:
        """SLO slack of a preemption candidate AFTER paying the pause.

        slack = deadline - now - predicted_finish - spill/resume cost
        (``t_preempt_roundtrip`` over ``resident_tokens`` of KV). A
        request without a deadline has infinite slack — the preferred
        victim. The preemptor only pauses candidates whose charged
        slack stays above ``OverloadPolicy.victim_min_slack_s``, so a
        victim is expected to STILL meet its own SLO after the detour;
        heavy-tail overload therefore degrades the slackest requests
        first and p99-critical ones last."""
        if deadline_at is None:
            return float("inf")
        return deadline_at - now \
            - self.predicted_finish_s(v, remaining_tokens) \
            - self.perf.t_preempt_roundtrip(resident_tokens)

    def _apply_leg(self, d: InstanceView, c: InstanceView, rid: int,
                   k_blocks: int) -> None:
        """Mutate working views as if k blocks of rid moved d -> c.

        Blocks beyond the creditor's plain free pool displace unpinned
        prefix-cache replicas (the runtime evicts/spills them on
        demand): those frames change hands rather than growing
        ``mem_blocks_used``."""
        tok = k_blocks * self.bs
        d.offloaded_tokens += tok
        d.mem_blocks_used -= k_blocks
        ln, blk, own = d.requests[rid]
        d.requests[rid] = (ln, blk - k_blocks, own)
        spans = d.req_spans.setdefault(rid, {})
        spans[c.inst_id] = spans.get(c.inst_id, 0) + k_blocks
        evicted = max(0, k_blocks - c.free_blocks)
        c.cache_blocks = max(0, c.cache_blocks - evicted)
        c.hosted_tokens += tok
        c.mem_blocks_used += k_blocks - evicted

    def _creditor_cap(self, c: InstanceView, *,
                      with_cache: bool = True) -> int:
        """Blocks an offload may place on creditor ``c``: its free
        blocks MINUS one block of headroom per running request, so the
        creditor's own decode tails can keep growing until the next
        planning round instead of hard-failing on pool exhaustion.

        Unpinned prefix-cache replicas (``cache_blocks``) count too —
        the runtime evicts or spills them on demand — but placements
        that dip into them are charged the host-link spill cost in
        ``_striped_gain``, so displacing a warm cache must pay."""
        extra = c.cache_blocks if with_cache else 0
        return max(0, c.free_blocks + extra - c.batch_size)

    def _split_blocks(self, k: int,
                      cands: List[InstanceView]) -> List[Tuple[int, int]]:
        """Greedy split of k blocks over candidate creditors (emptiest
        first, each filled to its headroom-capped capacity):
        [(creditor_idx, n)]."""
        splits = []
        for i, c in enumerate(cands):
            take = min(k, self._creditor_cap(c))
            if take > 0:
                splits.append((i, take))
                k -= take
            if k <= 0:
                break
        return splits

    def _debtor_tps_after(self, d2: InstanceView, base_batch: int,
                          moved_tok: int) -> float:
        """Debtor TPS after a plan, crediting batch growth: freed memory
        admits ~moved_tok / avg_new_len waiting requests, saturating at
        the compute roofline (the paper's Fig. 2(b) plateau), not at the
        debtor-selection threshold."""
        beta_sat = int(self.perf.hw.critical_intensity)
        extra = min(moved_tok // self.avg_new_len,
                    max(0, beta_sat - base_batch))
        # Freed memory only buys throughput if requests actually ARRIVE
        # to fill it: cap the credit by the EWMA-estimated arrivals
        # within the amortization horizon (unknown rate => uncapped,
        # the original optimistic behavior).
        if self.arrival_rate_hz > 0.0:
            expected = int(self.arrival_rate_hz *
                           self.reclaim_horizon_s) + 1
            extra = min(extra, expected)
        own_lens = [ln for (ln, _, o) in d2.requests.values() if o]
        entries, mx = self._span_stats(d2)
        return self.perf.tps(d2.batch_size + extra,
                             own_lens + [self.avg_new_len] * extra,
                             offloaded_tokens=d2.offloaded_tokens,
                             hosted_tokens=d2.hosted_tokens,
                             span_entries=entries, max_span_tokens=mx)

    def _striped_gain(self, d: InstanceView, cands: List[InstanceView],
                      rid: int, splits: List[Tuple[int, int]]) -> float:
        """Modeled aggregate TPS delta of applying a whole striped
        placement (every leg at once, Eq. 6/7 plus span merge cost)."""
        base = self._inst_tps(d) + sum(self._inst_tps(c) for c in cands)
        d2 = d.copy()
        c2s = {i: cands[i].copy() for i, _ in splits}
        for i, n in splits:
            self._apply_leg(d2, c2s[i], rid, n)
        tok = sum(n for _, n in splits) * self.bs
        d_new = self._debtor_tps_after(d2, d.batch_size, tok)
        after = d_new + sum(self._inst_tps(c2s.get(i, c))
                            for i, c in enumerate(cands))
        gain = after - base
        # Spill penalty: legs that overflow a creditor's plain headroom
        # displace unpinned cache replicas, whose frames must cross the
        # host link (D2H) before the leg's blocks land. Charged
        # un-overlapped and amortized over reclaim_horizon_s — the same
        # units as ``_reclaim_pays`` — so cache-displacing placements
        # only win when the freed-memory gain clearly beats re-warming.
        for i, n in splits:
            c = cands[i]
            overflow = min(n - self._creditor_cap(c, with_cache=False),
                           c.cache_blocks)
            if overflow > 0:
                t_spill = self.perf.t_host_transfer(overflow * self.bs)
                gain -= t_spill * self._inst_tps(c) / \
                    self.reclaim_horizon_s
        return gain

    def modeled_aggregate_tps(self, views: List[InstanceView],
                              moves: List[StripedMove]) -> float:
        """Aggregate modeled cluster TPS (Eq. 7) after applying
        ``moves`` to copies of ``views`` — the planner's own objective,
        batch-growth credit included. Public so benchmarks and monitors
        score plans with exactly the model the planner optimizes.
        Only offload moves are applied (reclaim application needs the
        owner-resolution bookkeeping internal to planning)."""
        work = {v.inst_id: v.copy() for v in views}
        moved_tok: Dict[int, int] = {}
        base_batch = {v.inst_id: v.batch_size for v in views}
        for mv in moves:
            if mv.kind != "offload":
                continue
            for leg in mv.legs:
                self._apply_leg(work[mv.src], work[leg.dst],
                                mv.req_id, leg.num_blocks)
                moved_tok[mv.src] = moved_tok.get(mv.src, 0) + \
                    leg.num_blocks * self.bs
        total = 0.0
        for iid, v in work.items():
            if iid in moved_tok:
                total += self._debtor_tps_after(v, base_batch[iid],
                                                moved_tok[iid])
            else:
                total += self._inst_tps(v)
        return total

    # ------------------------------------------------------------------ #
    def _plan_offloads(self, debtors: List[InstanceView],
                       creditors: List[InstanceView],
                       urgency: Dict[int, float]) -> List[StripedMove]:
        moves: List[StripedMove] = []
        for d in debtors:
            if not d.requests or len(moves) >= self.max_moves:
                continue
            # The debtor's most urgent owned request (frontend priority
            # + deadline proximity), length as the tie-break — without
            # lifecycle metadata this reduces to the original
            # longest-request pick.
            owned = [(rid, ln, blk) for rid, (ln, blk, own)
                     in d.requests.items() if own and blk > 1]
            if not owned:
                continue
            rid, _, rblocks = max(
                owned, key=lambda t: (urgency.get(t[0], 0.0), t[1]))
            block_budget = rblocks - 1          # keep the live tail local
            # Candidate creditors, emptiest first, capped at max_stripes
            # (headroom-capped: never fill a creditor past what leaves
            # its own running requests room to grow).
            cands = sorted((c for c in creditors
                            if self._creditor_cap(c) > 0),
                           key=lambda v: v.mem_util)[:self.max_stripes]
            cap_total = min(block_budget,
                            sum(self._creditor_cap(c) for c in cands))
            if cap_total <= 0:
                continue
            # Search the TOTAL moved-block count; each candidate total is
            # split greedily into per-(creditor, k) legs and the whole
            # striped placement is scored at once — per-leg marginal
            # gains miss moves that only pay off past one creditor's
            # capacity, which is exactly the striping case.
            best_splits, best_gain = None, 0.0
            step = max(1, cap_total // 16)
            for k in range(step, cap_total + 1, step):
                splits = self._split_blocks(k, cands)
                g = self._striped_gain(d, cands, rid, splits)
                if g > best_gain:
                    best_splits, best_gain = splits, g
            if not best_splits:
                continue
            for i, n in best_splits:
                self._apply_leg(d, cands[i], rid, n)
            moves.append(StripedMove(
                rid, d.inst_id,
                [SpanLeg(cands[i].inst_id, n) for i, n in best_splits]))
            creditors.sort(key=lambda v: v.mem_util)
        return moves

    def _apply_reclaim(self, by_id: Dict[int, InstanceView], host_id: int,
                       owner_id: Optional[int], rid: int, blk: int,
                       legs: List[SpanLeg]) -> None:
        """Mutate views as if host ``host_id`` evicted rid's ``blk``-block
        hosted span along ``legs`` (owner re-adopt and/or sideways)."""
        h = by_id[host_id]
        owner = by_id.get(owner_id) if owner_id is not None else None
        h.hosted_tokens -= blk * self.bs
        h.mem_blocks_used -= blk
        del h.requests[rid]
        for leg in legs:
            dst = by_id[leg.dst]
            dst.mem_blocks_used += leg.num_blocks
            if owner is not None and leg.dst == owner.inst_id:
                owner.offloaded_tokens -= leg.num_blocks * self.bs
                ln, b0, own = owner.requests[rid]
                owner.requests[rid] = (ln, b0 + leg.num_blocks, own)
            else:
                dst.hosted_tokens += leg.num_blocks * self.bs
            if owner is not None:
                spans = owner.req_spans.setdefault(rid, {})
                spans.pop(host_id, None)
                if leg.dst != owner.inst_id:
                    spans[leg.dst] = spans.get(leg.dst, 0) + \
                        leg.num_blocks

    def _reclaim_pays(self, by_id: Dict[int, InstanceView], host_id: int,
                      owner_id: Optional[int], rid: int, blk: int,
                      legs: List[SpanLeg]) -> bool:
        """Eq. 5-7 gain check for one reclaim candidate: undo a stripe
        only when the modeled aggregate tps gain, amortized over
        ``reclaim_horizon_s``, exceeds the movement cost.

        Gain is scored on copies of the involved views exactly like an
        offload plan — including the batch-growth credit of the host's
        freed blocks (relieving a stressed host is worth admitted work,
        not just lower utilization). Cost is the decode the source and
        destinations forgo while the span's bytes cross the link,
        charged UN-overlapped — conservative now that the runtime
        overlaps movement with compute, so marginal evictions stay
        filtered (the anti-thrash hysteresis) while clearly-paying ones
        pass."""
        involved = {host_id} | {leg.dst for leg in legs}
        if owner_id is not None:
            involved.add(owner_id)
        copies = {i: by_id[i].copy() for i in involved}
        before = sum(self._inst_tps(v) for v in copies.values())
        self._apply_reclaim(copies, host_id, owner_id, rid, blk, legs)
        freed_tok = blk * self.bs
        after = 0.0
        for i, v in copies.items():
            if i == host_id:
                after += self._debtor_tps_after(
                    v, by_id[i].batch_size, freed_tok)
            else:
                after += self._inst_tps(v)
        gain = after - before
        if gain <= 0.0:
            return False
        move_bytes = freed_tok * self.perf.kv_bytes_per_token_layer() \
            * self.perf.cfg.num_layers
        t_move = move_bytes / self.perf.hw.ici_link_bw
        busy = {host_id} | {leg.dst for leg in legs}
        lost_tokens = t_move * sum(self._inst_tps(by_id[i]) for i in busy)
        return gain * self.reclaim_horizon_s >= lost_tokens

    def _plan_reclaims(self, views: List[InstanceView],
                       stressed: List[InstanceView],
                       creditors: List[InstanceView]) -> List[StripedMove]:
        """Symmetric path: a memory-stressed host evicts hosted spans
        back to their owners (preferred) or sideways to calm creditors.

        Eviction stops as soon as the host is back under the creditor
        threshold — relief, not a purge — which together with the
        stress trigger sitting ABOVE that threshold (see ``plan``)
        gives the offload/reclaim pair a hysteresis band instead of a
        copy ping-pong at the margin. The trigger only NOMINATES spans:
        each candidate must additionally pass the ``_reclaim_pays``
        Eq. 5-7 gain-vs-move-cost check, so a stripe is undone only
        when reclaiming it is modeled to pay for its own copies."""
        by_id = {v.inst_id: v for v in views}
        moves: List[StripedMove] = []
        for h in stressed:
            hosted = [(rid, blk) for rid, (ln, blk, own)
                      in h.requests.items() if not own and blk > 0]
            if not hosted:
                continue
            # Evict the smallest spans first: cheapest relief per move.
            hosted.sort(key=lambda t: t[1])
            for rid, blk in hosted:
                if len(moves) >= self.max_moves or \
                        h.mem_util <= self.mem_util_thres:
                    break                # relieved — stop evicting
                owner = next((v for v in views
                              if v.requests.get(rid, (0, 0, False))[2]),
                             None)
                owner_id = owner.inst_id if owner is not None else None
                legs: List[SpanLeg] = []
                remaining = blk
                # Preferred: back to the owner if it has real headroom
                # (it must stay under the creditor threshold afterwards).
                if owner is not None and owner.inst_id != h.inst_id:
                    room = owner.free_blocks
                    after = (owner.mem_blocks_used + remaining) / \
                        max(1, owner.mem_blocks_total)
                    if room >= remaining and after <= self.mem_util_thres:
                        legs.append(SpanLeg(owner.inst_id, remaining))
                        remaining = 0
                # Sideways: stripe what's left across calm creditors.
                if remaining > 0:
                    for c in sorted(creditors, key=lambda v: v.mem_util):
                        if remaining <= 0 or \
                                len(legs) >= self.max_stripes:
                            break
                        if c.inst_id == h.inst_id or \
                                (owner is not None
                                 and c.inst_id == owner.inst_id):
                            continue
                        # Reclaims stay within plain free headroom: a
                        # relief move must not itself trash a cache.
                        take = min(remaining,
                                   self._creditor_cap(c, with_cache=False))
                        if take <= 0:
                            continue
                        legs.append(SpanLeg(c.inst_id, take))
                        remaining -= take
                if not legs or remaining > 0:
                    continue                 # nowhere to put the span
                if not self._reclaim_pays(by_id, h.inst_id, owner_id,
                                          rid, blk, legs):
                    continue                 # relief would cost > it gains
                self._apply_reclaim(by_id, h.inst_id, owner_id, rid, blk,
                                    legs)
                moves.append(StripedMove(rid, h.inst_id, legs,
                                         kind="reclaim"))
        return moves

    def plan(self, views: List[InstanceView],
             urgency: Optional[Dict[int, float]] = None
             ) -> List[StripedMove]:
        """One Algorithm-1 round: offload stressed debtors, reclaim
        stressed creditors; returns the striped move plans in order."""
        # Work on copies: the caller's heartbeat-fed views stay pristine
        # so the gManager can re-plan from the same state.
        urgency = urgency or {}
        views = [v.copy() for v in views if v.alive]
        # Quarantine hardening: a dead rank's view is excluded above,
        # and any STALE span entry naming a non-alive creditor is
        # stripped from the survivors' placement maps — it must not be
        # scored as a merge cost, a reclaim source, or a stripe target.
        alive_ids = {v.inst_id for v in views}
        for v in views:
            v.req_spans = {rid: kept
                           for rid, spans in v.req_spans.items()
                           if (kept := {i: b for i, b in spans.items()
                                        if i in alive_ids})}

        def inst_urgency(v: InstanceView) -> float:
            """Most urgent owned request on ``v`` (0 if none)."""
            return max((urgency.get(rid, 0.0)
                        for rid, (_, _, own) in v.requests.items()
                        if own), default=0.0)
        # A debtor must have something to offload: an idle instance with
        # no owned requests is a creditor candidate, not a debtor.
        # Near-deadline/high-priority debtors are planned first so they
        # get creditor capacity before best-effort ones exhaust it.
        debtors = sorted([v for v in views
                          if v.batch_size <= self.beta_thres
                          and any(own for (_, _, own)
                                  in v.requests.values())],
                         key=lambda v: (-inst_urgency(v), v.batch_size))
        creditors = sorted([v for v in views
                            if v.mem_util <= self.mem_util_thres],
                           key=lambda v: v.mem_util)
        # An instance never acts as both (paper §5.2).
        debtor_ids = {d.inst_id for d in debtors}
        creditors = [c for c in creditors if c.inst_id not in debtor_ids]
        # Reclaim first: hosts that crossed the STRESS threshold while
        # holding others' spans free their own headroom before new
        # offloads are planned onto the remaining creditors. The stress
        # trigger sits halfway between the creditor threshold and full:
        # an instance stops being a creditor at mem_util_thres but is
        # only force-relieved above this band (hysteresis against
        # offload/reclaim ping-pong right at the threshold).
        stress_thres = (self.mem_util_thres + 1.0) / 2
        stressed = [v for v in views
                    if v.hosted_tokens > 0
                    and v.mem_util > stress_thres]
        moves = self._plan_reclaims(views, stressed, creditors)
        creditors.sort(key=lambda v: v.mem_util)
        moves += self._plan_offloads(debtors, creditors, urgency)
        return moves[:self.max_moves]
