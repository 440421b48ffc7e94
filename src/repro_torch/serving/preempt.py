"""Overload survival: preemptive pause/host-spill scheduling.

Under sustained overload the admission queue alone starves
deadline-critical arrivals: every slot and pool block is held by
already-running (possibly long-context, best-effort) requests, and the
debtor/creditor machinery only moves memory BETWEEN instances — it
cannot make room that does not exist. Medha-style preemption does: the
``Preemptor`` stops a running request at a step boundary, spills its
whole KV chain (local blocks AND creditor-hosted spans, in token
order) byte-for-byte into a dedicated pinned ``HostKVTier``, and
releases every device resource it held — the slot, the local blocks,
the cache pins, and the creditor spans (through the same
finished-event / ``drop_hosted`` discipline every terminal path uses,
exactly once). The request itself survives as ``PAUSED`` with its
prompt/output/stream state intact.

Resume is re-admission through the paged path WITHOUT recompute: the
preemptor reserves a fresh placement (local tail blocks; overflow
striped onto creditors via the reserve-then-stream ``prefix_sink``),
uploads the saved frames H2D into the reserved blocks, and re-installs
the request in a slot — the next decode step feeds ``output[-1]`` over
byte-identical KV, so a preempted-then-resumed request emits exactly
the tokens an unpreempted oracle would (the bench_overload correctness
gate, in both per-instance and global-pool modes). On the card the
spill is an asynchronous D2H copy into pinned host frames on the tier's
side stream, and the resume an H2D upload on the compute stream (see
``hosttier``).

Victim selection is SLO-aware (``GreedyScheduler.victim_slack_s``):
slack = deadline - now - predicted finish (Eq. 5-7 over the gManager's
heartbeat views), charged the spill+resume round-trip
(``t_preempt_roundtrip``). Only victims whose charged slack stays
above ``OverloadPolicy.victim_min_slack_s`` — no-deadline requests
have infinite slack and go first — are paused, and only for queued
requests that out-rank them, so heavy-tail overload degrades the
slackest requests first and p99-critical ones last.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.config import OverloadPolicy
from repro_torch.serving.faults import FrameCorruptionError, TransferError
from repro_torch.serving.hosttier import HostKVTier
from repro_torch.serving.request import Request, RequestState


@dataclass
class PreemptStats:
    """Counters for the pause/spill/resume lifecycle."""

    preemptions: int = 0         # successful pauses
    resumes: int = 0             # successful resumes
    failed_pauses: int = 0       # refused (tier full / not pausable)
    failed_resumes: int = 0      # attempted but no capacity yet
    spilled_blocks: int = 0      # frames written to the preempt tier
    fetched_blocks: int = 0      # frames uploaded back on resume
    spilled_tokens: int = 0      # resident KV tokens across pauses


@dataclass
class _PausedRecord:
    """Book-keeping for one parked request: how much KV its host-tier
    frames hold (``(req_id, i)`` keys, chain order) and when it was
    paused (anti-thrash / resume ordering)."""

    req: Request
    n_tokens: int
    n_frames: int
    paused_at: float
    # Remote span layout of the chain at pause, chain order, as
    # (inst_id, n_blocks) runs. Resume reproduces this local/creditor
    # partition so the LSE-merge grouping — and therefore the greedy
    # argmax — matches the unpreempted run exactly, not just up to
    # reduction-order float drift.
    remote_layout: List[Tuple[int, int]]


class Preemptor:
    """Pause/spill/resume orchestrator over a cluster's engines.

    Owns a DEDICATED ``HostKVTier`` (``preempt_host_blocks`` frames,
    all pinned while their request is parked) separate from the prefix
    cache's tier: paused KV must always be resumable, so it never
    competes with cache watermark eviction. The frontend drives policy
    (``pause_for`` when urgent arrivals lack slots); ``maybe_resume``
    runs inside every cluster step and re-admits parked requests as
    capacity frees up — most urgent first, never stealing capacity a
    more urgent queued request (``queue_pressure``) is waiting for.
    ``cluster`` is held as given: the ``Cluster`` passes a weak proxy of
    itself (it owns the preemptor).
    """

    def __init__(self, cluster, policy: OverloadPolicy):
        self.cluster = cluster
        self.policy = policy
        # Watermarks at 1.0: eviction never runs below hard capacity —
        # every resident frame is pinned anyway while its request is
        # paused, so LRU pressure has nothing it may legally evict.
        fpol = cluster.config.faults
        self.tier = HostKVTier(policy.preempt_host_blocks,
                               high_watermark=1.0, low_watermark=1.0,
                               verify=fpol.verify_host_frames,
                               max_retries=fpol.max_transfer_retries,
                               backoff_base_s=fpol.retry_backoff_base_s,
                               backoff_max_s=fpol.retry_backoff_max_s)
        self.paused: Dict[int, _PausedRecord] = {}
        self.stats = PreemptStats()
        # Best urgency among the frontend's still-queued requests (set
        # by the server each step; None = no queue). A parked request
        # only resumes if it out-ranks this — otherwise the freed
        # capacity belongs to the queue and resuming would just get it
        # preempted again (thrash).
        self.queue_pressure: Optional[float] = None
        # The clock of pause stamps and the resume gate when no ``now``
        # is given (under a mesh the cluster installs its step's agreed
        # reading, as for its engines).
        self.clock: Callable[[], float] = time.monotonic

    # --- pause --------------------------------------------------------- #
    def is_paused(self, req_id: int) -> bool:
        """True while ``req_id`` is parked in the preempt tier."""
        return req_id in self.paused

    def _live_engines(self):
        cl = self.cluster
        return [e for i, e in cl.engines.items() if i not in cl._dead]

    def _owner_of(self, req: Request):
        if req.slot is None:
            return None
        for eng in self._live_engines():
            if req.slot < len(eng.slots) and \
                    eng.slots[req.slot] is req:
                return eng
        return None

    def pause(self, req: Request, now: Optional[float] = None) -> bool:
        """Stop a RUNNING request at this step boundary and spill its
        KV chain to the preempt tier.

        All-or-nothing: the chain's frames are read (cross-engine for
        creditor spans) and stored/pinned BEFORE any device state is
        released; a tier without room refuses the pause and the request
        keeps running untouched. On success the owner releases the
        slot/blocks/cache pins and every creditor-hosted span is
        dropped exactly once (immediately here; the finished-event
        drain at step end sees ``is_hosting`` false and no-ops).
        Returns True when the request is now PAUSED."""
        now = self.clock() if now is None else now
        rid = req.req_id
        owner = self._owner_of(req)
        if (owner is None or req.state is not RequestState.RUNNING
                or req.cancelled or rid in self.paused
                or not owner._can_pool):
            self.stats.failed_pauses += 1
            return False
        got = owner.read_chain_frames(req)
        if got is None:
            self.stats.failed_pauses += 1
            return False
        n_tokens, frames = got
        # Record the chain's creditor runs (chain order) so resume can
        # reproduce the exact local/remote partition.
        remote_layout: List[List[int]] = []
        for inst, _b in owner.chain_of(req):
            if inst == owner.inst_id:
                continue
            if remote_layout and remote_layout[-1][0] == inst:
                remote_layout[-1][1] += 1
            else:
                remote_layout.append([inst, 1])
        if self.tier.free_blocks < len(frames):
            self.stats.failed_pauses += 1
            return False
        # Tag the spill on the cluster's stager: the D2H chain overlaps
        # decode like every other movement, bounded by the same double
        # buffer ("preempt_spill" gets its own stall counters).
        self.cluster.stager.stage(frames[-1], tag="preempt_spill")
        for i, (k, v) in enumerate(frames):
            ok = self.tier.put((rid, i), k, v)
            assert ok, "preempt tier refused despite free_blocks check"
            self.tier.pin((rid, i))
        owner.finalize_pause(req, now=now)
        for eng in self._live_engines():
            if eng.rmanager.is_hosting(rid):
                eng.drop_hosted(rid)
        self.paused[rid] = _PausedRecord(
            req, n_tokens, len(frames), now,
            [(i, n) for i, n in remote_layout])
        self.stats.preemptions += 1
        self.stats.spilled_blocks += len(frames)
        self.stats.spilled_tokens += n_tokens
        return True

    # --- SLO-aware victim selection ------------------------------------ #
    def rank_victims(self, now: float) -> List[Tuple[float, Request]]:
        """Preemption candidates as ``(slack_s, request)``, most
        preemptible first (largest charged slack, then cheapest spill).

        Built from the gManager's heartbeat views: per-instance
        batch/lengths feed the Eq. 5-7 predicted-finish, and each
        candidate's slack is charged its own spill+resume round trip
        (``victim_slack_s``). Requests out of pause budget
        (``max_preemptions``), about to finish, or whose chain could
        not be re-placed on resume (a spanning chain needs a creditor)
        are not candidates."""
        cl = self.cluster
        sched = cl.gmanager.scheduler
        views = {v.inst_id: v for v in cl.gmanager._views()}
        live = self._live_engines()
        out: List[Tuple[float, int, Request]] = []
        for eng in live:
            if not eng._can_pool:
                continue
            view = views.get(eng.inst_id)
            if view is None:
                continue
            bs = eng.block_size
            for r in eng.running:
                if (r.state is not RequestState.RUNNING or r.cancelled
                        or r.preemptions >= self.policy.max_preemptions):
                    continue
                remaining = r.sampling.max_new_tokens - len(r.output)
                if remaining <= 0:
                    continue
                rb = eng.rmanager.pool.requests.get(r.req_id)
                chain = eng.chain_of(r)
                if rb is None or not chain:
                    continue
                resident = (len(chain) - 1) * bs + rb.tail_tokens
                # A chain too long to sit locally resumes via creditor
                # striping — infeasible with no other live instance.
                if resident > eng.max_local_len - bs and len(live) < 2:
                    continue
                slack = sched.victim_slack_s(view, resident, remaining,
                                             r.deadline_at, now)
                out.append((slack, resident, r))
        out.sort(key=lambda t: (-t[0], t[1]))
        return [(s, r) for s, _, r in out]

    def pause_for(self, queued: Request,
                  now: Optional[float] = None) -> Optional[int]:
        """Free one slot for ``queued`` by pausing the best victim.

        A victim is eligible only when the queued request out-ranks it
        (``urgency``: priority strictly dominates, then deadline
        proximity) AND its charged slack stays above
        ``victim_min_slack_s`` — the victim is still expected to meet
        its own SLO after the detour. Returns the instance id whose
        slot was freed (so the caller can dispatch ``queued`` straight
        into it), or None when no victim is eligible."""
        now = self.clock() if now is None else now
        qu = queued.urgency(now)
        for slack, victim in self.rank_victims(now):
            if slack < self.policy.victim_min_slack_s:
                continue
            if qu <= victim.urgency(now):
                continue
            owner = self._owner_of(victim)
            if owner is not None and self.pause(victim, now=now):
                return owner.inst_id
        return None

    # --- resume -------------------------------------------------------- #
    def _resume_one(self, rec: _PausedRecord) -> bool:
        """Try to re-admit one parked request on some live engine."""
        req, rid = rec.req, rec.req.req_id
        # Engines with spare capacity first; never steal a slot an
        # already-dispatched (engine-waiting) request is about to take.
        # Checked BEFORE fetching: a parked request retries every step,
        # and each fetch reads (and verifies) its whole chain.
        cands = [e for e in self._live_engines()
                 if e._can_pool and not e.waiting
                 and e._free_slot() is not None]
        if not cands:
            self.stats.failed_resumes += 1
            return False
        frames = []
        try:
            for i in range(rec.n_frames):
                f = self.tier.get((rid, i))
                assert f is not None, "pinned preempt frame evicted"
                frames.append(f)
        except (TransferError, FrameCorruptionError):
            # A parked frame that cannot be fetched (or fails hash
            # verification) makes a byte-identical restore impossible —
            # fall back to token-replay recovery: drop the record and
            # re-admit via re-prefill of the known tokens (never resume
            # over wrong KV).
            for i in range(rec.n_frames):
                self.tier.drop((rid, i))
            self.paused.pop(rid, None)
            self.stats.failed_resumes += 1
            self.cluster._recover_via_replay(req)
            return False
        cands.sort(key=lambda e: -e.rmanager.effective_free)
        for eng in cands:
            if eng.resume_paused(req, rec.n_tokens, frames,
                                 remote_layout=rec.remote_layout):
                self.cluster.stager.stage(eng.kv_store,
                                          tag="preempt_fetch")
                for i in range(rec.n_frames):
                    self.tier.drop((rid, i))
                self.paused.pop(rid, None)
                self.stats.resumes += 1
                self.stats.fetched_blocks += rec.n_frames
                return True
        self.stats.failed_resumes += 1
        return False

    def maybe_resume(self, now: Optional[float] = None) -> int:
        """Resume parked requests that capacity (and the queue) allows.

        Called once per cluster step: most urgent first, oldest pause
        as the tie-break; a record younger than ``min_pause_s`` or
        out-ranked by ``queue_pressure`` stays parked. Returns how many
        requests were resumed."""
        if not self.paused:
            return 0
        now = self.clock() if now is None else now
        made = 0
        order = sorted(self.paused.values(),
                       key=lambda rec: (-rec.req.urgency(now),
                                        rec.paused_at))
        for rec in order:
            if rec.req.cancelled:
                self.cancel_paused(rec.req.req_id)
                continue
            if now - rec.paused_at < self.policy.min_pause_s:
                continue
            if self.queue_pressure is not None and \
                    rec.req.urgency(now) < self.queue_pressure:
                continue
            if self._resume_one(rec):
                made += 1
        return made

    # --- terminal path -------------------------------------------------- #
    def cancel_paused(self, req_id: int) -> bool:
        """Cancel a PARKED request: drop its tier frames and retire it
        terminally (device state was already released at pause)."""
        rec = self.paused.pop(req_id, None)
        if rec is None:
            return False
        for i in range(rec.n_frames):
            self.tier.drop((req_id, i))
        req = rec.req
        req.cancelled = True
        req.state = RequestState.CANCELLED
        req.finish_time = time.monotonic()
        return True


__all__ = ["Preemptor", "PreemptStats"]
