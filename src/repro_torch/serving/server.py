"""Request-lifecycle serving frontend: ``LLMServer`` + ``RequestHandle``.

The paper's whole subject is DYNAMIC traffic — requests with wildly
different context lengths arriving, growing, and finishing at different
times — so the public serving API is a request lifecycle, not a step
loop:

    server = LLMServer(params, cfg, ServingConfig.h100())  # on "cuda"
    h = server.submit(prompt, SamplingParams(max_new_tokens=32),
                      priority=1, deadline_s=2.0)
    for tok in h.tokens():          # incremental stream (engine emits)
        ...
    h.result(); h.status; h.metrics; h.cancel()

and an OPEN-LOOP event pump for trace-driven evaluation:

    stats = server.run(arrivals, until=30.0)
    stats["ttft_p99"], stats["tbt_p99"], ...

``submit`` applies admission backpressure (a bounded waiting queue with
a reject-vs-queue policy from ``ServingConfig``); the dispatcher orders
waiting requests by priority and deadline proximity and feeds the same
urgency into the gManager's Algorithm-1 planning, so near-deadline
debtors are offloaded/served first. Cancellation propagates through
every layer (engine slot, in-flight streaming prefill, creditor-hosted
spans, planned moves) — see ``Cluster.cancel``.

With ``ServingConfig.overload.enabled`` the frontend also survives
sustained overload instead of queueing through it: when urgent arrivals
find zero free slots, ``_overload_control`` pauses SLO-slack victims
(their KV spills byte-for-byte to a pinned host tier — see
``repro_torch.serving.preempt``) and hands the freed slots to the
arrivals; parked requests resume with byte-identical KV once capacity
returns. Every ``submit`` additionally feeds the gManager's EWMA arrival
estimator, which replaces the static ``avg_new_req_len`` knob in
Algorithm 1's planning.

A handle holds its server; the server holds only the requests (never a
handle), so a dropped server with no live handle frees its cluster —
weights and pools — at once.

The cluster's ``step()`` loop still exists underneath — it is the
INTERNAL execution engine this frontend drives.

``LLMServer(..., mesh=, layout=)`` serves with the global pool sharded
over the processes of a ``torch.distributed`` job (see the
``repro_torch.serving`` package docstring): every process makes the same
calls in the same order, and the clock every decision reads (arrival
stamps, dispatch urgency) is the one the processes agree on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.perfmodel import InstancePerfModel
from repro_torch.serving.request import (Request, RequestIdAllocator,
                                   RequestState, SamplingParams)


@dataclass
class Arrival:
    """One trace event for the open-loop pump: a prompt that becomes
    available for admission at ``at`` seconds after ``run()`` starts."""
    at: float
    prompt: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    priority: int = 0
    deadline_s: Optional[float] = None


class RequestHandle:
    """Caller's view of one submitted request's lifecycle."""

    def __init__(self, server: "LLMServer", req: Request):
        self._server = server
        self._req = req

    @property
    def req_id(self) -> int:
        """The underlying request's id."""
        return self._req.req_id

    @property
    def status(self) -> RequestState:
        """Current lifecycle state of the request."""
        return self._req.state

    @property
    def done(self) -> bool:
        """True once the request reached a terminal state."""
        return self._req.done

    def tokens(self, max_steps: int = 100_000) -> Iterator[int]:
        """Incremental token stream, backed by the engine's emit path.

        Yields every token already generated, then drives the server
        until the next token lands (or the request reaches a terminal
        state). Safe to interleave with other handles' iterators — each
        ``server.step()`` advances EVERY in-flight request.
        """
        seen = 0
        steps = 0
        while True:
            out = self._req.output
            while seen < len(out):
                yield out[seen]
                seen += 1
            if self._req.done:
                return
            if steps >= max_steps:
                raise RuntimeError(
                    f"req {self._req.req_id} made no progress in "
                    f"{max_steps} steps (state={self._req.state})")
            self._server.step()
            steps += 1

    def result(self, max_steps: int = 100_000) -> List[int]:
        """Block (drive the server) until terminal; return the output
        tokens. Raises on FAILED; a CANCELLED request returns whatever
        it produced before the cancel."""
        for _ in self.tokens(max_steps=max_steps):
            pass
        if self._req.state == RequestState.FAILED:
            raise RuntimeError(f"req {self._req.req_id} failed "
                               f"(pool exhaustion or infeasible placement)")
        return list(self._req.output)

    def cancel(self) -> bool:
        """Cancel this request wherever it is in its lifecycle."""
        return self._server.cancel(self._req.req_id)

    @property
    def metrics(self) -> Dict[str, float]:
        """Per-request latency metrics (seconds, monotonic domain):
        ``ttft`` (first token after arrival), ``tbt_mean``/``tbt_max``
        over inter-token gaps, ``e2e`` (arrival -> terminal), plus the
        raw ``arrival_time``/``finish_time`` stamps."""
        r = self._req
        out: Dict[str, float] = {
            "arrival_time": r.arrival_time,
            "finish_time": r.finish_time if r.finish_time is not None
            else float("nan"),
            "n_tokens": float(len(r.output)),
        }
        tt = r.token_times
        out["ttft"] = (tt[0] - r.arrival_time) if tt else float("nan")
        gaps = np.diff(tt) if len(tt) >= 2 else np.asarray([])
        out["tbt_mean"] = float(gaps.mean()) if gaps.size else float("nan")
        out["tbt_max"] = float(gaps.max()) if gaps.size else float("nan")
        out["e2e"] = (r.finish_time - r.arrival_time) \
            if r.finish_time is not None else float("nan")
        return out


class LLMServer:
    """Serving frontend: admission queue + dispatcher over a Cluster."""

    def __init__(self, params, cfg: ModelConfig,
                 config: Optional[ServingConfig] = None, *,
                 perf: Optional[InstancePerfModel] = None, device=None,
                 mesh=None, layout=None):
        self.config = config if config is not None else ServingConfig()
        self.cluster = Cluster(params, cfg, self.config, perf=perf,
                               device=device, mesh=mesh, layout=layout)
        self._ids = RequestIdAllocator()
        self._requests: Dict[int, Request] = {}   # submitted, unreaped
        self._queue: List[Request] = []      # admitted, not yet dispatched
        self.rejected: int = 0               # bounded-queue rejections

    # --- submission ---------------------------------------------------- #
    def submit(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None, *,
               priority: int = 0, deadline_s: Optional[float] = None,
               arrival_time: Optional[float] = None) -> RequestHandle:
        """Admit one request; returns its lifecycle handle.

        Backpressure: when the waiting queue is at ``config.max_waiting``
        the ``admission_policy`` decides — "queue" accepts anyway (the
        bound only throttles DISPATCH), "reject" retires the request
        immediately as FAILED (open-loop load shedding; the handle's
        status says so and ``server.rejected`` counts them).
        """
        req = Request(prompt=list(prompt),
                      sampling=sampling if sampling is not None
                      else SamplingParams(),
                      req_id=self._ids.next_id(),
                      priority=priority, deadline_s=deadline_s)
        req.arrival_time = self.cluster.clock(arrival_time)
        handle = RequestHandle(self, req)
        self._requests[req.req_id] = req
        # Every arrival (even one about to be shed) feeds the gManager's
        # EWMA traffic estimator: expected KV footprint is the prompt
        # plus the decode budget — the worst case the pool must plan for.
        self.cluster.gmanager.observe_arrival(
            req.arrival_time,
            len(req.prompt) + req.sampling.max_new_tokens)
        if (self.config.admission_policy == "reject"
                and self._waiting_count() >= self.config.max_waiting):
            req.state = RequestState.FAILED
            req.finish_time = time.monotonic()
            self.rejected += 1
            return handle
        self._queue.append(req)
        return handle

    def cancel(self, req_id: int) -> bool:
        """Cancel a request whether it is still queued here or already
        inside the cluster."""
        for req in self._queue:
            if req.req_id == req_id:
                self._queue.remove(req)
                req.cancelled = True
                req.state = RequestState.CANCELLED
                req.finish_time = time.monotonic()
                return True
        return self.cluster.cancel(req_id)

    # --- dispatch ------------------------------------------------------ #
    def _waiting_count(self) -> int:
        return len(self._queue) + sum(
            len(e.waiting) for i, e in self.cluster.engines.items()
            if i not in self.cluster._dead)

    def _free_slots(self) -> int:
        """Cluster-wide dispatch budget: each live engine contributes
        the slots its own waiting queue has not already claimed (an
        overloaded engine contributes zero — it never cancels another
        engine's free capacity)."""
        free = 0
        for i, eng in self.cluster.engines.items():
            if i in self.cluster._dead:
                continue
            free += max(0, sum(1 for s in eng.slots if s is None)
                        - len(eng.waiting))
        return free

    def _dispatch(self, now: Optional[float] = None) -> None:
        """Hand queued requests to the cluster, most urgent first, only
        as many as have a real chance of a slot this step (admission
        backpressure — queued work stays HERE, reorderable by urgency,
        instead of piling into the engines' FCFS queues)."""
        if not self._queue:
            return
        now = self.cluster.clock() if now is None else now
        budget = self._free_slots()
        if budget <= 0:
            return
        self._queue.sort(key=lambda r: (-r.urgency(now), r.arrival_time))
        for req in self._queue[:budget]:
            self.cluster.submit(req, now=now)
        del self._queue[:budget]

    def _overload_control(self, now: float) -> None:
        """Preempt-for-queue: when dispatch left urgent requests queued
        with zero free slots, pause SLO-slack victims to make room.

        Runs after ``_dispatch`` each step (no-op unless the overload
        policy is enabled). Each queued request, most urgent first, asks
        the preemptor for a victim it out-ranks whose charged slack
        survives the detour; the victim's freed slot takes the queued
        request directly (``submit_to``), pairing preemption with the
        arrival that justified it. The preemptor's resume path is told
        the remaining queue's best urgency (``queue_pressure``) so
        parked requests never steal capacity the queue is entitled to."""
        pre = self.cluster.preemptor
        if pre is None:
            return
        if not self._queue:
            pre.queue_pressure = None
            return
        if self._free_slots() <= 0:
            self._queue.sort(
                key=lambda r: (-r.urgency(now), r.arrival_time))
            for req in list(self._queue):
                inst = pre.pause_for(req, now=now)
                if inst is None:
                    break           # no eligible victim for anyone less
                self._queue.remove(req)
                self.cluster.submit_to(req, inst, now=now)
        pre.queue_pressure = max(
            (r.urgency(now) for r in self._queue), default=None)

    # --- execution ----------------------------------------------------- #
    def step(self, now: Optional[float] = None) -> int:
        """One frontend iteration: dispatch, overload control (paused
        victims / preempted slots when enabled), then one cluster step."""
        now = self.cluster.clock(now)
        self._dispatch(now)
        self._overload_control(now)
        return self.cluster.step(now=now, agreed=True)

    def drain(self, max_steps: int = 10_000) -> int:
        """Drive until every submitted request is terminal (closed-loop
        convenience for examples/tests). Returns steps taken."""
        steps = 0
        active = [r for r in self._requests.values() if not r.done]
        while steps < max_steps:
            active = [r for r in active if not r.done]
            if not active:
                break
            self.step()
            steps += 1
        return steps

    def evict_terminal(self) -> int:
        """Drop terminal requests from the server/cluster maps so a
        long-lived server does not retain every prompt/output forever.
        Handles the caller still holds stay valid — they reference the
        Request directly. Returns how many were evicted."""
        gone = [rid for rid, r in self._requests.items() if r.done]
        for rid in gone:
            self._requests.pop(rid, None)
            self.cluster.requests.pop(rid, None)
        return len(gone)

    @property
    def handles(self) -> List[RequestHandle]:
        """Live (unreaped) request handles, including queued ones."""
        return [RequestHandle(self, r) for r in self._requests.values()]

    @property
    def metrics(self) -> Dict[str, float]:
        """Cluster-wide occupancy counters: device-pool blocks (total /
        used / free), prefix-cache footprint (device replicas, pinned by
        live requests), host-tier occupancy, cumulative spill / prefetch /
        hit traffic, overload-survival counters, the KV bytes moved
        between instances, the live traffic estimate feeding Algorithm 1,
        and fault-tolerance counters (dead ranks, token-replay
        recoveries, replayed tokens, move-leg failures, transfer
        retries/failures, frame corruptions). Cache, host-tier,
        preemption and fault entries are present (as zeros) even when the
        features are off or quiet, so dashboards keyed on the names never
        miss. Pool and cache entries count live instances only."""
        cl = self.cluster
        live = [i for i in cl.engines if i not in cl._dead]
        total = used = free = 0
        spill = prefetch = hit_toks = 0
        for i in live:
            eng = cl.engines[i]
            alloc = eng.rmanager.pool.alloc
            total += alloc.num_blocks
            used += alloc.used_count
            free += alloc.free_count
            spill += eng.stats.host_spill_bytes
            prefetch += eng.stats.host_prefetch_bytes
            hit_toks += eng.stats.cache_hit_tokens
        cache, tier, pre = cl.prefix_cache, cl.host_tier, cl.preemptor
        # Transfer retries/failures: the stager's plus every host tier's.
        retries = float(sum(cl.stager.retries.values()))
        failures = float(sum(cl.stager.failures.values()))
        corruptions = 0.0
        for t in (tier, pre.tier if pre else None):
            if t is not None:
                retries += float(t.stats.fetch_retries)
                failures += float(t.stats.fetch_failures)
                corruptions += float(t.stats.corruptions)
        fs = cl.fault_stats
        return {
            "device_blocks_total": float(total),
            "device_blocks_used": float(used),
            "device_blocks_free": float(free),
            "cache_device_blocks": float(sum(
                cache.device_blocks(i) for i in live)) if cache else 0.0,
            "cache_pinned_blocks": float(sum(
                cache.pinned_blocks(i) for i in live)) if cache else 0.0,
            "cache_hit_tokens": float(hit_toks),
            "host_blocks_used": float(tier.used_blocks) if tier else 0.0,
            "host_blocks_capacity": float(tier.capacity) if tier else 0.0,
            "host_spill_bytes": float(spill),
            "host_prefetch_bytes": float(prefetch),
            "preemptions": float(pre.stats.preemptions) if pre else 0.0,
            "preempt_resumes": float(pre.stats.resumes) if pre else 0.0,
            "paused_now": float(len(pre.paused)) if pre else 0.0,
            "preempt_tier_blocks_used":
                float(pre.tier.used_blocks) if pre else 0.0,
            "kv_moved_bytes": float(cl.throughput_stats["kv_moved_bytes"]),
            "arrival_rate_hz": cl.gmanager.arrivals.rate_hz,
            "avg_new_req_len_est":
                float(cl.gmanager.arrivals.avg_new_req_len),
            "dead_instances": float(len(cl._dead)),
            "fault_recoveries": float(fs.recoveries),
            "fault_failed_recoveries": float(fs.failed_recoveries),
            "replayed_tokens": float(fs.replayed_tokens),
            "move_leg_failures": float(fs.move_leg_failures),
            "transfer_retries": retries,
            "transfer_failures": failures,
            "host_frame_corruptions": corruptions,
        }

    # --- open-loop event pump ------------------------------------------ #
    def run(self, arrivals: Iterable[Arrival], *,
            until: Optional[float] = None,
            max_steps: int = 1_000_000) -> Dict[str, float]:
        """Serve a timestamped arrival trace open-loop.

        Arrivals are submitted when the wall clock passes their ``at``
        offset (the arrival process is NOT gated on service progress —
        the open-loop regime LoongServe/Medha evaluate under); the pump
        steps the cluster continuously and returns aggregate frontend
        metrics. ``until`` stops the pump (wall seconds after start)
        even if requests are still in flight; otherwise it runs until
        every arrival is terminal.
        """
        pending = sorted(arrivals, key=lambda a: a.at)
        t0 = self.cluster.clock()
        submitted: List[RequestHandle] = []
        in_flight: List[RequestHandle] = []   # pruned as handles finish
        steps = 0
        while steps < max_steps:
            now = self.cluster.clock()
            rel = now - t0
            while pending and pending[0].at <= rel:
                a = pending.pop(0)
                h = self.submit(a.prompt, a.sampling, priority=a.priority,
                                deadline_s=a.deadline_s, arrival_time=now)
                submitted.append(h)
                in_flight.append(h)
            if until is not None and rel >= until:
                break
            in_flight = [h for h in in_flight if not h.done]
            if not in_flight:
                if not pending:
                    break
                if not self._queue:
                    # Idle gap in the trace: sleep to the next arrival.
                    time.sleep(min(pending[0].at - rel, 0.05))
                    continue
            self.step(now=now)
            steps += 1
        return self.frontend_metrics(submitted,
                                     wall_s=self.cluster.clock() - t0)

    # --- aggregate metrics --------------------------------------------- #
    @staticmethod
    def frontend_metrics(handles: Sequence[RequestHandle],
                         wall_s: float,
                         now: Optional[float] = None) -> Dict[str, float]:
        """Per-request TTFT/TBT pooled into the percentile metrics the
        paper-adjacent frontends (LoongServe, Medha) report.

        A deadline only counts as missed once it is actually missable:
        the request finished past it, or is still unfinished at ``now``
        (monotonic) with the deadline already behind — an in-flight
        request whose deadline lies in the future is not a miss."""
        now = time.monotonic() if now is None else now
        ttfts, tbts, finished, failed, cancelled, toks = \
            [], [], 0, 0, 0, 0
        deadline_miss = preempted = goodput = dl_total = dl_met = 0
        for h in handles:
            r = h._req
            toks += len(r.output)
            if r.state == RequestState.FINISHED:
                finished += 1
            elif r.state == RequestState.FAILED:
                failed += 1
            elif r.state == RequestState.CANCELLED:
                cancelled += 1
            if r.preemptions > 0:
                preempted += 1
            if r.token_times:
                ttfts.append(r.token_times[0] - r.arrival_time)
                tbts.extend(np.diff(r.token_times))
            dl = r.deadline_at
            if dl is not None and (r.finish_time or now) > dl:
                deadline_miss += 1
            # Deadline GOODPUT: a request contributes only by finishing
            # in time (no deadline = any finish counts). The bench's
            # preemption-vs-baseline gate compares this.
            on_time = r.state == RequestState.FINISHED and (
                dl is None or (r.finish_time or now) <= dl)
            goodput += int(on_time)
            if dl is not None:
                dl_total += 1
                dl_met += int(on_time)

        def pct(xs, q):
            """Percentile helper tolerating empty series (-> nan)."""
            return float(np.percentile(xs, q)) if len(xs) else float("nan")

        return {
            "n_requests": float(len(handles)),
            "finished": float(finished),
            "failed": float(failed),
            "cancelled": float(cancelled),
            "deadline_missed": float(deadline_miss),
            "deadline_goodput": goodput / max(1, len(handles)),
            "slo_attainment": (dl_met / dl_total) if dl_total
            else float("nan"),
            "preempted": float(preempted),
            "tokens": float(toks),
            "throughput_tok_s": toks / max(wall_s, 1e-9),
            "ttft_p50": pct(ttfts, 50),
            "ttft_p99": pct(ttfts, 99),
            "tbt_p50": pct(tbts, 50),
            "tbt_p99": pct(tbts, 99),
            "wall_s": wall_s,
        }
