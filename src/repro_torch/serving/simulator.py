"""Event-driven cluster simulator (perf-model-timed) for Fig. 9/10.

Simulates N serving instances at decode-step granularity with the Eq. 5-7
performance model providing step times (the H100's data-sheet constants
by default; ``hw=`` takes another ``HardwareSpec``, e.g. the constants
the JAX package's simulator reads implicitly). Plain Python and numpy:
no tensor and no device. Three policies:

  "infinite"     — Infinite-LLM: cluster-pooled KV; admission to the
                   instance with most free memory; reactive spill +
                   Algorithm-1 proactive moves; spanning requests pay the
                   coverage-bounded debtor/creditor costs.
  "vllm-multi"   — static instances, no pooling: requests that outgrow
                   the instance are dropped (or never admitted).
  "vllm-single"  — all chips in ONE wide-TP instance: everything fits,
                   but every layer pays the wide-TP all-reduce cost
                   (paper Fig. 1c) and f(beta) saturates per-chip.

Striped spans: every request tracks its creditor placement exactly
(``SimRequest.spans``: inst_id -> hosted tokens). Remote MicroAttention
runs in PARALLEL across a request's creditors, so the debtor's remote
bound is its slowest single-creditor slice — striping over more
creditors shrinks it — while every (request, creditor) span entry pays
per-step query/merge traffic (``InstancePerfModel.t_span_merge``).
``striped=False`` restricts the proactive planner to one creditor per
request (the original single-destination Algorithm 1) for A/B runs.
The symmetric reclaim path evicts hosted spans off a memory-stressed
creditor back to owners or sideways, exactly as the real scheduler does.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.hardware import H100, HardwareSpec
from repro_torch.serving.perfmodel import InstancePerfModel


@dataclass
class SimRequest:
    """Analytic-simulator request: lengths + creditor placement only."""

    req_id: int
    arrival: float
    prompt_len: int
    output_len: int
    generated: int = 0
    inst: Optional[int] = None
    # Exact creditor placement: inst_id -> tokens hosted there.
    spans: Dict[int, int] = field(default_factory=dict)
    finish_time: Optional[float] = None
    failed: bool = False

    @property
    def length(self) -> int:
        """Current total tokens (prompt + generated)."""
        return self.prompt_len + self.generated

    @property
    def offloaded(self) -> int:
        """Tokens hosted on creditor instances."""
        return sum(self.spans.values())


@dataclass
class SimInstance:
    """Analytic-simulator instance: perf model + token accounting."""

    inst_id: int
    perf: InstancePerfModel
    kv_capacity_tokens: int
    running: List[SimRequest] = field(default_factory=list)
    hosted_tokens: int = 0
    clock: float = 0.0
    busy_until: float = 0.0
    max_batch: int = 512

    @property
    def local_tokens(self) -> int:
        """Debtor-resident tokens of this instance's running set."""
        return sum(r.length - r.offloaded for r in self.running)

    @property
    def free_tokens(self) -> int:
        """KV capacity left after local + hosted tokens."""
        return self.kv_capacity_tokens - self.local_tokens \
            - self.hosted_tokens

    def step_time(self) -> float:
        """Eq. 5-7 step time of the current batch (all layers)."""
        beta = len(self.running)
        if beta == 0:
            # Hosted-span MicroAttention cost is charged on the debtor
            # side (its coverage-bounded slice time); an instance with
            # no running requests just ticks.
            return 1e-3
        lens = [r.length for r in self.running]
        off = sum(r.offloaded for r in self.running)
        t = self.perf.t_layer(beta, lens)
        per_tok = self.perf.kv_bytes_per_token_layer() / \
            (self.perf.hw.hbm_bw * self.perf.chips)
        off_t = off * per_tok
        # Remote MicroAttention runs in PARALLEL across creditors — the
        # debtor waits only for its slowest single-creditor slice
        # (DistAttention's bandwidth aggregation), still bounded below
        # by local compute (paper Fig. 6a coverage).
        slice_t = max((max(r.spans.values(), default=0)
                       for r in self.running), default=0) * per_tok
        t = max(t - off_t, slice_t)
        t += self.hosted_tokens * per_tok
        # Per-(request, creditor) span entries pay query/merge traffic.
        entries = sum(len(r.spans) for r in self.running)
        t += self.perf.t_span_merge(entries)
        return self.perf.cfg.num_layers * max(t, 1e-9)


class ClusterSimulator:
    """Event-driven analytic cluster sim (paper Figs. 9-10 regimes).

    No tensors: instances advance on ``InstancePerfModel`` step times,
    and the scheduling ``policy`` controls admission/offload — used by
    the e2e-traces benchmark to compare policies at paper scale.
    """

    def __init__(self, cfg: ModelConfig, *, policy: str,
                 n_instances: int, chips_per_instance: int,
                 schedule_every: float = 0.25,
                 avg_new_len: int = 512,
                 striped: bool = True,
                 max_stripes: int = 8,
                 hw: HardwareSpec = H100):
        self.cfg = cfg
        self.policy = policy
        self.instances: List[SimInstance] = []
        for i in range(n_instances):
            perf = InstancePerfModel(cfg, hw=hw, chips=chips_per_instance)
            cap = perf.kv_tokens_capacity()
            self.instances.append(SimInstance(i, perf, cap))
        self.waiting: List[SimRequest] = []
        self.finished: List[SimRequest] = []
        self.failed: List[SimRequest] = []
        self.schedule_every = schedule_every
        self.clock = 0.0
        self.avg_new_len = avg_new_len
        self.striped = striped
        self.max_stripes = max_stripes if striped else 1
        self._next_sched = schedule_every
        self._requeue: List[SimRequest] = []

    # --------------------------------------------------------------- #
    def _host(self, req: SimRequest, donor: SimInstance, tok: int):
        donor.hosted_tokens += tok
        req.spans[donor.inst_id] = req.spans.get(donor.inst_id, 0) + tok

    def _release_spans(self, req: SimRequest):
        for iid, tok in req.spans.items():
            self.instances[iid].hosted_tokens -= tok
        req.spans = {}

    def _admit(self, req: SimRequest) -> bool:
        insts = sorted(self.instances, key=lambda x: -x.free_tokens)
        for inst in insts:
            if len(inst.running) >= inst.max_batch:
                continue
            if inst.free_tokens >= req.prompt_len:
                inst.running.append(req)
                req.inst = inst.inst_id
                return True
            if self.policy == "infinite":
                # Spill: local tail + remote prefix striped across up to
                # ``max_stripes`` creditors (reserve-then-stream at
                # admission; ONE creditor when striped=False — the
                # single-destination baseline cannot admit a prompt no
                # single creditor can hold).
                need = req.prompt_len - inst.free_tokens
                donors = sorted((d for d in self.instances
                                 if d is not inst and d.free_tokens > 0),
                                key=lambda d: -d.free_tokens)
                donors = donors[:self.max_stripes]
                avail = sum(d.free_tokens for d in donors)
                if avail >= need and inst.free_tokens > 0:
                    req.inst = inst.inst_id
                    inst.running.append(req)
                    for d in donors:
                        take = min(d.free_tokens, need)
                        self._host(req, d, take)
                        need -= take
                        if need <= 0:
                            break
                    return True
        return False

    def _preempt(self, inst: SimInstance, req: SimRequest, t: float):
        """vLLM-style preemption: drop KV, requeue (recompute on resume)."""
        inst.running.remove(req)
        self._release_spans(req)
        req.inst = None
        req.arrival = t                     # back of the queue
        self._requeue.append(req)

    def _spill(self, inst: SimInstance, t: float = 0.0):
        """Reactive: keep the instance under its memory capacity; when the
        cluster pool is exhausted, PREEMPT (never corrupt, never fail)."""
        while inst.free_tokens < 0:
            victim = max(inst.running, key=lambda r: r.length - r.offloaded,
                         default=None)
            if victim is None:
                break
            donors = sorted((d for d in self.instances if d is not inst
                             and d.free_tokens > 256),
                            key=lambda d: -d.free_tokens)
            # The single-destination baseline may only grow the span a
            # victim already has (or open its first); striped mode opens
            # up to max_stripes spans per victim.
            if victim.spans:
                allowed = [d for d in donors
                           if d.inst_id in victim.spans
                           or len(victim.spans) < self.max_stripes]
            else:
                allowed = donors
            chunk = 0
            if allowed:
                chunk = min(-inst.free_tokens + 256,
                            allowed[0].free_tokens,
                            victim.length - victim.offloaded - 256)
            if chunk <= 0:
                self._preempt(inst, victim, t)
                continue
            self._host(victim, allowed[0], chunk)

    def _proactive(self):
        """Algorithm-1 at simulator granularity, striped: the longest
        request of each debtor is placed across creditors, respecting
        the PER-REQUEST ``max_stripes`` span cap — a request may only
        grow spans it already has, or open new ones while it is under
        the cap (so ``striped=False`` is genuinely single-destination
        for each request's lifetime, not per planning round)."""
        debtors = sorted((i for i in self.instances
                          if 0 < len(i.running) <= 8
                          or i.free_tokens < i.kv_capacity_tokens // 10),
                         key=lambda i: len(i.running))
        for d in debtors:
            if not d.running:
                continue
            longest = max(d.running, key=lambda r: r.length - r.offloaded)
            movable = longest.length - longest.offloaded - 256
            if movable < 1024:
                continue
            creditors = sorted(
                (i for i in self.instances if i is not d
                 and i.free_tokens > i.kv_capacity_tokens // 3),
                key=lambda i: -i.free_tokens)
            for c in creditors:
                if movable < 1024:
                    break
                if c.free_tokens < 1024:
                    continue
                if c.inst_id not in longest.spans and \
                        len(longest.spans) >= self.max_stripes:
                    continue
                take = min(movable, c.free_tokens // 2)
                self._host(longest, c, take)
                movable -= take

    def _reclaim(self):
        """Symmetric path: a creditor that became memory-stressed evicts
        hosted spans back to owners or sideways to calm instances."""
        for h in self.instances:
            if h.hosted_tokens <= 0 or \
                    h.free_tokens > h.kv_capacity_tokens // 20:
                continue
            victims = [(r, o) for o in self.instances for r in o.running
                       if r.spans.get(h.inst_id, 0) > 0]
            for req, owner in victims:
                tok = req.spans.get(h.inst_id, 0)
                # Back to the owner when it has real headroom, else
                # sideways to the calmest other instance.
                dst = None
                if owner.free_tokens >= tok + 1024:
                    dst = owner
                else:
                    calm = sorted((i for i in self.instances
                                   if i is not h and i is not owner
                                   and i.free_tokens >= tok + 1024),
                                  key=lambda i: -i.free_tokens)
                    dst = calm[0] if calm else None
                if dst is None:
                    continue
                h.hosted_tokens -= tok
                del req.spans[h.inst_id]
                if dst is not owner:
                    self._host(req, dst, tok)
                if h.free_tokens > h.kv_capacity_tokens // 20:
                    break

    # --------------------------------------------------------------- #
    def run(self, requests: List[SimRequest], *, horizon: float = 600.0
            ) -> Dict[str, float]:
        """Event-driven: every instance advances on its OWN clock (an
        instance hosting heavy MicroAttention slows only itself, as in
        the real asynchronous cluster)."""
        pending = sorted(requests, key=lambda r: r.arrival)
        tokens_done = 0
        heap = [(0.0, i.inst_id) for i in self.instances]
        heapq.heapify(heap)

        while heap and (pending or any(i.running for i in self.instances)):
            t, iid = heapq.heappop(heap)
            if t > horizon:
                break
            self.clock = max(self.clock, t)
            inst = self.instances[iid]

            # Admit arrivals up to this time.
            while pending and pending[0].arrival <= t:
                req = pending[0]
                cap = self.instances[0].kv_capacity_tokens
                if self.policy != "infinite":
                    feasible = req.prompt_len + req.output_len <= cap
                else:
                    # Pooled feasibility: the local tail plus at most
                    # ``max_stripes`` creditor spans. A request no
                    # placement can EVER hold is rejected, not left to
                    # block the queue head forever.
                    pool_span = min(1 + self.max_stripes,
                                    len(self.instances))
                    feasible = req.prompt_len + req.output_len <= \
                        cap * pool_span
                if not feasible:
                    req.failed = True
                    self.failed.append(req)
                    pending.pop(0)
                    continue
                if self._admit(req):
                    pending.pop(0)
                else:
                    break                        # head-of-line wait

            if self.policy == "infinite" and t >= self._next_sched:
                self._reclaim()
                self._proactive()
                self._next_sched = t + self.schedule_every

            if not inst.running:
                # Idle: wake at the next arrival (or a coarse tick if the
                # head of line is blocked on memory elsewhere).
                nxt = (pending[0].arrival if pending else t + 0.05)
                heapq.heappush(heap, (max(nxt, t + 0.05), iid))
                continue

            # One decode step for THIS instance.
            dt = inst.step_time()
            for r in list(inst.running):
                r.generated += 1
                tokens_done += 1
                if r.generated >= r.output_len:
                    r.finish_time = t + dt
                    inst.running.remove(r)
                    self._release_spans(r)
                    self.finished.append(r)
            if self.policy == "infinite":
                self._spill(inst, t)
            if self._requeue:
                pending.extend(self._requeue)
                pending.sort(key=lambda r: r.arrival)
                self._requeue.clear()
            heapq.heappush(heap, (t + dt, iid))

        lat = [r.finish_time - r.arrival for r in self.finished
               if r.finish_time]
        return {
            "throughput_tok_s": tokens_done / max(self.clock, 1e-9),
            "finished": len(self.finished),
            "failed": len(self.failed),
            "p50_latency": float(np.percentile(lat, 50)) if lat else 0.0,
            "p99_latency": float(np.percentile(lat, 99)) if lat else 0.0,
            "clock": self.clock,
        }


def make_policy_cluster(cfg: ModelConfig, policy: str, total_chips: int,
                        chips_per_instance: int, *,
                        striped: bool = True,
                        hw: HardwareSpec = H100) -> ClusterSimulator:
    """Build the simulator laid out for a named scheduling policy."""
    if policy == "vllm-single":
        return ClusterSimulator(cfg, policy=policy, n_instances=1,
                                chips_per_instance=total_chips,
                                striped=striped, hw=hw)
    n = total_chips // chips_per_instance
    return ClusterSimulator(cfg, policy=policy, n_instances=n,
                            chips_per_instance=chips_per_instance,
                            striped=striped, hw=hw)
