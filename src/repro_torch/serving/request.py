"""Request lifecycle objects for the serving engine and cluster runtime.

Lifecycle: WAITING -> PREFILLING -> RUNNING -> FINISHED, with FAILED
(pool exhaustion / infeasible placement) and CANCELLED (caller-initiated
via ``RequestHandle.cancel``) as terminal branches. Cancellation is
cooperative inside an in-flight streaming prefill: the engine checks
``Request.cancelled`` between chunks and rolls the admission back via
the all-or-nothing reservation machinery.

PAUSED is the one non-terminal detour: under overload the ``Preemptor``
stops a RUNNING request at a step boundary, spills its KV chain to the
host tier, and parks it (prompt/output/stream state intact, device
state fully released). A paused request later resumes RUNNING with
byte-identical KV, or is cancelled while parked. ``pause_requested``
mirrors ``cancelled`` for the cooperative mid-prefill case: the engine
aborts the admission with the same exact-rollback discipline but keeps
the request WAITING instead of making it terminal.

Request ids are allocated PER SERVER (``RequestIdAllocator``): two
``LLMServer``/``Cluster`` instances in one process each get a dense,
deterministic 0..N id space instead of sharing one module-global
counter whose values drift with test/import order. Constructing a bare
``Request`` without a server still works — it falls back to a private
module counter — but anything submitted through a server gets the
server's ids.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Fallback for standalone Request() construction only; servers allocate
# from their own RequestIdAllocator.
_fallback_counter = itertools.count()


class RequestIdAllocator:
    """Dense per-server request-id space (deterministic across runs)."""

    def __init__(self, start: int = 0):
        self._counter = itertools.count(start)

    def next_id(self) -> int:
        """Return the next dense request id."""
        return next(self._counter)


class RequestState(enum.Enum):
    """Lifecycle states (see module docstring for the transition map)."""

    WAITING = "waiting"
    PREFILLING = "prefilling"
    RUNNING = "running"
    PAUSED = "paused"          # preempted: KV spilled to host, resumable
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class SamplingParams:
    """Per-request decoding knobs (greedy when ``temperature <= 0``)."""

    max_new_tokens: int = 64
    temperature: float = 0.0          # 0 => greedy
    eos_token: Optional[int] = None
    # Any of these tokens terminates generation (the token IS emitted,
    # like eos_token — callers strip it if they don't want it).
    stop_tokens: Tuple[int, ...] = ()
    # Keep only the k highest logits before sampling (0 => disabled).
    # Greedy (temperature <= 0) is unaffected.
    top_k: int = 0
    seed: int = 0


@dataclass
class Request:
    """One in-flight generation: prompt, lifecycle state, placement.

    Mutable by design — the engine, scheduler, preemptor, and frontend
    all annotate it. ``spans`` is the cluster-wide KV placement map;
    the preemption fields record pause/resume history for the
    anti-thrash cap and the SLO victim ranking.
    """

    prompt: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    req_id: int = field(default_factory=lambda: next(_fallback_counter))
    state: RequestState = RequestState.WAITING
    output: List[int] = field(default_factory=list)
    # --- lifecycle timestamps (time.monotonic domain) ------------------ #
    arrival_time: float = 0.0         # set at server/cluster submit
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)  # per emit
    # --- frontend scheduling ------------------------------------------- #
    priority: int = 0                 # higher = scheduled first
    deadline_s: Optional[float] = None  # SLO, seconds after arrival
    cancelled: bool = False           # cooperative-cancel flag
    # --- preemption (overload survival) -------------------------------- #
    pause_requested: bool = False     # cooperative mid-prefill pause flag
    preemptions: int = 0              # times this request has been paused
    paused_at: Optional[float] = None  # monotonic time of the last pause
    # --- fault recovery (token replay) ---------------------------------- #
    needs_replay: bool = False        # re-admit via prompt+output re-prefill
    replays: int = 0                  # completed token-replay recoveries
    replayed_tokens: int = 0          # generated tokens re-prefilled so far
    slot: Optional[int] = None        # engine batch slot while RUNNING
    # Cluster placement: ordered spans (instance_id, n_tokens) covering
    # [0, len); the LAST span is always on the owner (debtor) instance.
    spans: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def length(self) -> int:
        """Total tokens (prompt + emitted output)."""
        return len(self.prompt) + len(self.output)

    @property
    def done(self) -> bool:
        """True once the request reached a terminal state."""
        return self.state in (RequestState.FINISHED, RequestState.FAILED,
                              RequestState.CANCELLED)

    @property
    def deadline_at(self) -> Optional[float]:
        """Absolute deadline in the arrival_time clock domain."""
        if self.deadline_s is None:
            return None
        return self.arrival_time + self.deadline_s

    def urgency(self, now: float) -> float:
        """Scheduling key: higher = serve/offload first.

        Priority STRICTLY dominates: the deadline term lives in
        (0, 0.5], so no deadline pressure can lift a request past the
        next integer priority level. Within a priority level a request
        gets more urgent as its deadline approaches, saturating at
        +0.5 once the deadline is reached (an expired request stays the
        most urgent of its own level, never of a higher one). Requests
        without a deadline tie at their bare priority.
        """
        u = float(self.priority)
        dl = self.deadline_at
        if dl is not None:
            u += 1.0 / (2.0 + max(dl - now, 0.0))
        return u
