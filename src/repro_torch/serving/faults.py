"""Deterministic fault injection + the recovery vocabulary it exercises.

The paper's premise — one request's KV scattered across a pooled
cluster — means a single failed creditor rank, dropped move leg, or
corrupted host frame can silently destroy OTHER instances' requests.
This module is the chaos side of the fault-tolerance machinery: a
seedable, step-addressed ``FaultPlan`` whose events the ``Cluster``
fires inside its own ``step()`` loop, so every failure mode the
recovery paths claim to survive can be reproduced exactly:

* ``crash``          — an instance stops heartbeating (``kill_instance``);
  the gManager detects it after ``FaultPolicy.heartbeat_timeout_steps``
  missed beats and the cluster replays every affected request.
* ``silence``        — heartbeats suppressed for ``duration`` steps: a
  gap SHORTER than the timeout must be tolerated (no recovery), a
  longer one must be treated exactly like a crash.
* ``move_leg``       — the next executed stripe leg fails mid-plan: the
  remaining legs' reservations roll back exactly and the tail re-plans
  against surviving creditors.
* ``host_fetch``     — the next host-tier ``get`` raises a (transient)
  ``TransferError``; bounded exponential-backoff retries absorb it.
* ``host_corrupt``   — the next fetched host frame is bit-flipped; hash
  verification raises ``FrameCorruptionError`` instead of letting the
  poisoned KV reach decode, and the caller falls back to token replay.
* ``stager_timeout`` — the next drained stager chain raises a
  ``TransferError`` (retried within the stager's budget).

Everything is deterministic: ``FaultPlan.from_seed`` derives the event
list from a PRNG seed, events fire at exact cluster step counts, and
transfer faults are one-shot armed flags consumed in execution order.
The injector's hooks are its own bound methods and it keeps no reference
to the cluster (``on_step`` receives it), so an armed cluster frees its
weights and pools as soon as it is dropped.

Under a mesh every process arms the same plan on its replica of the
control state: the events fire at the same steps, and each one-shot
transfer fault is consumed by the same transfer in every process (a
``host_corrupt`` flips the same frame in every process's copy of the
tier), so recovery takes the same path everywhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

#: Every fault kind a plan may carry, in the order ``from_seed`` draws.
FAULT_KINDS = ("crash", "silence", "move_leg", "host_fetch",
               "host_corrupt", "stager_timeout")


class TransferError(RuntimeError):
    """A KV transfer (stager chain drain, host-tier fetch) failed.

    Transient by contract: callers retry within their
    ``FaultPolicy``-bounded backoff budget before propagating.
    """


class FrameCorruptionError(RuntimeError):
    """A host-tier frame failed verification against the content hash
    it was stored under — NOT retryable (the stored bytes are wrong);
    the caller must fall back to token-replay recovery."""


def backoff_delay_s(attempt: int, base_s: float, cap_s: float) -> float:
    """Bounded exponential backoff: ``min(cap, base * 2**attempt)``.

    ``base_s == 0`` (the smoke/test default) means immediate in-process
    retries — the retry COUNTING still happens, only the sleeping is
    skipped."""
    if base_s <= 0.0:
        return 0.0
    return min(cap_s, base_s * (2.0 ** attempt))


@dataclass(frozen=True)
class FaultEvent:
    """One planned fault: ``kind`` fires at cluster step ``step``.

    ``target`` picks the instance for crash/silence events (-1 = let
    the injector pick deterministically among the live ones);
    ``duration`` is the silenced-step count for ``silence``; ``count``
    arms that many one-shot transfer faults for the hook-consumed
    kinds (move_leg / host_fetch / host_corrupt / stager_timeout).
    """

    step: int
    kind: str
    target: int = -1
    duration: int = 1
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        if self.step < 1:
            raise ValueError("fault events fire at step >= 1")
        if self.duration < 1 or self.count < 1:
            raise ValueError("duration/count must be >= 1")


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seedable schedule of ``FaultEvent``s."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    @classmethod
    def from_seed(cls, seed: int, *, n_steps: int, n_instances: int,
                  n_events: int = 3, kinds: Tuple[str, ...] = FAULT_KINDS,
                  max_crashes: int = 1) -> "FaultPlan":
        """Derive a plan from ``seed`` alone: the same seed always
        yields the same events (steps in [1, n_steps], targets in
        [0, n_instances)). At most ``max_crashes`` crash events are
        drawn — a crash beyond the budget degrades to a transfer fault
        so arbitrary seeds can never kill the whole cluster."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        crashes = 0
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "crash":
                if crashes >= max_crashes or n_instances < 2:
                    kind = "stager_timeout"
                else:
                    crashes += 1
            events.append(FaultEvent(
                step=int(rng.integers(1, max(2, n_steps + 1))),
                kind=kind,
                target=int(rng.integers(n_instances)),
                duration=int(rng.integers(1, 5))))
        events.sort(key=lambda e: (e.step, e.kind, e.target))
        return cls(events=tuple(events), seed=seed)


@dataclass
class FaultStats:
    """Cluster-side counters of detection, recovery, and retry work."""

    dead_instances: int = 0      # ranks quarantined by detection
    recoveries: int = 0          # requests re-admitted via token replay
    failed_recoveries: int = 0   # replay budget exhausted -> FAILED
    replayed_tokens: int = 0     # generated tokens re-prefilled
    move_leg_failures: int = 0   # stripe legs that failed mid-execution
    move_leg_replans: int = 0    # failed tails re-planned successfully
    injected: int = 0            # plan events actually fired


class FaultInjector:
    """Fires a ``FaultPlan`` against a live cluster, deterministically.

    ``attach(cluster)`` installs the hooks (stager + host tiers) and
    registers the injector on the cluster; the cluster then calls
    ``on_step`` at the top of every ``step()``. Crash/silence events
    act immediately; transfer faults are ARMED one-shot flags the
    subsystem hooks consume in execution order, so a fault planned at
    step k hits the first matching transfer at-or-after step k."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_step: Dict[int, List[FaultEvent]] = {}
        for ev in plan.events:
            self._by_step.setdefault(ev.step, []).append(ev)
        self._silent_until: Dict[int, int] = {}   # inst -> last silent step
        self._move_leg_armed = 0
        self._host_armed: List[str] = []          # "error" | "corrupt" queue
        self._stager_armed = 0
        self.fired: List[FaultEvent] = []

    # --- wiring -------------------------------------------------------- #
    def attach(self, cluster) -> "FaultInjector":
        """Install this injector's hooks on ``cluster`` and return it."""
        cluster.faults = self
        cluster.stager.fault_hook = self.stager_fault
        if cluster.host_tier is not None:
            cluster.host_tier.fault_hook = self.host_fault
        if cluster.preemptor is not None:
            cluster.preemptor.tier.fault_hook = self.host_fault
        return self

    # --- event firing --------------------------------------------------- #
    def on_step(self, step: int, cluster) -> None:
        """Fire every event planned for cluster step ``step``."""
        for ev in self._by_step.get(step, ()):
            self._fire(ev, step, cluster)

    def _pick_target(self, ev: FaultEvent, cluster) -> Optional[int]:
        live = sorted(i for i in cluster.engines if i not in cluster._dead)
        if len(live) < 2:
            return None          # never take the last live instance down
        if ev.target in live:
            return ev.target
        return live[max(ev.target, 0) % len(live)]

    def _fire(self, ev: FaultEvent, step: int, cluster) -> None:
        if ev.kind == "crash":
            target = self._pick_target(ev, cluster)
            if target is None:
                return           # skipped: would strand the cluster
            cluster.kill_instance(target)
        elif ev.kind == "silence":
            target = self._pick_target(ev, cluster)
            if target is None:
                return
            self._silent_until[target] = max(
                self._silent_until.get(target, 0),
                step + ev.duration - 1)
        elif ev.kind == "move_leg":
            self._move_leg_armed += ev.count
        elif ev.kind == "host_fetch":
            self._host_armed.extend(["error"] * ev.count)
        elif ev.kind == "host_corrupt":
            self._host_armed.extend(["corrupt"] * ev.count)
        elif ev.kind == "stager_timeout":
            self._stager_armed += ev.count
        cluster.fault_stats.injected += 1
        self.fired.append(ev)

    # --- hooks consumed by the subsystems ------------------------------- #
    def silenced(self, inst_id: int, step: int) -> bool:
        """True while ``inst_id``'s heartbeat is suppressed at ``step``."""
        return step <= self._silent_until.get(inst_id, 0)

    def take_move_leg_fault(self) -> bool:
        """Consume one armed move-leg fault (False when none armed)."""
        if self._move_leg_armed > 0:
            self._move_leg_armed -= 1
            return True
        return False

    def host_fault(self, key) -> Optional[str]:
        """Consume one armed host-tier fault: "error" (transient fetch
        failure), "corrupt" (bit-flip the stored frame), or None."""
        if self._host_armed:
            return self._host_armed.pop(0)
        return None

    def stager_fault(self, tag: Optional[str]) -> bool:
        """Consume one armed stager transfer fault (False when none)."""
        if self._stager_armed > 0:
            self._stager_armed -= 1
            return True
        return False


__all__ = ["FAULT_KINDS", "FaultEvent", "FaultInjector", "FaultPlan",
           "FaultStats", "FrameCorruptionError", "TransferError",
           "backoff_delay_s"]
