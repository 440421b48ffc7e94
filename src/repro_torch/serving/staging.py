"""Async double-buffered staging of KV pool-row movement.

Pool-row copies are enqueued on the card's current stream and return at
once; because every step and every copy runs on that one stream, in
order, data correctness never depends on WHEN the host waits. What the
sync policy decides is whether movement traffic hides behind decode
compute (paper Fig. 12) or is paid serially on top of it:

* ``overlap=False`` — the serial baseline: every staged copy chain is
  waited for at dispatch (a CUDA event recorded after it, synchronized).
  Movement time adds to step time.
* ``overlap=True`` — up to ``depth`` copy chains stay in flight
  (double-buffered by default); the host blocks only when the ring is
  full or at an explicit ``commit()`` — the table-commit points where a
  span must be fully resident before its tables go live.

CUDA events take the place of the JAX package's ``block_until_ready``.
On the CPU every copy has completed when it returns, so staging is a
synchronous no-op there (the counters still count, and the fault hook is
still consulted before each wait).

Under a mesh the chains are staged in the same order in every process,
so an armed fault meets the same wait everywhere and the retries take
the same path; whether a chain had landed (``event.query()``) feeds
only the stall counters, which may differ between processes.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.serving.faults import TransferError, backoff_delay_s


class AsyncStager:
    """Bounded in-flight window over dispatched pool-row copy chains.

    Chains may carry a ``tag``: per-tag stall counters record how often
    draining a tagged chain actually had to WAIT — the copy was still in
    flight when the host needed it done.

    Failure handling: waiting on a chain that raises ``TransferError``
    (an injected ``FaultPlan`` timeout) is retried up to ``max_retries``
    times with bounded exponential backoff (``retries`` per tag);
    synchronizing the same CUDA event again is idempotent. On exhaustion
    — or any other error, such as a CUDA error, which is sticky and never
    retried — the failure is counted in ``failures`` per tag, the
    REMAINING in-flight ring is drained to a clean state (secondary
    errors are counted, not raised), and the original error propagates.
    """

    def __init__(self, overlap: bool = True, depth: int = 2, *,
                 max_retries: int = 0, backoff_base_s: float = 0.0,
                 backoff_max_s: float = 0.05):
        self.overlap = overlap
        self.depth = max(1, depth)
        self.max_retries = max(0, max_retries)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._inflight: Deque[Tuple[Optional[torch.cuda.Event],
                                    Optional[str]]] = deque()
        self.staged = 0          # copy chains handed to the stager
        self.synced = 0          # explicit waits
        self.sync_wait_s = 0.0   # host time spent blocked on copies
        self.stalls: Dict[str, int] = defaultdict(int)
        self.stall_wait_s: Dict[str, float] = defaultdict(float)
        self.retries: Dict[str, int] = defaultdict(int)
        self.failures: Dict[str, int] = defaultdict(int)
        # Chaos hook: called with the chain's tag before each wait; a
        # True return injects one TransferError (see serving.faults).
        self.fault_hook: Optional[Callable[[Optional[str]], bool]] = None

    def stage(self, tensors: Sequence[torch.Tensor],
              tag: Optional[str] = None) -> None:
        """Register one dispatched copy chain writing ``tensors``.

        A CUDA event recorded now marks the chain's completion. Serial
        mode waits for it immediately; overlap mode admits it into the
        in-flight ring and only drains the OLDEST chain when the ring
        exceeds ``depth`` — the double-buffer rotation.
        """
        self.staged += 1
        event = None
        dev = tensors[0].device if tensors else torch.device("cpu")
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        if not self.overlap:
            self._block(event, tag)
            return
        self._inflight.append((event, tag))
        while len(self._inflight) > self.depth:
            self._block(*self._inflight.popleft())

    def commit(self) -> None:
        """Barrier at a table-commit point: drain every in-flight chain."""
        while self._inflight:
            self._block(*self._inflight.popleft())

    def _block(self, event: Optional[torch.cuda.Event],
               tag: Optional[str] = None) -> None:
        # Retry wrapper around the actual wait. The chain was already
        # popped from the ring by the caller, so a chain that ultimately
        # fails is never left in flight.
        name = tag or "untagged"
        attempt = 0
        while True:
            try:
                self._wait_ready(event, tag)
                return
            except TransferError:
                if attempt < self.max_retries:
                    self.retries[name] += 1
                    delay = backoff_delay_s(attempt, self.backoff_base_s,
                                            self.backoff_max_s)
                    if delay > 0:
                        time.sleep(delay)
                    attempt += 1
                    continue
                self.failures[name] += 1
                self._drain_after_failure()
                raise
            except Exception:
                self.failures[name] += 1
                self._drain_after_failure()
                raise

    def _drain_after_failure(self) -> None:
        # Leave the ring EMPTY and consistent after a failed chain:
        # secondary errors while flushing the survivors are counted but
        # not raised (the primary error is the one that propagates).
        pending, self._inflight = list(self._inflight), deque()
        for event, tag in pending:
            try:
                self._wait_ready(event, tag)
            except Exception:
                self.failures[tag or "untagged"] += 1

    def _wait_ready(self, event: Optional[torch.cuda.Event],
                    tag: Optional[str] = None) -> None:
        if self.fault_hook is not None and self.fault_hook(tag):
            raise TransferError(
                f"injected stager transfer timeout (tag={tag!r})")
        self.synced += 1
        if event is None:
            return
        stalled = not event.query()
        t0 = time.perf_counter()
        event.synchronize()
        waited = time.perf_counter() - t0
        self.sync_wait_s += waited
        if stalled and tag is not None:
            self.stalls[tag] += 1
            self.stall_wait_s[tag] += waited
