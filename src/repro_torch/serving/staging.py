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
synchronous no-op there (the counters still count).
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Deque, Dict, Optional, Sequence, Tuple

import torch


class AsyncStager:
    """Bounded in-flight window over dispatched pool-row copy chains.

    Chains may carry a ``tag``: per-tag stall counters record how often
    draining a tagged chain actually had to WAIT — the copy was still in
    flight when the host needed it done.
    """

    def __init__(self, overlap: bool = True, depth: int = 2):
        self.overlap = overlap
        self.depth = max(1, depth)
        self._inflight: Deque[Tuple[Optional[torch.cuda.Event],
                                    Optional[str]]] = deque()
        self.staged = 0          # copy chains handed to the stager
        self.synced = 0          # explicit waits
        self.sync_wait_s = 0.0   # host time spent blocked on copies
        self.stalls: Dict[str, int] = defaultdict(int)
        self.stall_wait_s: Dict[str, float] = defaultdict(float)

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
