"""Host-DRAM KV tier: the memory level below the device block pools.

The paper pools KV across DEVICE memories; this module adds the level
below them: a bounded store of host-memory block frames that cold blocks
(finished requests' cached prefixes, preempted requests) spill into
instead of being dropped, and from which a prefix-cache hit or a resume
uploads them back.

Both directions are ASYNCHRONOUS on the card:

* **Spill (D2H)** — ``put`` takes a block's device rows (a gather result
  of ``read_pool_rows``: it does not alias the pool, so the pool block can
  be freed and reused at once) and copies them into PINNED host tensors
  with ``non_blocking=True`` on the tier's side stream, which first waits
  on an event recorded on the compute stream (so the copy reads the
  gathered rows only after the gather ran). ``record_stream`` keeps the
  caching allocator from handing the gathered rows to a later step while
  the copy still reads them. An event recorded on the side stream after
  the copy marks the frame final: ``drain()`` (once per cluster step)
  finalizes the frames whose event has fired, without blocking. Pinned
  frames come from torch's caching host allocator, one pair per put, so
  the tier pins only what it holds and steady state allocates no new
  pinned memory. Whether a spill has landed (``event.query()``) differs
  from process to process under a mesh, so no decision follows from
  it: a key counts toward membership, capacity and the LRU order from
  its ``put`` on, landed or not, and its checksum is of the same bytes
  whenever it is taken; only ``d2h_ms`` and ``fetch_stalls`` (and the
  host time counters) may differ between processes.
* **Upload (H2D)** — ``get`` returns the host frame; the engine uploads
  it with ``non_blocking=True`` on the compute stream, which orders the
  upload against the next step's kernels. ``get`` on a spill still in
  flight must block on its event — a PREFETCH STALL, counted in
  ``fetch_stalls``.

On the CPU every copy has completed when it returns: the tier is
synchronous there (its counters still count).

Eviction is LRU with a watermark pair: when occupancy crosses
``high_watermark`` the tier evicts least-recently-used frames down to
``low_watermark``. Pinned keys (a paused request's chain, an
``evictable_fn`` veto from the prefix cache) are skipped; ``on_evict``
lets the owner drop dependent state — the radix cache deletes the
evicted node's now-unreachable subtree there.

Frames stay torch tensors end to end. Their checksum is CRC32 over the
raw bytes (``t.view(torch.uint8)``), K's bytes then V's: the same value
the JAX package's tier computes over the same bytes (a bf16 frame hashes
as its 16-bit patterns).
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serving.faults import (FrameCorruptionError, TransferError,
                                        backoff_delay_s)

Frame = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class HostTierStats:
    """Counters for tier traffic, stalls, and eviction pressure."""

    spilled_bytes: int = 0       # D2H bytes accepted by put()
    fetched_bytes: int = 0       # H2D bytes handed out by get()
    spills: int = 0
    fetches: int = 0
    fetch_stalls: int = 0        # get() had to block on an in-flight D2H
    stall_wait_s: float = 0.0    # host time spent blocked in stalls
    evictions: int = 0
    rejected: int = 0            # put() refused (tier full of pinned keys)
    fetch_retries: int = 0       # transient fetch errors absorbed by retry
    fetch_failures: int = 0      # fetches that exhausted the retry budget
    corruptions: int = 0         # frames that failed hash verification
    spill_s: float = 0.0         # host time spent dispatching spills
    d2h_ms: float = 0.0          # device time of finalized D2H copies


def frame_bytes(frame: Frame) -> int:
    """Bytes of one (k, v) frame."""
    return int(frame[0].nbytes + frame[1].nbytes)


def frame_crc32(frame: Frame) -> int:
    """CRC32 of a frame's raw bytes, K then V (host tensors)."""
    k, v = (t.detach().contiguous().view(torch.uint8).numpy() for t in frame)
    return zlib.crc32(v, zlib.crc32(k))


class HostKVTier:
    """Bounded LRU store of host-memory KV block frames.

    Keys are content hashes (the radix cache's node hashes) or any
    hashable id; one key maps to ONE block's (k, v) rows of shape
    ``[L, block_size, K, hd]``.

    With ``verify=True`` every frame is checksummed when its spill
    finalizes, and every ``get`` re-checks the stored bytes against that
    hash before handing them out — a corrupted frame raises
    ``FrameCorruptionError`` (and is dropped) instead of silently
    poisoning decode. Transient fetch errors (``TransferError``) are
    retried up to ``max_retries`` times with bounded exponential backoff
    before propagating.
    """

    def __init__(self, capacity_blocks: int, *,
                 high_watermark: float = 0.9, low_watermark: float = 0.7,
                 on_evict: Optional[Callable[[Any], None]] = None,
                 evictable_fn: Optional[Callable[[Any], bool]] = None,
                 verify: bool = False, max_retries: int = 0,
                 backoff_base_s: float = 0.0, backoff_max_s: float = 0.05):
        assert capacity_blocks >= 0
        assert 0.0 < low_watermark <= high_watermark <= 1.0
        self.capacity = capacity_blocks
        self.high = high_watermark
        self.low = low_watermark
        self.on_evict = on_evict
        self.evictable_fn = evictable_fn
        self.verify = verify
        self.max_retries = max(0, max_retries)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        # key -> (k_host, v_host) finalized frames.
        self._frames: Dict[Any, Frame] = {}
        # key -> (k_host, v_host, (start, done) events or None) with the
        # D2H copy dispatched.
        self._pending: Dict[Any, tuple] = {}
        self._sums: Dict[Any, int] = {}       # key -> stored-frame CRC32
        self._tick: Dict[Any, int] = {}       # key -> LRU clock value
        self._clock = 0
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.pinned: set = set()
        self.stats = HostTierStats()
        # Fault hook: called with the key on each fetch; may return
        # "error" (raise a transient TransferError) or "corrupt"
        # (bit-flip the stored frame). See serving.faults.
        self.fault_hook: Optional[Callable[[Any], Optional[str]]] = None

    # ----------------------------------------------------------------- #
    @property
    def used_blocks(self) -> int:
        """Frames resident or in flight (both count against capacity)."""
        return len(self._frames) + len(self._pending)

    @property
    def free_blocks(self) -> int:
        """Capacity headroom without evicting anything."""
        return max(0, self.capacity - self.used_blocks)

    @property
    def held_bytes(self) -> int:
        """Host bytes of the frames resident or in flight."""
        return sum(frame_bytes(f[:2]) for f in list(self._frames.values())
                   + list(self._pending.values()))

    def lru_keys(self) -> List[Any]:
        """Every key resident or in flight, least recently used first."""
        return sorted((k for k in self._tick if k in self),
                      key=self._tick.__getitem__)

    def __contains__(self, key: Any) -> bool:
        return key in self._frames or key in self._pending

    def pin(self, key: Any) -> None:
        """Exempt ``key`` from LRU eviction until ``unpin``/``drop``.

        The preemptor pins every frame of a paused request's KV chain:
        a paused request must ALWAYS be resumable byte-identically, so
        its frames can never be sacrificed to watermark pressure."""
        self.pinned.add(key)

    def unpin(self, key: Any) -> None:
        """Make ``key`` LRU-evictable again (no-op if not pinned)."""
        self.pinned.discard(key)

    def _touch(self, key: Any) -> None:
        self._clock += 1
        self._tick[key] = self._clock

    # ----------------------------------------------------------------- #
    def put(self, key: Any, k_dev: torch.Tensor, v_dev: torch.Tensor) -> bool:
        """Spill one block's rows to host, asynchronously on the card.

        ``k_dev``/``v_dev``: [L, block_size, K, hd] tensors that do NOT
        alias the pool (a gather result). Returns False when the tier
        cannot make room (capacity 0 or everything pinned) — the caller
        then simply drops the block.
        """
        if self.capacity <= 0:
            self.stats.rejected += 1
            return False
        if key in self:
            self._touch(key)
            return True
        if self.used_blocks + 1 > self.capacity and \
                not self._evict_down(self.capacity - 1):
            self.stats.rejected += 1
            return False
        t0 = time.perf_counter()
        self._pending[key] = self._copy_to_host(k_dev, v_dev)
        self.stats.spill_s += time.perf_counter() - t0
        self._touch(key)
        self.stats.spills += 1
        self.stats.spilled_bytes += frame_bytes((k_dev, v_dev))
        if self.used_blocks > int(self.high * self.capacity):
            self._evict_down(int(self.low * self.capacity))
        return True

    def _copy_to_host(self, k: torch.Tensor, v: torch.Tensor):
        """Dispatch the D2H copy of one frame; returns (k_host, v_host,
        (start, done) events or None). On the CPU the gathered rows are
        the frame."""
        if k.device.type != "cuda":
            return k, v, None
        side = self._streams.get(k.device)
        if side is None:
            side = self._streams[k.device] = torch.cuda.Stream(k.device)
        side.wait_stream(torch.cuda.current_stream(k.device))
        start, done = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        out = []
        with torch.cuda.stream(side):
            start.record(side)
            for t in (k, v):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t.record_stream(side)
                out.append(host)
            done.record(side)
        return out[0], out[1], (start, done)

    def drain(self, block: bool = False) -> None:
        """Finalize spill transfers that have landed (all of them when
        ``block`` is True). Called once per cluster step so host frames
        materialize behind decode compute, never on its critical path."""
        done: List[Any] = []
        for key, (k, v, events) in self._pending.items():
            if not block and events is not None and not events[1].query():
                continue
            self._finalize(key, k, v, events)
            done.append(key)
        for key in done:
            del self._pending[key]

    def _finalize(self, key: Any, k: torch.Tensor, v: torch.Tensor,
                  events) -> None:
        # The landed host bytes are the frame of record: the content
        # hash every later fetch is verified against is taken HERE.
        if events is not None:
            start, done = events
            done.synchronize()
            self.stats.d2h_ms += start.elapsed_time(done)
        self._frames[key] = (k, v)
        if self.verify:
            self._sums[key] = frame_crc32((k, v))

    # ----------------------------------------------------------------- #
    def get(self, key: Any) -> Optional[Frame]:
        """Host rows for ``key`` — finalizing (and counting as a stall)
        a spill that is still in flight.

        Raises ``TransferError`` after ``max_retries`` failed fetch
        attempts and ``FrameCorruptionError`` (dropping the frame) when
        verification does not match the stored content hash; returns
        None only for an absent key (raced eviction)."""
        attempt = 0
        while True:
            try:
                return self._get_once(key)
            except TransferError:
                if attempt >= self.max_retries:
                    self.stats.fetch_failures += 1
                    raise
                self.stats.fetch_retries += 1
                delay = backoff_delay_s(attempt, self.backoff_base_s,
                                        self.backoff_max_s)
                if delay > 0:
                    time.sleep(delay)
                attempt += 1

    def _get_once(self, key: Any) -> Optional[Frame]:
        if key in self._pending:
            k, v, events = self._pending.pop(key)
            stalled = events is not None and not events[1].query()
            t0 = time.perf_counter()
            self._finalize(key, k, v, events)
            if stalled:
                self.stats.fetch_stalls += 1
                self.stats.stall_wait_s += time.perf_counter() - t0
        if key in self._frames and self.fault_hook is not None:
            mode = self.fault_hook(key)
            if mode == "error":
                raise TransferError(f"injected host fetch error "
                                    f"(key={key!r})")
            if mode == "corrupt":
                self._corrupt(key)
        frame = self._frames.get(key)
        if frame is None:
            return None
        if self.verify and key in self._sums and \
                frame_crc32(frame) != self._sums[key]:
            self.stats.corruptions += 1
            self.drop(key)
            raise FrameCorruptionError(
                f"host frame {key!r} failed content-hash verification")
        self._touch(key)
        self.stats.fetches += 1
        self.stats.fetched_bytes += frame_bytes(frame)
        return frame

    def _corrupt(self, key: Any) -> None:
        # Fault injection: flip the first byte of the stored K rows —
        # exactly what a wrong/bit-rotted frame looks like to a reader.
        k, v = self._frames[key]
        k = k.clone()
        flat = k.view(torch.uint8).view(-1)
        flat[0] = flat[0] ^ 0xFF
        self._frames[key] = (k, v)

    def drop(self, key: Any) -> None:
        """Forget ``key`` entirely (pending or resident; idempotent)."""
        self._pending.pop(key, None)
        self._frames.pop(key, None)
        self._sums.pop(key, None)
        self._tick.pop(key, None)
        self.pinned.discard(key)

    # ----------------------------------------------------------------- #
    def _evict_down(self, target_blocks: int) -> bool:
        """LRU-evict unpinned frames until occupancy <= target. Returns
        True if the target was reached."""
        order = sorted((k for k in self._tick if k in self),
                       key=lambda k: self._tick[k])
        for key in order:
            if self.used_blocks <= target_blocks:
                break
            if key in self.pinned:
                continue
            if self.evictable_fn is not None and \
                    not self.evictable_fn(key):
                continue
            self.stats.evictions += 1
            if self.on_evict is not None:
                # The owner's hook drops dependent state and may call
                # ``drop(key)`` itself (the radix cache deletes the
                # node's subtree, which includes this frame).
                self.on_evict(key)
            self.drop(key)               # idempotent if the hook dropped
        return self.used_blocks <= target_blocks


__all__ = ["HostKVTier", "HostTierStats", "frame_bytes", "frame_crc32"]
