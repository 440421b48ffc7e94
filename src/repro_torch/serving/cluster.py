"""Cluster runtime: N instances + gManager, KV movement, fault tolerance.

In-process realization of the paper's Fig. 3/8 system: every instance is
an ``InstanceEngine`` with an ``RManager``; a ``GManager`` ingests
heartbeats, plans Algorithm-1 moves, and the runtime executes them with
the try_move reservation protocol. All serving KV lives in the engines'
block pools (one set of pool tensors per instance; the instances share
one set of weight tensors), so every movement here is pool row copies
plus table edits. Two movement protocols exist:

  * **reserve-then-stream** (admission): a prompt whose prefix
    overflows the owner's local quota gets its creditor blocks
    committed BEFORE any prefill compute (``PrefixSink``; may stripe
    the prefix across several creditors when no single one can hold
    it). The owner's chunked paged prefill then streams each chunk's
    creditor-bound KV rows into those blocks as they are computed.
  * **read-copy-free** (decode-time moves, reactive or Algorithm-1):
    read the oldest blocks out of the debtor's pool, write them into
    blocks reserved in the creditor's pool, free the debtor's blocks.
    Algorithm-1 plans are STRIPED: one ``MoveKVCache`` may carry legs
    for several creditors (or, for reclaim plans, evict a hosted span
    back to its owner / sideways); every leg is reserved before any
    byte moves and one refusal rolls the whole plan back.

Both protocols stage their pool-row copies on the cluster's
``AsyncStager``. Requests whose KV spans instances decode via the
owner's multi-rank ``decode_step_paged`` merge (creditor pools are read
directly, block-table addressed).

Global-pool mode (``ServingConfig.global_pool``, dense and MoE): ONE
``GlobalKVPool`` tensor ``[n_instances, L, NB, bs, K, hd]`` on the card
holds every instance's KV; each engine aliases its rank's slice and
allocator, a StripedMove leg is a block copy inside the tensor
(``GlobalKVPool.copy_blocks``), admission writes creditor rows in the
prefill step itself, and decode reads every rank in one kernel launch a
layer. The rank axis is fixed at construction, so ``add_instance``
raises there.

Engines of a non-pooled (hybrid) model hold no pool: reactive moves,
Algorithm-1 plans and creditor picks all skip them, so nothing ever
moves to, from or between them.

The memory hierarchy (opt-in, both pool modes): ``prefix_cache=True``
installs one ``RadixPrefixCache`` over every engine's pool, and
``host_tier_blocks > 0`` a ``HostKVTier`` of pinned host frames that
evicted replicas spill into; ``overload.enabled`` installs the
``Preemptor`` (pause/spill/resume, its own host tier). The cluster owns
all of them, and they, the engines' peer maps and prefix sinks hold the
cluster only weakly: a dropped server frees its weights and pools at
once, without a garbage collection.

Fault tolerance (``serving.faults`` is the chaos side), in both pool
modes: an instance that misses ``FaultPolicy.heartbeat_timeout_steps``
consecutive heartbeats (or the wall-clock timeout) is marked DEAD and
quarantined — no new creditor legs, its view leaves Algorithm-1
planning, its allocator is drained wholesale (in global-pool mode the
dead rank is a quarantined slice of the one tensor: its memory stays,
every block of it is released and never reused). Every request that lost
KV on the dead rank — owned locally OR creditor-hosted — is recovered by
TOKEN REPLAY: its emitted tokens are known, so the lost KV is exactly
recomputable by re-prefilling ``prompt + output[:-1]`` through the
normal admission path (no resampling; the greedy continuation equals an
unfailed run's). Transfer failures retry with bounded backoff; a move
stripe whose leg fails mid-execution rolls back exactly and re-plans
against surviving creditors. ``install_faults`` arms a deterministic
``FaultPlan``; the injector holds no reference to the cluster.

Global pool sharded over processes (``Cluster(..., mesh=, layout=)``,
``distributed.mesh``): SPMD with replicated control. Every process runs
this whole cluster — every engine's host logic, the gManager, Algorithm
1 — on the same request stream, holds only its slab of the pool
(``layout.pool_axes``), and issues every collective in the same order.
Decisions read only what every process agrees on: the clock is
``agreed_clock`` (the largest of the processes' readings), liveness is
the step-count detector alone, and each step checks that a digest of
its plan (per engine: running requests, their lengths and last tokens,
the waiting queue, the dead set, the paused requests, each request's
replay count and the host tiers' keys in LRU order; then the Algorithm-1
moves) is equal everywhere, raising ``RuntimeError`` in every process if
not. Every extension runs under a mesh, as the JAX package's cluster
runs them over its mesh-sharded pool:

* the host tier and the prefix cache: a spill reads its block through
  ``GlobalKVPool.read_blocks`` (a broadcast from the owner), so EVERY
  process keeps the frame — the tier's keys, LRU order, watermarks,
  pins and checksums stay replicated like the rest of control (a GSPMD
  read is a global array too); a fetch writes on the owner only. The
  cache's content hashes chain from a fixed int root, so they are equal
  in every process;
* overload preemption: pause reads the chain the same way, resume writes
  on the owners; pause stamps and the resume gate read the step's
  agreed clock (``Cluster.step``'s reading, installed in the engines and
  the preemptor);
* a crash is logical: ``kill_instance`` marks the instance dead, its
  rank's slab stays addressable and no process exits; replay re-admits
  through the normal (collective) path;
* a ``FaultPlan`` is deterministic and armed in every process, so every
  process fires the same events and consumes the same one-shot transfer
  faults at the same transfers (a host-fetch corruption flips the same
  frame in every process).
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import (agreed_clock, check_replicated,
                                          mesh_group)
from repro_torch.models.model import POOLED_FAMILIES, resolve_device
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import InstanceEngine
from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultStats
from repro_torch.serving.globalpool import GlobalKVPool
from repro_torch.serving.gmanager import GManager
from repro_torch.serving.hosttier import HostKVTier
from repro_torch.serving.kvpool import rows_for_token_range
from repro_torch.serving.perfmodel import InstancePerfModel
from repro_torch.serving.prefixcache import RadixPrefixCache
from repro_torch.serving.preempt import Preemptor
from repro_torch.serving.protocol import MoveKVCache, MoveLeg, MoveResult
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.staging import AsyncStager


class EngineMap(dict):
    """inst_id -> InstanceEngine: the cluster's engines. A dict that can
    be referenced weakly, so each engine's ``peers`` does not keep the
    map (and with it every engine) alive."""


def reserve_all_or_nothing(req_id: int, legs) -> bool:
    """FCFS-reserve every (rmanager, n_blocks) leg of a striped plan.

    Paper Fig. 8 step 4 generalized to multi-destination plans: either
    EVERY destination accepts its reservation or every reservation made
    so far is cancelled — allocator state is restored exactly and the
    caller sees a clean REJECTED. ``legs``: [(rmanager, n_blocks)].
    """
    reserved = []
    for rm, n in legs:
        if not rm.try_move_kvcache(req_id, n):
            for rm2, m in reserved:
                rm2.cancel_move_in(m)
            return False
        reserved.append((rm, n))
    return True


class PrefixSink:
    """Reserve-then-stream placement of a prompt prefix on creditors.

    Built before any prefill FLOPs are spent: every creditor block the
    [0, n_tokens) prefix needs is already reserved (try_move, FCFS) and
    committed, so admission can only fail while it is still free to
    fail. The owner's chunk loop then calls ``write`` once per chunk to
    scatter the creditor-bound KV rows into those blocks.
    """

    def __init__(self, cluster: "Cluster", req_id: int,
                 spans: List[Tuple[int, int, List[int]]]):
        self._cluster = cluster
        self._req_id = req_id
        self._spans = spans          # [(inst, start_token, block_ids)]
        self._bs = cluster.block_size

    @property
    def spans(self) -> List[Tuple[int, int, List[int]]]:
        """Committed ``(inst, start_token, block_ids)`` spans, in
        global token order — the creditor part of the request's chain."""
        return [(d, st, list(b)) for d, st, b in self._spans]

    @property
    def rank_ids(self) -> List[int]:
        """Creditor instance ids, deduplicated, in prefix order."""
        out: List[int] = []
        for d, _, _ in self._spans:
            if d not in out:
                out.append(d)
        return out

    def coverage(self, upto: int) -> Dict[int, int]:
        """Tokens of the written prefix [0, upto) held per creditor."""
        cov = {d: 0 for d in self.rank_ids}
        for d, start, blocks in self._spans:
            cov[d] += min(max(upto - start, 0), len(blocks) * self._bs)
        return cov

    def row_targets(self, t0: int, t1: int):
        """Per-token (rank, block, offset) of global tokens [t0, t1) in
        the committed creditor spans — the global-pool prefill step
        writes creditor rows itself with these."""
        n = t1 - t0
        ranks = np.zeros(n, np.int32)
        blks = np.zeros(n, np.int32)
        offs = np.zeros(n, np.int32)
        for d, start, blocks in self._spans:
            lo = max(t0, start)
            hi = min(t1, start + len(blocks) * self._bs)
            if lo >= hi:
                continue
            b, o = rows_for_token_range(blocks, self._bs, lo - start,
                                        hi - start)
            ranks[lo - t0:hi - t0] = d
            blks[lo - t0:hi - t0] = b
            offs[lo - t0:hi - t0] = o
        return ranks, blks, offs

    def write(self, t0: int, k, v) -> None:
        """Scatter global prefix rows [t0, t0 + n) into creditor pools.

        k/v: [L, n, K, hd] — one prefill chunk's creditor-bound rows.
        The writes are enqueued here and staged on the cluster's
        ``AsyncStager``; they are drained at ``flush()``, the
        admission's table-commit point.
        """
        n = k.shape[1]
        for d, start, blocks in self._spans:
            lo = max(t0, start)
            hi = min(t0 + n, start + len(blocks) * self._bs)
            if lo >= hi:
                continue
            blk, off = rows_for_token_range(blocks, self._bs,
                                            lo - start, hi - start)
            eng = self._cluster.engines[d]
            eng.host_kv_rows(
                self._req_id, blk, off,
                k[:, lo - t0:hi - t0], v[:, lo - t0:hi - t0])
            self._cluster.stager.stage(eng.kv_store)

    def flush(self) -> None:
        """Drain every staged creditor write (end-of-admission commit)."""
        self._cluster.stager.commit()

    def abort(self) -> None:
        """Cancellation rollback: drain any staged row writes, then
        release every committed creditor span — the same all-or-nothing
        metadata rollback a refused stripe takes. The written rows become
        garbage in freed blocks; allocator state is restored exactly."""
        self._cluster.stager.commit()
        for d in self.rank_ids:
            self._cluster.engines[d].drop_hosted(self._req_id)


class Cluster:
    """N ``InstanceEngine``s + one ``GManager`` driven in lock-step.

    Owns the shared ``AsyncStager`` (all KV movement), the optional
    ``GlobalKVPool``/host tier/prefix cache, and — when
    ``config.overload.enabled`` — the ``Preemptor``. ``step()`` is the
    cluster heartbeat: armed chaos events, every live engine's heartbeat
    into the gManager, liveness and recovery of dead instances, reactive
    moves and the Algorithm-1 plan round, resume of paused requests, a
    step of every live engine, host-tier drains, releases.
    """

    def __init__(self, params, cfg: ModelConfig,
                 config: Optional[ServingConfig] = None, *,
                 perf: Optional[InstancePerfModel] = None, device=None,
                 mesh=None, layout=None):
        config = config if config is not None else ServingConfig()
        self.device = resolve_device(device)
        # Replicated control over a mesh: the group every process of the
        # job is in (the clock and the divergence guard run over it).
        self.mesh = mesh
        self._group = None
        if mesh is not None:
            if not (config.global_pool and cfg.family in POOLED_FAMILIES):
                raise ValueError("a mesh shards the global pool: it needs "
                                 "ServingConfig(global_pool=True) and a "
                                 "pooled (dense or moe) model")
            self._group = mesh_group(mesh)
        # The clock of this step's decisions (``Cluster.clock``'s reading
        # at the top of ``step``), which the engines stamp pauses with.
        self._now = 0.0
        self.cfg = cfg
        self.config = config
        self.block_size = config.block_size
        self.move_chunk = config.move_chunk_tokens
        self.schedule_every = config.schedule_every
        # All stripe/offload/reclaim row copies and streaming-prefill
        # creditor writes go through one double-buffered stager.
        fpol = config.faults
        self.stager = AsyncStager(overlap=config.async_movement,
                                  max_retries=fpol.max_transfer_retries,
                                  backoff_base_s=fpol.retry_backoff_base_s,
                                  backoff_max_s=fpol.retry_backoff_max_s)
        # Global-pool mode: ONE [n_instances, L, NB, bs, K, hd] tensor
        # holds every instance's KV; every engine aliases its rank's
        # slice + allocator.
        self.gpool = None
        if config.global_pool and cfg.family in POOLED_FAMILIES:
            self.gpool = GlobalKVPool(
                config.n_instances, config.pool_blocks, config.block_size,
                cfg, device=self.device, mesh=mesh,
                pool_axes=(layout.pool_axes if layout is not None
                           else ("data",)))
        self.engines: Dict[int, InstanceEngine] = EngineMap({
            i: InstanceEngine(params, cfg, max_batch=config.max_batch,
                              max_local_len=config.max_local_len,
                              pool_blocks=config.pool_blocks,
                              block_size=config.block_size, inst_id=i,
                              prefill_chunk=config.prefill_chunk,
                              device=self.device, gpool=self.gpool)
            for i in range(config.n_instances)
        })
        for eng in self.engines.values():
            eng.prefix_sink = self._make_prefix_sink(eng.inst_id)
            eng.peers = self.engines      # shared: add_instance updates all
            if self._group is not None:
                eng.clock = self._step_clock()
        # Host-DRAM tier + cross-request prefix cache (both opt-in). They
        # and the preemptor reach the cluster through a weak proxy.
        self.host_tier: Optional[HostKVTier] = None
        self.prefix_cache: Optional[RadixPrefixCache] = None
        if config.host_tier_blocks > 0:
            self.host_tier = HostKVTier(
                config.host_tier_blocks,
                high_watermark=config.host_high_watermark,
                low_watermark=config.host_low_watermark,
                verify=fpol.verify_host_frames,
                max_retries=fpol.max_transfer_retries,
                backoff_base_s=fpol.retry_backoff_base_s,
                backoff_max_s=fpol.retry_backoff_max_s)
        if config.prefix_cache:
            self.prefix_cache = RadixPrefixCache(weakref.proxy(self),
                                                 host_tier=self.host_tier)
            for eng in self.engines.values():
                self._wire_cache(eng)
        perf = perf if perf is not None else InstancePerfModel(cfg)
        self.gmanager = GManager(perf, config.block_size,
                                 heartbeat_timeout=config.heartbeat_timeout,
                                 beta_thres=config.beta_threshold,
                                 mem_util_thres=config.mem_util_thres,
                                 avg_new_req_len=config.avg_new_req_len,
                                 max_stripes=config.max_stripes,
                                 reclaim_horizon_s=config.reclaim_horizon_s,
                                 arrival_alpha=config.overload.arrival_alpha,
                                 heartbeat_timeout_steps=(
                                     fpol.heartbeat_timeout_steps))
        # Overload survival (opt-in): pause/host-spill preemption with
        # its own pinned host tier, driven by the serving frontend.
        self.preemptor: Optional[Preemptor] = None
        if config.overload.enabled:
            self.preemptor = Preemptor(weakref.proxy(self), config.overload)
            if self._group is not None:
                self.preemptor.clock = self._step_clock()
        self.requests: Dict[int, Request] = {}
        self._step_count = 0
        # Dead (quarantined) instances; the cache, the preemptor and the
        # creditor picks filter on it.
        self._dead: set = set()
        # Dead instances whose recovery has run (``_handle_dead``).
        self._recovered: set = set()
        self.fault_stats = FaultStats()
        self.faults: Optional[FaultInjector] = None
        self._need_full_hb: set = set(self.engines)
        # Req ids whose creditor-hosted spans still need releasing; fed
        # by the engines' finished-event drains so each finished request
        # is released exactly once (never a rescan of all history).
        self._pending_release: set = set()

    # ----------------------------------------------------------------- #
    def submit(self, req: Request, now: Optional[float] = None) -> None:
        """Register ``req`` and enqueue it on the instance Algorithm 1
        picks (least-loaded engine before any heartbeat exists)."""
        if req.req_id not in self.requests and req.arrival_time == 0.0:
            req.arrival_time = self.clock(now)
        self.requests[req.req_id] = req
        inst = self.gmanager.pick_instance_for_new_request()
        if inst is None or inst in self._dead:
            # Bootstrap: no heartbeats yet -> least-loaded live engine.
            live = [e for i, e in self.engines.items()
                    if i not in self._dead]
            inst = min(live, key=lambda e: e.batch_size).inst_id
        self.engines[inst].submit(req)

    def submit_to(self, req: Request, inst_id: int,
                  now: Optional[float] = None) -> None:
        """Targeted ``submit``: enqueue on a SPECIFIC live instance —
        the preemption path pairs a paused victim's freed slot with the
        urgent request it was freed for, bypassing the most-free-memory
        placement query."""
        if req.req_id not in self.requests and req.arrival_time == 0.0:
            req.arrival_time = self.clock(now)
        self.requests[req.req_id] = req
        assert inst_id in self.engines and inst_id not in self._dead
        self.engines[inst_id].submit(req)

    def cancel(self, req_id: int) -> bool:
        """Cancel a request anywhere in its lifecycle.

        Propagates through every layer: the owning engine's slot (or
        waiting queue) is released, an in-flight streaming prefill is
        flagged and aborts at its next chunk boundary (rolling back its
        ``PrefixSink`` creditor reservations), every creditor-hosted
        span is dropped exactly once, and any planned-but-unexecuted
        ``MoveKVCache`` for the request resolves ``MoveResult.GONE``.
        Returns True if the request was live when cancelled.
        """
        req = self.requests.get(req_id)
        if req is None or req.done:
            return False
        req.cancelled = True
        # A PAUSED request lives in no engine — its device state was
        # already released at pause; retire it from the preempt tier.
        if self.preemptor is not None and \
                self.preemptor.cancel_paused(req_id):
            return True
        for i, eng in self.engines.items():
            if i in self._dead:
                continue
            if eng.cancel(req):
                break
        # Mid-streaming-prefill: the engine's chunk loop owns the
        # rollback; hosted spans are released when its finished event
        # drains. For every other state the request is terminal now —
        # release creditor-hosted spans immediately so allocator state
        # is clean the moment cancel() returns.
        if req.done:
            for eng in self.engines.values():
                if eng.rmanager.is_hosting(req_id):
                    eng.drop_hosted(req_id)
        return True

    def _wire_cache(self, eng: InstanceEngine) -> None:
        """Install the prefix cache's hooks on one engine: the engine's
        admission walks/inserts it, and the rManager treats unpinned
        replicas as reclaimable capacity (evicting on demand)."""
        cache = self.prefix_cache
        eng.prefix_cache = cache
        inst = eng.inst_id
        eng.rmanager.evict_hook = \
            lambda n, _i=inst: cache.evict_device(_i, n)
        eng.rmanager.cache_blocks_fn = \
            lambda _i=inst: cache.evictable(_i)

    # --- movement ------------------------------------------------------ #
    def _make_prefix_sink(self, src_id: int):
        """Reserve-then-stream prefix sink for streaming paged prefill.

        ``sink(req, n_tokens, start=0)`` commits whole blocks covering
        the block-aligned GLOBAL token range [start, start + n_tokens)
        across one or more creditors (striping when no single creditor
        can hold it; ``start`` > 0 when a cached prefix already covers
        the head of the prompt) and returns the ``PrefixSink`` the
        owner's chunk loop writes through — or None when the cluster is
        out of pooled memory, with every partial reservation rolled back
        and zero compute spent. Creditors count their unpinned
        prefix-cache replicas as capacity (try_move evicts on demand).

        ``prefer`` (``[(inst_id, n_blocks)]``, chain order) asks the
        sink to reproduce a specific span layout before falling back to
        the generic creditor picker — preemption resume passes the
        paused chain's layout so the restored request keeps its exact
        LSE-merge partition. Entries naming dead instances or the owner
        itself are skipped (their blocks fall through to the generic
        picker), so ``prefer`` is best-effort and never blocks a resume
        that generic placement could satisfy.

        The sink holds the cluster weakly (the engine holding it is the
        cluster's)."""
        cluster = weakref.proxy(self)

        def sink(req: Request, n_tokens: int, start: int = 0,
                 prefer: Optional[List[Tuple[int, int]]] = None,
                 ) -> Optional[PrefixSink]:
            bs = cluster.block_size
            spans: List[Tuple[int, int, List[int]]] = []

            def rollback():
                for d, _, _ in spans:
                    cluster.engines[d].drop_hosted(req.req_id)

            def take(dst: int, nb: int, off: int) -> int:
                """Reserve up to ``nb`` blocks on ``dst``; 0 on refusal."""
                eng = cluster.engines[dst]
                nb = min(nb, eng.rmanager.effective_free)
                if nb <= 0 or not eng.rmanager.try_move_kvcache(
                        req.req_id, nb):
                    return 0
                blocks = eng.rmanager.commit_move_in(req.req_id, nb,
                                                     at_front=False)
                spans.append((dst, start + off, blocks))
                return nb

            off = 0
            for dst, nb in (prefer or []):
                if off >= n_tokens:
                    break
                if dst == src_id or dst in cluster._dead \
                        or dst not in cluster.engines:
                    continue
                nb = min(nb, (n_tokens - off) // bs)
                off += take(dst, nb, off) * bs
            while off < n_tokens:
                dst = cluster._pick_creditor(exclude=src_id)
                if dst is None:
                    rollback()
                    return None
                nb = take(dst, (n_tokens - off) // bs, off)
                if nb <= 0:
                    rollback()
                    return None
                off += nb * bs
            return PrefixSink(cluster, req.req_id, spans)
        return sink

    def _execute_move(self, mv: MoveKVCache) -> MoveResult:
        """Execute one striped plan: the oldest blocks of a request's
        span on ``src_inst`` stream onto one or more destinations.

        All-or-nothing: EVERY leg is reserved on its destination first
        (try_move_kvcache, FCFS); if any leg is refused all reservations
        are cancelled and nothing moved. Only then does each leg copy
        pool rows + edit tables. Handles both offload plans (src = owner,
        keep the live tail local) and reclaim plans (src = a stressed
        creditor; a leg whose destination is the OWNER re-adopts blocks
        at the FRONT of its local span).

        A leg that fails mid-stripe (an injected ``move_leg`` fault)
        cancels its own and every later leg's reservation exactly; the
        un-moved tail re-plans once onto a creditor outside the failed
        stripe (``FaultStats.move_leg_replans``)."""
        if mv.src_inst in self._dead or \
                any(leg.dst_inst in self._dead for leg in mv.legs):
            return MoveResult.REJECTED
        src = self.engines[mv.src_inst]
        req = self.requests.get(mv.req_id)
        if req is None or req.done or req.slot is None:
            return MoveResult.GONE
        if not src._can_pool or not all(self.engines[leg.dst_inst]._can_pool
                                        for leg in mv.legs):
            return MoveResult.GONE       # a non-pooled engine has no KV rows
        owner = next((e for i, e in self.engines.items()
                      if i not in self._dead and req in e.running), None)
        if owner is None:
            return MoveResult.GONE
        bs = self.block_size
        if mv.src_inst == owner.inst_id:
            # Offload: only full blocks, keep the live tail local.
            budget = max(0, src.local_tokens(req) - bs) // bs
        else:
            # Reclaim: src hosts a whole-block span (or the plan is
            # stale and the span is gone).
            rb = src.rmanager.pool.requests.get(mv.req_id)
            budget = len(rb.blocks) if rb is not None else 0
        # Clamp legs in order against what src can actually give up.
        legs = []
        for leg in mv.legs:
            n = min(leg.num_blocks, budget)
            if n <= 0:
                continue
            if leg.dst_inst == owner.inst_id and mv.src_inst != \
                    owner.inst_id:
                # Re-adopting at the owner must respect its local quota
                # (headroom for the next decode append included).
                room = (owner.max_local_len - owner.local_tokens(req)
                        - bs) // bs
                n = min(n, max(0, room))
                if n <= 0:
                    continue
            legs.append((leg.dst_inst, n))
            budget -= n
        if not legs:
            return MoveResult.GONE
        # Paper Fig. 8 step 4, striped: FCFS reservation on EVERY
        # destination before any KV byte moves; one refusal rolls every
        # reservation back.
        if not reserve_all_or_nothing(
                mv.req_id,
                [(self.engines[d].rmanager, n) for d, n in legs]):
            return MoveResult.REJECTED
        # Commit: each leg is pool-row copies + table edits, oldest
        # blocks first so the source span drains front-to-back. The
        # owner's sequence-ordered global chain tracks every relocated
        # block; a fully-local request gets one on its first move.
        if owner.req_chain.get(mv.req_id) is None:
            rb0 = owner.rmanager.pool.requests.get(mv.req_id)
            if rb0 is not None:
                owner.req_chain[mv.req_id] = [(owner.inst_id, b)
                                              for b in rb0.blocks]
        failed_tail: List[Tuple[int, int]] = []
        executed = 0
        for li, (dst_id, n) in enumerate(legs):
            if self.faults is not None and \
                    self.faults.take_move_leg_fault():
                # Injected mid-stripe leg failure: this leg and every
                # later one are still only RESERVATIONS (their
                # commit_move_in has not run) — cancel them exactly.
                # Executed legs keep their consistent placement.
                self.fault_stats.move_leg_failures += 1
                for dj, nj in legs[li:]:
                    self.engines[dj].rmanager.cancel_move_in(nj)
                failed_tail = legs[li:]
                break
            dst = self.engines[dst_id]
            src_blocks = list(
                src.rmanager.pool.requests[mv.req_id].blocks[:n])
            blocks = dst.rmanager.commit_move_in(
                mv.req_id, n, at_front=(dst_id == owner.inst_id))
            if self.gpool is not None:
                # Global-pool mode: the leg is ONE block copy between
                # rank slices of the tensor + allocator/table edits.
                self.gpool.copy_blocks(src.inst_id, src_blocks, dst_id,
                                       blocks)
            else:
                k, v = src.extract_prefix_kv(req, n)
                dst.host_kv(mv.req_id, blocks, k, v)
            self.stager.stage(dst.kv_store)
            src.rmanager.move_out_prefix(mv.req_id, n)
            c = self.cfg
            nbytes = (2 * c.num_layers * n * bs * c.num_kv_heads *
                      c.head_dim * src.kv_store[0].element_size())
            if dst_id != owner.inst_id:
                insts = owner.remote_insts.setdefault(mv.req_id, [])
                if dst_id not in insts:
                    insts.append(dst_id)
            src.stats.kv_moved += nbytes
            src.stats.tokens_moved_steps.append(n * bs)
            # Rewrite the chain entries in place (ID-based: the moved
            # blocks keep their position in the global token order).
            chain = owner.req_chain.get(mv.req_id)
            if chain is not None and blocks is not None:
                remap = {(mv.src_inst, sb): (dst_id, nb)
                         for sb, nb in zip(src_blocks, blocks)}
                for ci, e in enumerate(chain):
                    if e in remap:
                        chain[ci] = remap.pop(e)
            executed += 1
        if failed_tail:
            # Re-plan the un-moved tail onto a surviving creditor OUTSIDE
            # the failed stripe (source and every failed destination
            # excluded). One recursive attempt — a still-armed fault is
            # consumed above — and no alternative leaves the tail where
            # it was for the next reactive or planning round.
            n_rest = sum(n for _, n in failed_tail)
            alt = self._pick_creditor(
                exclude={mv.src_inst} | {d for d, _ in failed_tail})
            if alt is not None:
                res = self._execute_move(MoveKVCache(
                    mv.req_id, mv.src_inst, [MoveLeg(alt, n_rest)]))
                if res == MoveResult.OK:
                    self.fault_stats.move_leg_replans += 1
                    return MoveResult.OK
            return MoveResult.OK if executed else MoveResult.REJECTED
        # A reclaim that drained the source span drops it from the
        # owner's span map (and frees the host's metadata).
        if mv.src_inst != owner.inst_id and \
                not src.rmanager.pool.tokens_of(mv.req_id):
            src.drop_hosted(mv.req_id)
            insts = owner.remote_insts.get(mv.req_id)
            if insts and mv.src_inst in insts:
                insts.remove(mv.src_inst)
                if not insts:
                    owner.remote_insts.pop(mv.req_id, None)
        return MoveResult.OK

    def _reactive_moves(self) -> None:
        """Ship prefix blocks before a request breaches its local quota."""
        for i, eng in self.engines.items():
            if i in self._dead or not eng._can_pool:
                continue
            for req in eng.running:
                if eng.local_free_tokens(req) <= 1:
                    dst = self._pick_creditor(exclude=eng.inst_id)
                    n_blocks = max(1, self.move_chunk // self.block_size)
                    ok = (dst is not None and
                          self._execute_move(MoveKVCache(
                              req.req_id, eng.inst_id,
                              [MoveLeg(dst, n_blocks)]))
                          == MoveResult.OK)
                    if not ok and eng.local_free_tokens(req) <= 0:
                        # The next append would breach the quota and no
                        # creditor can absorb blocks: the cluster is out
                        # of pooled memory -> fail loudly, never corrupt
                        # (paper: reject when pool exhausted).
                        eng._fail(req)

    def _pick_creditor(self, exclude) -> Optional[int]:
        excl = {exclude} if isinstance(exclude, int) else set(exclude)
        best, best_free = None, 0
        for i, e in self.engines.items():
            if i in excl or i in self._dead or not e._can_pool:
                continue
            free = e.rmanager.effective_free
            if free > best_free:
                best, best_free = i, free
        return best

    # --- fault tolerance ------------------------------------------------#
    def kill_instance(self, inst_id: int) -> None:
        """Simulate an instance failure: it stops heartbeating (and
        stepping) at once; detection and recovery follow in ``step``.
        Under a mesh the crash is logical (every process calls this at
        the same point): the rank's slab stays, no process exits."""
        self._dead.add(inst_id)

    def install_faults(self, plan: FaultPlan) -> FaultInjector:
        """Arm a deterministic chaos plan against this cluster.

        Crash/silence events fire at the top of the matching ``step()``;
        transfer faults (move leg, host fetch/corrupt, stager timeout)
        become one-shot armed flags the subsystem hooks consume on the
        next matching transfer. Returns the attached injector (the
        cluster holds it; it holds nothing of the cluster). Under a mesh
        every process arms the same plan."""
        return FaultInjector(plan).attach(self)

    def _recover_via_replay(self, req: Request,
                            owner: Optional[InstanceEngine] = None) -> bool:
        """Re-admit one request whose KV (partially) died with a rank.

        Every surviving resource the request still holds is released
        exactly once — the live owner's slot and local blocks (when
        ``owner`` is given), hosted spans on live creditors, cache pins —
        then the request goes back to WAITING with ``needs_replay`` set:
        admission re-prefills ``prompt + output[:-1]`` (known tokens, NO
        resampling) and the next decode feeds ``output[-1]``, so the
        greedy continuation equals an unfailed run's. The emitted-token
        stream is never truncated — ``RequestHandle.tokens()`` consumers
        see no seam. A request past
        ``FaultPolicy.max_replays_per_request`` FAILs instead of
        replaying forever. Returns True when the request was re-queued."""
        if req.done:
            return False
        rid = req.req_id
        if owner is not None:
            if req.slot is not None and owner.slots[req.slot] is req:
                owner.slots[req.slot] = None
            owner.rmanager.release_request(rid)
            owner.remote_insts.pop(rid, None)
            owner.req_chain.pop(rid, None)
        req.slot = None
        for i, e in self.engines.items():
            if i not in self._dead and e.rmanager.is_hosting(rid):
                e.drop_hosted(rid)
        if self.prefix_cache is not None:
            self.prefix_cache.release(rid)
        if req.output and \
                req.replays >= self.config.faults.max_replays_per_request:
            req.state = RequestState.FAILED
            req.finish_time = time.monotonic()
            self.fault_stats.failed_recoveries += 1
            return False
        req.state = RequestState.WAITING
        req.needs_replay = bool(req.output)
        self.fault_stats.recoveries += 1
        self.fault_stats.replayed_tokens += max(0, len(req.output) - 1)
        self.submit(req)
        return True

    def _handle_dead(self, dead: List[int]) -> None:
        """Quarantine newly dead instances and recover their requests.

        Every request with LOCAL blocks (owned by the dead engine) or a
        creditor-HOSTED span on the dead rank lost KV that is exactly
        recomputable from its known tokens — each is re-admitted via
        ``_recover_via_replay``. The dead rank's allocator is then
        drained wholesale (leftover records, cache replicas), so a
        quarantined rank — in global-pool mode, the quarantined slice of
        the one tensor — holds zero blocks, and the gManager forgets it:
        its view leaves Algorithm-1 planning and
        ``pick_instance_for_new_request`` can never choose it."""
        for d in dead:
            self._dead.add(d)
            self._recovered.add(d)
            self.fault_stats.dead_instances += 1
            eng = self.engines[d]
            # 1) Requests OWNED by the dead instance (running or queued):
            #    their local span is gone.
            for req in list(eng.running) + list(eng.waiting):
                self._recover_via_replay(req)
            eng.slots = [None] * eng.max_batch
            eng.waiting = []
            # 2) Requests owned by SURVIVORS with a span hosted on the
            #    dead rank: the lost creditor span is replayed too.
            for i, e in self.engines.items():
                if i in self._dead:
                    continue
                for req in list(e.running):
                    if d in e.remote_insts.get(req.req_id, ()):
                        self._recover_via_replay(req, owner=e)
            # 3) Drain the dead rank's allocator: whatever records remain
            #    (hosted spans of other dead-owned requests, stale
            #    entries) release here, and its prefix-cache replicas are
            #    purged — the quarantined rank ends with zero blocks.
            for rid in list(eng.rmanager.pool.requests):
                eng.rmanager.release_request(rid)
            if self.prefix_cache is not None:
                self.prefix_cache.purge_instance(d)
            eng.remote_insts.clear()
            eng.req_chain.clear()
            self.gmanager.deregister(d)

    def add_instance(self, params) -> int:
        """Elastic scale-out: new instance joins as a fresh creditor."""
        if self.gpool is not None:
            raise RuntimeError(
                "add_instance is unsupported in global-pool mode: the "
                "pool tensor's rank axis is fixed at construction")
        new_id = max(self.engines) + 1
        ref = next(iter(self.engines.values()))
        self.engines[new_id] = InstanceEngine(
            params, self.cfg, max_batch=ref.max_batch,
            max_local_len=ref.max_local_len,
            pool_blocks=ref.rmanager.pool.alloc.num_blocks,
            block_size=self.block_size, inst_id=new_id,
            prefill_chunk=ref.prefill_chunk, device=self.device)
        self.engines[new_id].prefix_sink = self._make_prefix_sink(new_id)
        self.engines[new_id].peers = self.engines
        if self.prefix_cache is not None:
            self._wire_cache(self.engines[new_id])
        self._need_full_hb.add(new_id)
        return new_id

    # ----------------------------------------------------------------- #
    def clock(self, now: Optional[float] = None) -> float:
        """``now`` (``time.monotonic()`` by default); under a mesh the
        reading every process agrees on (a collective)."""
        if self._group is not None:
            return agreed_clock(self._group, now)
        return time.monotonic() if now is None else now

    def _step_clock(self):
        """An engine's clock under a mesh: this step's agreed reading
        (held weakly: the engines are the cluster's)."""
        ref = weakref.ref(self)
        return lambda: ref()._now

    def _plan_state(self) -> list:
        """What this step's decisions follow from: per engine, running
        requests with their lengths and last tokens, and the waiting
        queue; the dead instances, the paused requests (with their pause
        stamps), every live request's replay count, and each host tier's
        keys in LRU order."""
        tiers = [t for t in (self.host_tier, self.preemptor and
                             self.preemptor.tier) if t is not None]
        return [[(i, [(r.req_id, r.length, r.output[-1] if r.output else -1)
                      for r in e.slots if r is not None],
                  [r.req_id for r in e.waiting])
                 for i, e in self.engines.items()],
                sorted(self._dead),
                [] if self.preemptor is None else
                [(rid, rec.paused_at) for rid, rec in
                 self.preemptor.paused.items()],
                [(rid, r.replays) for rid, r in self.requests.items()
                 if r.replays and not r.done],
                [t.lru_keys() for t in tiers]]

    def step(self, now: Optional[float] = None, *,
             agreed: bool = False) -> int:
        """One cluster iteration: heartbeats, liveness, plan, moves,
        decode. ``agreed``: ``now`` already is the reading every process
        agrees on (``LLMServer.step`` agreed on it), so no second
        collective is spent on the clock."""
        if not agreed:
            now = self.clock(now)
        self._now = now
        self._step_count += 1
        if self._group is not None:
            # Divergence guard: before this step's first collective.
            check_replicated(self._group, "step state",
                             (self._step_count, now, self._plan_state()))

        # Armed chaos events fire first: a crash injected at this step
        # already misses this step's heartbeat, like a real failure in
        # the gap between steps.
        if self.faults is not None:
            self.faults.on_step(self._step_count, self)

        # Heartbeats (dead and fault-silenced instances stay silent).
        beat: set = set()
        for i, eng in self.engines.items():
            if i in self._dead:
                continue
            if self.faults is not None and \
                    self.faults.silenced(i, self._step_count):
                continue
            full = i in self._need_full_hb or self.gmanager.bootstrapping
            ok = self.gmanager.on_heartbeat(eng.rmanager.heartbeat(full),
                                            now=now)
            if not ok:
                self.gmanager.on_heartbeat(
                    eng.rmanager.heartbeat(full=True), now=now)
            self._need_full_hb.discard(i)
            beat.add(i)
        self.gmanager.bootstrapping = False

        # Liveness: the wall-clock timeout against this step's ``now``
        # (the time live engines just beat at, so a slow step never
        # kills a live engine) OR the deterministic step-count detector.
        # Under a mesh only the step-count detector (a slow step must not
        # read as a death in one process and not in another).
        dead = (self.gmanager.check_liveness(now=now)
                if self.mesh is None else [])
        for d in self.gmanager.check_liveness_steps(beat):
            if d not in dead:
                dead.append(d)
        # An instance killed before its first heartbeat was never
        # registered, so neither detector can see it: recover it at once
        # (it holds nothing but queued requests).
        for d in sorted(self._dead - self._recovered):
            if d not in self.gmanager.instances and d not in dead:
                dead.append(d)
        if dead:
            self._handle_dead(dead)

        # Reactive overflow shipping, then periodic Algorithm-1 planning.
        self._reactive_moves()
        if self._step_count % self.schedule_every == 0 and any(
                e._can_pool for e in self.engines.values()):
            # Frontend lifecycle feeds the planner: per-request urgency
            # (priority + deadline proximity) biases which debtor
            # requests are offloaded first.
            urgency = {rid: r.urgency(now)
                       for rid, r in self.requests.items()
                       if not r.done and (r.priority
                                          or r.deadline_s is not None)}
            moves = self.gmanager.plan_moves(urgency=urgency)
            if self._group is not None:
                check_replicated(self._group, "move plan",
                                 [(m.req_id, m.src_inst,
                                   [(g.dst_inst, g.num_blocks)
                                    for g in m.legs]) for m in moves])
            for mv in moves:
                self._execute_move(mv)

        # Resume parked (preempted) requests before the decode sweep so
        # a freed slot carries tokens this very step; the preemptor's
        # guards keep it from stealing capacity the waiting queue (or a
        # more urgent arrival) is entitled to.
        if self.preemptor is not None:
            self.preemptor.maybe_resume(now=now)

        made = 0
        for i, eng in self.engines.items():
            if i not in self._dead:
                made += eng.step()
        # Finalize whichever D2H spills have landed (the preempt tier's
        # and the shared tier's) — behind the decode compute just
        # dispatched, never blocking on it.
        if self.preemptor is not None:
            self.preemptor.tier.drain(block=False)
        if self.host_tier is not None:
            self.host_tier.drain(block=False)
        # Free creditor-hosted blocks of requests that finished since the
        # last step (metadata only). Engines report each finish once.
        for i, eng in self.engines.items():
            if i not in self._dead:
                self._pending_release.update(eng.drain_finished())
        for rid in self._pending_release:
            req = self.requests.get(rid)
            if req is not None and not req.done:
                # A pause queues a finished event after dropping the
                # chain's hosted spans itself. If the request resumed
                # within this same step, is_hosting is true again for its
                # FRESH creditor spans — releasing those here would
                # silently shrink the resumed chain. Live requests keep
                # their spans; terminal ones release as usual.
                continue
            for eng in self.engines.values():
                if eng.rmanager.is_hosting(rid):
                    eng.drop_hosted(rid)
        self._pending_release.clear()
        return made

    # ----------------------------------------------------------------- #
    def run_until_done(self, max_steps: int = 10_000) -> int:
        """Step until every registered request is done; returns steps."""
        steps = 0
        while steps < max_steps and any(not r.done
                                        for r in self.requests.values()):
            self.step()
            steps += 1
        return steps

    @property
    def throughput_stats(self) -> Dict[str, float]:
        """Cluster-wide KV-moved / query-shipped byte counters."""
        total_kv = sum(e.stats.kv_moved for e in self.engines.values())
        total_q = sum(e.stats.query_shipped for e in self.engines.values())
        return {"kv_moved_bytes": total_kv, "query_shipped_bytes": total_q}
