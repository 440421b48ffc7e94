"""Cluster runtime: N instances + gManager, KV movement.

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

Not in this port yet (each raises NotImplementedError): the prefix cache
and host tier, overload preemption, fault injection/recovery
(``kill_instance``, ``install_faults``), and a global pool sharded over
several devices.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import POOLED_FAMILIES, resolve_device
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import InstanceEngine
from repro_torch.serving.globalpool import GlobalKVPool
from repro_torch.serving.gmanager import GManager
from repro_torch.serving.kvpool import rows_for_token_range
from repro_torch.serving.perfmodel import InstancePerfModel
from repro_torch.serving.protocol import MoveKVCache, MoveLeg, MoveResult
from repro_torch.serving.request import Request
from repro_torch.serving.staging import AsyncStager

_LATER = "is not ported yet; it comes with a later slice of the port"


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
            self._cluster.stager.stage((eng.pool_k, eng.pool_v))

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

    ``step()`` is the cluster heartbeat: step every engine's heartbeat
    into the gManager, run reactive moves and the Algorithm-1 plan
    round, execute moves, step every engine, drain releases.
    """

    def __init__(self, params, cfg: ModelConfig,
                 config: Optional[ServingConfig] = None, *,
                 perf: Optional[InstancePerfModel] = None, device=None):
        config = config if config is not None else ServingConfig()
        if config.prefix_cache or config.host_tier_blocks > 0:
            raise NotImplementedError(
                f"the prefix cache and host-DRAM tier {_LATER}")
        if config.overload.enabled:
            raise NotImplementedError(f"overload preemption {_LATER}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.config = config
        self.block_size = config.block_size
        self.move_chunk = config.move_chunk_tokens
        self.schedule_every = config.schedule_every
        # All stripe/offload/reclaim row copies and streaming-prefill
        # creditor writes go through one double-buffered stager.
        self.stager = AsyncStager(overlap=config.async_movement)
        # Global-pool mode: ONE [n_instances, L, NB, bs, K, hd] tensor
        # holds every instance's KV; every engine aliases its rank's
        # slice + allocator.
        self.gpool = None
        if config.global_pool and cfg.family in POOLED_FAMILIES:
            self.gpool = GlobalKVPool(config.n_instances,
                                      config.pool_blocks, config.block_size,
                                      cfg, device=self.device)
        self.engines: Dict[int, InstanceEngine] = {
            i: InstanceEngine(params, cfg, max_batch=config.max_batch,
                              max_local_len=config.max_local_len,
                              pool_blocks=config.pool_blocks,
                              block_size=config.block_size, inst_id=i,
                              prefill_chunk=config.prefill_chunk,
                              device=self.device, gpool=self.gpool)
            for i in range(config.n_instances)
        }
        for eng in self.engines.values():
            eng.prefix_sink = self._make_prefix_sink(eng.inst_id)
            eng.peers = self.engines      # shared: add_instance updates all
        perf = perf if perf is not None else InstancePerfModel(cfg)
        fpol = config.faults
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
        self.requests: Dict[int, Request] = {}
        self._step_count = 0
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
            req.arrival_time = time.monotonic() if now is None else now
        self.requests[req.req_id] = req
        inst = self.gmanager.pick_instance_for_new_request()
        if inst is None:
            # Bootstrap: no heartbeats yet -> least-loaded engine.
            inst = min(self.engines.values(),
                       key=lambda e: e.batch_size).inst_id
        self.engines[inst].submit(req)

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
        for eng in self.engines.values():
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

    # --- movement ------------------------------------------------------ #
    def _make_prefix_sink(self, src_id: int):
        """Reserve-then-stream prefix sink for streaming paged prefill.

        ``sink(req, n_tokens, start=0)`` commits whole blocks covering
        the block-aligned GLOBAL token range [start, start + n_tokens)
        across one or more creditors (striping when no single creditor
        can hold it) and returns the ``PrefixSink`` the owner's chunk
        loop writes through — or None when the cluster is out of pooled
        memory, with every partial reservation rolled back and zero
        compute spent."""
        def sink(req: Request, n_tokens: int, start: int = 0
                 ) -> Optional[PrefixSink]:
            bs = self.block_size
            spans: List[Tuple[int, int, List[int]]] = []

            def rollback():
                for d, _, _ in spans:
                    self.engines[d].drop_hosted(req.req_id)

            off = 0
            while off < n_tokens:
                dst = self._pick_creditor(exclude=src_id)
                if dst is None:
                    rollback()
                    return None
                eng = self.engines[dst]
                nb = min((n_tokens - off) // bs, eng.rmanager.effective_free)
                if nb <= 0 or not eng.rmanager.try_move_kvcache(
                        req.req_id, nb):
                    rollback()
                    return None
                blocks = eng.rmanager.commit_move_in(req.req_id, nb,
                                                     at_front=False)
                spans.append((dst, start + off, blocks))
                off += nb * bs
            return PrefixSink(self, req.req_id, spans)
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
        at the FRONT of its local span)."""
        src = self.engines[mv.src_inst]
        req = self.requests.get(mv.req_id)
        if req is None or req.done or req.slot is None:
            return MoveResult.GONE
        if not src._can_pool or not all(self.engines[leg.dst_inst]._can_pool
                                        for leg in mv.legs):
            return MoveResult.GONE       # a non-pooled engine has no KV rows
        owner = next((e for e in self.engines.values()
                      if req in e.running), None)
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
        for dst_id, n in legs:
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
            self.stager.stage((dst.pool_k, dst.pool_v))
            src.rmanager.move_out_prefix(mv.req_id, n)
            c = self.cfg
            nbytes = (2 * c.num_layers * n * bs * c.num_kv_heads *
                      c.head_dim * src.pool_k.element_size())
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
        for eng in self.engines.values():
            if not eng._can_pool:
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
            if i in excl or not e._can_pool:
                continue
            free = e.rmanager.effective_free
            if free > best_free:
                best, best_free = i, free
        return best

    def kill_instance(self, inst_id: int) -> None:
        """Instance failure injection: not in this slice of the port."""
        raise NotImplementedError(f"fault injection and recovery {_LATER}")

    def install_faults(self, plan) -> None:
        """Chaos-plan injection: not in this slice of the port."""
        raise NotImplementedError(f"fault injection and recovery {_LATER}")

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
        self._need_full_hb.add(new_id)
        return new_id

    # ----------------------------------------------------------------- #
    def step(self, now: Optional[float] = None) -> int:
        """One cluster iteration: heartbeats, plan, moves, decode."""
        now = time.monotonic() if now is None else now
        self._step_count += 1
        for i, eng in self.engines.items():
            full = i in self._need_full_hb or self.gmanager.bootstrapping
            ok = self.gmanager.on_heartbeat(eng.rmanager.heartbeat(full),
                                            now=now)
            if not ok:
                self.gmanager.on_heartbeat(
                    eng.rmanager.heartbeat(full=True), now=now)
            self._need_full_hb.discard(i)
        self.gmanager.bootstrapping = False

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
            for mv in self.gmanager.plan_moves(urgency=urgency):
                self._execute_move(mv)

        made = 0
        for eng in self.engines.values():
            made += eng.step()
        # Free creditor-hosted blocks of requests that finished since the
        # last step (metadata only). Engines report each finish once.
        for eng in self.engines.values():
            self._pending_release.update(eng.drain_finished())
        for rid in self._pending_release:
            req = self.requests.get(rid)
            if req is not None and not req.done:
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
