"""Single-instance serving engine: continuous batching over a paged pool.

ORCA-style iteration-level scheduling: each ``step()`` admits waiting
requests into free slots (prefill), then runs ONE decode iteration for
all running slots. All serving KV bytes live in the instance's
device-resident block pool ``pool_k/pool_v: [L, num_blocks, block_size,
K, hd]``, managed by the ``RManager``'s block allocator and addressed
only through block tables:

  * admission is STREAMING PAGED PREFILL: every block the prompt needs
    is reserved up front (the local tail in this pool; the overflow
    prefix committed on creditors through the reserve-then-stream
    ``prefix_sink``), then ``prefill_chunk_paged`` streams the prompt in
    fixed-size chunks — chunk-internal causal attention plus paged
    MicroAttention partials over the already-written spans, with each
    chunk's KV rows written straight into the reserved blocks. Peak
    admission memory is O(chunk + pool), and a prompt can stripe its
    prefix across several creditors at admission time,
  * each decode step appends the new token's KV into the request's tail
    block inside ``decode_step_paged``,
  * creditor-hosted spans are just blocks owned by ``req_id`` in the
    creditor's pool (``host_kv`` writes whole migrated blocks;
    ``host_kv_rows`` takes the prefill stream's row-addressed writes;
    dropping them is a metadata release),
  * moving KV between instances copies pool rows and edits tables; a
    striped Algorithm-1 plan is a sequence of such copies, one per
    (destination, k-blocks) leg, each reserved before any byte moves.

``max_local_len`` is the per-request LOCAL QUOTA (the paper's
instance-local budget): when a request's local span approaches it the
cluster ships prefix blocks to a creditor and decoding continues with
the multi-rank paged step.

IN-PLACE DISCIPLINE: the pool tensors are allocated once per engine and
every step and row copy updates them in place (the JAX package donates
them instead). ``CommStats.pool_copy_steps`` counts decode steps after
which the pool's ``data_ptr()`` changed — 0 on the hot path.

GLOBAL-POOL MODE (``gpool``, a cluster-installed ``GlobalKVPool``): the
engine holds no private pool. ``pool_k``/``pool_v`` are views of its
rank's slice of the ONE cluster-wide ``[NR, L, NB, bs, K, hd]`` tensor
and the rManager aliases the shared per-rank allocator, so every row
copy above works unchanged on the shared tensor. Admission runs
``prefill_chunk_global`` and decode ``decode_step_global``: one
rank-form kernel launch per layer reads every rank's slab, creditor
rows included, and the step writes both owner- and creditor-bound rows
itself (the prefix sink only reserves and accounts).

NON-POOLED PATH (hybrid family): a model whose state is O(1) in the
sequence — RG-LRU states and a local-attention KV ring bounded by the
window — has nothing for DistAttention to pool. Its engine holds no pool
tensors; every decode slot's state lives in one batched ``DecodeState``
(a ring of ``local_window`` tokens per attention layer, so attention
always sees the whole window whatever ``max_local_len`` is). Admission
is one dense ``prefill`` whose attention layers run the flash-prefill
kernel, repacked into the slot (``repack_ring`` + ``write_slot``); each
iteration is one batched ``decode_step`` over every slot. The rManager's
allocator still accounts each request's tokens against the quota, and a
prompt longer than ``max_local_len - block_size`` FAILS (it cannot span
creditors).

This port covers the per-instance and global pool paths of the dense
and MoE families and the non-pooled path of the hybrid family. The JAX
engine's prefix cache, host tier, preemption, fault replay and the ssm
family come later.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import (POOLED_FAMILIES, decode_step,
                                      init_decode_state, params_device,
                                      require_family, resolve_device)
from repro_torch.models.prefill import (decode_step_paged, prefill,
                                        prefill_chunk_paged, repack_ring,
                                        write_slot)
from repro_torch.serving.kvpool import (build_local_tables, prefix_tables,
                                        read_pool_rows, rows_for_token_range,
                                        scatter_pool_rows, table_bucket,
                                        write_pool_rows)
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.rmanager import RManager
from repro_torch.serving.sharded_step import (decode_step_global,
                                              prefill_chunk_global)


@dataclass
class CommStats:
    """Bytes moved, per category — feeds the movement benchmarks."""
    kv_moved: int = 0            # KV block migration (overlapped)
    query_shipped: int = 0       # q + (o, m, l) merge traffic per step
    tokens_moved_steps: List[int] = field(default_factory=list)
    host_gather_s: float = 0.0   # host-side table/step-input build time
    decode_steps: int = 0
    # Decode steps after which the pool tensor was NOT the same storage
    # (0: every step updated it in place).
    pool_copy_steps: int = 0
    # Peak bytes of prompt-KV STAGED in flight by admission: one chunk's
    # [L, C, K, hd] export on the pooled path (never a dense
    # [L, 1, T, K, hd] cache); the prefill's KV ring on the non-pooled
    # path.
    admit_stage_bytes: int = 0


def _sample_batch(gen: torch.Generator, logits: torch.Tensor,
                  temps: torch.Tensor,
                  top_ks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next tokens for EVERY slot in one device pass.

    logits [B, V], temps [B] -> [B] int64; temperature <= 0 is greedy
    (argmax, first index on ties — as ``jnp.argmax``). ``top_ks`` [B]
    masks everything below each row's k-th largest logit before sampling
    (k == 0 keeps the full distribution). Sampled slots draw from the
    engine's ``torch.Generator``; the JAX package's PRNG stream cannot be
    reproduced, so only greedy and ``top_k=1`` match it token for token.
    """
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temps > 0).any()):
        return greedy
    lg = logits.float()
    if top_ks is not None:
        vocab = lg.shape[-1]
        desc = torch.sort(lg, dim=-1, descending=True).values
        kth = torch.gather(desc, -1,
                           torch.clamp(top_ks - 1, 0, vocab - 1)[:, None])
        lg = lg.masked_fill((top_ks[:, None] > 0) & (lg < kth),
                            float("-inf"))
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    probs = torch.softmax(lg / safe_t[:, None], dim=-1)
    sampled = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.where(temps > 0, sampled, greedy)


# Sentinel return of a streaming admission aborted by cancellation
# (distinct from None, which means cluster-wide OOM).
_CANCELLED = object()


class InstanceEngine:
    """One serving instance (model replica) on ``device``.

    Several instances may share one parameter tree (the cluster passes
    the same tensors to each), and in global-pool mode one pool tensor.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int = 8,
                 max_local_len: int = 256, pool_blocks: int = 1024,
                 block_size: int = 16, inst_id: int = 0,
                 prefill_chunk: int = 32, device=None, gpool=None):
        require_family(cfg)
        self.device = resolve_device(device)
        if params_device(params) != self.device:
            raise ValueError(f"params live on {params_device(params)}, "
                             f"the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.inst_id = inst_id
        self.max_batch = max_batch
        self.max_local_len = max_local_len
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        # Global-pool mode: this engine's KV lives in rank ``inst_id``'s
        # slice of the cluster-wide tensor, and the rManager aliases the
        # shared per-rank allocator.
        self.gpool = gpool
        self.rmanager = RManager(
            inst_id, pool_blocks, block_size,
            pool=(gpool.ranks[inst_id] if gpool is not None else None))
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.waiting: List[Request] = []
        self.stats = CommStats()
        self._gen = torch.Generator(device=self.device).manual_seed(
            1234 + inst_id)
        self._finished_events: List[int] = []
        self._can_pool = cfg.family in POOLED_FAMILIES
        self._pool_k = self._pool_v = None
        self.state = None
        if self._can_pool:
            assert max_local_len >= 2 * block_size, \
                "local quota must cover at least two blocks"
            if gpool is None:
                L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
                dt = torch_dtype(cfg)
                # THE serving KV store: every local or hosted byte lives
                # here (global mode: in gpool.k/gpool.v instead).
                shape = (L, pool_blocks, block_size, K, hd)
                self._pool_k = torch.zeros(shape, dtype=dt,
                                           device=self.device)
                self._pool_v = torch.zeros_like(self._pool_k)
        else:
            # Every slot's recurrent state and a window-sized KV ring.
            self.state = init_decode_state(cfg, max_batch, cfg.local_window,
                                           device=self.device)
        # Sequence-ordered GLOBAL block chain [(inst_id, block_id)] per
        # creditor-spanning (or moved) request.
        self.req_chain: Dict[int, List[Tuple[int, int]]] = {}
        # Owner-side placement metadata: req_id -> creditor inst ids
        # hosting prefix spans (the KV itself is in THEIR pools).
        self.remote_insts: Dict[int, List[int]] = {}
        # Cluster-installed peer lookup (inst_id -> InstanceEngine) so the
        # decode step can read creditor pools directly.
        self.peers: Dict[int, "InstanceEngine"] = {}
        # Cluster-installed callback: commit creditor blocks for an
        # overflowing prompt prefix BEFORE any prefill compute.
        # sink(req, n_tokens, start=0) -> PrefixSink handle | None
        # (cluster OOM); the chunk loop streams KV rows in through
        # handle.write().
        self.prefix_sink: Optional[Callable] = None

    # The pool handles are properties so the whole serving stack — row
    # copies, staging, pointer checks — reads the same tensors in both
    # modes: the private per-instance tensors, or this rank's view of
    # the global tensors. None for a non-pooled engine.
    @property
    def pool_k(self) -> Optional[torch.Tensor]:
        """Key pool [L, NB, bs, K, hd] (private, or the global view)."""
        if self.gpool is None:
            return self._pool_k
        return self.gpool.k[self.inst_id]

    @property
    def pool_v(self) -> Optional[torch.Tensor]:
        """Value pool [L, NB, bs, K, hd] (private, or the global view)."""
        if self.gpool is None:
            return self._pool_v
        return self.gpool.v[self.inst_id]

    # ----------------------------------------------------------------- #
    def submit(self, req: Request) -> None:
        """Enqueue ``req`` on this instance's waiting list."""
        req.state = RequestState.WAITING
        self.waiting.append(req)

    @property
    def running(self) -> List[Request]:
        """Requests currently occupying decode slots."""
        return [r for r in self.slots if r is not None]

    @property
    def batch_size(self) -> int:
        """Number of occupied decode slots."""
        return len(self.running)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    # ----------------------------------------------------------------- #
    def _admit_one(self) -> bool:
        if not self.waiting:
            return False
        # Cancelled while queued: retire without spending any compute.
        if self.waiting[0].cancelled:
            self._cancel_finalize(self.waiting.pop(0))
            return True
        slot = self._free_slot()
        if slot is None:
            return False
        req = self.waiting[0]
        tokens = list(req.prompt)
        T = len(tokens)
        bs = self.block_size
        # Admit with one block of quota headroom so the first decode
        # appends never breach the local budget before a reactive move
        # can run. The spilled prefix is block-aligned so creditor spans
        # are always whole blocks.
        cap = self.max_local_len - bs
        n_over = 0 if T <= cap else -(-(T - cap) // bs) * bs
        n_local = T - n_over
        need_blocks = -(-n_local // bs)
        if self.rmanager.pool.alloc.free_count < need_blocks:
            return False
        if n_over and (not self._can_pool or self.prefix_sink is None):
            # Cannot span: no cluster, or no KV pool to span with.
            req.state = RequestState.FAILED
            req.finish_time = time.monotonic()
            self.waiting.pop(0)
            self._finished_events.append(req.req_id)
            return True
        self.waiting.pop(0)
        if not self._can_pool:
            logits = self._admit_dense(req, slot, tokens, n_local)
        else:
            logits = self._admit_streaming(req, tokens, n_over, n_local)
        if logits is None:                       # cluster-wide OOM
            req.state = RequestState.FAILED
            req.finish_time = time.monotonic()
            self._finished_events.append(req.req_id)
            return True
        if logits is _CANCELLED:                 # aborted mid-prefill
            self._cancel_finalize(req)
            return True
        self.rmanager.set_owner(req.req_id, True)
        req.slot = slot
        req.state = RequestState.RUNNING
        self.slots[slot] = req
        # First generated token comes from the final prefill logits.
        self._emit(req, int(self._sample_tokens(logits, [req])[0]))
        return True

    def _admit_dense(self, req: Request, slot: int, tokens: List[int],
                     n_local: int) -> torch.Tensor:
        """Non-pooled admission: one dense prefill (its attention layers
        on the flash-prefill kernel), its state moved into ``slot``."""
        T = len(tokens)
        tok = torch.tensor([tokens], dtype=torch.int64, device=self.device)
        logits, full = prefill(self.params, self.cfg, tok, max_len=T,
                               backend="flash")
        self.stats.admit_stage_bytes = max(
            self.stats.admit_stage_bytes,
            2 * full.kv_k.numel() * full.kv_k.element_size())
        ring = self.state.kv_k.shape[2]
        req_state = repack_ring(full, ring, n_keep=min(n_local, ring))
        self.state = write_slot(self.state, slot, req_state, self.cfg)
        self.rmanager.pool.append_tokens(req.req_id, n_local)
        return logits

    def _admit_streaming(self, req: Request, tokens: List[int],
                         n_over: int, n_local: int):
        """Reserve every block, then stream chunks.

        All placement decisions happen BEFORE any compute: creditor
        blocks for the overflow prefix are committed via the
        reserve-then-stream ``prefix_sink`` and the local tail's blocks
        are allocated here, so a failed admission costs zero FLOPs.
        Returns the final chunk's logits, None on cluster-wide OOM, or
        the ``_CANCELLED`` sentinel when the request was cancelled
        mid-stream — in that case every reservation (local blocks and
        committed creditor spans) is rolled back, allocator state
        restored exactly.
        """
        rid = req.req_id
        req.state = RequestState.PREFILLING
        sink = None
        if n_over:
            sink = self.prefix_sink(req, n_over, start=0)
            if sink is None:
                self.rmanager.release_request(rid)
                return None
        if not self.rmanager.pool.append_tokens(rid, n_local):
            if sink is not None:
                sink.abort()
            self.rmanager.release_request(rid)
            return None
        logits = self._stream_prefill(req, tokens, n_over, n_local, sink)
        if logits is _CANCELLED:
            # Abort the in-flight admission: drain staged creditor
            # writes, drop the committed spans (metadata release — the
            # all-or-nothing machinery's rollback), free local blocks.
            if sink is not None:
                sink.abort()
            self.rmanager.release_request(rid)
            return logits
        if sink is not None:
            self.remote_insts[rid] = list(sink.rank_ids)
            L, K, hd = (self.cfg.num_layers, self.cfg.num_kv_heads,
                        self.cfg.head_dim)
            itemsize = self.pool_k.element_size()
            self.stats.kv_moved += int(2 * L * n_over * K * hd) * itemsize
            # The GLOBAL chain: striped creditor blocks + local tail, in
            # token order.
            chain = []
            for inst, _start, blks in sink.spans:
                chain += [(inst, b) for b in blks]
            chain += [(self.inst_id, b)
                      for b in self.rmanager.pool.requests[rid].blocks]
            self.req_chain[rid] = chain
        return logits

    def _stream_prefill(self, req: Request, tokens: List[int],
                        n_over: int, n_local: int, sink):
        """Drive ``prefill_chunk_paged`` over the prompt, O(chunk) peak.

        Per chunk: local rows are written into the pool inside the step;
        creditor-bound rows come back as the chunk KV export and stream
        out through ``sink.write`` — the only transient tensors are
        chunk-sized, never [T]-sized.
        """
        if self.gpool is not None:
            return self._stream_prefill_global(req, tokens, n_over, n_local,
                                               sink)
        rid = req.req_id
        T = len(tokens)
        bs, C = self.block_size, self.prefill_chunk
        pool = self.rmanager.pool
        NB = pool.alloc.num_blocks
        local_blocks = pool.requests[rid].blocks
        cred_ids = list(sink.rank_ids) if sink is not None else []
        rank_pools = [pool] + [self.peers[d].rmanager.pool
                               for d in cred_ids]
        cred_end = n_over                # first locally-written token
        logits = None
        for t0 in range(0, T, C):
            if req.cancelled:
                # Cooperative abort point: between chunks, before any
                # more compute or creditor writes are dispatched.
                return _CANCELLED
            t1 = min(t0 + C, T)
            n_valid = t1 - t0
            toks = np.zeros(C, np.int32)
            toks[:n_valid] = tokens[t0:t1]
            # Owner-pool write target per chunk row; creditor-bound and
            # padded rows carry block id NB (out of range => not written).
            wblk = np.full(C, NB, np.int32)
            woff = np.zeros(C, np.int32)
            lo = max(t0, cred_end)
            if lo < t1:
                blk, off = rows_for_token_range(local_blocks, bs,
                                                lo - n_over, t1 - n_over)
                wblk[lo - t0:t1 - t0] = blk
                woff[lo - t0:t1 - t0] = off
            # Tables address exactly the already-written tokens [0, t0).
            covered = [min(max(t0 - cred_end, 0), n_local)]
            if sink is not None:
                cov = sink.coverage(min(t0, cred_end))
                covered += [cov[d] for d in cred_ids]
            needed = max(1, max(-(-c // bs) for c in covered))
            tables, tails = prefix_tables(rank_pools, rid, covered,
                                          table_bucket(needed))
            remote = tuple((self.peers[d].pool_k, self.peers[d].pool_v)
                           for d in cred_ids)
            logits, _, _, k_c, v_c = prefill_chunk_paged(
                self.params, self.cfg, toks, t0, n_valid,
                self.pool_k, self.pool_v, tables, tails, wblk, woff,
                remote_pools=remote)
            if sink is not None and t0 < cred_end:
                hi = min(t1, cred_end)
                sink.write(t0, k_c[:, :hi - t0], v_c[:, :hi - t0])
            self.stats.admit_stage_bytes = max(
                self.stats.admit_stage_bytes,
                int((k_c.numel() + v_c.numel()) * k_c.element_size()))
        if sink is not None:
            # Table-commit point: the creditor spans become part of this
            # request's decode view now, so the staged row writes are
            # drained here — and only here.
            sink.flush()
        return logits

    def _stream_prefill_global(self, req: Request, tokens: List[int],
                               n_over: int, n_local: int, sink):
        """``_stream_prefill`` over the GLOBAL pool tensor.

        One ``prefill_chunk_global`` per chunk: the prefix partial runs
        over EVERY rank's slab in one launch a layer, and creditor-striped
        rows are written by the same in-step scatter as owner rows — the
        sink only reserves the blocks, gives each row's target and covers
        the tables (its flush drains the stager).
        """
        rid = req.req_id
        T = len(tokens)
        bs, C = self.block_size, self.prefill_chunk
        gpool = self.gpool
        pool = self.rmanager.pool
        NB = pool.alloc.num_blocks
        local_blocks = pool.requests[rid].blocks
        cred_ids = list(sink.rank_ids) if sink is not None else []
        cred_end = n_over                # first locally-written token
        logits = None
        for t0 in range(0, T, C):
            if req.cancelled:
                return _CANCELLED
            t1 = min(t0 + C, T)
            n_valid = t1 - t0
            toks = np.zeros(C, np.int32)
            toks[:n_valid] = tokens[t0:t1]
            # Per-row (rank, block, offset) target; padded rows keep the
            # out-of-range block sentinel.
            wrank = np.full(C, self.inst_id, np.int32)
            wblk = np.full(C, NB, np.int32)
            woff = np.zeros(C, np.int32)
            if sink is not None and t0 < cred_end:
                hi = min(t1, cred_end)
                rr, bb, oo = sink.row_targets(t0, hi)
                wrank[:hi - t0] = rr
                wblk[:hi - t0] = bb
                woff[:hi - t0] = oo
            lo = max(t0, cred_end)
            if lo < t1:
                blk, off = rows_for_token_range(local_blocks, bs,
                                                lo - n_over, t1 - n_over)
                wblk[lo - t0:t1 - t0] = blk
                woff[lo - t0:t1 - t0] = off
            # Coverage over ALL ranks: the owner's written tail, each
            # creditor's streamed span, zero elsewhere.
            covered = [0] * gpool.n_ranks
            covered[self.inst_id] = min(max(t0 - cred_end, 0), n_local)
            if sink is not None:
                cov = sink.coverage(min(t0, cred_end))
                for d in cred_ids:
                    covered[d] = cov[d]
            needed = max(1, max(-(-c // bs) for c in covered))
            tables, tails = prefix_tables(gpool.ranks, rid, covered,
                                          table_bucket(needed))
            logits, _, _, k_c, v_c = prefill_chunk_global(
                self.params, self.cfg, toks, t0, n_valid, gpool.k, gpool.v,
                tables[:, 0], tails[:, 0], wrank, wblk, woff)
            self.stats.admit_stage_bytes = max(
                self.stats.admit_stage_bytes,
                int((k_c.numel() + v_c.numel()) * k_c.element_size()))
        if sink is not None:
            sink.flush()
        return logits

    def _sample_tokens(self, logits, reqs) -> np.ndarray:
        """Sampled tokens for a batch of slots: ONE device pass + ONE
        host readback (not one per slot per step)."""
        dev = logits.device
        temps = torch.tensor([(r.sampling.temperature if r is not None
                               else 0.0) for r in reqs],
                             dtype=torch.float32, device=dev)
        ks = [(r.sampling.top_k if r is not None else 0) for r in reqs]
        top_ks = (torch.tensor(ks, dtype=torch.int64, device=dev)
                  if any(ks) else None)
        return _sample_batch(self._gen, logits, temps, top_ks).cpu().numpy()

    def _emit(self, req: Request, tok: int) -> None:
        req.output.append(tok)
        req.token_times.append(time.monotonic())
        s = req.sampling
        if (len(req.output) >= s.max_new_tokens
                or (s.eos_token is not None and tok == s.eos_token)
                or tok in s.stop_tokens):
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = time.monotonic()
        self._release_slot(req)

    def _fail(self, req: Request) -> None:
        req.state = RequestState.FAILED
        req.finish_time = time.monotonic()
        self._release_slot(req)

    def _cancel_finalize(self, req: Request) -> None:
        """Terminal bookkeeping shared by every cancellation path."""
        req.state = RequestState.CANCELLED
        req.finish_time = time.monotonic()
        self._release_slot(req)

    def cancel(self, req: Request) -> bool:
        """Cancel a request this engine holds (waiting or running).

        Returns True when the request was retired HERE (slot released,
        local blocks freed, finished event queued). A request that is
        mid-streaming-prefill only gets its flag set — the chunk loop
        aborts and rolls back at its next cooperative check. Creditor-
        hosted spans are the cluster's to release (it sees the finished
        event, exactly once, like any other terminal state).
        """
        if req.done:
            return False
        req.cancelled = True
        if req in self.waiting:
            self.waiting.remove(req)
            self._cancel_finalize(req)
            return True
        if req.slot is not None and self.slots[req.slot] is req:
            self._cancel_finalize(req)
            return True
        return False

    def _release_slot(self, req: Request) -> None:
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        self.rmanager.release_request(req.req_id)
        self.remote_insts.pop(req.req_id, None)
        self.req_chain.pop(req.req_id, None)
        self._finished_events.append(req.req_id)

    def drain_finished(self) -> List[int]:
        """Req ids finished/failed since the last drain, each reported
        once — the cluster releases their creditor-hosted spans from
        this instead of rescanning every request ever submitted."""
        out, self._finished_events = self._finished_events, []
        return out

    # ----------------------------------------------------------------- #
    def _chain_append(self, req: Request) -> None:
        """Keep the request's GLOBAL chain in step with the local one:
        a decode append that opened a fresh tail block extends it."""
        chain = self.req_chain.get(req.req_id)
        if chain is None:
            return
        rb = self.rmanager.pool.requests[req.req_id]
        if rb.tail_tokens == 1:
            chain.append((self.inst_id, rb.blocks[-1]))

    def _append_step_tokens(self) -> None:
        """Reserve this step's token in each request's tail block. A
        failed append means the pool is exhausted: reject loudly, never
        corrupt (paper: reject when pool exhausted)."""
        pool = self.rmanager.pool
        for r in list(self.slots):
            if r is None:
                continue
            if not pool.append_tokens(r.req_id, 1):
                self._fail(r)
            else:
                self._chain_append(r)

    def _step_paged(self) -> Optional[torch.Tensor]:
        """One decode iteration over the pool path. Returns logits."""
        if self.gpool is not None:
            return self._step_paged_global()
        pool = self.rmanager.pool
        t0 = time.perf_counter()
        self._append_step_tokens()
        running = self.running
        if not running:
            return None
        B, NB = self.max_batch, pool.alloc.num_blocks
        tokens = np.zeros(B, np.int32)
        lens = np.zeros(B, np.int32)
        wblk = np.full(B, NB, np.int32)      # NB = out of range => no write
        woff = np.zeros(B, np.int32)
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            tokens[i] = r.output[-1] if r.output else r.prompt[-1]
            lens[i] = r.length - 1           # abs position of the new token
            rb = pool.requests[r.req_id]
            wblk[i] = rb.blocks[-1]
            woff[i] = rb.tail_tokens - 1
        insts = sorted({i for r in running
                        for i in self.remote_insts.get(r.req_id, ())})
        rank_pools = [pool] + [self.peers[i].rmanager.pool for i in insts]
        req_ids = [r.req_id if r is not None else -1 for r in self.slots]
        needed = max((len(p.requests[rid].blocks)
                      for p in rank_pools for rid in req_ids
                      if rid in p.requests), default=1)
        tables, tails = build_local_tables(rank_pools, req_ids,
                                           table_bucket(needed))
        remote_pools = tuple((self.peers[i].pool_k, self.peers[i].pool_v)
                             for i in insts)
        self.stats.host_gather_s += time.perf_counter() - t0
        self.stats.decode_steps += 1

        ptr = self.pool_k.data_ptr()
        logits, pool_k, pool_v = decode_step_paged(
            self.params, self.cfg, tokens, lens, self.pool_k, self.pool_v,
            tables, tails, wblk, woff, remote_pools=remote_pools)
        if pool_k is not self.pool_k or pool_k.data_ptr() != ptr:
            self.stats.pool_copy_steps += 1
        self._account_merge_traffic(running)
        return logits

    def _step_paged_global(self) -> Optional[torch.Tensor]:
        """One decode iteration over the GLOBAL pool tensor.

        One ``decode_step_global`` call covers the owner AND every
        creditor rank: tables come from the shared per-rank allocators
        (``gpool.ranks``), each layer LSE-merges the ranks' partials from
        one kernel launch, and the new token's KV lands after the layer
        loop — so the pending token's slot is excluded from the tables
        (it enters as the self partial)."""
        gpool = self.gpool
        pool = self.rmanager.pool
        t0 = time.perf_counter()
        self._append_step_tokens()
        running = self.running
        if not running:
            return None
        B, NB = self.max_batch, pool.alloc.num_blocks
        tokens = np.zeros(B, np.int32)
        lens = np.zeros(B, np.int32)
        wblk = np.full(B, NB, np.int32)      # NB = out of range => no write
        woff = np.zeros(B, np.int32)
        req_ids = [r.req_id if r is not None else -1 for r in self.slots]
        needed = max((len(p.requests[rid].blocks)
                      for p in gpool.ranks for rid in req_ids
                      if rid in p.requests), default=1)
        tables, tails = build_local_tables(gpool.ranks, req_ids,
                                           table_bucket(needed))
        own = self.inst_id
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            tokens[i] = r.output[-1] if r.output else r.prompt[-1]
            lens[i] = r.length - 1       # abs position of the new token
            rb = pool.requests[r.req_id]
            wblk[i] = rb.blocks[-1]
            woff[i] = rb.tail_tokens - 1
            # The pending token's slot must not be visible to the pooled
            # partial (its row is written after the layer loop).
            if rb.tail_tokens == 1:
                tables[own, i, len(rb.blocks) - 1] = -1
                tails[own, i] = self.block_size
            else:
                tails[own, i] = rb.tail_tokens - 1
        self.stats.host_gather_s += time.perf_counter() - t0
        self.stats.decode_steps += 1

        ptr = gpool.k.data_ptr()
        logits, gk, _ = decode_step_global(
            self.params, self.cfg, tokens, lens, gpool.k, gpool.v, tables,
            tails, wblk, woff, rank=own)
        if gk is not gpool.k or gk.data_ptr() != ptr:
            self.stats.pool_copy_steps += 1
        self._account_merge_traffic(running)
        return logits

    def _account_merge_traffic(self, running) -> None:
        """Account the paper's per-step merge traffic — q + (o, m, l) —
        once per (request, creditor) span entry, matching the per-rank
        partial exchanges a real deployment would make."""
        H, hd = self.cfg.num_heads, self.cfg.head_dim
        L = self.cfg.num_layers
        entries = sum(len(self.remote_insts.get(r.req_id, ()))
                      for r in running)
        self.stats.query_shipped += int(
            entries * L * (H * hd * 2 + H * hd * 4 + 2 * H * 4))

    def _step_dense(self) -> Optional[torch.Tensor]:
        """One decode iteration over the batch slots (non-pooled path):
        one ``decode_step`` for every slot, empty ones included (their
        state is overwritten when the slot is reused). Returns logits."""
        self._append_step_tokens()
        if not self.running:
            return None
        tokens = np.zeros(self.max_batch, np.int64)
        for i, r in enumerate(self.slots):
            if r is not None:
                tokens[i] = r.output[-1] if r.output else r.prompt[-1]
        self.stats.decode_steps += 1
        logits, self.state = decode_step(
            self.params, self.cfg, self.state,
            torch.from_numpy(tokens).to(self.device))
        return logits

    def step(self) -> int:
        """Admit + one decode iteration. Returns #tokens generated."""
        # Retire slots whose cancel flag was set since the last step
        # (e.g. from a streaming consumer) before any decode compute.
        for r in list(self.slots):
            if r is not None and r.cancelled and not r.done:
                self._cancel_finalize(r)
        while self._admit_one():
            pass
        if not self.running:
            self.rmanager.batch_size = 0
            return 0
        logits = self._step_paged() if self._can_pool else self._step_dense()
        if logits is None:
            self.rmanager.batch_size = 0
            return 0
        made = 0
        reqs = list(self.slots)
        toks = self._sample_tokens(logits, reqs)
        for r, tok in zip(reqs, toks):
            if r is None:
                continue
            self._emit(r, int(tok))
            made += 1
        self.rmanager.batch_size = self.batch_size
        return made

    # --- KV movement (debtor side) ------------------------------------ #
    def local_tokens(self, req: Request) -> int:
        """Tokens of ``req`` resident in THIS instance's pool."""
        return self.rmanager.pool.tokens_of(req.req_id)

    def local_free_tokens(self, req: Request) -> int:
        """Quota slots left AFTER the pending token's append."""
        return self.max_local_len - self.local_tokens(req) - 1

    def extract_prefix_kv(self, req: Request, n_blocks: int):
        """Read the OLDEST n full blocks' rows of this rank's span of
        ``req`` out of the pool — the request's local prefix when this
        rank owns it, or the hosted span when this rank is a creditor
        being reclaimed. Returns copies [L, 1, n*bs, K, hd]."""
        blocks = self.rmanager.pool.requests[req.req_id].blocks[:n_blocks]
        k = read_pool_rows(self.pool_k, blocks, self.block_size)
        v = read_pool_rows(self.pool_v, blocks, self.block_size)
        return k[:, None], v[:, None]

    # --- creditor side -------------------------------------------------#
    def host_kv(self, req_id: int, blocks: List[int], k, v) -> None:
        """Write an arriving span's rows into already-committed blocks.

        k/v: [L, 1, n, K, hd] with n == len(blocks) * block_size (spans
        are always whole blocks).
        """
        write_pool_rows(self.pool_k, blocks, k[:, 0], self.block_size)
        write_pool_rows(self.pool_v, blocks, v[:, 0], self.block_size)

    def host_kv_rows(self, req_id: int, block_ids, offsets, k, v) -> None:
        """Scatter a streaming-prefill span's rows into already-committed
        blocks, row-addressed (may land mid-block).

        k/v: [L, n, K, hd] with row i bound for
        ``(block_ids[i], offsets[i])`` of this pool.
        """
        scatter_pool_rows(self.pool_k, block_ids, offsets, k)
        scatter_pool_rows(self.pool_v, block_ids, offsets, v)

    def drop_hosted(self, req_id: int) -> None:
        """Release a hosted span — pure metadata; rows are reused later."""
        self.rmanager.release_request(req_id)
