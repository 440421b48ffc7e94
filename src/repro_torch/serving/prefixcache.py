"""Cross-request radix prefix cache over content-hashed block chains.

Multi-tenant serving repeats prefixes constantly — shared system
prompts, few-shot templates, multi-turn history. Under the paper's
pooled-memory economy a cached prefix is the perfect span: KV that is
already resident somewhere in the cluster hierarchy, so admitting a
request that starts with it costs table edits (device hit), an
asynchronous H2D chain (host-tier hit), or a D2D block copy (peer
hit) — never prefill FLOPs.

The index is a radix tree over FULL blocks: each node represents one
``block_size``-token chunk, keyed under its parent by the chunk's token
tuple and identified globally by a chained content hash
(``block_hash(parent_hash, tokens)`` — also the node's key in the
:class:`~repro_torch.serving.hosttier.HostKVTier`). A node's storage is any
of: device replicas (``inst_id -> block id``, each holding one
refcounted reference in that instance's ``BlockAllocator``) and/or one
host-tier frame. Admission walks the longest cached prefix, PINS every
matched node (``refcount`` = live request pins; recorded per request so
release is exactly-once), and returns local block ids the engine
attaches via ``RankKVPool.attach_shared`` — prefill then streams only
the uncached tail. Finished requests insert their chain back
(``insert_chain`` adopts the very frames, zero copies), which is how
blocks get a second life instead of being dropped; device pressure
evicts unpinned LRU replicas, spilling them to the host tier first when
one is configured — the spill half of the paper's memory hierarchy.

Invariants (property-tested against the JAX package's cache in
tests/test_torch_prefix_cache.py):
  * a pinned node (refcount > 0) is never evicted, and pins cover the
    whole matched path, so an unpinned node has no pinned descendants;
  * every device replica holds exactly one allocator reference — frames
    return to the free list only when the cache AND every sharing
    request have released them;
  * a node with no storage left is unreachable and its whole subtree is
    dropped (every replica freed, every host frame dropped) — the tree
    stays closed under parents.

Hash collisions: children are keyed by the literal token tuple, so a
colliding 64-bit chain hash can never serve wrong KV — it could only
alias two host-tier frames, which we accept at ~2^-64 odds.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.faults import FrameCorruptionError, TransferError
from repro_torch.serving.hosttier import HostKVTier, frame_bytes

# Allocator owner id of frames held by the cache (never a real req_id).
CACHE_OWNER = -2

# A fixed int: the chain hashes (the host tier's keys) are then the same
# in every process of a mesh (a string's ``hash`` is salted per process;
# an int's and a tuple of ints' are not).
_ROOT_HASH = 0x5AD1C5EED


def _weakly(method):
    """A callback calling ``method`` without keeping its object alive
    (None once the object is gone)."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        fn = ref()
        return fn(*args) if fn is not None else None
    return call


def block_hash(parent_hash: int, tokens: Sequence[int]) -> int:
    """Chained content hash of one full block given its prefix's hash."""
    return hash((parent_hash, tuple(int(t) for t in tokens)))


@dataclass
class RadixNode:
    """One block-granular radix-tree node (a content-hashed KV block).

    ``replicas`` maps instance id -> device block; ``on_host`` marks a
    host-tier copy; ``refcount`` pins the chain while requests use it.
    """

    tokens: Tuple[int, ...]                    # this block's token chunk
    hash: int
    parent: Optional["RadixNode"]
    depth: int = 0                             # blocks from root (root=0)
    children: Dict[Tuple[int, ...], "RadixNode"] = field(
        default_factory=dict)
    replicas: Dict[int, int] = field(default_factory=dict)
    on_host: bool = False
    refcount: int = 0                          # live request pins
    tick: int = 0                              # LRU clock


@dataclass
class PrefixCacheStats:
    """Counters surfaced through ``server.metrics`` (cache_* keys)."""

    lookups: int = 0
    hits: int = 0                 # lookups that matched >= 1 block
    hit_blocks: int = 0
    cow_copies: int = 0
    inserted_nodes: int = 0
    device_evictions: int = 0


class RadixPrefixCache:
    """Cluster-wide radix index over cached KV block chains.

    ``cluster`` provides ``engines`` (inst_id -> engine with
    ``rmanager.pool.alloc``, ``read_block_rows``, ``write_block_rows``,
    ``stats``), ``stager`` and ``block_size`` — the real ``Cluster`` (as
    a weak proxy: the cluster owns the cache) or a test stub. The host
    tier's callbacks hold the cache weakly, so cache and tier form no
    reference cycle.
    """

    def __init__(self, cluster, host_tier: Optional[HostKVTier] = None):
        self.cluster = cluster
        self.bs = cluster.block_size
        self.tier = host_tier
        if host_tier is not None:
            host_tier.on_evict = _weakly(self._on_host_evict)
            host_tier.evictable_fn = _weakly(self._host_evictable)
        self.root = RadixNode((), _ROOT_HASH, None)
        self._nodes: Dict[int, RadixNode] = {}      # hash -> node
        self._pins: Dict[int, List[RadixNode]] = {}  # req_id -> path
        self._clock = 0
        self.stats = PrefixCacheStats()

    # ----------------------------------------------------------------- #
    def _touch(self, node: RadixNode) -> None:
        self._clock += 1
        node.tick = self._clock

    def _live_insts(self) -> set:
        dead = getattr(self.cluster, "_dead", set())
        return {i for i in self.cluster.engines if i not in dead}

    # --- admission walk ---------------------------------------------- #
    def acquire(self, inst_id: int, req_id: int, tokens: Sequence[int],
                max_blocks: int) -> List[int]:
        """Walk the longest cached prefix of ``tokens`` and materialize
        it on ``inst_id``: device hit = reuse the frame (table edit
        only), host hit = async H2D prefetch into a fresh frame, peer
        hit = D2D block copy. Every matched node is pinned under
        ``req_id`` (released exactly once by :meth:`release`). Returns
        the sequence-ordered local block ids of the matched prefix."""
        assert req_id not in self._pins, "acquire without release"
        self.stats.lookups += 1
        node = self.root
        blocks: List[int] = []
        pinned: List[RadixNode] = []
        n = min(len(tokens) // self.bs, max_blocks)
        for i in range(n):
            chunk = tuple(int(t) for t in
                          tokens[i * self.bs:(i + 1) * self.bs])
            child = node.children.get(chunk)
            if child is None:
                break
            blk = self._materialize(inst_id, child)
            if blk is None:
                break
            child.refcount += 1
            self._touch(child)
            pinned.append(child)
            blocks.append(blk)
            node = child
        if pinned:
            self._pins[req_id] = pinned
            self.stats.hits += 1
            self.stats.hit_blocks += len(blocks)
        return blocks

    def release(self, req_id: int) -> None:
        """Unpin every node ``req_id`` acquired — exactly once,
        idempotent (the pin list is popped)."""
        for node in self._pins.pop(req_id, ()):
            assert node.refcount > 0, "release without matching pin"
            node.refcount -= 1

    def _materialize(self, inst_id: int, node: RadixNode) -> Optional[int]:
        """A device block id for ``node`` on ``inst_id``, creating a
        replica from a peer (D2D) or the host tier (H2D) if needed."""
        blk = node.replicas.get(inst_id)
        if blk is not None:
            return blk
        eng = self.cluster.engines[inst_id]
        alloc = eng.rmanager.pool.alloc
        got = alloc.alloc(1, CACHE_OWNER)
        if got is None:
            if self.evict_device(inst_id, 1):
                got = alloc.alloc(1, CACHE_OWNER)
            if got is None:
                return None
        blk = got[0]
        live = self._live_insts()
        src = next(((i, b) for i, b in node.replicas.items() if i in live),
                   None)
        if src is not None:
            # Peer device replica: block-copy D2D, dispatched async.
            si, sb = src
            k, v = self.cluster.engines[si].read_block_rows(sb)
            eng.write_block_rows(blk, k, v)
            eng.stats.kv_moved += frame_bytes((k, v))
            self.cluster.stager.stage(eng.kv_store,
                                      tag="prefetch")
        elif node.on_host and self.tier is not None:
            try:
                frame = self.tier.get(node.hash)  # stall-aware
            except (TransferError, FrameCorruptionError):
                # Unfetchable or hash-mismatched host frame: treat it
                # as LOST rather than poisoning decode with wrong KV.
                # The shortened cached prefix means admission simply
                # re-prefills those tokens — token-replay fallback.
                self.tier.drop(node.hash)
                frame = None
            if frame is None:                     # raced a host eviction
                node.on_host = False
                alloc.free([blk])
                return None
            k, v = frame
            eng.write_block_rows(blk, k, v)
            eng.stats.host_prefetch_bytes += frame_bytes(frame)
            self.cluster.stager.stage(eng.kv_store,
                                      tag="prefetch")
        else:
            alloc.free([blk])                     # storage-less node
            return None
        node.replicas[inst_id] = blk
        return blk

    # --- insertion (finished requests) -------------------------------- #
    def insert_chain(self, inst_id: int, tokens: Sequence[int],
                     blocks: Sequence[int]) -> int:
        """Adopt a finished request's full local blocks as cached nodes.

        ``tokens``: the content whose KV the chain holds (prompt +
        generated minus the last sampled token); ``blocks``: the
        request's sequence-ordered device blocks on ``inst_id``. Only
        the leading FULL blocks are inserted. Adoption is zero-copy:
        the frame gains one cache-held allocator reference and survives
        the request's release. Returns the number of frames adopted."""
        return self.insert_chain_multi([(inst_id, b) for b in blocks],
                                       tokens)

    def insert_chain_multi(self, placements: Sequence[Tuple[int, int]],
                           tokens: Sequence[int]) -> int:
        """``insert_chain`` where block i may live on ANY instance.

        ``placements``: the sequence-ordered ``(inst_id, block_id)``
        GLOBAL chain of a finished request — for a creditor-spanning
        request that is its striped ``PrefixSink`` frames followed by
        the owner's local tail (``InstanceEngine.req_chain``). Each
        adopted frame gains one cache-held reference in ITS OWN
        instance's allocator, so a striped span survives both the
        owner's release and the cluster's ``drop_hosted`` — and a later
        request admitted ANYWHERE warm-hits it (``_materialize`` D2D-
        copies from whichever replica instance is closest). The walk
        stops at the first block on a dead instance: a radix prefix must
        stay gap-free."""
        live = self._live_insts()
        node = self.root
        adopted = 0
        n = min(len(tokens) // self.bs, len(placements))
        for i in range(n):
            inst_id, blk = placements[i]
            if inst_id not in live:
                break
            chunk = tuple(int(t) for t in
                          tokens[i * self.bs:(i + 1) * self.bs])
            child = node.children.get(chunk)
            if child is None:
                child = RadixNode(chunk, block_hash(node.hash, chunk),
                                  node, depth=node.depth + 1)
                node.children[chunk] = child
                self._nodes[child.hash] = child
                self.stats.inserted_nodes += 1
            if inst_id not in child.replicas:
                alloc = self.cluster.engines[inst_id].rmanager.pool.alloc
                alloc.incref([blk])
                alloc.rebind(blk, CACHE_OWNER)
                child.replicas[inst_id] = blk
                adopted += 1
            self._touch(child)
            node = child
        return adopted

    # --- eviction ------------------------------------------------------ #
    def evictable(self, inst_id: int) -> int:
        """Unpinned device replicas on ``inst_id`` — frames an eviction
        pass could return to the allocator."""
        return sum(1 for nd in self._nodes.values()
                   if inst_id in nd.replicas and nd.refcount == 0)

    def pinned_blocks(self, inst_id: int) -> int:
        """Cached device blocks on ``inst_id`` pinned by live requests."""
        return sum(1 for nd in self._nodes.values()
                   if inst_id in nd.replicas and nd.refcount > 0)

    def device_blocks(self, inst_id: int) -> int:
        """All cached device blocks resident on ``inst_id``."""
        return sum(1 for nd in self._nodes.values()
                   if inst_id in nd.replicas)

    def evict_device(self, inst_id: int, n_blocks: int) -> int:
        """Free >= ``n_blocks`` device frames on ``inst_id`` by evicting
        unpinned replicas in LRU order, spilling each to the host tier
        first when one is configured (the D2H copy is dispatched async
        and lands behind compute). Returns the frames actually freed."""
        eng = self.cluster.engines[inst_id]
        alloc = eng.rmanager.pool.alloc
        victims = sorted((nd for nd in self._nodes.values()
                          if inst_id in nd.replicas and nd.refcount == 0),
                         key=lambda nd: nd.tick)
        freed = 0
        for node in victims:
            if freed >= n_blocks:
                break
            if node.hash not in self._nodes or node.refcount:
                continue                 # dropped by a cascading delete
            blk = node.replicas.get(inst_id)
            if blk is None:
                continue
            if self.tier is not None and not node.on_host:
                k, v = eng.read_block_rows(blk)
                if self.tier.put(node.hash, k, v):
                    node.on_host = True
                    eng.stats.host_spill_bytes += frame_bytes((k, v))
                # The put can trip the host high watermark, and the LRU
                # callback may _drop_subtree an ancestor — taking this
                # node (and its already-freed frame) with it. The frame
                # just put then belongs to no node: drop it too (the JAX
                # package leaves it in the tier until LRU reaches it).
                if node.hash not in self._nodes:
                    self.tier.drop(node.hash)
                    continue
                if inst_id not in node.replicas:
                    continue
            del node.replicas[inst_id]
            alloc.free([blk])
            freed += 1
            self.stats.device_evictions += 1
            if not node.replicas and not node.on_host:
                freed += self._drop_subtree(node, count_inst=inst_id)
        return freed

    def _drop_subtree(self, node: RadixNode,
                      count_inst: Optional[int] = None) -> int:
        """Remove ``node`` and every descendant from the tree, freeing
        all their device replicas and host frames (a storage-less node
        makes its subtree unreachable). Returns frames freed on
        ``count_inst``."""
        freed = 0
        stack = [node]
        if node.parent is not None:
            node.parent.children.pop(node.tokens, None)
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            nd.children = {}
            for i, blk in list(nd.replicas.items()):
                eng = self.cluster.engines.get(i)
                if eng is not None:
                    eng.rmanager.pool.alloc.free([blk])
                if i == count_inst:
                    freed += 1
            nd.replicas = {}
            if nd.on_host and self.tier is not None:
                self.tier.drop(nd.hash)
            nd.on_host = False
            self._nodes.pop(nd.hash, None)
        return freed

    def purge_instance(self, inst_id: int) -> int:
        """Quarantine cleanup for a dead rank: pop every cache replica
        on ``inst_id`` and return its allocator reference (the rank's
        pool is being drained wholesale), dropping any node left with
        no storage at all. Host frames and live-rank replicas survive —
        they stay warm-hittable. Returns replicas purged."""
        purged = 0
        for node in list(self._nodes.values()):
            if node.hash not in self._nodes:
                continue                 # removed by a cascading delete
            blk = node.replicas.pop(inst_id, None)
            if blk is None:
                continue
            eng = self.cluster.engines.get(inst_id)
            if eng is not None:
                eng.rmanager.pool.alloc.free([blk])
            purged += 1
            if not node.replicas and not node.on_host:
                self._drop_subtree(node)
        return purged

    def clear(self) -> int:
        """Drop the whole tree: every device replica returns its
        allocator reference and every host frame is dropped (no spill).
        Requires no live pins. Returns the nodes dropped."""
        assert not self._pins, "clear() with live request pins"
        n = len(self._nodes)
        for child in list(self.root.children.values()):
            self._drop_subtree(child)
        return n

    # --- host-tier callbacks ------------------------------------------- #
    def _host_evictable(self, key: int) -> bool:
        node = self._nodes.get(key)
        return node is None or node.refcount == 0

    def _on_host_evict(self, key: int) -> None:
        """Host-tier LRU dropped ``key``'s frame: if the node has no
        device replica left either, its subtree is unreachable."""
        node = self._nodes.get(key)
        if node is None:
            return
        node.on_host = False
        if not node.replicas:
            self._drop_subtree(node)

    # --- introspection ------------------------------------------------- #
    @property
    def num_nodes(self) -> int:
        """Radix nodes currently in the tree."""
        return len(self._nodes)

    def host_blocks(self) -> int:
        """Host-tier frames holding cache replicas (0 without a tier)."""
        return self.tier.used_blocks if self.tier is not None else 0


__all__ = ["RadixPrefixCache", "RadixNode", "PrefixCacheStats",
           "block_hash", "CACHE_OWNER"]
