"""The port's radix prefix cache and its serving paths against JAX's.

``repro_torch.serving.prefixcache.RadixPrefixCache`` over the port's
block allocators and host tier, held against the JAX package's cache:

* the radix index: one seeded sequence of inserts, acquires, releases,
  evictions and host-tier drains drives both packages' caches through
  stub clusters (numpy frames for JAX, torch frames for the port). After
  every op both hold the same nodes (by content hash) with the same
  replicas, the same stats, evictable, pinned and device counts, the
  same allocator occupancy and the same host frames of nodes, the port's
  tier no other frame (the JAX tier's orphan frames are dropped after
  each op); and the port's
  index keeps every invariant of ``tests/test_prefix_cache.py``
  (refcount == live pins, no storage-less node, a tree closed under
  parents, one allocator reference a replica, zero leaks at the end);
* serving, olmo-1b smoke in float32, in both pool modes: a cold, a warm
  (partial-prefix) and a copy-on-write (full-prompt) admission, and
  hits that prefetch from the host tier, give the JAX server's tokens
  and the dense oracle's (``prefill`` + ``decode_step``), with the same
  hit tokens and host traffic;
* the COW tail never aliases a shared frame, and the shared frames'
  bytes never change;
* a cancel mid-prefill of an admission that holds cache pins AND
  creditor reservations restores every allocator exactly, frees each
  frame at most once, unpins every node and leaves the host tier
  untouched;
* a creditor-spanning request's striped chain is adopted into the cache
  on finish (a multi-instance chain), and a follow-up warm-hits it with
  the oracle's tokens;
* a spill whose watermark eviction drops its own node's subtree leaves
  no orphan frame in the port's tier (the JAX package's tier keeps one).
"""
import collections
import dataclasses
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serving.engine as pt_engine_mod
from repro import serving as jsv
from repro.configs import get_smoke_config
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro.serving.hosttier import HostKVTier as JaxTier
from repro.serving.kvpool import BlockAllocator as JaxAllocator
from repro.serving.prefixcache import RadixPrefixCache as JaxCache
from repro_torch import bridge
from repro_torch import serving as psv
from repro_torch.serving.hosttier import HostKVTier
from repro_torch.serving.kvpool import BlockAllocator
from repro_torch.serving.prefixcache import RadixPrefixCache

BS = 4          # stub block size
POOL = 24       # stub pool blocks per instance
MODES = pytest.mark.parametrize("global_pool", [False, True],
                                ids=["per-instance", "global-pool"])


# ------------------------------------------------------------------ #
# Stub clusters: the same interface over each package's allocator
# ------------------------------------------------------------------ #
class _StubEngine:
    def __init__(self, alloc, zeros, copy):
        self.rmanager = SimpleNamespace(pool=SimpleNamespace(alloc=alloc))
        self.stats = SimpleNamespace(kv_moved=0, host_spill_bytes=0,
                                     host_prefetch_bytes=0)
        self.frames = {}                 # blk -> (k, v) rows
        self.pool_k = self.pool_v = None
        self.kv_store = (None, None)     # the port's staging handle
        self._zeros, self._copy = zeros, copy

    def read_block_rows(self, blk):
        return self.frames.get(blk, (self._zeros(), self._zeros()))

    def write_block_rows(self, blk, k, v):
        self.frames[blk] = (self._copy(k), self._copy(v))


def _stub(port: bool, n_inst=2):
    if port:
        def mk():
            return _StubEngine(BlockAllocator(POOL, BS),
                               lambda: torch.zeros(2, BS), torch.clone)
    else:
        def mk():
            return _StubEngine(JaxAllocator(POOL, BS),
                               lambda: np.zeros((2, BS), np.float32),
                               lambda a: np.array(a, copy=True))
    return SimpleNamespace(block_size=BS,
                           engines={i: mk() for i in range(n_inst)},
                           stager=SimpleNamespace(
                               stage=lambda arrays, tag=None: None),
                           _dead=set())


_CHUNKS = [(t,) * BS for t in range(4)]


def _tokens(path):
    return [tok for chunk in path for tok in chunk]


def _finish_request(cl, cache, inst, path, rid, port):
    """A finished request's chain: alloc frames, fill KV rows, insert
    into the cache, release the request's own references."""
    alloc = cl.engines[inst].rmanager.pool.alloc
    blocks = alloc.alloc(len(path), rid)
    if blocks is None:
        cache.evict_device(inst, len(path))
        blocks = alloc.alloc(len(path), rid)
        if blocks is None:
            return False
    for blk, chunk in zip(blocks, path):
        val = float(hash(chunk) % 997)
        row = (torch.full((2, BS), val) if port
               else np.full((2, BS), val, np.float32))
        cl.engines[inst].frames[blk] = (row, -row)
    cache.insert_chain(inst, _tokens(path), blocks)
    alloc.free(blocks)
    return True


def _state(cl, cache):
    """Everything two caches must agree on, as plain Python values."""
    nodes = {nd.hash: (nd.depth, nd.refcount, nd.on_host,
                       sorted(nd.replicas.items()))
             for nd in cache._nodes.values()}
    per_inst = {i: (cache.evictable(i), cache.pinned_blocks(i),
                    cache.device_blocks(i), e.rmanager.pool.alloc.free_count,
                    e.rmanager.pool.alloc.used_count)
                for i, e in cl.engines.items()}
    # Host frames of nodes (the JAX tier may also hold an orphan frame:
    # see test_spill_that_evicts_its_own_ancestor_leaves_no_orphan_frame).
    host = sorted(h for h in cache._nodes if cache.tier is not None
                  and h in cache.tier)
    return (cache.num_nodes, dataclasses.asdict(cache.stats), nodes,
            per_inst, host)


def _check_invariants(cl, cache):
    refs = collections.Counter()
    for pinned in cache._pins.values():
        for nd in pinned:
            refs[id(nd)] += 1
    for nd in cache._nodes.values():
        assert nd.refcount == refs[id(nd)]
        assert nd.replicas or nd.on_host
        assert nd.parent is cache.root or nd.parent.hash in cache._nodes
        assert nd.parent.children.get(nd.tokens) is nd
    for i, eng in cl.engines.items():
        alloc = eng.rmanager.pool.alloc
        seen = set()
        for nd in cache._nodes.values():
            blk = nd.replicas.get(i)
            if blk is None:
                continue
            assert blk not in seen, "two nodes share one frame"
            seen.add(blk)
            assert alloc.refcount(blk) >= 1
        assert len(seen) == cache.device_blocks(i)
    if cache.tier is not None:
        assert cache.tier.used_blocks <= cache.tier.capacity
        for nd in cache._nodes.values():
            if nd.on_host:
                assert nd.hash in cache.tier


def _drop_orphans(cache):
    """Drop the JAX tier's frames that belong to no node — the port
    never keeps one (see the orphan test below), so the reference is
    held to the same state after each op."""
    if cache.tier is not None:
        for key in list(cache.tier._frames) + list(cache.tier._pending):
            if key not in cache._nodes:
                cache.tier.drop(key)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("tier_blocks", [0, 6])
def test_radix_index_agrees_with_jax_op_for_op(seed, tier_blocks,
                                               monkeypatch):
    # The node hashes are compared: the port's chain from JAX's root
    # (a salted string hash there, a fixed int in the port).
    import repro.serving.prefixcache as jax_pc
    import repro_torch.serving.prefixcache as port_pc
    monkeypatch.setattr(port_pc, "_ROOT_HASH", jax_pc._ROOT_HASH)
    rng = random.Random(1000 * tier_blocks + seed)
    sides = []
    for port in (False, True):
        cl = _stub(port)
        tier = ((HostKVTier if port else JaxTier)(tier_blocks)
                if tier_blocks else None)
        sides.append((port, cl, (RadixPrefixCache if port else JaxCache)(
            cl, host_tier=tier)))
    live, next_rid = set(), 0
    for _ in range(25):
        op = rng.choice(["insert", "acquire", "release", "evict", "drain"])
        inst = rng.choice([0, 1])
        path = [rng.choice(_CHUNKS) for _ in range(rng.randint(1, 4))]
        n = rng.randint(0, 5)
        rid = rng.choice(sorted(live)) if live else None
        got = []
        for port, cl, cache in sides:
            if op == "insert":
                got.append(_finish_request(cl, cache, inst, path,
                                           next_rid + 1, port))
            elif op == "acquire":
                got.append(cache.acquire(inst, next_rid + 1, _tokens(path),
                                         max_blocks=n))
                cache.evict_device(inst, POOL)   # pins must hold
            elif op == "release" and rid is not None:
                cache.release(rid)
            elif op == "evict":
                got.append(cache.evict_device(inst, n + 1))
            elif op == "drain" and cache.tier is not None:
                cache.tier.drain(block=True)
        assert got[:len(got) // 2] == got[len(got) // 2:], (op, got)
        _drop_orphans(sides[0][2])
        if op in ("insert", "acquire"):
            next_rid += 1
            if op == "acquire":
                live.add(next_rid)
        elif op == "release" and rid is not None:
            live.discard(rid)
        _check_invariants(sides[1][1], sides[1][2])
        assert _state(*sides[0][1:]) == _state(*sides[1][1:]), op
        pcache = sides[1][2]
        if pcache.tier is not None:       # no orphan frame in the port's
            assert pcache.tier.used_blocks == len(_state(*sides[1][1:])[-1])
    for _, cl, cache in sides:
        for r in live:
            cache.release(r)
        for i in cl.engines:
            cache.evict_device(i, POOL)
        _check_invariants(cl, cache)
        for i, eng in cl.engines.items():
            assert cache.device_blocks(i) == 0
            assert eng.rmanager.pool.alloc.used_count == 0
    assert _state(*sides[0][1:]) == _state(*sides[1][1:])


def test_host_round_trip_content_and_lru_subtree_drop():
    """Evicted replicas land on the host byte-exact and come back into
    a fresh frame; a host LRU eviction of a chain's root drops its
    subtree (no orphan child stays matchable)."""
    cl = _stub(True, n_inst=1)
    cache = RadixPrefixCache(cl, host_tier=HostKVTier(8))
    eng = cl.engines[0]
    _finish_request(cl, cache, 0, _CHUNKS[:2], 1, True)
    orig = {nd.hash: eng.read_block_rows(nd.replicas[0])
            for nd in cache._nodes.values()}
    assert cache.evict_device(0, 2) == 2
    assert cache.device_blocks(0) == 0 and cache.host_blocks() == 2
    assert len(cache.acquire(0, 2, _tokens(_CHUNKS[:2]), max_blocks=2)) == 2
    for nd in cache._pins[2]:
        for got, want in zip(eng.read_block_rows(nd.replicas[0]),
                             orig[nd.hash]):
            assert torch.equal(got, want)
    cache.release(2)
    cl = _stub(True, n_inst=1)
    cache = RadixPrefixCache(cl, host_tier=HostKVTier(3))
    cache.tier.high = cache.tier.low = 1.0
    for j, path in enumerate(([_CHUNKS[0], _CHUNKS[1]], [_CHUNKS[2]],
                              [_CHUNKS[3]])):
        _finish_request(cl, cache, 0, path, j + 1, True)
    assert cache.evict_device(0, POOL) >= 4
    assert cache.host_blocks() == 2 and cache.num_nodes == 2
    assert cache.acquire(0, 99, _tokens(_CHUNKS[:2]), max_blocks=2) == []
    _check_invariants(cl, cache)


def test_spill_that_evicts_its_own_ancestor_leaves_no_orphan_frame():
    """Spilling a chain's second block into a full tier LRU-evicts the
    first block's host frame; the first node has no device replica, so
    its subtree — the second node included — is dropped. The frame just
    spilled then belongs to no node: the port drops it, while the JAX
    package's tier keeps it (an orphan until LRU reaches it). Everything
    else matches."""
    sides = []
    for port in (False, True):
        cl = _stub(port, n_inst=1)
        tier = (HostKVTier if port else JaxTier)(1, high_watermark=1.0,
                                                 low_watermark=1.0)
        cache = (RadixPrefixCache if port else JaxCache)(cl, host_tier=tier)
        _finish_request(cl, cache, 0, _CHUNKS[:2], 1, port)
        assert cache.evict_device(0, 1) == 1        # the root block spills
        cache.evict_device(0, 1)                    # its child's spill
        sides.append((cl, cache))
    (jcl, jcache), (pcl, pcache) = sides
    assert pcache.num_nodes == jcache.num_nodes == 0
    for cl in (jcl, pcl):
        assert cl.engines[0].rmanager.pool.alloc.used_count == 0
    assert pcache.tier.used_blocks == 0
    assert jcache.tier.used_blocks == 1             # the reference's orphan


# ------------------------------------------------------------------ #
# Serving
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _oracle(jp, cfg, prompt, n_new):
    logits, state = jax_prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                max_len=len(prompt) + n_new + 2)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = jax_decode_step(jp, cfg, state,
                                    jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def _cache_server(pkg, params, cfg, **over):
    base = dict(n_instances=1, max_batch=2, max_local_len=64,
                pool_blocks=48, block_size=8, prefill_chunk=8,
                prefix_cache=True, host_tier_blocks=64)
    base.update(over)
    kw = {"device": "cpu"} if pkg is psv else {}
    return pkg.LLMServer(params, cfg, pkg.ServingConfig.smoke(**base), **kw)


_METRICS = ("cache_hit_tokens", "host_spill_bytes", "host_prefetch_bytes",
            "cache_device_blocks", "host_blocks_used")


@MODES
def test_warm_and_cow_hits_match_jax_and_the_oracle(setup, global_pool):
    cfg, jp, tp = setup
    rng = np.random.default_rng(60)
    full = rng.integers(0, cfg.vocab_size, 24).tolist()    # 3 blocks
    partial = full[:16] + rng.integers(0, cfg.vocab_size, 6).tolist()
    want = [_oracle(jp, cfg, p, 6) for p in (full, full, partial)]
    got = {}
    for pkg, params in ((jsv, jp), (psv, tp)):
        server = _cache_server(pkg, params, cfg, global_pool=global_pool)
        sp = pkg.SamplingParams(max_new_tokens=6)
        outs = [server.submit(p, sp).result()          # cold, COW, warm
                for p in (full, full, partial)]
        m = server.metrics
        got[pkg] = (outs, [m[k] for k in _METRICS],
                    server.cluster.prefix_cache.stats.cow_copies)
    assert got[psv][0] == want
    assert got[psv] == got[jsv]
    assert got[psv][1][0] == 23 + 16 and got[psv][2] == 1


@MODES
def test_host_prefetched_hits_match_jax_and_the_oracle(setup, global_pool):
    cfg, jp, tp = setup
    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, cfg.vocab_size, 24).tolist()
               for _ in range(3)]
    want = [_oracle(jp, cfg, p, 4) for p in prompts] * 2
    got = {}
    for pkg, params in ((jsv, jp), (psv, tp)):
        server = _cache_server(pkg, params, cfg, pool_blocks=9, max_batch=1,
                               global_pool=global_pool)
        sp = pkg.SamplingParams(max_new_tokens=4)
        outs = [server.submit(p, sp).result() for p in prompts + prompts]
        got[pkg] = (outs, [server.metrics[k] for k in _METRICS])
    assert got[psv][0] == want
    assert got[psv] == got[jsv]
    spill, prefetch = got[psv][1][1:3]
    assert spill > 0 and prefetch > 0
    cl = server.cluster
    steps = sum(e.stats.decode_steps for e in cl.engines.values())
    assert steps and not sum(e.stats.pool_copy_steps
                             for e in cl.engines.values())


@MODES
def test_cow_tail_never_aliases_a_shared_frame(setup, global_pool):
    cfg, jp, tp = setup
    rng = np.random.default_rng(62)
    server = _cache_server(psv, tp, cfg, global_pool=global_pool)
    cl = server.cluster
    eng = cl.engines[0]
    ptr = eng.pool_k.data_ptr()
    prompt = rng.integers(0, cfg.vocab_size, 24).tolist()
    server.submit(prompt, psv.SamplingParams(max_new_tokens=4)).result()
    cache = cl.prefix_cache
    node_blocks = {nd.hash: nd.replicas[0] for nd in cache._nodes.values()}
    assert len(node_blocks) == 3
    baseline = {h: tuple(t.clone() for t in eng.read_block_rows(b))
                for h, b in node_blocks.items()}
    h = server.submit(prompt, psv.SamplingParams(max_new_tokens=6))
    for _ in range(50):                  # drive past admission
        if h._req.output:
            break
        server.step()
    rb = eng.rmanager.pool.requests[h.req_id]
    shared = set(node_blocks.values())
    assert set(rb.blocks[:2]) <= shared          # table-edit admission
    assert not set(rb.blocks[2:]) & shared       # private COW tail
    assert h.result() == _oracle(jp, cfg, prompt, 6)
    for hsh, b in node_blocks.items():
        for got, want in zip(eng.read_block_rows(b), baseline[hsh]):
            assert torch.equal(got, want)
    assert eng.pool_k.data_ptr() == ptr


@MODES
def test_cancel_mid_prefill_with_cache_pins_rolls_back_exactly(
        setup, global_pool, monkeypatch):
    cfg, _, tp = setup
    rng = np.random.default_rng(63)
    server = psv.LLMServer(tp, cfg, psv.ServingConfig.smoke(
        n_instances=2, max_batch=2, max_local_len=16, pool_blocks=32,
        block_size=4, prefix_cache=True, host_tier_blocks=32,
        global_pool=global_pool), device="cpu")
    cl = server.cluster
    cache = cl.prefix_cache
    sp = psv.SamplingParams(max_new_tokens=4)
    # Warm the cache with an 8-token prefix (2 blocks, local).
    prefix = rng.integers(0, cfg.vocab_size, 8).tolist()
    server.submit(prefix, sp).result()
    assert sum(cache.device_blocks(i) for i in cl.engines) >= 2

    def snap():
        out = {}
        for i, e in cl.engines.items():
            a = e.rmanager.pool.alloc
            cache_blks = {nd.replicas[i] for nd in cache._nodes.values()
                          if i in nd.replicas}
            used = set(range(a.num_blocks)) - set(a._free)
            req_blks = {b for rb in e.rmanager.pool.requests.values()
                        for b in rb.blocks}
            assert used >= cache_blks | req_blks
            out[i] = (len(used - cache_blks - req_blks), a.reserved,
                      {r: list(rb.blocks)
                       for r, rb in e.rmanager.pool.requests.items()})
        return out

    before = snap()
    tier_before = (cl.host_tier.used_blocks, cl.host_tier.stats.spills)
    frees = collections.Counter()
    orig_free = BlockAllocator.free

    def spy_free(self, blocks):
        for b in blocks:
            frees[(id(self), b)] += 1
        orig_free(self, blocks)

    monkeypatch.setattr(BlockAllocator, "free", spy_free)
    name = "prefill_chunk_global" if global_pool else "prefill_chunk_paged"
    orig_chunk = getattr(pt_engine_mod, name)
    chunks = []

    def chunk_then_cancel(*a, **kw):
        out = orig_chunk(*a, **kw)
        chunks.append(a[3])                      # t0
        server.cancel(h.req_id)
        return out

    monkeypatch.setattr(pt_engine_mod, name, chunk_then_cancel)
    # 40 tokens reusing the cached prefix: pins both nodes, commits
    # creditor spans, then cancels after the first streamed chunk.
    prompt = prefix + rng.integers(0, cfg.vocab_size, 32).tolist()
    h = server.submit(prompt, sp)
    for _ in range(30):
        if h.done:
            break
        server.step()
    assert h.status.name == "CANCELLED"
    assert chunks == [8], "the stream should start after the cached prefix"
    assert snap() == before, "rollback was not exact"
    assert not cache._pins
    assert all(nd.refcount == 0 for nd in cache._nodes.values())
    assert (cl.host_tier.used_blocks, cl.host_tier.stats.spills) == \
        tier_before
    assert all(n == 1 for n in frees.values()), frees
    monkeypatch.setattr(pt_engine_mod, name, orig_chunk)
    hits0 = server.metrics["cache_hit_tokens"]
    server.submit(prefix, sp).result()
    assert server.metrics["cache_hit_tokens"] > hits0


@MODES
def test_spanning_chain_is_cached_and_warm_hits(setup, global_pool,
                                                monkeypatch):
    cfg, jp, tp = setup
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, 40).tolist()
    want = _oracle(jp, cfg, prompt, 8)
    inserted = []
    orig = RadixPrefixCache.insert_chain_multi

    def spy(self, placements, tokens):
        inserted.append([inst for inst, _ in placements])
        return orig(self, placements, tokens)

    monkeypatch.setattr(RadixPrefixCache, "insert_chain_multi", spy)
    outs = {}
    for pkg, params in ((psv, tp), (jsv, jp)):
        kw = {"device": "cpu"} if pkg is psv else {}
        cl = pkg.Cluster(params, cfg, pkg.ServingConfig.smoke(
            n_instances=3, max_batch=2, pool_blocks=32,
            global_pool=global_pool, prefix_cache=True), **kw)
        reqs = []
        for _ in range(2):
            r = pkg.Request(prompt=list(prompt),
                            sampling=pkg.SamplingParams(max_new_tokens=8))
            cl.submit(r)
            cl.run_until_done(max_steps=300)
            reqs.append(r)
        outs[pkg] = ([r.output for r in reqs],
                     sum(e.stats.cache_hit_tokens
                         for e in cl.engines.values()))
    assert inserted and len(set(inserted[0])) >= 2, inserted
    assert outs[psv][0] == [want, want]
    assert outs[psv] == outs[jsv]
    assert outs[psv][1] > 0
