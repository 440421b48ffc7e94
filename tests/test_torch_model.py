"""The port's dense and hybrid models and paged steps against the JAX
package.

The same float32 smoke weights (JAX ``init_params``, bridged) and the
same numpy-made inputs go through the JAX functions and the port's:

* ``forward`` logits, and prefill followed by ``decode_step`` == forward;
* hybrid (RecurrentGemma): the RG-LRU scan (closed form by chunks)
  against JAX's associative scan, with and without a carried state and
  at lengths from 1 to over two chunks; chained decode steps == the
  scan; ``forward`` with the flash and xla cores; ``prefill`` then
  teacher-forced ``decode_step`` past the window; ``repack_ring`` and
  ``write_slot`` against JAX where JAX is right, and the port's repack
  of a prompt longer than the window (where JAX's raises);
* ``prefill_chunk_paged`` over a prompt whose prefix is striped across
  1-3 creditor pools (dense models, and the MoE smoke models) (chunk sizes of the JAX package's chunked-prefill
  test), then teacher-forced ``decode_step_paged`` steps over the same
  owner + creditor pools: per-step logits, the chunk KV exports and every
  pool row agree, the new token's KV lands in its tail block before
  attention (its row equals the dense oracle's cache row and the step's
  logits equal the dense oracle's), and the pool tensors are updated in
  place, never reallocated.

Tolerance: float32 on both sides, summed in different orders by XLA and
PyTorch; 1e-4 relative to the largest logit (and absolute on KV rows,
which are O(1)), far below any argmax margin the serving tests rely on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import decode_step_paged as jax_decode_step_paged
from repro.models.prefill import prefill as jax_prefill
from repro.models.prefill import prefill_chunk_paged as jax_prefill_chunk_paged
from repro.models.prefill import repack_ring as jax_repack_ring
from repro.models.prefill import write_slot as jax_write_slot
from repro.models import rglru as jax_rglru
from repro.serving.kvpool import scatter_pool_rows as jax_scatter_pool_rows
from repro_torch import bridge
from repro_torch.models import rglru
from repro_torch.models.attention import make_causal_core
from repro_torch.models.moe import apply_moe
from repro_torch.models.model import (decode_step, forward,
                                      init_decode_state, layer_params)
from repro_torch.models.prefill import (decode_step_paged, prefill,
                                        prefill_chunk_paged, repack_ring,
                                        write_slot)
from repro_torch.serving.kvpool import (RankKVPool, build_local_tables,
                                        prefix_tables, rows_for_token_range,
                                        scatter_pool_rows, table_bucket)

TOL = 1e-4
_SETUPS = {}


def _setup(arch, layers=None):
    """(cfg, JAX params, port params) in float32, built once per arch
    and depth."""
    if (arch, layers) not in _SETUPS:
        cfg = dataclasses.replace(get_smoke_config(arch, layers=layers),
                                  dtype="float32")
        jp = jax_init_params(jax.random.PRNGKey(0), cfg)
        tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _SETUPS[(arch, layers)] = (cfg, jp, tp)
    return _SETUPS[(arch, layers)]


def _close_logits(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-0.6b"])
def test_forward_matches_jax(arch):
    cfg, jp, tp = _setup(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13))
    want, _ = jax_forward(jp, cfg, jnp.asarray(toks, jnp.int32))
    got, _ = forward(tp, cfg, torch.from_numpy(toks))
    assert got.shape == want.shape
    _close_logits(got.numpy(), want)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-0.6b"])
def test_prefill_then_decode_step_equals_forward(arch):
    cfg, jp, tp = _setup(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    T0 = 7
    full, _ = forward(tp, cfg, torch.from_numpy(toks))
    lg, st = prefill(tp, cfg, torch.from_numpy(toks[:, :T0]), max_len=16)
    jlg, jst = jax_prefill(jp, cfg, jnp.asarray(toks[:, :T0], jnp.int32),
                           max_len=16)
    _close_logits(lg.numpy(), full[:, T0 - 1].numpy())
    _close_logits(lg.numpy(), jlg)
    for t in range(T0, toks.shape[1]):
        lg, st = decode_step(tp, cfg, st, torch.from_numpy(toks[:, t]))
        jlg, jst = jax_decode_step(jp, cfg, jst,
                                   jnp.asarray(toks[:, t], jnp.int32))
        _close_logits(lg.numpy(), full[:, t].numpy())
        _close_logits(lg.numpy(), jlg)
    _close(st.kv_k.numpy(), jst.kv_k)
    assert st.lens.tolist() == [toks.shape[1]] * 2


def test_flash_backend_and_other_families_wait_for_later_slices():
    """The "flash" core builds and equals the "xla" core; the JAX name
    "pallas" points to it; expert-parallel grouped MoE (``ep_groups > 1``,
    ported since the training slice) no longer raises and, with no-drop
    capacity, equals the plain dispatch (both against JAX:
    ``tests/test_torch_moe.py``, ``tests/test_torch_training.py``; the
    ssm family: ``tests/test_torch_xlstm.py``)."""
    cfg, _, _ = _setup("olmo-1b")
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 37, cfg.num_heads, cfg.head_dim)).astype(np.float32))
        for _ in range(3))
    for window in (0, 8):
        flash = make_causal_core(cfg, backend="flash", window=window)
        xla = make_causal_core(cfg, backend="xla", window=window, chunk=16)
        _close(flash(q, k, v).numpy(), xla(q, k, v).numpy())
    with pytest.raises(ValueError, match="'flash'"):
        make_causal_core(cfg, backend="pallas")
    mcfg, _, mtp = _setup("qwen2-moe-a2.7b")
    lp = layer_params(mtp["moe_layers"]["moe"], 0)
    x = torch.from_numpy(rng.standard_normal(
        (1, 4, mcfg.d_model)).astype(np.float32))
    plain = apply_moe(lp, x, mcfg, -1.0)
    assert apply_moe(lp, x, mcfg, ep_groups=1).shape == x.shape
    _close(apply_moe(lp, x, mcfg, -1.0, ep_groups=2).numpy(), plain.numpy())


# ------------------------------------------------------------------ #
# Paged steps: owner pool + 1-3 creditor pools, teacher-forced
# ------------------------------------------------------------------ #
BS, NB, T, N_DEC = 4, 16, 22, 5
CREDITOR_BLOCKS = (2, 1, 1)        # prefix blocks on creditor 1, 2, 3


class _Ranks:
    """Owner + creditor pools of one request, mirrored as JAX arrays and
    port tensors with identical contents, plus the port's allocators."""

    def __init__(self, cfg, n_cred, rid=5):
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        self.rid = rid
        self.alloc = [RankKVPool(NB, BS) for _ in range(n_cred + 1)]
        for p, a in enumerate(self.alloc):        # ballast: non-trivial ids
            assert a.append_tokens(900 + p, BS * (p + 1))
        # Creditor spans hold the block-aligned prefix [0, n_over).
        self.spans, start = [], 0
        for c in range(n_cred):
            n = CREDITOR_BLOCKS[c] * BS
            assert self.alloc[c + 1].append_tokens(rid, n)
            self.spans.append((start, n))
            start += n
        self.n_over = start
        self.n_local = T - start
        assert self.alloc[0].append_tokens(rid, self.n_local)
        rng = np.random.default_rng(n_cred)
        shape = (L, NB, BS, K, hd)
        # Unused rows hold noise: a wrong table entry cannot read zeros.
        init = [(rng.standard_normal(shape).astype(np.float32),
                 rng.standard_normal(shape).astype(np.float32))
                for _ in self.alloc]
        self.jax = [(jnp.asarray(k), jnp.asarray(v)) for k, v in init]
        self.pt = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                   for k, v in init]

    def blocks(self, p):
        return self.alloc[p].requests[self.rid].blocks

    def assert_pools_equal(self):
        for (jk, jv), (tk, tv) in zip(self.jax, self.pt):
            _close(tk.numpy(), jk)
            _close(tv.numpy(), jv)


def _stream_prompt(cfg, jp, tp, ranks, prompt, chunk):
    """Drive both packages' ``prefill_chunk_paged`` over the prompt the
    way the engine does; returns the final chunk's port logits."""
    n_over, n_local = ranks.n_over, ranks.n_local
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        n_valid = t1 - t0
        toks = np.zeros(chunk, np.int32)
        toks[:n_valid] = prompt[t0:t1]
        wblk = np.full(chunk, NB, np.int32)
        woff = np.zeros(chunk, np.int32)
        lo = max(t0, n_over)
        if lo < t1:
            blk, off = rows_for_token_range(ranks.blocks(0), BS,
                                            lo - n_over, t1 - n_over)
            wblk[lo - t0:t1 - t0] = blk
            woff[lo - t0:t1 - t0] = off
        covered = [min(max(t0 - n_over, 0), n_local)] + \
            [min(max(t0 - s, 0), n) for s, n in ranks.spans]
        needed = max(1, max(-(-c // BS) for c in covered))
        tables, tails = prefix_tables(ranks.alloc, ranks.rid, covered,
                                      table_bucket(needed))
        (jk, jv), (tk, tv) = ranks.jax[0], ranks.pt[0]
        jlg, jk, jv, jkc, jvc = jax_prefill_chunk_paged(
            jp, cfg, toks, t0, n_valid, jk, jv, tables, tails, wblk, woff,
            remote_pools=tuple(ranks.jax[1:]))
        ranks.jax[0] = (jk, jv)
        ptr = tk.data_ptr()
        lg, tk2, tv2, kc, vc = prefill_chunk_paged(
            tp, cfg, toks, t0, n_valid, tk, tv, tables, tails, wblk, woff,
            remote_pools=tuple(ranks.pt[1:]))
        assert tk2 is tk and tv2 is tv and tk.data_ptr() == ptr
        _close_logits(lg.numpy(), jlg)
        _close(kc.numpy(), jkc)
        _close(vc.numpy(), jvc)
        # Creditor-bound rows stream out to the creditor pools.
        for c, (s, n) in enumerate(ranks.spans, start=1):
            a, b = max(t0, s), min(t1, s + n)
            if a >= b:
                continue
            blk, off = rows_for_token_range(ranks.blocks(c), BS, a - s, b - s)
            jk, jv = ranks.jax[c]
            ranks.jax[c] = (
                jax_scatter_pool_rows(jk, blk, off, jkc[:, a - t0:b - t0]),
                jax_scatter_pool_rows(jv, blk, off, jvc[:, a - t0:b - t0]))
            tk, tv = ranks.pt[c]
            scatter_pool_rows(tk, blk, off, kc[:, a - t0:b - t0])
            scatter_pool_rows(tv, blk, off, vc[:, a - t0:b - t0])
    return lg


@pytest.mark.parametrize("arch,chunk,n_cred", [
    ("qwen3-0.6b", 5, 3),
    ("qwen3-0.6b", 8, 2),
    ("qwen3-0.6b", 32, 1),
    ("olmo-1b", 8, 3),
    ("qwen2-moe-a2.7b", 8, 2),         # MoE layers, no capacity drop
    ("kimi-k2-1t-a32b", 5, 3),         # first_k_dense=1: dense + MoE
])
def test_paged_steps_match_jax_and_dense_oracle(arch, chunk, n_cred):
    cfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(100 + chunk)
    prompt = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, N_DEC).astype(np.int32)
    ranks = _Ranks(cfg, n_cred)

    lg = _stream_prompt(cfg, jp, tp, ranks, prompt, chunk)
    ranks.assert_pools_equal()
    # Dense oracle (the port's own prefill + decode_step).
    olg, ost = prefill(tp, cfg, torch.from_numpy(prompt[None]),
                       max_len=T + N_DEC)
    _close_logits(lg.numpy(), olg.numpy())

    # Teacher-forced decode: slot 0 runs the request, slot 1 is inactive
    # (write target NB: the JAX package's dropped write).
    for i, tok in enumerate(forced):
        pos = T + i
        assert ranks.alloc[0].append_tokens(ranks.rid, 1)
        rb = ranks.alloc[0].requests[ranks.rid]
        wblk = np.array([rb.blocks[-1], NB], np.int32)
        woff = np.array([rb.tail_tokens - 1, 0], np.int32)
        needed = max(len(ranks.blocks(p)) for p in range(len(ranks.alloc)))
        tables, tails = build_local_tables(ranks.alloc, [ranks.rid, -1],
                                           table_bucket(needed))
        tokens = np.array([tok, 0], np.int32)
        lens = np.array([pos, 0], np.int32)
        (jk, jv), (tk, tv) = ranks.jax[0], ranks.pt[0]
        jlg, jk, jv = jax_decode_step_paged(
            jp, cfg, tokens, lens, jk, jv, tables, tails, wblk, woff,
            remote_pools=tuple(ranks.jax[1:]))
        ranks.jax[0] = (jk, jv)
        ptr = tk.data_ptr()
        lg, tk2, tv2 = decode_step_paged(
            tp, cfg, tokens, lens, tk, tv, tables, tails, wblk, woff,
            remote_pools=tuple(ranks.pt[1:]))
        assert tk2 is tk and tk.data_ptr() == ptr
        _close_logits(lg[0].numpy(), jlg[0])
        olg, ost = decode_step(tp, cfg, ost, torch.from_numpy(tokens[:1]))
        # The token attended to itself: its KV was in the tail block
        # before attention, so the step equals the dense oracle.
        _close_logits(lg[0].numpy(), olg[0].numpy())
        _close(tk[:, wblk[0], woff[0]].numpy(), ost.kv_k[:, 0, pos].numpy())
        _close(tv[:, wblk[0], woff[0]].numpy(), ost.kv_v[:, 0, pos].numpy())
    ranks.assert_pools_equal()


# ------------------------------------------------------------------ #
# Hybrid family (RecurrentGemma): RG-LRU, local attention, slots
# ------------------------------------------------------------------ #
HYBRID = "recurrentgemma-9b"


def _rglru_params(cfg):
    """One recurrent block's weights: JAX's init, bridged to the port."""
    jp = jax_rglru.init_rglru_block(jax.random.PRNGKey(3), cfg)
    return jp, bridge.from_numpy_tree(jax.tree.map(np.asarray, jp),
                                      device="cpu")


@pytest.mark.parametrize("T", [1, 7, 64, 150])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_scan_matches_jax(T, carried):
    """Chunked closed form == JAX's associative scan: the scan alone, and
    the whole block (conv with its carry, scan with h0, gates, GeLU)."""
    cfg, _, _ = _setup(HYBRID)
    jp, tp = _rglru_params(cfg)
    w = cfg.lru_width
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, w)).astype(np.float32)
    xd = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32) if carried else None
    conv = (rng.standard_normal((2, 3, w)).astype(np.float32)
            if carried else None)
    jy, jh = jax.jit(jax_rglru.rglru_scan)(
        jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    y, h = rglru.rglru_scan(
        tp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    assert h.dtype == torch.float32 and y.dtype == torch.float32
    _close(y.numpy(), jy)
    _close(h.numpy(), jh)
    jstate = None if h0 is None else (jnp.asarray(conv), jnp.asarray(h0))
    state = None if h0 is None else (torch.from_numpy(conv),
                                     torch.from_numpy(h0))
    jy, (jc, jh) = jax.jit(jax_rglru.apply_rglru_block, static_argnums=2)(
        jp, jnp.asarray(xd), cfg, jstate)
    y, (c, h) = rglru.apply_rglru_block(tp, torch.from_numpy(xd), cfg, state)
    _close(y.numpy(), jy)
    _close(c.numpy(), jc)                 # last 3 PRE-conv inputs
    _close(h.numpy(), jh)


def test_rglru_steps_chained_equal_the_scan():
    """T decode steps of the block, state carried, == one prompt pass."""
    cfg, _, _ = _setup(HYBRID)
    jp, tp = _rglru_params(cfg)
    T = 70
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32))
    y, (c, h) = rglru.apply_rglru_block(tp, x, cfg)
    shapes = rglru.rglru_state_shape(cfg, 2)
    state = (torch.zeros(shapes[0]), torch.zeros(shapes[1]))
    steps = []
    for t in range(T):
        yt, state = rglru.apply_rglru_block(tp, x[:, t:t + 1], cfg, state,
                                            decode=True)
        steps.append(yt)
    _close(torch.cat(steps, 1).numpy(), y.numpy())
    _close(state[0].numpy(), c.numpy())
    _close(state[1].numpy(), h.numpy())


@pytest.mark.parametrize("layers", [3, 6])
@pytest.mark.parametrize("backend", ["flash", "xla"])
def test_hybrid_forward_matches_jax(layers, backend):
    """Logits over a prompt longer than the window (45 > 32), with one
    group and with two groups of (rglru, rglru, attn)."""
    cfg, jp, tp = _setup(HYBRID, layers)
    toks = np.random.default_rng(layers).integers(0, cfg.vocab_size, (2, 45))
    want, _ = jax_forward(jp, cfg, jnp.asarray(toks, jnp.int32))
    got, _ = forward(tp, cfg, torch.from_numpy(toks), backend=backend)
    _close_logits(got.numpy(), want)


def test_hybrid_prefill_then_decode_past_the_window_matches_jax():
    """Prefill 40 tokens (> window 32) with the flash core, then
    teacher-forced decode steps: logits, KV ring, RG-LRU and conv states
    == JAX's, and logits == the full forward (5 layers: a group plus
    two leftover RG-LRU layers)."""
    cfg, jp, tp = _setup(HYBRID, 5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 46))
    T0 = 40
    full, _ = forward(tp, cfg, torch.from_numpy(toks))
    lg, st = prefill(tp, cfg, torch.from_numpy(toks[:, :T0]), max_len=T0,
                     backend="flash")
    jlg, jst = jax.jit(jax_prefill, static_argnums=1,
                       static_argnames="max_len")(
        jp, cfg, jnp.asarray(toks[:, :T0], jnp.int32), max_len=T0)
    assert st.kv_k.shape[2] == cfg.local_window
    jdecode = jax.jit(jax_decode_step, static_argnums=1)
    _close_logits(lg.numpy(), jlg)
    _close_logits(lg.numpy(), full[:, T0 - 1].numpy())
    for t in range(T0, toks.shape[1]):
        lg, st = decode_step(tp, cfg, st, torch.from_numpy(toks[:, t]))
        jlg, jst = jdecode(jp, cfg, jst, jnp.asarray(toks[:, t], jnp.int32))
        _close_logits(lg.numpy(), jlg)
        _close_logits(lg.numpy(), full[:, t].numpy())
    _close(st.kv_k.numpy(), jst.kv_k)
    _close(st.kv_v.numpy(), jst.kv_v)
    _close(st.rec[0].numpy(), jst.rec[0])
    _close(st.rec[1].numpy(), jst.rec[1])
    assert st.lens.tolist() == [toks.shape[1]] * 2


def test_hybrid_prefill_then_decode_with_two_groups_equals_forward():
    """With two or more groups the states are kept in layer order, the
    order ``decode_step`` reads them in (JAX's ``prefill`` stacks them by
    pattern position, so its own decode drifts from its forward here)."""
    cfg, _, tp = _setup(HYBRID, 6)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 44))
    T0 = 36
    full, _ = forward(tp, cfg, torch.from_numpy(toks))
    lg, st = prefill(tp, cfg, torch.from_numpy(toks[:, :T0]), max_len=T0)
    _close_logits(lg.numpy(), full[:, T0 - 1].numpy())
    for t in range(T0, toks.shape[1]):
        lg, st = decode_step(tp, cfg, st, torch.from_numpy(toks[:, t]))
        _close_logits(lg.numpy(), full[:, t].numpy())


def test_repack_ring_and_write_slot_match_jax_within_the_window():
    """A 20-token prompt (< window) repacked into a 32-slot ring and
    written into slot 1 of a 3-slot batch state, as JAX does it."""
    cfg, jp, tp = _setup(HYBRID)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 20))
    _, st = prefill(tp, cfg, torch.from_numpy(toks), max_len=20)
    _, jst = jax_prefill(jp, cfg, jnp.asarray(toks, jnp.int32), max_len=20)
    req = repack_ring(st, 32, n_keep=20)
    jreq = jax_repack_ring(jst, 32, n_keep=20)
    _close(req.kv_k.numpy(), jreq.kv_k)
    _close(req.kv_v.numpy(), jreq.kv_v)
    batch = init_decode_state(cfg, 3, 32, device="cpu")
    for f in (batch.kv_k, batch.kv_v, *batch.rec):
        f.fill_(7.0)                      # stale contents of a reused slot
    def j(t):
        return jnp.asarray(t.numpy().copy())
    jbatch = type(jst)(j(batch.kv_k), j(batch.kv_v),
                       j(batch.lens).astype(jnp.int32),
                       (j(batch.rec[0]), j(batch.rec[1])))
    got = write_slot(batch, 1, req, cfg)
    want = jax_write_slot(jbatch, 1, jreq, cfg)
    assert got.kv_k is batch.kv_k                   # written in place
    for g, w in ((got.kv_k, want.kv_k), (got.kv_v, want.kv_v),
                 (got.rec[0], want.rec[0]), (got.rec[1], want.rec[1])):
        _close(g.numpy(), w)
    assert got.lens.tolist() == [0, 20, 0]


def test_repack_ring_reads_the_prefill_ring_past_the_window():
    """A 40-token prompt (> window 32): the prefill ring holds positions
    8..39 at slot position % 32. Repacked into rings of 32 and 48 slots,
    decoding from either equals decoding from the prefill's own state
    (JAX's repack slices the ring as if it held every token, and
    raises)."""
    cfg, jp, tp = _setup(HYBRID)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 48))
    T0 = 40
    _, ref = prefill(tp, cfg, torch.from_numpy(toks[:, :T0]), max_len=T0)
    _, jst = jax_prefill(jp, cfg, jnp.asarray(toks[:, :T0], jnp.int32),
                         max_len=T0)
    with pytest.raises(ValueError):
        jax_repack_ring(jst, 64, n_keep=T0)
    states = [repack_ring(ref, ring, n_keep=T0) for ring in (32, 48)]
    pos = torch.arange(T0 - 32, T0)
    for st, ring in zip(states, (32, 48)):
        assert st.kv_k.shape[2] == ring
        assert torch.equal(st.kv_k[:, :, pos % ring], ref.kv_k[:, :, pos % 32])
    for t in range(T0, toks.shape[1]):
        tok = torch.from_numpy(toks[:, t])
        want, ref = decode_step(tp, cfg, ref, tok)
        for i, st in enumerate(states):
            got, states[i] = decode_step(tp, cfg, st, tok)
            _close_logits(got.numpy(), want.numpy())
