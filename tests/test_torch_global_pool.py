"""The port's global KV pool against the JAX package.

One cluster-wide pool tensor ``[ranks, L, NB, bs, K, hd]`` in place of
the per-instance pools (``serving/globalpool.py``,
``serving/sharded_step.py`` and the global branches of the engine and
the cluster). JAX float32 smoke weights are bridged into the port and
the same numpy-made inputs go through both packages:

* ``GlobalKVPool``'s updaters (whole-block writes with a zero-padded
  partial block, row scatters, block reads, a StripedMove's block copy
  between ranks) against JAX's on the same operations;
* the global steps alone, ``prefill_chunk_global`` and
  ``decode_step_global``, on the same random pool, tables and write
  targets: logits, chunk KV exports and every pool row agree with JAX's
  (dense, MoE, and kimi's dense + MoE stacks);
* drop-mode writes: rows whose block is the sentinel ``NB`` or whose
  rank lies outside the pool (negative, or past the last rank) write
  nothing — where JAX's single-device scatter would wrap a negative rank
  onto the last one — and no other row moves;
* serving, olmo-1b and qwen2-moe-a2.7b smoke, prompts of 5, 40 and 12
  tokens, 10 new tokens: the port's global-pool cluster gives the same
  greedy streams as its per-instance cluster, the JAX dense oracle
  (``prefill`` + ``decode_step``) and the JAX global-pool cluster, with
  KV moved (striped admission and mid-decode moves);
* the engines alias the shared allocators and hold no private pool, no
  step reallocates the pool tensor, and ``add_instance`` refuses.

Tolerance: float32 on both sides, summed in different orders; 1e-4
relative to the largest logit, absolute on KV rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jsv
from repro.configs import get_smoke_config
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro.serving.globalpool import GlobalKVPool as JaxGlobalKVPool
from repro.serving.sharded_step import decode_step_global as jax_decode_global
from repro.serving.sharded_step import \
    prefill_chunk_global as jax_prefill_global
from repro_torch import bridge
from repro_torch import serving as psv
from repro_torch.serving.sharded_step import (decode_step_global,
                                              prefill_chunk_global)

TOL = 1e-4
NR, NB, BS, MB = 3, 10, 4, 4
_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        jp = jax_init_params(jax.random.PRNGKey(0), cfg)
        tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _SETUPS[arch] = (cfg, jp, tp)
    return _SETUPS[arch]


def _close_logits(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def _pool(cfg, rng):
    """A global pool pair with noise in every row, as numpy."""
    shape = (NR, cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2))


def _tables(rng, rows):
    """Prefix-contiguous -1-padded tables [NR, rows, MB] and tails."""
    tables = -np.ones((NR, rows, MB), np.int32)
    tails = np.full((NR, rows), BS, np.int32)
    for p in range(NR):
        perm = rng.permutation(NB)
        for r in range(rows):
            n = int(rng.integers(0, 3))
            tables[p, r, :n] = perm[2 * r:2 * r + n]
            if n:
                tails[p, r] = rng.integers(1, BS + 1)
    return tables, tails


def test_global_pool_updaters_match_jax():
    cfg, _, _ = _setup("olmo-1b")
    rng = np.random.default_rng(4)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    jg = JaxGlobalKVPool(NR, NB, BS, cfg)
    pg = psv.GlobalKVPool(NR, NB, BS, cfg, device="cpu")
    assert pg.k.shape == jg.k.shape == (NR, L, NB, BS, K, hd)
    assert len(pg.ranks) == NR and pg.ranks[0] is not pg.ranks[1]
    ptr = pg.k.data_ptr()

    def rows(n):
        return rng.standard_normal((L, n, K, hd)).astype(np.float32)
    k, v = rows(2 * BS - 1), rows(2 * BS - 1)      # partial final block
    jg.write_blocks(1, [3, 7], k, v)
    pg.write_blocks(1, [3, 7], torch.from_numpy(k), torch.from_numpy(v))
    k, v = rows(3), rows(3)
    blk, off = np.array([2, 2, 9]), np.array([0, 3, 1])
    jg.scatter_rows(2, blk, off, k, v)
    pg.scatter_rows(2, blk, off, torch.from_numpy(k), torch.from_numpy(v))
    jg.copy_blocks(1, [7, 3], 0, [5, 6])
    pg.copy_blocks(1, [7, 3], 0, [5, 6])
    for got, want in zip(pg.read_blocks(0, [5, 6, 9]),
                         jg.read_blocks(0, [5, 6, 9])):
        assert got.shape == (L, 3 * BS, K, hd)
        _close(got.numpy(), want)
    _close(pg.k.numpy(), jg.k)
    _close(pg.v.numpy(), jg.v)
    assert pg.k.data_ptr() == ptr            # every update in place


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b",
                                  "kimi-k2-1t-a32b"])
def test_global_steps_match_jax(arch):
    cfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(5)
    gk, gv = _pool(cfg, rng)
    tk, tv = torch.from_numpy(gk.copy()), torch.from_numpy(gv.copy())
    ptr = tk.data_ptr()
    # A chunk of 8 rows (6 valid) over a prefix on every rank; rows land
    # on the owner (rank 0) and on both creditors, padding on NB.
    C, t0, n_valid = 8, 9, 6
    toks = rng.integers(0, cfg.vocab_size, C).astype(np.int32)
    tables, tails = _tables(rng, 1)
    wrank = np.array([1, 1, 2, 0, 0, 0, 0, 0], np.int32)
    wblk = np.array([7, 7, 8, 9, 9, 9, NB, NB], np.int32)
    woff = np.array([0, 1, 3, 0, 1, 2, 0, 0], np.int32)
    jlg, jk, jv, jkc, jvc = jax_prefill_global(
        jp, cfg, toks, t0, n_valid, jnp.asarray(gk), jnp.asarray(gv),
        tables[:, 0], tails[:, 0], wrank, wblk, woff)
    lg, tk2, tv2, kc, vc = prefill_chunk_global(
        tp, cfg, toks, t0, n_valid, tk, tv, tables[:, 0], tails[:, 0],
        wrank, wblk, woff)
    assert tk2 is tk and tk.data_ptr() == ptr
    _close_logits(lg.numpy(), jlg)
    _close(kc.numpy(), jkc)
    _close(vc.numpy(), jvc)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)
    # Decode: two slots of rank 1, the second inactive (sentinel NB).
    tables, tails = _tables(rng, 2)
    tokens = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
    lens = np.array([17, 3], np.int32)
    wblk, woff = np.array([9, NB], np.int32), np.array([2, 0], np.int32)
    jlg, jk, jv = jax_decode_global(jp, cfg, tokens, lens, jk, jv, tables,
                                    tails, wblk, woff, rank=1)
    lg, tk2, _ = decode_step_global(tp, cfg, tokens, lens, tk, tv, tables,
                                    tails, wblk, woff, rank=1)
    assert tk2 is tk and tk.data_ptr() == ptr
    _close_logits(lg.numpy(), jlg)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)


def test_drop_mode_writes_nothing_and_never_wraps():
    """Sentinel-block rows and rows of a foreign rank (-1, NR, NR + 1)
    write nothing; the valid rows land where they point, and nothing
    else of the pool changes."""
    cfg, _, tp = _setup("olmo-1b")
    rng = np.random.default_rng(6)
    gk, gv = _pool(cfg, rng)
    tk, tv = torch.from_numpy(gk.copy()), torch.from_numpy(gv.copy())
    tables, tails = _tables(rng, 1)
    wrank = np.array([-1, NR, NR + 1, 2, 0, 1], np.int32)
    wblk = np.array([3, 3, 3, NB, 5, 6], np.int32)
    woff = np.array([1, 1, 1, 1, 2, 3], np.int32)
    toks = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    _, _, _, kc, vc = prefill_chunk_global(tp, cfg, toks, 0, 6, tk, tv,
                                           tables[:, 0], tails[:, 0],
                                           wrank, wblk, woff)
    want_k, want_v = gk.copy(), gv.copy()
    for c in (4, 5):                       # the only rows that write
        want_k[wrank[c], :, wblk[c], woff[c]] = kc[:, c].numpy()
        want_v[wrank[c], :, wblk[c], woff[c]] = vc[:, c].numpy()
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tv.numpy(), want_v)
    # Decode with a negative tail block and the sentinel: no write.
    lens = np.array([6, 6], np.int32)
    decode_step_global(tp, cfg, toks[:2], lens, tk, tv, *_tables(rng, 2),
                       np.array([-1, NB], np.int32),
                       np.array([0, 0], np.int32), rank=NR - 1)
    np.testing.assert_array_equal(tk.numpy(), want_k)


# ------------------------------------------------------------------ #
# Serving
# ------------------------------------------------------------------ #
def _oracle(jp, cfg, prompt, n_new):
    logits, state = jax_prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                max_len=len(prompt) + n_new + 2)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = jax_decode_step(jp, cfg, state,
                                    jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def _run(pkg, params, cfg, prompts, n_new, *, global_pool, **kw):
    cl = pkg.Cluster(params, cfg, pkg.ServingConfig.smoke(
        n_instances=3, max_batch=2, pool_blocks=32,
        global_pool=global_pool), **kw)
    reqs = [pkg.Request(prompt=list(p),
                        sampling=pkg.SamplingParams(max_new_tokens=n_new))
            for p in prompts]
    for r in reqs:
        cl.submit(r)
    cl.run_until_done(max_steps=400)
    assert all(r.done for r in reqs), [r.state for r in reqs]
    return cl, [r.output for r in reqs]


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_global_pool_serves_the_oracle_streams_with_movement(arch):
    cfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 12)]
    n_new = 10
    refs = [_oracle(jp, cfg, p, n_new) for p in prompts]
    _, outs_pi = _run(psv, tp, cfg, prompts, n_new, global_pool=False,
                      device="cpu")
    cl, outs_gp = _run(psv, tp, cfg, prompts, n_new, global_pool=True,
                       device="cpu")
    _, outs_jax = _run(jsv, jp, cfg, prompts, n_new, global_pool=True)
    assert outs_pi == refs
    assert outs_gp == refs
    assert outs_jax == refs
    assert cl.gpool is not None
    assert cl.throughput_stats["kv_moved_bytes"] > 0


def test_global_pool_shares_allocators_and_never_copies_the_pool():
    cfg, _, tp = _setup("olmo-1b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (6, 40, 11)]
    cl, _ = _run(psv, tp, cfg, prompts, 8, global_pool=True, device="cpu")
    ptr = cl.gpool.k.data_ptr()
    for i, e in cl.engines.items():
        assert e.rmanager.pool is cl.gpool.ranks[i]
        assert e._pool_k is None and e._pool_v is None
        assert e.pool_k.data_ptr() == cl.gpool.k[i].data_ptr()
    steps = sum(e.stats.decode_steps for e in cl.engines.values())
    copies = sum(e.stats.pool_copy_steps for e in cl.engines.values())
    assert steps > 0 and copies == 0
    assert cl.gpool.k.data_ptr() == ptr
    with pytest.raises(RuntimeError, match="global-pool"):
        cl.add_instance(tp)
