"""The port's DistAttention math against the JAX package's (float32).

Same numpy-made inputs through both: the stacked LSE merge (paper Eq. 3)
with an empty partial among the ranks, the causal chunk partial the
admission step merges with the paged ones, the single-process paged
DistAttention decode over several rank pools (one of them empty) against
full attention over the whole KV, and the flash-prefill kernel's plain
twin.
Tolerance 1e-5: float32 on both sides, summed in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import online_softmax as jax_os
from repro.core.attention import full_attention_decode as jax_full_decode
from repro.kernels import ref as jax_ref
from repro_torch.core.distattn import distattn_decode_paged
from repro_torch.core.online_softmax import (combine, merge_partials,
                                             micro_attention_prefill)
from repro_torch.kernels.flash_prefill import flash_prefill_plain

TOL = 1e-5


def _pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def test_merge_partials_matches_jax_and_pairwise_combine():
    rng = np.random.default_rng(0)
    P, B, H, D = 3, 2, 4, 8
    jo, to = _pair(rng, (P, B, H, D))
    jm, tm = _pair(rng, (P, B, H))
    jl, tl = _pair(rng, (P, B, H))
    tl = tl.abs()
    jl = jnp.abs(jl)
    # Rank 1 holds no KV: the identity (0, -inf, 0).
    jo, jm, jl = jo.at[1].set(0), jm.at[1].set(-jnp.inf), jl.at[1].set(0)
    to[1], tm[1], tl[1] = 0, float("-inf"), 0
    got = merge_partials(to, tm, tl, axis=0)
    for g, w in zip(got, jax_os.merge_partials(jo, jm, jl, axis=0)):
        _close(g.numpy(), w)
    pair = combine(combine((to[0], tm[0], tl[0]), (to[1], tm[1], tl[1])),
                   (to[2], tm[2], tl[2]))
    for g, w in zip(pair, got):
        _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("window", [0, 3])
def test_chunk_causal_partial_matches_jax(window):
    rng = np.random.default_rng(1)
    B, T, S, K, G, D = 1, 6, 9, 2, 2, 16
    jq, tq = _pair(rng, (B, T, K * G, D))
    jk, tk = _pair(rng, (B, S, K, D))
    jv, tv = _pair(rng, (B, S, K, D))
    q_pos = np.arange(3, 3 + T, dtype=np.int32)[None]
    kv_pos = np.arange(S, dtype=np.int32)[None]
    valid = kv_pos < S - 1
    want = jax_os.micro_attention_prefill(
        jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
        jnp.asarray(valid), window=window)
    got = micro_attention_prefill(
        tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
        torch.from_numpy(valid), window=window)
    _close(got[0].numpy(), want[0])
    _close(got[2].numpy(), want[2])
    finite = np.isfinite(np.asarray(want[1]))
    assert np.array_equal(np.isfinite(got[1].numpy()), finite)
    _close(got[1].numpy()[finite], np.asarray(want[1])[finite])


def test_paged_distattn_over_ranks_equals_full_attention():
    """KV of 2 requests split over 3 rank pools (rank 2 holds none): the
    merged paged partials equal full attention over all of it."""
    rng = np.random.default_rng(2)
    R, bs, K, G, D, nblk = 2, 4, 2, 2, 16, 5
    jq, tq = _pair(rng, (R, K * G, D))
    jk, tk = _pair(rng, (R, nblk * bs, K, D))
    jv, tv = _pair(rng, (R, nblk * bs, K, D))
    tail = 3                                   # last block holds 3 tokens
    S = (nblk - 1) * bs + tail
    mask = np.arange(nblk * bs)[None].repeat(R, 0) < S
    want = jax_full_decode(jq, jk, jv, jnp.asarray(mask))
    kb = tk.reshape(R, nblk, bs, K, D)
    vb = tv.reshape(R, nblk, bs, K, D)
    split = [list(range(0, 3)), list(range(3, nblk)), []]
    pools, tables, tails = [], [], []
    for blocks in split:
        n = len(blocks)
        pk = torch.zeros((R * max(n, 1), bs, K, D))
        pv = torch.zeros_like(pk)
        table = -torch.ones((R, nblk), dtype=torch.int32)
        for r in range(R):
            for i, b in enumerate(blocks):
                pk[r * n + i], pv[r * n + i] = kb[r, b], vb[r, b]
                table[r, i] = r * n + i
        pools.append((pk, pv))
        tables.append(table)
        tails.append(torch.full((R,), tail if nblk - 1 in blocks else bs))
    got = distattn_decode_paged(tq, pools, torch.stack(tables),
                                torch.stack(tails))
    _close(got.numpy(), want)


@pytest.mark.parametrize("window", [0, 5])
def test_flash_prefill_oracle_matches_jax(window):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (2, 11, 6, 16))
    jk, tk = _pair(rng, (2, 11, 3, 16))
    jv, tv = _pair(rng, (2, 11, 3, 16))
    want = jax_ref.flash_prefill_ref(jq, jk, jv, window=window)
    _close(flash_prefill_plain(tq, tk, tv, scale=16 ** -0.5,
                               window=window).numpy(), want)
