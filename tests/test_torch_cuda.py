"""The port's CUDA kernels on the card, against their plain PyTorch twins.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they
carry the ``cuda`` marker and skip without one. The file imports no JAX,
so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 1e-4: kernel and twin compute in float32 from the same inputs
and differ in summation order (split-KV decode and prefill also in merge
order); the bf16 prefill-chunk kernel runs on tensor cores, where q K^T
products of bf16 values are exact and each probability enters P V as
bf16 hi + lo, which keeps it within the same 1e-4. The bf16 flash-prefill
kernel runs on tensor cores under the same contract; its output is
rounded from float32 on both sides, so it may differ by one bf16 ulp.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels.micro_attn_decode import (
    paged_micro_attention_cuda, paged_micro_attention_plain,
    paged_micro_attention_ranks_cuda, paged_micro_attention_ranks_plain)
from repro_torch.kernels.micro_attn_prefill import (
    paged_prefill_attention_cuda, paged_prefill_attention_plain,
    paged_prefill_attention_ranks_cuda, paged_prefill_attention_ranks_plain)

TOL = 1e-4


@pytest.fixture
def cuda_device():
    """The card; the test skips here when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _tables(rng, R, NB, bs, MB):
    """Random prefix-contiguous -1-padded tables and tails."""
    table = -np.ones((R, MB), np.int32)
    tail = np.full(R, bs, np.int32)
    perm = rng.permutation(NB)
    used = 0
    for r in range(R):
        n = min(int(rng.integers(0, MB + 1)), NB - used)
        table[r, :n] = perm[used:used + n]
        used += n
        if n:
            tail[r] = rng.integers(1, bs + 1)
    return table, tail


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,G,D,bs", [(8, 2, 128, 16), (1, 16, 128, 16),
                                      (16, 1, 128, 16), (2, 4, 256, 64),
                                      (1, 4, 112, 8)])
def test_cuda_kernels_match_plain(dtype, K, G, D, bs, cuda_device):
    """Each kernel == its plain twin at GQA, MQA, MHA, the largest head
    dim and block size and an unaligned head dim, with -1 padding,
    partial tails and an empty table."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rng = np.random.default_rng(0)
    H, NB, R, MB = K * G, 40, 5, 9
    q = torch.randn((R, H, D), generator=gen, device=cuda_device).to(dtype)
    pk = torch.randn((NB, bs, K, D), generator=gen,
                     device=cuda_device).to(dtype)
    pv = torch.randn((NB, bs, K, D), generator=gen,
                     device=cuda_device).to(dtype)
    table, tail = _tables(rng, R, NB, bs, MB)
    table[0] = -1
    tb = torch.from_numpy(table).to(cuda_device)
    tl = torch.from_numpy(tail).to(cuda_device)
    scale = D ** -0.5
    got = paged_micro_attention_cuda(q, pk, pv, tb, tl, scale=scale)
    _close(got, paged_micro_attention_plain(q, pk, pv, tb, tl, scale=scale))
    for r in range(2):                   # an empty and a filled table
        got = paged_prefill_attention_cuda(q, pk, pv, tb[r], tl[r],
                                           scale=scale)
        _close(got, paged_prefill_attention_plain(q, pk, pv, tb[r], tl[r],
                                                  scale=scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,D,window", [
    (1, 300, 16, 1, 256, 128),     # MQA, the hybrid path's heads
    (2, 200, 8, 2, 128, 0),        # GQA, causal only, ragged S
    (1, 77, 3, 3, 112, 16),        # MHA, odd head count, D=112
    (1, 50, 4, 1, 64, 100),        # window larger than S
    (1, 130, 4, 2, 64, 1),         # window of one token
    (1, 1, 16, 1, 256, 2048),      # S = 1: less than one m16 tile
    (1, 13, 16, 8, 128, 0),        # S = 13
    (1, 300, 8, 2, 40, 0),         # D = 40: reduction padded to 48
    (1, 300, 8, 2, 120, 100),      # D = 120: padded to 128, windowed
    (1, 700, 16, 1, 128, 0),       # G = 16 at D = 128
    (1, 700, 32, 2, 256, 300),     # G = 16 at D = 256, windowed
    (1, 1037, 16, 1, 256, 100),    # window not a multiple of the tile
    (2, 777, 16, 1, 256, 200),     # B = 2 with a window
])
def test_flash_prefill_kernel_matches_plain(dtype, B, S, H, K, D, window,
                                            cuda_device):
    """The flash-prefill kernel == its plain twin (tiles skipped before
    the window and above the diagonal, ragged S, every GQA grouping)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((B, S, H, D), generator=gen,
                    device=cuda_device).to(dtype)
    k = torch.randn((B, S, K, D), generator=gen,
                    device=cuda_device).to(dtype)
    v = torch.randn((B, S, K, D), generator=gen,
                    device=cuda_device).to(dtype)
    scale = D ** -0.5
    got = flash_prefill_cuda(q, k, v, scale=scale, window=window)
    want = flash_prefill_plain(q, k, v, scale=scale, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    # A bf16 output is rounded once from float32 on both sides: at most
    # one bf16 ulp apart (2**-7 relative).
    rtol = TOL if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=TOL,
                               rtol=rtol)


@pytest.mark.cuda
def test_flash_entry_refuses_plans_it_cannot_launch(cuda_device,
                                                    monkeypatch):
    """The flash C entry takes the wrapper's plan and refuses rows or a
    shared-memory size unlike its instantiation's, in both dtypes, instead
    of launching a mismatched block; the launch counter stays put."""
    import repro_torch.kernels.flash_prefill as fp
    plan = fp.flash_plan
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 70, 4, 64), device=cuda_device).to(dtype)
        kv = torch.randn((1, 70, 2, 64), device=cuda_device).to(dtype)
        for bad in ({"smem_bytes": 16}, {"rows_per_block": 96}):
            monkeypatch.setattr(fp, "flash_plan",
                                lambda *a, bad=bad: {**plan(*a), **bad})
            before = flash_prefill_cuda.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                flash_prefill_cuda(q, kv, kv, scale=0.125)
            assert flash_prefill_cuda.launches == before
        monkeypatch.undo()
        got = flash_prefill_cuda(q, kv, kv, scale=0.125)
        want = flash_prefill_plain(q, kv, kv, scale=0.125)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=TOL,
                                   rtol=TOL if dtype == torch.float32
                                   else 2 ** -7)


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernels_and_count_them(cuda_device):
    q = torch.randn((2, 4, 16), device=cuda_device)
    pool = torch.randn((4, 8, 2, 16), device=cuda_device)
    ops.reset_counts()
    ops.paged_micro_attention(q, pool, pool,
                              torch.tensor([[0, 1], [2, -1]],
                                           device=cuda_device),
                              torch.tensor([8, 3], device=cuda_device))
    ops.paged_prefill_attention(q, pool, pool,
                                torch.tensor([3, -1], device=cuda_device),
                                torch.tensor(5, device=cuda_device))
    kv = pool[0, :2][None]                     # [1, 2, 2, 16]
    ops.flash_prefill(q[None], kv, kv, window=4)
    torch.cuda.synchronize()
    assert ops.counts() == {
        "paged_micro_attention": {"launches": 1, "plain_calls": 0},
        "paged_prefill_attention": {"launches": 1, "plain_calls": 0},
        "paged_micro_attention_ranks": {"launches": 0, "plain_calls": 0},
        "paged_prefill_attention_ranks": {"launches": 0, "plain_calls": 0},
        "flash_prefill": {"launches": 1, "plain_calls": 0}}


def _prefix_tables(rng, nblks, MB, bs):
    """Prefix-contiguous -1-padded tables [R, MB] over disjoint random
    blocks of a pool with sum(nblks) + 2 blocks; random tails."""
    perm = rng.permutation(sum(nblks) + 2)
    table = -np.ones((len(nblks), MB), np.int32)
    tail = np.full(len(nblks), bs, np.int32)
    used = 0
    for r, n in enumerate(nblks):
        table[r, :n] = perm[used:used + n]
        used += n
        if n:
            tail[r] = rng.integers(1, bs + 1)
    return table, tail


def _close_partials(got, want):
    """The contract's check, as in chip_smoke.py: finalized outputs and m
    within TOL, l within TOL relative, the same empty rows, no NaN."""
    from repro_torch.core.online_softmax import finalize
    (go, gm, gl), (wo, wm, wl) = got, want
    for t in got:
        assert not torch.isnan(t).any()
    assert torch.equal(torch.isneginf(gm), torch.isneginf(wm))
    fin = (finalize(go, gl) - finalize(wo, wl)).abs().max().item()
    finite = ~torch.isneginf(wm)
    m_err = (gm - wm)[finite].abs().max().item() if finite.any() else 0.0
    l_err = ((gl - wl).abs() / wl.abs().clamp_min(1e-30)).max().item()
    assert max(fin, m_err, l_err) <= TOL, (fin, m_err, l_err)
    empty = torch.isneginf(wm)
    assert float(go[empty].abs().sum()) == 0.0
    assert float(gl[empty].abs().sum()) == 0.0


def _pools(gen, NB, bs, K, D, dtype, device):
    return tuple(torch.randn((NB, bs, K, D), generator=gen,
                             device=device).to(dtype) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,G,D,bs,nblks,MB", [
    (8, 2, 128, 16, [250], 256),             # R=1 over ~4,000 tokens
    (8, 2, 128, 16, [0, 3, 250], 256),       # empty, shorter than a split
    (4, 2, 128, 16, [128, 128], 128),        # full tables: tail in last split
    (8, 1, 128, 8, [500, 37], 512),          # bs 8, G 1
    (1, 16, 128, 64, [64, 10], 64),          # bs 64, G 16
    (2, 16, 256, 16, [200, 0], 256),         # G 16 at D 256
    (2, 2, 120, 16, [250, 40], 256),         # D % 16 == 8: odd bf16 chunks
    (4, 2, 72, 16, [200], 256),              # D = 72
    (1, 4, 40, 8, [500], 512),               # D = 40, bs 8
])
def test_split_kv_decode_matches_plain(dtype, K, G, D, bs, nblks, MB,
                                       cuda_device):
    """The split-KV decode kernel == its plain twin over contexts long
    enough to split: empty tables, splits past a short request's tokens,
    a partial tail in the last split, bs 8 and 64, G 1, 2 and 16."""
    from repro_torch.kernels.micro_attn_decode import (decode_plan,
                                                       device_sm_count)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rng = np.random.default_rng(5)
    R, H = len(nblks), K * G
    table, tail = _prefix_tables(rng, nblks, MB, bs)
    pk, pv = _pools(gen, sum(nblks) + 2, bs, K, D, dtype, cuda_device)
    q = torch.randn((R, H, D), generator=gen, device=cuda_device).to(dtype)
    tb = torch.from_numpy(table).to(cuda_device)
    tl = torch.from_numpy(tail).to(cuda_device)
    plan = decode_plan(R, H, K, MB, bs,
                       device_sm_count(torch.cuda.current_device()))
    assert plan["nsplit"] > 1
    scale = D ** -0.5
    for _ in range(2):          # the ticket counters are reset for reuse
        got = paged_micro_attention_cuda(q, pk, pv, tb, tl, scale=scale)
        _close_partials(got, paged_micro_attention_plain(
            q, pk, pv, tb, tl, scale=scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,K,G,D,bs,nblk", [
    (37, 8, 2, 128, 16, 187),     # C*G = 74: not a multiple of 16 or 64
    (512, 8, 2, 128, 16, 190),    # the main shape, ~3,000-token prefix
    (50, 2, 2, 112, 8, 130),      # D = 112 in the 128-wide build
    (33, 2, 4, 256, 64, 20),      # D = 256, bs = 64
    (40, 4, 3, 64, 24, 70),       # bs 24 does not divide the 64-token tile
    (37, 8, 2, 128, 16, 0),       # empty table: (0, -inf, 0)
    (50, 2, 2, 120, 8, 130),      # D % 16 == 8: reduction padded to 128
    (45, 4, 3, 72, 16, 60),       # D = 72, padded to 80
    (40, 2, 4, 40, 24, 70),       # D = 40 in the 64-wide build, bs 24
])
def test_prefill_chunk_kernel_matches_plain(dtype, C, K, G, D, bs, nblk,
                                            cuda_device):
    """The prefill-chunk kernel (bf16: tensor cores, hi + lo
    probabilities, split prefix) == its float32 plain twin at 1e-4."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    rng = np.random.default_rng(6)
    H, MB = K * G, nblk + 3
    table, tail = _prefix_tables(rng, [nblk], MB, bs)
    pk, pv = _pools(gen, nblk + 2, bs, K, D, dtype, cuda_device)
    q = torch.randn((C, H, D), generator=gen, device=cuda_device).to(dtype)
    tb = torch.from_numpy(table[0]).to(cuda_device)
    tl = torch.tensor(int(tail[0]), dtype=torch.int32, device=cuda_device)
    scale = D ** -0.5
    for _ in range(2):
        got = paged_prefill_attention_cuda(q, pk, pv, tb, tl, scale=scale)
        _close_partials(got, paged_prefill_attention_plain(
            q, pk, pv, tb, tl, scale=scale))


@pytest.mark.cuda
def test_split_kernels_launch_once_per_call(cuda_device):
    """A split grid is still one launch per wrapper call."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    rng = np.random.default_rng(7)
    table, tail = _prefix_tables(rng, [250, 100], 256, 16)
    pk, pv = _pools(gen, 352, 16, 8, 128, torch.bfloat16, cuda_device)
    q = torch.randn((2, 16, 128), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    tb = torch.from_numpy(table).to(cuda_device)
    tl = torch.from_numpy(tail).to(cuda_device)
    ops.reset_counts()
    ops.paged_micro_attention(q, pk, pv, tb, tl)
    ops.paged_prefill_attention(q, pk, pv, tb[0], tl[0])
    torch.cuda.synchronize()
    c = ops.counts()
    assert c["paged_micro_attention"] == {"launches": 1, "plain_calls": 0}
    assert c["paged_prefill_attention"] == {"launches": 1, "plain_calls": 0}


@pytest.mark.cuda
def test_c_entries_refuse_plans_they_cannot_launch(cuda_device,
                                                   monkeypatch):
    """The C entries launch the wrappers' plans as given and refuse one
    they have no instantiation for or whose shared memory differs from
    the kernel's layout, instead of launching a mismatched grid."""
    import repro_torch.kernels.micro_attn_decode as dec
    import repro_torch.kernels.micro_attn_prefill as pre
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    rng = np.random.default_rng(8)
    table, tail = _prefix_tables(rng, [120, 30], 128, 16)
    pk, pv = _pools(gen, 152, 16, 8, 128, torch.bfloat16, cuda_device)
    q = torch.randn((2, 16, 128), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    tb = torch.from_numpy(table).to(cuda_device)
    tl = torch.from_numpy(tail).to(cuda_device)
    plan_p, plan_d = pre.prefill_plan, dec.decode_plan
    for bad in ({"smem_bytes": 16}, {"rows_per_block": 96}):
        monkeypatch.setattr(pre, "prefill_plan",
                            lambda *a, bad=bad: {**plan_p(*a), **bad})
        with pytest.raises(RuntimeError, match="launch failed"):
            paged_prefill_attention_cuda(q, pk, pv, tb[0], tl[0],
                                         scale=0.1)
    monkeypatch.setattr(dec, "decode_plan",
                        lambda *a: {**plan_d(*a), "heads_per_block": 3})
    with pytest.raises(RuntimeError, match="launch failed"):
        paged_micro_attention_cuda(q, pk, pv, tb, tl, scale=0.1)
    monkeypatch.undo()
    _close_partials(paged_micro_attention_cuda(q, pk, pv, tb, tl, scale=0.1),
                    paged_micro_attention_plain(q, pk, pv, tb, tl,
                                                scale=0.1))


# ------------------------------------------------------------------ #
# Rank forms: one launch over a stack of rank pools (the global pool)
# ------------------------------------------------------------------ #
def _global_pool(gen, NR, L, NB, bs, K, D, dtype, device):
    """A global pool pair [NR, L, NB, bs, K, D] (noise in every row)."""
    return tuple(torch.randn((NR, L, NB, bs, K, D), generator=gen,
                             device=device).to(dtype) for _ in range(2))


def _rank_tables(rng, NR, nblks, MB, bs, NB, empty):
    """Tables [NR, R, MB] and tails [NR, R]: each non-empty rank holds
    request r's ``nblks[r]`` blocks (prefix-contiguous, random ids)."""
    tables = -np.ones((NR, len(nblks), MB), np.int32)
    tails = np.full((NR, len(nblks)), bs, np.int32)
    for rank in range(NR):
        if rank in empty:
            continue
        perm, used = rng.permutation(NB), 0
        for r, n in enumerate(nblks):
            tables[rank, r, :n] = perm[used:used + n]
            used += n
            if n:
                tails[rank, r] = rng.integers(1, bs + 1)
    return tables, tails


def _no_copy_call(fn, view):
    """``fn()`` under the peak-memory counter: the call may allocate its
    outputs and scratch, never a copy of ``view``."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < \
        view.numel() * view.element_size()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NR,K,G,nblks,MB,empty", [
    (1, 4, 2, [5, 0, 9], 9, ()),           # one rank
    (3, 16, 1, [3, 7, 0, 2], 8, (1,)),     # MHA (G 1), an empty rank
    (3, 8, 2, [60, 4], 64, (0, 2)),        # split-KV, two empty ranks
    (4, 8, 2, [20, 61, 0, 5], 64, (3,)),   # four ranks, split-KV
    (4, 4, 2, [6, 6], 8, (0, 1, 2, 3)),    # every rank empty
])
def test_rank_kernels_match_plain_on_a_strided_layer_view(
        dtype, NR, K, G, nblks, MB, empty, cuda_device):
    """Both rank kernels == their plain twins on one layer's view of a
    global pool, ``gk[:, l]``: strided (rank stride L*NB*bs*K*D), read in
    place, one launch each; empty ranks give (0, -inf, 0)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    rng = np.random.default_rng(NR * 10 + G)
    L, NB, bs, D, H = 3, 160, 16, 128, K * G
    gk, gv = _global_pool(gen, NR, L, NB, bs, K, D, dtype, cuda_device)
    pk, pv = gk[:, 1], gv[:, 1]
    assert NR == 1 or not pk.is_contiguous()
    tables, tails = _rank_tables(rng, NR, nblks, MB, bs, NB, empty)
    tb = torch.from_numpy(tables).to(cuda_device)
    tl = torch.from_numpy(tails).to(cuda_device)
    q = torch.randn((len(nblks), H, D), generator=gen,
                    device=cuda_device).to(dtype)
    ops.reset_counts()
    got = _no_copy_call(lambda: ops.paged_micro_attention_ranks(
        q, pk, pv, tb, tl), pk)
    want = paged_micro_attention_ranks_plain(q, pk, pv, tb, tl,
                                             scale=D ** -0.5)
    assert got[0].shape == (NR, len(nblks), H, D)
    _close_partials(got, want)
    for rank in empty:
        assert bool(torch.isneginf(got[1][rank]).all())
    # Prefill chunk: request 0's table on each rank, 37 chunk queries.
    qc = torch.randn((37, H, D), generator=gen,
                     device=cuda_device).to(dtype)
    got = _no_copy_call(lambda: ops.paged_prefill_attention_ranks(
        qc, pk, pv, tb[:, 0], tl[:, 0]), pk)
    want = paged_prefill_attention_ranks_plain(qc, pk, pv, tb[:, 0],
                                               tl[:, 0], scale=D ** -0.5)
    assert got[0].shape == (NR, 37, H, D)
    _close_partials(got, want)
    c = ops.counts()
    assert c["paged_micro_attention_ranks"] == {"launches": 1,
                                                "plain_calls": 0}
    assert c["paged_prefill_attention_ranks"] == {"launches": 1,
                                                  "plain_calls": 0}
    assert c["paged_micro_attention"]["launches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rank_kernels_equal_one_launch_per_rank(dtype, cuda_device):
    """At the qwen2-moe global path's shapes (MHA 16 x 128, three ranks,
    a 512-query chunk) a rank launch == NR single-rank launches, rank by
    rank, to 1e-4 (their split plans may differ)."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    rng = np.random.default_rng(12)
    NR, L, NB, bs, K, D = 3, 2, 160, 16, 16, 128
    gk, gv = _global_pool(gen, NR, L, NB, bs, K, D, dtype, cuda_device)
    pk, pv = gk[:, 1], gv[:, 1]
    tables, tails = _rank_tables(rng, NR, [63, 2, 30, 0], 64, bs, NB, (2,))
    tb = torch.from_numpy(tables).to(cuda_device)
    tl = torch.from_numpy(tails).to(cuda_device)
    q = torch.randn((4, K, D), generator=gen, device=cuda_device).to(dtype)
    qc = torch.randn((512, K, D), generator=gen,
                     device=cuda_device).to(dtype)
    s = D ** -0.5
    for rank_fn, one_fn, qq, t, tt in (
            (paged_micro_attention_ranks_cuda, paged_micro_attention_cuda,
             q, tb, tl),
            (paged_prefill_attention_ranks_cuda,
             paged_prefill_attention_cuda, qc, tb[:, 0], tl[:, 0])):
        got = rank_fn(qq, pk, pv, t, tt, scale=s)
        for rank in range(NR):
            one = one_fn(qq, pk[rank].contiguous(), pv[rank].contiguous(),
                         t[rank], tt[rank], scale=s)
            _close_partials(tuple(g[rank] for g in got), one)


@pytest.mark.cuda
def test_rank_entries_refuse_bad_plans_and_layouts(cuda_device,
                                                   monkeypatch):
    """The C entries refuse a rank plan they cannot launch (too few
    ticket counters for the rank grid, no instantiation), and the
    wrappers refuse a rank slab that is not contiguous."""
    import repro_torch.kernels.micro_attn_decode as dec
    import repro_torch.kernels.micro_attn_prefill as pre
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    rng = np.random.default_rng(13)
    NR, NB, bs, K, D = 3, 160, 16, 8, 128
    gk, gv = _global_pool(gen, NR, 2, NB, bs, K, D, torch.bfloat16,
                          cuda_device)
    pk, pv = gk[:, 0], gv[:, 0]
    tables, tails = _rank_tables(rng, NR, [60, 60], 64, bs, NB, ())
    tb = torch.from_numpy(tables).to(cuda_device)
    tl = torch.from_numpy(tails).to(cuda_device)
    q = torch.randn((2, 16, D), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    plan_d, plan_p = dec.decode_plan, pre.prefill_plan
    # A plan for one rank's work items: the rank grid needs NR times the
    # ticket counters it would be given.
    monkeypatch.setattr(dec, "decode_plan",
                        lambda *a: {**plan_d(*a), "items": 1})
    monkeypatch.setattr(dec, "_TICKETS", {})
    with pytest.raises(RuntimeError, match="launch failed"):
        paged_micro_attention_ranks_cuda(q, pk, pv, tb, tl, scale=0.1)
    monkeypatch.setattr(pre, "prefill_plan",
                        lambda *a: {**plan_p(*a), "rows_per_block": 96})
    with pytest.raises(RuntimeError, match="launch failed"):
        paged_prefill_attention_ranks_cuda(q, pk, pv, tb[:, 0], tl[:, 0],
                                           scale=0.1)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="contiguous"):
        paged_micro_attention_ranks_cuda(q, pk[:, :, :, ::2],
                                         pv[:, :, :, ::2], tb, tl,
                                         scale=0.1)
    with pytest.raises(ValueError, match="rank tables"):
        paged_micro_attention_ranks_cuda(q, pk, pv, tb[:2], tl[:2],
                                         scale=0.1)
    _close_partials(paged_micro_attention_ranks_cuda(q, pk, pv, tb, tl,
                                                     scale=0.1),
                    paged_micro_attention_ranks_plain(q, pk, pv, tb, tl,
                                                      scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_global_pool_serves_on_the_card(arch, cuda_device):
    """The cluster in global-pool mode on the card, float32 smoke width:
    the streams equal the per-instance cluster's and the dense oracle's,
    KV moves, the pool tensor is never reallocated, and only the rank
    kernels serve the pooled attention."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import decode_step, init_params
    from repro_torch.models.prefill import prefill
    from repro_torch.serving import (Cluster, Request, SamplingParams,
                                     ServingConfig)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 12)]
    streams = {}
    for gp in (False, True):
        ops.reset_counts()
        cl = Cluster(params, cfg, ServingConfig.smoke(
            n_instances=3, max_batch=2, pool_blocks=32, global_pool=gp))
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=10))
                for p in prompts]
        for r in reqs:
            cl.submit(r)
        cl.run_until_done(max_steps=400)
        assert all(r.done for r in reqs)
        streams[gp] = [r.output for r in reqs]
        assert sum(e.stats.pool_copy_steps for e in cl.engines.values()) == 0
        assert cl.throughput_stats["kv_moved_bytes"] > 0
    c = ops.counts()
    assert c["paged_micro_attention_ranks"]["launches"] > 0
    assert c["paged_prefill_attention_ranks"]["launches"] > 0
    assert c["paged_micro_attention"]["launches"] == 0
    assert all(v["plain_calls"] == 0 for v in c.values())
    assert streams[True] == streams[False]
    for p, out in zip(prompts, streams[True]):
        lg, st = prefill(params, cfg, torch.tensor([p], device=cuda_device),
                         max_len=len(p) + 12)
        ref = [int(lg[0].argmax())]
        for _ in range(9):
            lg, st = decode_step(params, cfg, st,
                                 torch.tensor([ref[-1]], device=cuda_device))
            ref.append(int(lg[0].argmax()))
        assert out == ref


# ------------------------------------------------------------------ #
# The memory hierarchy's shapes and transport on the card
# ------------------------------------------------------------------ #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,tail", [(1, 15), (128, 16)])
def test_warm_and_cow_chunks_match_plain(dtype, C, tail, cuda_device):
    """The chunks a cached admission launches: C = 1 (the COW path's
    re-run last token) over a ~3,000-token prefix whose last block holds
    bs - 1 rows, and C = 128 over a prefix ending at a block boundary (a
    warm admission's uncached tail), single-rank and in rank form (NR 3,
    one rank empty), each one launch, equal to the plain twins."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    rng = np.random.default_rng(C)
    K, G, D, bs, nblk = 8, 2, 128, 16, 188
    H, MB = K * G, 256
    table, _ = _prefix_tables(rng, [nblk], MB, bs)
    pk, pv = _pools(gen, nblk + 2, bs, K, D, dtype, cuda_device)
    q = torch.randn((C, H, D), generator=gen, device=cuda_device).to(dtype)
    tb = torch.from_numpy(table[0]).to(cuda_device)
    tl = torch.tensor(tail, dtype=torch.int32, device=cuda_device)
    scale = D ** -0.5
    ops.reset_counts()
    _close_partials(ops.paged_prefill_attention(q, pk, pv, tb, tl),
                    paged_prefill_attention_plain(q, pk, pv, tb, tl,
                                                  scale=scale))
    gk, gv = _global_pool(gen, 3, 2, 200, bs, K, D, dtype, cuda_device)
    tables, tails = _rank_tables(rng, 3, [nblk], MB, bs, 200, (1,))
    tails[:, 0] = np.where(tables[:, 0, 0] >= 0, tail, bs)
    rtb = torch.from_numpy(tables[:, 0]).to(cuda_device)
    rtl = torch.from_numpy(tails[:, 0]).to(cuda_device)
    got = ops.paged_prefill_attention_ranks(q, gk[:, 1], gv[:, 1], rtb, rtl)
    _close_partials(got, paged_prefill_attention_ranks_plain(
        q, gk[:, 1], gv[:, 1], rtb, rtl, scale=scale))
    assert bool(torch.isneginf(got[1][1]).all())
    c = ops.counts()
    assert c["paged_prefill_attention"] == {"launches": 1, "plain_calls": 0}
    assert c["paged_prefill_attention_ranks"] == {"launches": 1,
                                                  "plain_calls": 0}


@pytest.mark.cuda
def test_host_tier_spills_and_uploads_bf16_frames_byte_identical(
        cuda_device):
    """A bf16 block spilled through pinned memory on the tier's side
    stream and uploaded back into another block is byte-identical, even
    when the source block is overwritten right after the put (the
    gathered rows are the copy's source, ordered after the gather); the
    pool is written in place."""
    from repro_torch.serving.hosttier import HostKVTier
    from repro_torch.serving.kvpool import read_pool_rows, write_pool_rows
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    L, NB, bs, K, D = 4, 64, 16, 8, 128
    pool = torch.randn((L, NB, bs, K, D), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    ptr = pool.data_ptr()
    want = pool[:, 3].clone()
    tier = HostKVTier(4, verify=True)
    for key in range(6):                 # LRU keeps the newest 4
        k = read_pool_rows(pool, [3 + key], bs)
        assert tier.put(key, k, k)
        pool[:, 3 + key].zero_()          # the frame must not see this
    tier.drain(block=True)
    assert tier.used_blocks <= 4 and 5 in tier
    k_host, _ = tier._frames[5]
    assert k_host.is_pinned() and k_host.device.type == "cpu"
    pool[:, 3] = want
    k = read_pool_rows(pool, [3], bs)
    assert tier.put("again", k, k)
    fk, fv = tier.get("again")           # finalizes (maybe a stall)
    write_pool_rows(pool, [40], fk.to(cuda_device, non_blocking=True), bs)
    torch.cuda.synchronize()
    assert torch.equal(pool[:, 40].view(torch.int16),
                       want.view(torch.int16))
    assert torch.equal(fv.view(torch.int16), want.view(torch.int16).cpu())
    assert pool.data_ptr() == ptr
    assert tier.stats.corruptions == 0


@pytest.mark.cuda
@pytest.mark.parametrize("global_pool", [False, True],
                         ids=["per-instance", "global-pool"])
def test_cached_serving_on_the_card_allocates_nothing_pool_sized(
        global_pool, cuda_device):
    """bf16 smoke serving with the prefix cache and a host tier on the
    card: replicas spill and come back, no step reallocates a pool and
    only the CUDA paged kernels run (a 9-block pool); and a warm
    admission allocates nothing pool-sized (a 4,096-block pool, so that
    a pool dwarfs the smoke model's activations)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import LLMServer, SamplingParams, ServingConfig
    cfg = get_smoke_config("olmo-1b")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, cfg.vocab_size, 24).tolist()
               for _ in range(3)]
    sp = SamplingParams(max_new_tokens=4)

    def server(pool_blocks):
        return LLMServer(params, cfg, ServingConfig.smoke(
            n_instances=1, max_batch=1, max_local_len=64,
            pool_blocks=pool_blocks, block_size=8, prefill_chunk=8,
            prefix_cache=True, host_tier_blocks=64,
            global_pool=global_pool))

    small = server(9)
    eng = small.cluster.engines[0]
    ptr = eng.pool_k.data_ptr()
    ops.reset_counts()
    for p in prompts + prompts:
        small.submit(p, sp).result()
    m = small.metrics
    assert m["host_spill_bytes"] > 0 and m["host_prefetch_bytes"] > 0
    assert m["cache_hit_tokens"] > 0
    assert eng.pool_k.data_ptr() == ptr
    assert eng.stats.pool_copy_steps == 0
    c = ops.counts()
    assert all(v["plain_calls"] == 0 for v in c.values())
    suffix = "_ranks" if global_pool else ""
    assert c["paged_prefill_attention" + suffix]["launches"] > 0
    assert c["paged_micro_attention" + suffix]["launches"] > 0

    big = server(4096)
    eng = big.cluster.engines[0]
    big.submit(prompts[0], sp).result()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    h = big.submit(prompts[0][:20] + [1, 2, 3], sp)   # warm: 16 cached
    big.step()
    torch.cuda.synchronize()
    assert h._req.output, "the warm request was not admitted"
    assert big.metrics["cache_hit_tokens"] == 16
    pool_bytes = eng.pool_k.numel() * eng.pool_k.element_size()
    assert torch.cuda.max_memory_allocated() - base < pool_bytes
    h.result()


# ------------------------------------------------------------------ #
# Fault recovery and the ssm family on the card
# ------------------------------------------------------------------ #
def _greedy_oracle(params, cfg, prompt, n_new, device):
    from repro_torch.models.model import decode_step
    from repro_torch.models.prefill import prefill
    lg, st = prefill(params, cfg, torch.tensor([prompt], device=device),
                     max_len=len(prompt) + n_new + 2)
    out = [int(lg[0].argmax())]
    for _ in range(n_new - 1):
        lg, st = decode_step(params, cfg, st,
                             torch.tensor([out[-1]], device=device))
        out.append(int(lg[0].argmax()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("global_pool", [False, True],
                         ids=["per-instance", "global-pool"])
def test_creditor_crash_replays_on_the_card(global_pool, cuda_device):
    """float32 smoke width: a creditor of a spanning request crashes
    mid-decode; the request replays to the dense oracle's stream through
    the CUDA paged kernels only (the replay's re-prefill and the decode
    after it), every allocator drains and no pool is reallocated."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import (Cluster, FaultPolicy, Request,
                                     SamplingParams, ServingConfig)
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0), cuda_device)
    prompt = np.random.default_rng(90).integers(0, cfg.vocab_size,
                                                40).tolist()
    cl = Cluster(params, cfg, ServingConfig.smoke(
        n_instances=3, max_batch=2, pool_blocks=32, global_pool=global_pool,
        faults=FaultPolicy(max_transfer_retries=2)))
    ptr = (cl.gpool.k if global_pool else cl.engines[0].pool_k).data_ptr()
    req = Request(prompt=prompt, sampling=SamplingParams(max_new_tokens=12))
    cl.submit(req)
    while len(req.output) < 4:
        cl.step()
    victim = next(i for i, e in cl.engines.items()
                  if e.rmanager.is_hosting(req.req_id))
    ops.reset_counts()
    cl.kill_instance(victim)
    cl.run_until_done(max_steps=300)
    assert req.output == _greedy_oracle(params, cfg, prompt, 12, cuda_device)
    assert req.replays == 1 and victim in cl._dead
    c = ops.counts()
    suffix = "_ranks" if global_pool else ""
    assert c["paged_prefill_attention" + suffix]["launches"] > 0
    assert c["paged_micro_attention" + suffix]["launches"] > 0
    assert all(v["plain_calls"] == 0 for v in c.values())
    for _ in range(2):
        cl.step()
    for e in cl.engines.values():
        assert e.rmanager.pool.alloc.used_count == 0
        assert e.rmanager.pool.alloc.reserved == 0
    assert (cl.gpool.k if global_pool else cl.engines[0].pool_k) \
        .data_ptr() == ptr


@pytest.mark.cuda
def test_xlstm_steps_on_the_card_match_the_cpu(cuda_device):
    """float32 xLSTM smoke: prefill and decode steps on the card equal
    the same weights' steps on the CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import decode_step, init_params
    from repro_torch.models.prefill import prefill
    cfg = dataclasses.replace(get_smoke_config("xlstm-350m", layers=16),
                              dtype="float32")
    cpu = init_params(cfg, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)
    gpu = to(cpu, cuda_device)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20))
    out = {}
    for dev, params in (("cpu", cpu), (cuda_device, gpu)):
        t = torch.from_numpy(toks).to(dev)
        lg, st = prefill(params, cfg, t[:, :12], max_len=24)
        logits = [lg]
        for i in range(12, 20):
            lg, st = decode_step(params, cfg, st, t[:, i])
            logits.append(lg)
        out[str(dev)] = [x.cpu() for x in logits] + \
            [x.cpu() for x in st.rec["mlstm"]] + \
            [x.cpu() for x in st.rec["slstm"]]
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        scale = float(a.abs().max().clamp_min(1e-6))
        assert float((a - b).abs().max()) <= 1e-4 * scale


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.fixture
def no_tf32():
    """float32 products in float32 (not TF32) for a card-vs-CPU check."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.cuda
def test_bf16_train_steps_at_full_width_are_finite(cuda_device):
    """qwen3-0.6b at full width, 2 layers, bf16, through the trainer:
    finite losses and gradient norms, and no kernel of the port runs
    (training uses the plain attention core, as JAX does)."""
    from repro_torch.launch import train
    ops.reset_counts()
    recs = train.run("qwen3-0.6b", steps=3, seq=512, batch=2, layers=2,
                     device=cuda_device, log=None)
    assert len(recs) == 3
    for r in recs:
        assert np.isfinite([r["loss"], r["grad_norm"], r["lr"]]).all()
    assert not any(c["launches"] or c["plain_calls"]
                   for c in ops.counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw,tkw", [
    ("qwen3-0.6b", {}, {}),
    ("qwen2-moe-a2.7b", {}, {"moe_ep_groups": 2}),
    ("recurrentgemma-9b", {"layers": 3}, {}),
])
def test_float32_train_step_on_the_card_matches_the_cpu(
        cuda_device, no_tf32, arch, kw, tkw):
    """One float32 train step of the same smoke weights on the card and
    on the CPU: loss and gradient norm within 1e-5 relative, each
    gradient within 1e-4 of its largest magnitude."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.train_step import TrainConfig, loss_and_grads
    from repro_torch.training.tree import tree_leaves
    cfg = dataclasses.replace(get_smoke_config(arch, **kw), dtype="float32")
    cpu = init_params(cfg, device="cpu")
    toks, mask = batch_for_step(DataConfig(cfg.vocab_size, 48, 2, 3), 0)
    res = {}
    for dev, params in (("cpu", cpu), ("cuda", _tree_to(cpu, cuda_device))):
        loss, _, grads = loss_and_grads(
            params, cfg, torch.from_numpy(toks).to(dev),
            torch.from_numpy(mask).to(dev), TrainConfig(**tkw))
        res[dev] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)])
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-5,
                               atol=0)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        scale = float(b.abs().max().clamp_min(1e-12))
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("cf,T", [(-1.0, 8), (1.25, 16), (0.5, 24)])
def test_grouped_moe_on_the_card_matches_the_cpu(cuda_device, no_tf32,
                                                 cf, T):
    """``apply_moe(..., ep_groups=4)`` in float32 on the card equals the
    grouped path on the CPU, with and without drops."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params, layer_params
    from repro_torch.models.moe import apply_moe
    cfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                              dtype="float32")
    lp = layer_params(init_params(cfg, device="cpu")["moe_layers"]["moe"], 0)
    x = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32))
    want = apply_moe(lp, x, cfg, cf, ep_groups=4)
    got = apply_moe(_tree_to(lp, cuda_device), x.to(cuda_device), cfg, cf,
                    ep_groups=4).cpu()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


# ------------------------------------------------------------------ #
# The ServeLayout steps' shapes: the decode kernel at block size 128
# ------------------------------------------------------------------ #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NR,nblks,MB,H,K", [
    (1, [1024], 1025, 16, 8),   # long_500k: one shard's 1,024 blocks
    (4, [64, 3], 65, 16, 8),    # a batch of two over four shards
    (2, [0, 40, 7], 48, 16, 8),  # an empty request, short ones
    (2, [2, 1], 4, 16, 16),     # the mesh job's slab, MHA (G = 1)
    (1, [0, 2], 4, 8, 8),       # its half over a TP axis of 2 (G = 1)
])
def test_decode_kernels_at_block_size_128_match_plain(dtype, NR, nblks, MB,
                                                      H, K, cuda_device):
    """The decode kernel and its rank form at the launch cells' block size
    (128 tokens), on a strided layer view of a [NR, L, NB, 128, K, D]
    pool (qwen3's GQA 16/8 x 128, and MHA), against their plain twins."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    rng = np.random.default_rng(len(nblks) * 10 + NR)
    L, bs, D = 2, 128, 128
    NB = sum(nblks) + 2
    gk, gv = _global_pool(gen, NR, L, NB, bs, K, D, dtype, cuda_device)
    pk, pv = gk[:, 1], gv[:, 1]
    tables, tails = _rank_tables(rng, NR, nblks, MB, bs, NB, ())
    tb = torch.from_numpy(tables).to(cuda_device)
    tl = torch.from_numpy(tails).to(cuda_device)
    q = torch.randn((len(nblks), H, D), generator=gen,
                    device=cuda_device).to(dtype)
    scale = D ** -0.5
    ops.reset_counts()
    got = ops.paged_micro_attention_ranks(q, pk, pv, tb, tl)
    _close_partials(got, paged_micro_attention_ranks_plain(
        q, pk, pv, tb, tl, scale=scale))
    got = ops.paged_micro_attention(q, pk[0], pv[0], tb[0], tl[0])
    _close_partials(got, paged_micro_attention_plain(
        q, pk[0], pv[0], tb[0], tl[0], scale=scale))
    c = ops.counts()
    assert c["paged_micro_attention_ranks"] == {"launches": 1,
                                                "plain_calls": 0}
    assert c["paged_micro_attention"] == {"launches": 1, "plain_calls": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_serve_steps_on_the_card_match_the_cpu(arch, cuda_device, no_tf32):
    """``serve_prefill_step`` (full and partial last blocks) and both
    decode schedules at float32 smoke width, on the card (flash prefill,
    one decode rank launch a layer) against the same steps on the CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.models.prefill import prefill
    from repro_torch.serving import sharded_step as ss
    from test_torch_serve_layout import adversarial_pool
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dev_params = _tree_to(params, cuda_device)
    layout = ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    rng = np.random.default_rng(21)
    for S in (32, 30):
        toks = rng.integers(0, cfg.vocab_size, (2, S))
        ops.reset_counts()
        got = ss.serve_prefill_step(dev_params, cfg, layout, toks,
                                    block_size=8, NP=4, n_data=2)
        assert ops.counts()["flash_prefill"] == {
            "launches": cfg.num_layers, "plain_calls": 0}
        want = ss.serve_prefill_step(params, cfg, layout, toks,
                                     block_size=8, NP=4, n_data=2)
        assert torch.equal(got[0].cpu(), want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       atol=TOL, rtol=TOL)
    hist = rng.integers(0, cfg.vocab_size, (4, 21))
    _, st = prefill(params, cfg, torch.from_numpy(hist), max_len=25)
    inp = adversarial_pool(st.kv_k.numpy(), st.kv_v.numpy(), 21, 8, 4)
    tokens = rng.integers(0, cfg.vocab_size, 4)
    lens = np.full(4, 21)
    for step, tails in ((ss.serve_decode_step, inp["tails_new"]),
                        (ss.serve_decode_step_opt, inp["tails"])):
        out = {}
        for dev, p in (("cpu", params), (cuda_device, dev_params)):
            ops.reset_counts()
            out[str(dev)] = step(
                p, cfg, layout, torch.from_numpy(inp["pool_k"]).to(dev),
                torch.from_numpy(inp["pool_v"]).to(dev), inp["tables"],
                inp["nblk"], tails, inp["wblk"], inp["woff"], tokens, lens,
                return_logits=True)
        c = ops.counts()["paged_micro_attention_ranks"]
        assert c == {"launches": cfg.num_layers, "plain_calls": 0}
        for g, w in zip(out[str(cuda_device)], out["cpu"]):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       atol=TOL, rtol=TOL)


# ------------------------------------------------------------------ #
# The paged prefill at block size 128: read as 64-token sub-blocks
# ------------------------------------------------------------------ #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tail", [1, 64, 65, 128])
def test_prefill_kernels_at_block_size_128_match_plain(dtype, tail,
                                                       cuda_device):
    """The prefill-chunk kernel and its rank form over a strided layer
    view of a [NR, L, NB, 128, K, D] pool (qwen3's GQA 16/8 x 128): the
    wrappers read it as 64-token sub-blocks of the same memory, and the
    partials equal the plain twins' over the 128-token blocks (a
    -1-padded table, an empty rank)."""
    from repro_torch.kernels.micro_attn_prefill import _checked
    gen = torch.Generator(device=cuda_device).manual_seed(tail)
    NR, L, NB, bs, K, H, D, C, MB = 3, 2, 9, 128, 8, 16, 128, 64, 5
    gk, gv = _global_pool(gen, NR, L, NB, bs, K, D, dtype, cuda_device)
    pk, pv = gk[:, 1], gv[:, 1]
    tb = torch.tensor([[4, 0, 2, -1, -1], [7, -1, -1, -1, -1],
                       [-1] * 5], dtype=torch.int32, device=cuda_device)
    tl = torch.full((NR,), tail, dtype=torch.int32, device=cuda_device)
    q = torch.randn((C, H, D), generator=gen, device=cuda_device).to(dtype)
    scale = D ** -0.5
    ops.reset_counts()
    got = ops.paged_prefill_attention_ranks(q, pk, pv, tb, tl)
    _close_partials(got, paged_prefill_attention_ranks_plain(
        q, pk, pv, tb, tl, scale=scale))
    for r in range(NR):
        got = ops.paged_prefill_attention(q, pk[r], pv[r], tb[r], tl[r])
        _close_partials(got, paged_prefill_attention_plain(
            q, pk[r], pv[r], tb[r], tl[r], scale=scale))
    c = ops.counts()
    assert c["paged_prefill_attention_ranks"] == {"launches": 1,
                                                  "plain_calls": 0}
    assert c["paged_prefill_attention"] == {"launches": NR,
                                            "plain_calls": 0}
    # The kernel reads the pool itself: views, never a copy.
    _, vk, vv, _, _ = _checked(q, pk, pv, tb, tl, ranked=True)
    assert vk.shape[-3] == 64 and vk.data_ptr() == pk.data_ptr() and \
        vv.data_ptr() == pv.data_ptr()


@pytest.mark.cuda
def test_prefill_kernel_refuses_a_block_without_a_sub_block(cuda_device):
    pool = torch.zeros((2, 67, 1, 8), device=cuda_device)
    q = torch.zeros((1, 1, 8), device=cuda_device)
    table = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="no divisor"):
        ops.paged_prefill_attention(q, pool, pool, table, 1)
