"""The port's CUDA kernels on the card, against their plain PyTorch twins.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they
carry the ``cuda`` marker and skip without one. The file imports no JAX,
so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 1e-4: kernel and twin compute in float32 from the same inputs
and differ in summation order (the paged kernels also in the order of
their in-launch merges); the bf16 prefill-chunk and decode kernels run
on tensor cores, where q K^T products of bf16 values are exact and each
probability enters P V as bf16 hi + lo, which keeps them within the same
1e-4. The bf16 flash-prefill
kernel runs on tensor cores under the same contract; its output is
rounded from float32 on both sides, so it may differ by one bf16 ulp.
The float32 flash-prefill and prefill-chunk kernels run on the tf32
tensor cores in 3xTF32 (each float32 product as three tf32 products of
the operands' hi and lo halves), held to the same 1e-4 as the float32
twins; the tests here also feed them inputs whose low 13 mantissa bits
matter, where one tf32 product would miss 1e-4.

Also the transports of the mesh paths on the card: the gloo probe
(``scripts/gloo_probe.py``: the port's reduce-scatter and ring shift of
CUDA tensors give the right values; gloo runs the reduce-scatter
directly, as the port does, and where it cannot run a send directly the
port stages it), and ``ring_attention_prefill`` in a one-process NCCL
group (no shift), equal to its run on host tensors.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels.micro_attn_decode import (
    paged_micro_attention_cuda, paged_micro_attention_plain,
    paged_micro_attention_ranks_cuda,
    paged_micro_attention_ranks_merged_cuda,
    paged_micro_attention_ranks_merged_plain,
    paged_micro_attention_ranks_plain)
from repro_torch.kernels.micro_attn_prefill import (
    paged_prefill_attention_cuda, paged_prefill_attention_plain,
    paged_prefill_attention_ranks_cuda,
    paged_prefill_attention_ranks_merged_cuda,
    paged_prefill_attention_ranks_merged_plain,
    paged_prefill_attention_ranks_plain)

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
    (1, 300, 8, 2, 40, 0),         # D = 40: zero-filled to 64
    (1, 300, 8, 2, 120, 100),      # D = 120: zero-filled to 128, windowed
    (1, 700, 16, 1, 128, 0),       # G = 16 at D = 128
    (1, 700, 32, 2, 256, 300),     # G = 16 at D = 256, windowed
    (1, 1037, 16, 1, 256, 100),    # window not a multiple of the tile
    (2, 777, 16, 1, 256, 200),     # B = 2 with a window
    (2, 4099, 16, 8, 128, 0),      # the persistent order over many items:
    (2, 4099, 16, 2, 128, 0),      # S 4,099 (a ragged last tile), B 2,
    (2, 4099, 16, 8, 64, 0),       # G 2 and 8, D 128 and 64
    (2, 4099, 16, 2, 64, 0),
    (1, 2000, 8, 2, 112, 0),       # D = 112: TMA zero-fills 112..127
    (1, 3001, 16, 1, 256, 1000),   # D = 256, window not tile-aligned
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
    """The flash C entry takes the wrapper's plan and refuses rows, a K/V
    tile, a ring depth, a block count or a shared-memory size unlike its
    instantiation's, in both dtypes, instead of launching a mismatched
    block; the launch counter stays put."""
    import repro_torch.kernels.flash_prefill as fp
    plan = fp.flash_plan
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 70, 4, 64), device=cuda_device).to(dtype)
        kv = torch.randn((1, 70, 2, 64), device=cuda_device).to(dtype)
        items = plan(1, 70, 4, 2, 64, dtype, sms)["items"]
        for bad in ({"smem_bytes": 16}, {"rows_per_block": 96},
                    {"kv_tile": 32}, {"stages": 5}, {"blocks": 0},
                    {"blocks": items + 1}):
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
@pytest.mark.parametrize("B,S,H,K,D,window", [(2, 1000, 16, 8, 128, 0),
                                              (1, 1500, 16, 1, 256, 300)])
def test_flash_prefill_graph_replay_matches_eager(B, S, H, K, D, window,
                                                  cuda_device):
    """A CUDA graph of the bf16 kernel (its tensor maps captured as launch
    parameters) replays to the eager output bit for bit, and after new
    values are copied into its inputs, to the eager output of those."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)

    def inputs():
        return [torch.randn(shape, generator=gen, device=cuda_device)
                .to(torch.bfloat16)
                for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]
    q, k, v = inputs()
    scale = D ** -0.5
    eager = flash_prefill_cuda(q, k, v, scale=scale, window=window)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_prefill_cuda(q, k, v, scale=scale, window=window)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_prefill_cuda(q, k, v, scale=scale, window=window)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for t, new in zip((q, k, v), inputs()):
        t.copy_(new)
    graph.replay()
    want = flash_prefill_cuda(q, k, v, scale=scale, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and not torch.equal(want, eager)


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
    once = {"launches": 1, "plain_calls": 0, "float32_launches": 1}
    none = {"launches": 0, "plain_calls": 0, "float32_launches": 0}
    assert ops.counts() == {
        "paged_micro_attention": once, "paged_prefill_attention": once,
        "paged_micro_attention_ranks": none,
        "paged_prefill_attention_ranks": none,
        "paged_micro_attention_ranks_merged": none,
        "paged_prefill_attention_ranks_merged": none,
        "flash_prefill": once}


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
    """The decode kernel (units of valid tokens planned on the card, a
    group's partials merged in the launch) == its plain twin over
    contexts long enough to split a group over blocks: empty tables, a
    request shorter than a unit, a partial tail in the last unit, bs 8
    and 64, G 1, 2 and 16."""
    from repro_torch.kernels import rank_units
    from repro_torch.kernels.micro_attn_decode import (decode_unit_plan,
                                                       device_sm_count)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rng = np.random.default_rng(5)
    R, H = len(nblks), K * G
    table, tail = _prefix_tables(rng, nblks, MB, bs)
    pk, pv = _pools(gen, sum(nblks) + 2, bs, K, D, dtype, cuda_device)
    q = torch.randn((R, H, D), generator=gen, device=cuda_device).to(dtype)
    tb = torch.from_numpy(table).to(cuda_device)
    tl = torch.from_numpy(tail).to(cuda_device)
    plan = decode_unit_plan(R, H, K, D, MB, bs, dtype,
                            device_sm_count(torch.cuda.current_device()))
    S = rank_units.pair_tokens(table[None], tail[None], bs)
    up = rank_units.unit_plan(S, plan["unit_tokens"], plan["head_groups"],
                              stacked=False)
    assert any(seg["parts"] > 1
               for seg in rank_units.all_segments(up, plan["blocks"]))
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
    """The prefill-chunk kernel (bf16: wgmma, hi + lo probabilities,
    units of the prefix planned on the card) == its float32 plain twin at
    1e-4."""
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
    """Units merged in the launch are still one launch per wrapper
    call."""
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
    bf16_once = {"launches": 1, "plain_calls": 0, "float32_launches": 0}
    assert c["paged_micro_attention"] == bf16_once
    assert c["paged_prefill_attention"] == bf16_once


@pytest.mark.cuda
def test_c_entries_refuse_plans_they_cannot_launch(cuda_device,
                                                   monkeypatch):
    """The C entries launch the wrappers' plans as given and refuse one
    they have no instantiation for or whose shared memory, ring or
    ticket counters differ from the kernel's layout, instead of
    launching a mismatched grid; the launch counters stay put."""
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
    plan_p, plan_d = pre.prefill_unit_plan, dec.decode_unit_plan
    for bad in ({"smem_bytes": 16}, {"rows_per_block": 96}, {"stages": 5},
                {"kv_tile": 32}, {"blocks": 0}, {"groups": 1}):
        monkeypatch.setattr(pre, "prefill_unit_plan",
                            lambda *a, bad=bad: {**plan_p(*a), **bad})
        monkeypatch.setattr(dec, "_TICKETS", {})
        before = paged_prefill_attention_cuda.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            paged_prefill_attention_cuda(q, pk, pv, tb[0], tl[0],
                                         scale=0.1)
        assert paged_prefill_attention_cuda.launches == before
    for bad in ({"heads_per_block": 17}, {"smem_bytes": 16},
                {"unit_tokens": 100}, {"groups": 1}):
        monkeypatch.setattr(dec, "decode_unit_plan",
                            lambda *a, bad=bad: {**plan_d(*a), **bad})
        monkeypatch.setattr(dec, "_TICKETS", {})
        before = paged_micro_attention_cuda.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            paged_micro_attention_cuda(q, pk, pv, tb, tl, scale=0.1)
        assert paged_micro_attention_cuda.launches == before
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


def _rank_call_bytes(kind, q, pools, tables, stacked):
    """What a rank wrapper allocates: its float32 outputs (o, m, l) and
    the scratch its plan asks for (``rank_*_plan``: slots of rows of
    D + 4 floats)."""
    from repro_torch.kernels.micro_attn_decode import (device_sm_count,
                                                       rank_decode_plan)
    from repro_torch.kernels.micro_attn_prefill import rank_prefill_plan
    NR, _, bs, K, D = pools.shape
    rows, H = q.shape[:2]
    sms = device_sm_count(q.device.index)
    MB = tables.shape[-1]
    if kind == "decode":
        plan = rank_decode_plan(rows, H, K, D, MB, bs, q.dtype, sms, NR,
                                stacked)
        slot_rows = plan["heads_per_block"]
    else:
        plan = rank_prefill_plan(rows, H, K, D, MB, bs, q.dtype, sms, NR,
                                 stacked)
        slot_rows = plan["rows_per_block"]
    outputs = (NR if stacked else 1) * rows * H * (D + 2) * 4
    return outputs + plan["ws_slots"] * slot_rows * (D + 4) * 4


def _no_copy_call(fn, view, planned):
    """``fn()`` under the peak-memory counter: the call allocates its
    outputs and scratch (``planned`` bytes, its ticket counters, and what
    the caching allocator adds: it hands out a cached block up to 1 MiB
    larger than asked, for each of the two large allocations) and nothing
    else, never a copy of ``view`` (at least 2.6 MB in these tests)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - planned
    assert extra < min(2 << 20, view.numel() * view.element_size()), extra
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
        q, pk, pv, tb, tl), pk, _rank_call_bytes("decode", q, pk, tb, True))
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
        qc, pk, pv, tb[:, 0], tl[:, 0]), pk,
        _rank_call_bytes("prefill", qc, pk, tb, True))
    want = paged_prefill_attention_ranks_plain(qc, pk, pv, tb[:, 0],
                                               tl[:, 0], scale=D ** -0.5)
    assert got[0].shape == (NR, 37, H, D)
    _close_partials(got, want)
    c = ops.counts()
    once = {"launches": 1, "plain_calls": 0,
            "float32_launches": int(dtype == torch.float32)}
    assert c["paged_micro_attention_ranks"] == once
    assert c["paged_prefill_attention_ranks"] == once
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NR,K,G,bs,nblks,MB,empty", [
    (1, 8, 2, 16, [250, 0, 9], 256, ()),      # one rank
    (4, 8, 2, 16, [60, 3, 0, 200], 256, ()),  # four ranks
    (3, 16, 1, 16, [63, 38, 0, 0], 256, (1,)),  # MHA, an empty rank
    (3, 4, 2, 16, [40, 7], 64, (0, 1, 2)),    # a process holding no block
    (2, 4, 2, 128, [64, 3], 65, (1,)),        # 128-token blocks
    (4, 8, 2, 8, [500, 37], 512, (2,)),       # bs 8: many units a request
], ids=["nr1", "nr4", "mha-empty", "no-block", "bs128", "bs8"])
def test_merged_and_stacked_rank_kernels_match_plain(
        dtype, NR, K, G, bs, nblks, MB, empty, cuda_device):
    """The rank kernels' merged entries == merge_partials of the stacked
    plain twin, and their stacked entries == the stacked twin, at one and
    four ranks, G 1 and 2, empty ranks, a process holding no block of
    the batch, bs 8 / 16 / 128 (decode; a 37-query chunk over request
    0's prefix for prefill), each one launch, twice (the ticket counters
    are reset for reuse)."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    rng = np.random.default_rng(NR * 100 + bs)
    L, D, H = 2, 128, K * G
    NB = max(nblks) * len(nblks) + 2
    gk, gv = _global_pool(gen, NR, L, NB, bs, K, D, dtype, cuda_device)
    pk, pv = gk[:, 1], gv[:, 1]
    tables, tails = _rank_tables(rng, NR, nblks, MB, bs, NB, empty)
    tb = torch.from_numpy(tables).to(cuda_device)
    tl = torch.from_numpy(tails).to(cuda_device)
    q = torch.randn((len(nblks), H, D), generator=gen,
                    device=cuda_device).to(dtype)
    qc = torch.randn((37, H, D), generator=gen,
                     device=cuda_device).to(dtype)
    s = D ** -0.5
    for stacked_fn, merged_fn, stacked_plain, merged_plain, qq, t, tt in (
            (paged_micro_attention_ranks_cuda,
             paged_micro_attention_ranks_merged_cuda,
             paged_micro_attention_ranks_plain,
             paged_micro_attention_ranks_merged_plain, q, tb, tl),
            (paged_prefill_attention_ranks_cuda,
             paged_prefill_attention_ranks_merged_cuda,
             paged_prefill_attention_ranks_plain,
             paged_prefill_attention_ranks_merged_plain, qc, tb[:, 0],
             tl[:, 0])):
        want = merged_plain(qq, pk, pv, t, tt, scale=s)
        want_st = stacked_plain(qq, pk, pv, t, tt, scale=s)
        before = (merged_fn.launches, stacked_fn.launches)
        for _ in range(2):
            got = merged_fn(qq, pk, pv, t, tt, scale=s)
            assert got[0].shape == want[0].shape
            _close_partials(got, want)
            _close_partials(stacked_fn(qq, pk, pv, t, tt, scale=s), want_st)
        assert (merged_fn.launches, stacked_fn.launches) == (
            before[0] + 2, before[1] + 2)
        if len(empty) == NR:
            assert bool(torch.isneginf(got[1]).all())


@pytest.mark.cuda
def test_rank_entries_refuse_bad_plans_and_layouts(cuda_device,
                                                   monkeypatch):
    """The C entries refuse a rank plan they cannot launch (too few
    ticket counters for the merge groups, no instantiation for its heads
    a block, no block, a shared memory size, unit, tile or ring unlike
    the kernel's), and the wrappers refuse a rank slab that is not
    contiguous."""
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
    plan_d, plan_p = dec.rank_decode_plan, pre.rank_prefill_plan
    # One ticket counter for all the merge groups; no instantiation.
    for bad in ({"groups": 1}, {"heads_per_block": 17},
                {"smem_bytes": 16}, {"unit_tokens": 100}, {"blocks": 0}):
        monkeypatch.setattr(dec, "rank_decode_plan",
                            lambda *a, bad=bad: {**plan_d(*a), **bad})
        monkeypatch.setattr(dec, "_TICKETS", {})
        before = paged_micro_attention_ranks_cuda.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            paged_micro_attention_ranks_cuda(q, pk, pv, tb, tl, scale=0.1)
        assert paged_micro_attention_ranks_cuda.launches == before
    for bad in ({"groups": 1}, {"rows_per_block": 96}, {"smem_bytes": 16},
                {"kv_tile": 64}, {"stages": 5}):
        monkeypatch.setattr(pre, "rank_prefill_plan",
                            lambda *a, bad=bad: {**plan_p(*a), **bad})
        monkeypatch.setattr(dec, "_TICKETS", {})
        with pytest.raises(RuntimeError, match="launch failed"):
            paged_prefill_attention_ranks_cuda(q, pk, pv, tb[:, 0],
                                               tl[:, 0], scale=0.1)
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
    assert c["paged_micro_attention_ranks_merged"]["launches"] > 0
    assert c["paged_prefill_attention_ranks_merged"]["launches"] > 0
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
    once = {"launches": 1, "plain_calls": 0,
            "float32_launches": int(dtype == torch.float32)}
    assert c["paged_prefill_attention"] == once
    assert c["paged_prefill_attention_ranks"] == once


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
    suffix = "_ranks_merged" if global_pool else ""
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
    suffix = "_ranks_merged" if global_pool else ""
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
    once = {"launches": 1, "plain_calls": 0,
            "float32_launches": int(dtype == torch.float32)}
    assert c["paged_micro_attention_ranks"] == once
    assert c["paged_micro_attention"] == once


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
            "launches": cfg.num_layers, "plain_calls": 0,
            "float32_launches": cfg.num_layers}
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
        c = ops.counts()["paged_micro_attention_ranks_merged"]
        assert c == {"launches": cfg.num_layers, "plain_calls": 0,
                     "float32_launches": cfg.num_layers}
        for g, w in zip(out[str(cuda_device)], out["cpu"]):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       atol=TOL, rtol=TOL)


# ------------------------------------------------------------------ #
# The paged prefill at block size 128: read in place in both dtypes
# ------------------------------------------------------------------ #
class _LaunchSpy:
    """Wraps a kernel library's C entry: records each launch's positional
    arguments, then launches."""

    def __init__(self, lib, fn):
        self.lib, self.fn, self.calls = lib, fn, []

    def __getattr__(self, name):
        real = getattr(self.lib, name)
        if name != self.fn:
            return real

        def call(*args):
            self.calls.append(args)
            return real(*args)
        return call


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tail", [1, 64, 65, 128])
def test_prefill_kernels_at_block_size_128_match_plain(dtype, tail,
                                                       cuda_device,
                                                       monkeypatch):
    """The prefill-chunk kernel and its rank forms over a strided layer
    view of a [NR, L, NB, 128, K, D] pool (qwen3's GQA 16/8 x 128): all
    read the 128-token blocks in place, in both dtypes (TMA boxes of the
    pool's blocks), and the partials equal the plain twins' over the
    128-token blocks (a -1-padded table, an empty rank)."""
    import repro_torch.kernels.micro_attn_prefill as pre
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
    got = ops.paged_prefill_attention_ranks_merged(q, pk, pv, tb, tl)
    _close_partials(got, paged_prefill_attention_ranks_merged_plain(
        q, pk, pv, tb, tl, scale=scale))
    load = pre.build.load
    spies = []

    def spy_load(name, fn, argtypes):
        spies.append(_LaunchSpy(load(name, fn, argtypes), fn))
        return spies[-1]
    monkeypatch.setattr(pre.build, "load", spy_load)
    for r in range(NR):
        got = ops.paged_prefill_attention(q, pk[r], pv[r], tb[r], tl[r])
        _close_partials(got, paged_prefill_attention_plain(
            q, pk[r], pv[r], tb[r], tl[r], scale=scale))
    c = ops.counts()
    f32 = 1 if dtype == torch.float32 else 0
    assert c["paged_prefill_attention_ranks"] == {
        "launches": 1, "plain_calls": 0, "float32_launches": f32}
    assert c["paged_prefill_attention_ranks_merged"] == {
        "launches": 1, "plain_calls": 0, "float32_launches": f32}
    assert c["paged_prefill_attention"] == {
        "launches": NR, "plain_calls": 0, "float32_launches": NR * f32}
    # The single-rank kernel reads the pool itself: the C entry gets the
    # pool's own addresses and its 128-token block size, never a copy.
    calls = [a for sp in spies for a in sp.calls]
    assert len(calls) == NR
    for r, args in enumerate(calls):
        assert args[1] == pk[r].data_ptr() and args[2] == pv[r].data_ptr()
        assert args[14] == bs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [40, 64, 112, 128, 256])
@pytest.mark.parametrize("window", [0, 100])
def test_float32_flash_kernel_at_every_head_dim(D, window, cuda_device):
    """The 3xTF32 flash kernel at each instantiation's widths (D 40 and 64
    in the 64-wide build, 112 and 128 in the 128-wide, 256 with one
    consumer warpgroup), causal and windowed, over several query tiles
    and a ragged last one: within 1e-4 of the float32 twin."""
    gen = torch.Generator(device=cuda_device).manual_seed(D + window)
    B, S, H, K = 1, 517, 8, 2
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    ops.reset_counts()
    got = ops.flash_prefill(q, k, v, window=window)
    want = flash_prefill_plain(q, k, v, scale=D ** -0.5, window=window)
    assert ops.counts()["flash_prefill"] == {
        "launches": 1, "plain_calls": 0, "float32_launches": 1}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=0)


def _low_bits(x, pattern):
    """x with its low 13 mantissa bits set to ``pattern``: bits that a
    tf32 operand drops, so only their lo halves carry them."""
    return ((x.view(torch.int32) & ~0x1FFF) | pattern).view(torch.float32)


def _one_tf32_product(eq, a, b):
    """``einsum(eq, a, b)`` with both operands rounded to tf32 (10
    mantissa bits, to nearest): one tf32 product a float32 product."""
    def tf32(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
            torch.float32)
    return torch.einsum(eq, tf32(a), tf32(b))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [0x1FFF, 0x1000, 0x0FFF])
def test_float32_kernels_carry_the_low_mantissa_bits(pattern, cuda_device):
    """Inputs whose low 13 mantissa bits are all set, at the rounding
    midpoint or just below it (where rounding to nearest and truncating
    to tf32 differ most), and logits of standard deviation 2: the flash
    and prefill-chunk kernels stay within 1e-4 of the float32 twins,
    where one tf32 product a float32 product (emulated here on the card)
    misses 1e-4 on the same inputs. A kernel that dropped the lo halves
    fails this. It also pins the truncation the kernels rely on: they
    pass each raw float32 value as its tf32 hi half and x - trunc(x) as
    its lo half, which sum to x only if the tensor cores ignore the low
    13 bits; a rounding unit would move every operand with bits 0x1FFF
    or 0x1000 by a tf32 ulp."""
    gen = torch.Generator(device=cuda_device).manual_seed(pattern)
    S, H, K, D = 1000, 8, 2, 128
    q, k, v = (_low_bits(torch.randn(shape, generator=gen,
                                     device=cuda_device), pattern)
               for shape in ((1, S, H, D), (1, S, K, D), (1, S, K, D)))
    q = _low_bits(2 * q, pattern)
    scale = D ** -0.5
    got = ops.flash_prefill(q, k, v)
    want = flash_prefill_plain(q, k, v, scale=scale)
    assert (got - want).abs().max().item() <= TOL
    # One tf32 product (the plain twin's arithmetic otherwise).
    G = H // K
    s = _one_tf32_product("tkgd,skd->tkgs", q[0].reshape(S, K, G, D),
                          k[0]) * scale
    mask = torch.ones(S, S, dtype=torch.bool,
                      device=cuda_device).tril()[:, None, None, :]
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    one = _one_tf32_product("tkgs,skd->tkgd", p, v[0]).reshape(S, H, D)
    assert (one - want[0]).abs().max().item() > TOL
    # The prefill chunk over those keys as a paged pool (bs 16).
    bs = 16
    pk = k[0, :S // bs * bs].reshape(S // bs, bs, K, D).contiguous()
    pv = v[0, :S // bs * bs].reshape(S // bs, bs, K, D).contiguous()
    table = torch.arange(S // bs + 2, dtype=torch.int32,
                         device=cuda_device)
    table[S // bs:] = -1
    tail = torch.tensor(bs, dtype=torch.int32, device=cuda_device)
    qc = q[0, :128].contiguous()
    _close_partials(ops.paged_prefill_attention(qc, pk, pv, table, tail),
                    paged_prefill_attention_plain(qc, pk, pv, table, tail,
                                                  scale=scale))


@pytest.mark.cuda
def test_float32_prefill_kernel_empty_table(cuda_device):
    """An empty table gives (0, -inf, 0) in every row, from the 3xTF32
    kernel at each width."""
    for D in (64, 128, 256):
        pool = torch.randn((3, 16, 2, D), device=cuda_device)
        q = torch.randn((37, 4, D), device=cuda_device)
        table = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)
        o, m, l = ops.paged_prefill_attention(q, pool, pool, table, 5)
        assert bool((o == 0).all()) and bool(torch.isneginf(m).all())
        assert bool((l == 0).all())


@pytest.mark.cuda
def test_unit_kernels_refuse_blocks_off_the_swizzle_atom(cuda_device):
    """The single-rank kernels' TMA boxes start on 8-row swizzle atoms (8
    rows of 128 bytes: 64 bf16 or 32 float32 columns): a block size that
    is not a multiple of 8 raises ValueError naming the reason, in both
    dtypes (no ServingConfig has one); so does a block over 128 tokens."""
    for dtype in (torch.bfloat16, torch.float32):
        pool = torch.zeros((2, 12, 1, 8), device=cuda_device, dtype=dtype)
        q = torch.zeros((1, 1, 8), device=cuda_device, dtype=dtype)
        table = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError, match="multiple of 8"):
            ops.paged_prefill_attention(q, pool, pool, table, 1)
        with pytest.raises(ValueError, match="multiple of 8"):
            ops.paged_micro_attention(q, pool, pool, table[None], table + 1)
        big = torch.zeros((2, 136, 1, 8), device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError, match="exceeds 128"):
            ops.paged_prefill_attention(q, big, big, table, 1)


# ------------------------------------------------------------------ #
# The rank prefill on the Hopper prefill kernels (one kernel a dtype)
# ------------------------------------------------------------------ #
def _poisoned_rank_pools(gen, rng, NR, L, NB, bs, K, D, dtype, device,
                         nblks, empty, ones=()):
    """A layer's view of a global pool [NR, L, NB, bs, K, D] whose rows
    past each rank's tail and whose blocks no table names hold NaN and
    Inf, the same view with those rows zeroed, and the tables and tails:
    ``nblks[k]`` a number of blocks (one table a rank: tables [NR, MB],
    tails [NR]) or a list of one a request (tables [NR, R, MB], tails
    [NR, R]); rank k holds nothing if in ``empty``, and pair (k, r) in
    ``ones`` a one-token tail."""
    one_table = not isinstance(nblks[0], (list, tuple))
    rows = [[n] for n in nblks] if one_table else nblks
    R = len(rows[0])
    gk, gv = _global_pool(gen, NR, L, NB, bs, K, D, torch.float32, device)
    most = max(max(r) for r in rows)
    MB = most + 3
    tables = -np.ones((NR, R, MB), np.int32)
    tails = np.full((NR, R), bs, np.int32)
    for k in range(NR):
        if k in empty:
            continue
        perm, used = rng.permutation(NB), 0
        for r, n in enumerate(rows[k]):
            tables[k, r, :n] = perm[used:used + n]
            used += n
            # One table a rank draws a tail wherever any rank holds a
            # block (the draws of the tables it was first written for).
            if n or (one_table and most):
                tail = rng.integers(1, bs + 1)
                if n:
                    tails[k, r] = 1 if (k, r) in ones else tail
    valid = torch.zeros((NR, NB, bs), dtype=torch.bool)
    for k in range(NR):
        for r in range(R):
            n = int((tables[k, r] >= 0).sum())
            for j in range(n):
                valid[k, tables[k, r, j],
                      :tails[k, r] if j == n - 1 else bs] = True
    valid = valid.to(device)[..., None, None]
    poison = torch.full((NR, NB, bs, K, D), float("nan"), device=device)
    poison[:, :, ::2] = float("inf")
    l = L // 2
    out = []
    for g in (gk, gv):
        clean = torch.where(valid, g[:, l], 0.).to(dtype)
        g[:, l] = torch.where(valid, g[:, l], poison)
        out.append((g.to(dtype)[:, l], clean))
    (pk, ck), (pv, cv) = out
    if one_table:
        tables, tails = tables[:, 0], tails[:, 0]
    return (pk, pv, ck, cv, torch.from_numpy(tables).to(device),
            torch.from_numpy(tails).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NR,nblks,empty,bs,D,K,G", [
    (1, [40], (), 16, 128, 8, 2),            # the single-rank shape
    (2, [0, 90], (0,), 8, 64, 4, 1),         # MHA, bs 8, an empty rank
    (3, [5, 0, 3], (1,), 128, 256, 2, 12),   # D 256, G 12, 128-token blocks
    (4, [7, 30, 0, 12], (2,), 16, 128, 1, 12),  # MQA-like G 12, four ranks
    (4, [3, 11, 9, 1], (), 24, 64, 8, 2),    # bs 24: 8-token boxes
    (3, [0, 0, 0], (0, 1, 2), 16, 128, 8, 2),  # no rank holds a block
], ids=["nr1", "nr2-bs8-d64", "nr3-bs128-d256-g12", "nr4-g12",
        "nr4-bs24", "all-empty"])
def test_hopper_rank_prefill_matches_plain(dtype, NR, nblks, empty, bs, D,
                                           K, G, cuda_device):
    """The prefill kernels in rank form (``paged_prefill_wgmma_kernel``,
    ``paged_prefill_tf32_kernel``: one launch over every rank, the boxes
    from a 5-D map of the rank slabs) == the plain twins, stacked and
    merged, on a strided layer view of a global pool, at NR 1-4 with
    empty ranks, bs 8 / 16 / 24 / 128, D 64 / 128 / 256 and G 1 / 2 /
    12. The rows past each rank's tail and the blocks no table names
    hold NaN and Inf: a tile that ends one rank's prefix inside a block's
    run scores them -inf and zeroes their V rows before P V."""
    gen = torch.Generator(device=cuda_device).manual_seed(NR * 7 + bs)
    rng = np.random.default_rng(NR * 1000 + D + G)
    NB = max(max(nblks) * NR + 2, 4)
    pk, pv, ck, cv, tb, tl = _poisoned_rank_pools(
        gen, rng, NR, 3, NB, bs, K, D, dtype, cuda_device, nblks, empty)
    assert NR == 1 or not pk.is_contiguous()
    qc = torch.randn((77, K * G, D), generator=gen,
                     device=cuda_device).to(dtype)
    s = D ** -0.5
    before = (paged_prefill_attention_ranks_cuda.launches,
              paged_prefill_attention_ranks_merged_cuda.launches)
    got = paged_prefill_attention_ranks_cuda(qc, pk, pv, tb, tl, scale=s)
    _close_partials(got, paged_prefill_attention_ranks_plain(
        qc, ck, cv, tb, tl, scale=s))
    got = paged_prefill_attention_ranks_merged_cuda(qc, pk, pv, tb, tl,
                                                    scale=s)
    _close_partials(got, paged_prefill_attention_ranks_merged_plain(
        qc, ck, cv, tb, tl, scale=s))
    assert not any(bool(torch.isnan(x).any()) for x in got)
    if len(empty) == NR:
        assert bool(torch.isneginf(got[1]).all())
    assert (paged_prefill_attention_ranks_cuda.launches,
            paged_prefill_attention_ranks_merged_cuda.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_rank_prefill_float32_carries_the_low_mantissa_bits(cuda_device):
    """The float32 rank form over three ranks of a strided layer view,
    every input's low 13 mantissa bits 0x1FFF and logits of standard
    deviation 2: within 1e-4 of the float32 twins, merged and stacked
    (the lo halves of 3xTF32 carry those bits)."""
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    rng = np.random.default_rng(29)
    NR, L, NB, bs, K, D = 3, 2, 120, 16, 2, 128
    gk, gv = (_low_bits(g, 0x1FFF) for g in _global_pool(
        gen, NR, L, NB, bs, K, D, torch.float32, cuda_device))
    pk, pv = gk[:, 1], gv[:, 1]
    tables, tails = _rank_tables(rng, NR, [30], 40, bs, NB, ())
    tb = torch.from_numpy(tables[:, 0]).to(cuda_device)
    tl = torch.from_numpy(tails[:, 0]).to(cuda_device)
    q = _low_bits(2 * torch.randn((128, 8, D), generator=gen,
                                  device=cuda_device), 0x1FFF)
    s = D ** -0.5
    _close_partials(ops.paged_prefill_attention_ranks_merged(q, pk, pv, tb,
                                                             tl),
                    paged_prefill_attention_ranks_merged_plain(
                        q, pk, pv, tb, tl, scale=s))
    _close_partials(ops.paged_prefill_attention_ranks(q, pk, pv, tb, tl),
                    paged_prefill_attention_ranks_plain(q, pk, pv, tb, tl,
                                                        scale=s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rank_prefill_at_a_rank_stride_off_the_block_grid(dtype,
                                                          cuda_device):
    """Rank slabs whose stride is a multiple of 16 bytes but not of a
    block (the 5-D map's rank stride, off every block boundary): both
    rank forms == the plain twins, read in place."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    rng = np.random.default_rng(31)
    NR, NB, bs, K, G, D = 3, 24, 16, 2, 4, 128
    slab = NB * bs * K * D
    step = slab + 16 * 4 // torch.tensor([], dtype=dtype).element_size()
    buf = torch.randn(NR * step, generator=gen,
                      device=cuda_device).to(dtype)
    pools = buf.as_strided((NR, NB, bs, K, D),
                           (step, bs * K * D, K * D, D, 1))
    tables, tails = _rank_tables(rng, NR, [20], 24, bs, NB, ())
    tb = torch.from_numpy(tables[:, 0]).to(cuda_device)
    tl = torch.from_numpy(tails[:, 0]).to(cuda_device)
    q = torch.randn((60, K * G, D), generator=gen,
                    device=cuda_device).to(dtype)
    s = D ** -0.5
    _close_partials(paged_prefill_attention_ranks_cuda(q, pools, pools, tb,
                                                       tl, scale=s),
                    paged_prefill_attention_ranks_plain(q, pools, pools, tb,
                                                        tl, scale=s))
    _close_partials(paged_prefill_attention_ranks_merged_cuda(
        q, pools, pools, tb, tl, scale=s),
        paged_prefill_attention_ranks_merged_plain(q, pools, pools, tb, tl,
                                                   scale=s))


@pytest.mark.cuda
def test_rank_prefill_refuses_strides_and_blocks_tma_cannot_address(
        cuda_device):
    """A rank stride that is not a multiple of 16 bytes (the 5-D map's
    rank stride) and a block size that is not a multiple of 8 (a box
    starts on an 8-row swizzle atom) raise ValueError in both rank forms
    and both dtypes; nothing launches."""
    for dtype in (torch.bfloat16, torch.float32):
        NR, NB, bs, K, D = 2, 4, 16, 2, 64
        slab = NB * bs * K * D
        step = slab + 1  # 2 or 4 bytes past a 16-byte multiple
        buf = torch.zeros(NR * step + slab, dtype=dtype, device=cuda_device)
        pools = buf.as_strided((NR, NB, bs, K, D),
                               (step, bs * K * D, K * D, D, 1))
        q = torch.zeros((3, 4, D), dtype=dtype, device=cuda_device)
        tb = torch.zeros((NR, 2), dtype=torch.int32, device=cuda_device)
        tl = torch.ones((NR,), dtype=torch.int32, device=cuda_device)
        odd = torch.zeros((NR, NB, 12, K, D), dtype=dtype,
                          device=cuda_device)
        before = (paged_prefill_attention_ranks_cuda.launches,
                  paged_prefill_attention_ranks_merged_cuda.launches)
        for fn in (paged_prefill_attention_ranks_cuda,
                   paged_prefill_attention_ranks_merged_cuda):
            with pytest.raises(ValueError, match="16-byte"):
                fn(q, pools, pools, tb, tl, scale=0.1)
            with pytest.raises(ValueError, match="multiple of 8"):
                fn(q, odd, odd, tb, tl, scale=0.1)
        assert (paged_prefill_attention_ranks_cuda.launches,
                paged_prefill_attention_ranks_merged_cuda.launches) == before


# ------------------------------------------------------------------ #
# The rank decode on the Hopper decode kernel (one kernel a dtype)
# ------------------------------------------------------------------ #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NR,nblks,empty,ones,bs,D,K,G", [
    (1, [[40, 3, 0]], (), ((0, 1),), 16, 128, 8, 2),  # the single-rank shape
    (2, [[0, 0], [90, 5]], (0,), ((1, 1),), 8, 64, 4, 1),  # MHA, bs 8
    (3, [[5, 1], [0, 0], [3, 2]], (1,), ((0, 1),), 128, 256, 2, 12),
    (4, [[7, 30], [30, 1], [0, 0], [12, 0]], (2,), ((1, 1),), 16, 128, 1,
     16),                                             # G 16, four ranks
    (4, [[3, 11], [11, 9], [9, 1], [1, 3]], (), ((2, 1), (3, 0)), 24, 64,
     8, 2),                                           # bs 24: 8-token boxes
    (3, [[0, 0], [0, 0], [0, 0]], (0, 1, 2), (), 16, 128, 8, 2),
], ids=["nr1", "nr2-bs8-d64-g1", "nr3-bs128-d256-g12", "nr4-g16",
        "nr4-bs24", "no-block"])
def test_hopper_rank_decode_matches_plain(dtype, NR, nblks, empty, ones, bs,
                                          D, K, G, cuda_device):
    """The decode kernel in rank form (``paged_decode_units_kernel``: one
    launch over every rank, the boxes from a 5-D map of the rank slabs)
    == the plain twins, stacked and merged, on a strided layer view of a
    global pool, at NR 1-4 with empty ranks, one-token tails, bs 8 / 16 /
    24 / 128, D 64 / 128 / 256 and G 1 / 2 / 12 / 16. The rows past each
    pair's tail and the blocks no table names hold NaN and Inf: a tile
    that ends a unit inside a segment (the segment going on to the next
    rank) scores them -inf and, on the tensor cores, zeroes their V rows
    before P V; a request with no valid token on any rank gives (0, -inf,
    0)."""
    gen = torch.Generator(device=cuda_device).manual_seed(NR * 7 + bs)
    rng = np.random.default_rng(NR * 1000 + D + G)
    R = len(nblks[0])
    NB = max(max(sum(r) for r in nblks) + 2, 4)
    pk, pv, ck, cv, tb, tl = _poisoned_rank_pools(
        gen, rng, NR, 3, NB, bs, K, D, dtype, cuda_device, nblks, empty,
        ones)
    assert NR == 1 or not pk.is_contiguous()
    q = torch.randn((R, K * G, D), generator=gen,
                    device=cuda_device).to(dtype)
    s = D ** -0.5
    before = (paged_micro_attention_ranks_cuda.launches,
              paged_micro_attention_ranks_merged_cuda.launches)
    got = paged_micro_attention_ranks_cuda(q, pk, pv, tb, tl, scale=s)
    assert got[0].shape == (NR, R, K * G, D)
    _close_partials(got, paged_micro_attention_ranks_plain(
        q, ck, cv, tb, tl, scale=s))
    got = paged_micro_attention_ranks_merged_cuda(q, pk, pv, tb, tl,
                                                  scale=s)
    assert got[0].shape == (R, K * G, D)
    want = paged_micro_attention_ranks_merged_plain(q, ck, cv, tb, tl,
                                                    scale=s)
    _close_partials(got, want)
    assert not any(bool(torch.isnan(x).any()) for x in got)
    empty_rows = [r for r in range(R) if not (tb[:, r] >= 0).any()]
    for r in empty_rows:
        assert bool(torch.isneginf(got[1][r]).all())
    assert (paged_micro_attention_ranks_cuda.launches,
            paged_micro_attention_ranks_merged_cuda.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rank_decode_at_a_rank_stride_off_the_block_grid(dtype,
                                                         cuda_device):
    """Rank slabs whose stride is a multiple of 16 bytes but not of a
    block (the 5-D map's rank stride, off every block boundary): both
    rank decode forms == the plain twins, read in place."""
    gen = torch.Generator(device=cuda_device).manual_seed(37)
    rng = np.random.default_rng(37)
    NR, NB, bs, K, G, D = 3, 48, 16, 2, 4, 128
    slab = NB * bs * K * D
    step = slab + 16 * 4 // torch.tensor([], dtype=dtype).element_size()
    buf = torch.randn(NR * step, generator=gen,
                      device=cuda_device).to(dtype)
    pools = buf.as_strided((NR, NB, bs, K, D),
                           (step, bs * K * D, K * D, D, 1))
    tables, tails = _rank_tables(rng, NR, [20, 3, 17], 24, bs, NB, ())
    tb = torch.from_numpy(tables).to(cuda_device)
    tl = torch.from_numpy(tails).to(cuda_device)
    q = torch.randn((3, K * G, D), generator=gen,
                    device=cuda_device).to(dtype)
    s = D ** -0.5
    _close_partials(paged_micro_attention_ranks_cuda(q, pools, pools, tb,
                                                     tl, scale=s),
                    paged_micro_attention_ranks_plain(q, pools, pools, tb,
                                                      tl, scale=s))
    _close_partials(paged_micro_attention_ranks_merged_cuda(
        q, pools, pools, tb, tl, scale=s),
        paged_micro_attention_ranks_merged_plain(q, pools, pools, tb, tl,
                                                 scale=s))


@pytest.mark.cuda
def test_rank_decode_refuses_strides_and_blocks_tma_cannot_address(
        cuda_device):
    """A rank stride that is not a multiple of 16 bytes (the 5-D map's
    rank stride) and a block size that is not a multiple of 8 (a box
    starts on an 8-row swizzle atom) raise ValueError in both rank decode
    forms and both dtypes; nothing launches."""
    for dtype in (torch.bfloat16, torch.float32):
        NR, NB, bs, K, D = 2, 4, 16, 2, 64
        slab = NB * bs * K * D
        step = slab + 1  # 2 or 4 bytes past a 16-byte multiple
        buf = torch.zeros(NR * step + slab, dtype=dtype, device=cuda_device)
        pools = buf.as_strided((NR, NB, bs, K, D),
                               (step, bs * K * D, K * D, D, 1))
        q = torch.zeros((3, 4, D), dtype=dtype, device=cuda_device)
        tb = torch.zeros((NR, 3, 2), dtype=torch.int32, device=cuda_device)
        tl = torch.ones((NR, 3), dtype=torch.int32, device=cuda_device)
        odd = torch.zeros((NR, NB, 12, K, D), dtype=dtype,
                          device=cuda_device)
        before = (paged_micro_attention_ranks_cuda.launches,
                  paged_micro_attention_ranks_merged_cuda.launches)
        for fn in (paged_micro_attention_ranks_cuda,
                   paged_micro_attention_ranks_merged_cuda):
            with pytest.raises(ValueError, match="16-byte"):
                fn(q, pools, pools, tb, tl, scale=0.1)
            with pytest.raises(ValueError, match="multiple of 8"):
                fn(q, odd, odd, tb, tl, scale=0.1)
        assert (paged_micro_attention_ranks_cuda.launches,
                paged_micro_attention_ranks_merged_cuda.launches) == before


# ------------------------------------------------------------------ #
# The single-rank paged kernels: graph replay and poisoned pools
# ------------------------------------------------------------------ #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_graph_replay_matches_eager(dtype, cuda_device):
    """CUDA graphs of the decode and prefill-chunk kernels (their tensor
    maps captured as launch parameters) replay to the eager outputs bit
    for bit twice over (so the ticket counters are back at 0 after each
    launch), and after new values are copied into q, to the eager
    outputs of those."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    rng = np.random.default_rng(21)
    K, G, D, bs = 8, 2, 128, 16
    table, tail = _prefix_tables(rng, [250, 3, 100], 256, bs)
    pk, pv = _pools(gen, 355, bs, K, D, dtype, cuda_device)
    tb = torch.from_numpy(table).to(cuda_device)
    tl = torch.from_numpy(tail).to(cuda_device)
    qd = torch.randn((3, K * G, D), generator=gen,
                     device=cuda_device).to(dtype)
    qp = torch.randn((300, K * G, D), generator=gen,
                     device=cuda_device).to(dtype)

    def step():
        return (paged_micro_attention_cuda(qd, pk, pv, tb, tl, scale=0.1),
                paged_prefill_attention_cuda(qp, pk, pv, tb[0], tl[0],
                                             scale=0.1))
    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(out, eager):
            assert all(torch.equal(a, b) for a, b in zip(g, w))
    qd.copy_(torch.randn(qd.shape, generator=gen, device=cuda_device))
    qp.copy_(torch.randn(qp.shape, generator=gen, device=cuda_device))
    graph.replay()
    want = step()
    torch.cuda.synchronize()
    for g, w in zip(out, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [16, 24, 128])
def test_paged_kernels_ignore_poisoned_rows(dtype, bs, cuda_device):
    """Pool rows past each tail and blocks no table names hold NaN and
    Inf: the decode and prefill-chunk kernels give the plain twins'
    results over a copy of the pool with those rows zeroed, and nothing
    is NaN (a token past the valid ones scores -inf by a select and its
    V row never reaches a product)."""
    gen = torch.Generator(device=cuda_device).manual_seed(bs)
    rng = np.random.default_rng(bs)
    K, G, D = 4, 4, 128
    nblks = [30, 1, 0, 17]
    NB = sum(nblks) + 6
    table, tail = _prefix_tables(rng, nblks, 34, bs)
    tail[1] = 1
    pk, pv = _pools(gen, NB, bs, K, D, dtype, cuda_device)
    valid = torch.zeros((NB, bs), dtype=torch.bool)
    for r, n in enumerate(nblks):
        for j in range(n):
            valid[table[r, j], :tail[r] if j == n - 1 else bs] = True
    valid = valid.to(cuda_device)[..., None, None]
    poison = torch.full((NB, bs, K, D), float("nan"), device=cuda_device)
    poison[:, ::2] = float("inf")
    poison[:, 1::3] = -float("inf")
    bad_k = torch.where(valid, pk.float(), poison).to(dtype)
    bad_v = torch.where(valid, pv.float(), poison).to(dtype)
    clean_k = torch.where(valid, pk.float(), 0.).to(dtype)
    clean_v = torch.where(valid, pv.float(), 0.).to(dtype)
    tb = torch.from_numpy(table).to(cuda_device)
    tl = torch.from_numpy(tail).to(cuda_device)
    q = torch.randn((4, K * G, D), generator=gen,
                    device=cuda_device).to(dtype)
    qc = torch.randn((77, K * G, D), generator=gen,
                     device=cuda_device).to(dtype)
    scale = D ** -0.5
    got = paged_micro_attention_cuda(q, bad_k, bad_v, tb, tl, scale=scale)
    _close_partials(got, paged_micro_attention_plain(
        q, clean_k, clean_v, tb, tl, scale=scale))
    for r in range(len(nblks)):
        got = paged_prefill_attention_cuda(qc, bad_k, bad_v, tb[r], tl[r],
                                           scale=scale)
        _close_partials(got, paged_prefill_attention_plain(
            qc, clean_k, clean_v, tb[r], tl[r], scale=scale))


@pytest.mark.cuda
def test_gloo_probe_collectives_on_cuda_tensors(cuda_device, tmp_path):
    """The port's paths give the right values over gloo; gloo runs the
    reduce-scatter directly (the port relies on it), and a send it does
    not run directly is one the port stages."""
    import importlib.util
    import pathlib
    from repro_torch.distributed.mesh import host_staged
    path = pathlib.Path(__file__).parent.parent / "scripts" / "gloo_probe.py"
    spec = importlib.util.spec_from_file_location("gloo_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    got = probe.probe(workdir=str(tmp_path))
    assert set(got) == set(probe.OPS)
    for op, res in got.items():
        assert res["port"] == "ok", (op, res)
    assert got["reduce_scatter"]["direct"] == "ok", got
    assert got["send"]["direct"] == "ok" or host_staged("gloo", cuda_device)


def _nccl_ring_worker(rank, store, queue):
    import traceback
    import torch.distributed as dist
    try:
        from repro_torch.core.baselines import ring_attention_prefill
        from repro_torch.distributed.mesh import HostStaging
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=1)
        gen = torch.Generator().manual_seed(31)
        B, S, H, K, D = 2, 96, 8, 2, 64
        q = torch.randn((B, S, H, D), generator=gen)
        k, v = (torch.randn((B, S, K, D), generator=gen) for _ in range(2))
        pos = torch.arange(S).expand(B, S)
        valid = torch.ones((B, S), dtype=torch.bool)
        out, staging = {}, HostStaging()
        for dev in ("cpu", "cuda"):
            args = [t.to(dev) for t in (q, k, v, pos, pos, valid)]
            out[dev] = ring_attention_prefill(
                *args, dist.group.WORLD, staging=staging).cpu().numpy()
        queue.put((rank, {"backend": str(dist.get_backend()),
                          "copies": staging.copies, **out}))
        dist.destroy_process_group()
    except Exception:
        queue.put((rank, traceback.format_exc()))


@pytest.mark.cuda
def test_ring_attention_prefill_in_a_one_process_nccl_group(cuda_device,
                                                            tmp_path):
    """W = 1: no shift, nothing staged, the CUDA tensors' result equals
    the host tensors' within 1e-4."""
    from test_torch_collectives import Spawned
    got = Spawned(_nccl_ring_worker, 1, str(tmp_path)).results()[0]
    assert got["backend"] == "nccl" and got["copies"] == 0
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=TOL, atol=TOL)
