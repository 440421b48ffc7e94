"""The attention kernels' plain twins against the JAX package.

On the CPU the port's wrappers run the plain PyTorch twins of its CUDA
kernels; here they are held against the Pallas kernels in interpret mode
and against the JAX package's ``ref.py``, on the shape sweeps of its own
kernel tests (MHA, GQA, MQA, an unaligned head dim; the prefill chunk
sizes of its zero-copy tests; the flash-prefill sweep and its sliding
windows, plus a window longer than the prompt). Tolerances for the paged
kernels: float32 1e-4 everywhere. In bf16 the twins and the Pallas
kernels both upcast to float32, so they still agree to 1e-4; ``ref.py``
rounds q and the probabilities to bf16, so it is held at the JAX tests'
bf16 tolerance, 5e-2. Flash prefill keeps the JAX test's tolerances:
2e-5 in float32, 3e-2 in bf16 (its output is rounded to bf16).

The rank forms' plain twins (a stack of rank pools, one partial each —
the global pool's path) are held against the JAX package's
``paged_micro_attention_ranks`` / ``paged_prefill_attention_ranks`` (a
vmap over the rank axis) with ``backend="jnp"`` and with the Pallas
kernels in interpret mode, at 1e-5 in float32, on a strided per-layer
view of a global pool with an empty rank.

The design of the CUDA kernels is checked here before any run on the
card: the single-rank kernels' unit plans (``kernels/rank_units.py`` at
NR = 1), their TMA boxes and their merges, the flash-prefill plans, and
the bf16 precision contracts of the prefill-chunk and flash-prefill
kernels, emulated in plain PyTorch at their main shapes.

The kernels themselves need the card: ``tests/test_torch_cuda.py``
(no JAX, so it also runs on a machine without it) holds them against
these plain twins there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.attention import full_attention_decode as jax_full_decode
from repro.kernels import ref as jax_ref
from repro.kernels.ops import flash_prefill as jax_flash_prefill
from repro.kernels.ops import paged_micro_attention as jax_paged_decode
from repro.kernels.ops import paged_prefill_attention as jax_paged_prefill
from repro.kernels.ops import \
    paged_micro_attention_ranks as jax_paged_decode_ranks
from repro.kernels.ops import \
    paged_prefill_attention_ranks as jax_paged_prefill_ranks
from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import (_masked_softmax_parts, combine,
                                             finalize, merge_partials)
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_prefill import (MAX_HEAD_DIM,
                                               flash_block_items,
                                               flash_plan,
                                               flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels import rank_units
from repro_torch.kernels.micro_attn_decode import (
    decode_unit_plan, paged_micro_attention_cuda,
    paged_micro_attention_plain, paged_micro_attention_ranks_cuda,
    paged_micro_attention_ranks_plain, rank_decode_plan)
from repro_torch.kernels.micro_attn_prefill import (
    SMEM_PER_SM, paged_prefill_attention_cuda, paged_prefill_attention_plain,
    paged_prefill_attention_ranks_cuda, paged_prefill_attention_ranks_plain,
    prefill_unit_plan, rank_prefill_plan)

F32_TOL = 1e-4
JAX_REF_BF16_TOL = 5e-2
_NP_DT = {"float32": np.float32, "bfloat16": jnp.bfloat16}
_PT_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (CPU)."""
    a = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(_NP_DT[dtype])
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(_PT_DT[dtype])
    return j, t


def _tables(rng, R, NB, bs, MB):
    """Random -1-padded tables with variable block counts and tails
    (the generator of the JAX package's kernel tests)."""
    table = -np.ones((R, MB), np.int32)
    nblk = rng.integers(0, MB + 1, size=R)
    tail = np.ones((R,), np.int32)
    perm = rng.permutation(NB)
    used = 0
    for r in range(R):
        n = int(nblk[r])
        take = perm[used:used + n]
        if len(take) < n:
            n = len(take)
            nblk[r] = n
        table[r, :n] = take
        used += n
        tail[r] = rng.integers(1, bs + 1) if n else bs
    return table, nblk.astype(np.int32), tail


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("R,NB,bs,K,G,D,MB", [
    (4, 16, 16, 2, 2, 16, 4),
    (3, 32, 8, 1, 4, 32, 8),      # MQA
    (2, 8, 32, 4, 1, 112, 3),     # MHA, unaligned head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_ref(R, NB, bs, K, G, D, MB, dtype):
    H = K * G
    rng = np.random.default_rng(0)
    qj, qt = _arrays(rng, (R, H, D), dtype)
    kj, kt = _arrays(rng, (NB, bs, K, D), dtype)
    vj, vt = _arrays(rng, (NB, bs, K, D), dtype)
    table, nblk, tail = _tables(rng, R, NB, bs, MB)
    got = paged_micro_attention_plain(qt, kt, vt, torch.from_numpy(table),
                                      torch.from_numpy(tail),
                                      scale=D ** -0.5)
    pallas = jax_paged_decode(qj, kj, vj, jnp.asarray(table),
                              jnp.asarray(tail), interpret=True)
    _close(got, pallas, F32_TOL)
    want = jax_ref.paged_micro_attention_ref(
        qj, kj, vj, jnp.asarray(table), jnp.asarray(nblk), jnp.asarray(tail))
    _close(got, want, F32_TOL if dtype == "float32" else JAX_REF_BF16_TOL)


@pytest.mark.parametrize("chunk", [3, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_plain_matches_pallas_and_ref(chunk, dtype):
    NB, bs, K, G, D = 12, 8, 2, 2, 24
    H = K * G
    rng = np.random.default_rng(chunk)
    qj, qt = _arrays(rng, (chunk, H, D), dtype)
    kj, kt = _arrays(rng, (NB, bs, K, D), dtype)
    vj, vt = _arrays(rng, (NB, bs, K, D), dtype)
    for table, tail in [([0, 3, 5, -1], 5), ([7, -1, -1, -1], 8),
                        ([2, 4, 6, 8], 2)]:
        tab = np.asarray(table, np.int32)
        got = paged_prefill_attention_plain(
            qt, kt, vt, torch.from_numpy(tab), torch.tensor(tail),
            scale=D ** -0.5)
        pallas = jax_paged_prefill(qj, kj, vj, jnp.asarray(tab),
                                   jnp.asarray(tail, jnp.int32),
                                   backend="pallas", interpret=True)
        _close(got, pallas, F32_TOL)
        nblk = int((tab >= 0).sum())
        want = jax_ref.paged_prefill_micro_attention_ref(
            qj, kj, vj, jnp.asarray(tab), jnp.asarray(nblk, jnp.int32),
            jnp.asarray(tail, jnp.int32))
        _close(got, want,
               F32_TOL if dtype == "float32" else JAX_REF_BF16_TOL)


RANK_TOL = 1e-5


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("NR", [1, 3])
def test_rank_plain_twins_match_jax_ranks(backend, NR):
    """Both rank forms' plain twins == the JAX package's vmapped ones, on
    one layer's (strided) view of a global pool; with three ranks the
    middle one is empty and yields the merge identity."""
    L, NB, bs, K, G, D, MB, R, C = 2, 12, 8, 2, 2, 32, 4, 3, 5
    H = K * G
    rng = np.random.default_rng(40 + NR)
    qj, qt = _arrays(rng, (R, H, D), "float32")
    qcj, qct = _arrays(rng, (C, H, D), "float32")
    gkj, gkt = _arrays(rng, (NR, L, NB, bs, K, D), "float32")
    gvj, gvt = _arrays(rng, (NR, L, NB, bs, K, D), "float32")
    tables = -np.ones((NR, R, MB), np.int32)
    tails = np.full((NR, R), bs, np.int32)
    for p in range(NR):
        if NR > 1 and p == 1:
            continue
        tables[p], _, tails[p] = _tables(rng, R, NB, bs, MB)
    tb, tl = torch.from_numpy(tables), torch.from_numpy(tails)
    pk, pv = gkt[:, 1], gvt[:, 1]
    assert NR == 1 or not pk.is_contiguous()
    got = paged_micro_attention_ranks_plain(qt, pk, pv, tb, tl,
                                            scale=D ** -0.5)
    want = jax_paged_decode_ranks(qj, gkj[:, 1], gvj[:, 1],
                                  jnp.asarray(tables), jnp.asarray(tails),
                                  backend=backend)
    assert got[0].shape == (NR, R, H, D)
    _close(got, want, RANK_TOL)
    got = paged_prefill_attention_ranks_plain(qct, pk, pv, tb[:, 0],
                                              tl[:, 0], scale=D ** -0.5)
    want = jax_paged_prefill_ranks(qcj, gkj[:, 1], gvj[:, 1],
                                   jnp.asarray(tables[:, 0]),
                                   jnp.asarray(tails[:, 0]),
                                   backend=backend)
    assert got[0].shape == (NR, C, H, D)
    _close(got, want, RANK_TOL)
    if NR > 1:
        assert bool(torch.isneginf(got[1][1]).all())


def test_rank_launchers_refuse_cpu_tensors_and_bad_stacks():
    q = torch.zeros(2, 4, 16)
    pools = torch.zeros(3, 4, 8, 2, 16)
    tables = torch.zeros(3, 2, 2, dtype=torch.int32)
    tails = torch.full((3, 2), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_micro_attention_ranks_cuda(q, pools, pools, tables, tails,
                                         scale=0.25)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_prefill_attention_ranks_cuda(q, pools, pools, tables[:, 0],
                                           tails[:, 0], scale=0.25)


def test_empty_tables_are_the_merge_identity():
    """A rank with no blocks contributes (0, -inf, 0), never NaN."""
    rng = np.random.default_rng(1)
    _, q = _arrays(rng, (4, 4, 16), "float32")
    _, pool = _arrays(rng, (6, 8, 2, 16), "float32")
    for o, m, l in (
            paged_micro_attention_plain(q, pool, pool,
                                        torch.full((4, 3), -1), torch.full(
                                            (4,), 8), scale=0.25),
            paged_prefill_attention_plain(q, pool, pool,
                                          torch.full((4,), -1),
                                          torch.tensor(8), scale=0.25)):
        assert not torch.isnan(o).any() and not torch.isnan(l).any()
        assert float(o.abs().sum()) == 0.0
        assert bool(torch.isneginf(m).all())
        assert float(l.abs().sum()) == 0.0


def test_two_partials_merge_to_full_attention():
    """Partials from two disjoint pools == full attention (Eq. 2+3),
    against the JAX package's full decode attention."""
    rng = np.random.default_rng(9)
    R, bs, K, G, D = 2, 8, 2, 2, 16
    H, S = K * G, 64                           # 8 blocks, split 5 / 3
    qj, qt = _arrays(rng, (R, H, D), "float32")
    kj, kt = _arrays(rng, (R, S, K, D), "float32")
    vj, vt = _arrays(rng, (R, S, K, D), "float32")
    want = jax_full_decode(qj, kj, vj, jnp.ones((R, S), bool))
    kb = kt.reshape(R, 8, bs, K, D)
    vb = vt.reshape(R, 8, bs, K, D)
    parts = []
    for idx in (list(range(0, 5)), list(range(5, 8))):
        pk = kb[:, idx].reshape(-1, bs, K, D)
        pv = vb[:, idx].reshape(-1, bs, K, D)
        table = torch.tensor([[r * len(idx) + i for i in range(len(idx))]
                              for r in range(R)], dtype=torch.int32)
        parts.append(ops.paged_micro_attention(
            qt, pk, pv, table, torch.full((R,), bs)))
    merged = combine(parts[0], parts[1])
    np.testing.assert_allclose(finalize(merged[0], merged[2]).numpy(),
                               np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_cpu_tensors_take_the_plain_path_and_count_it():
    rng = np.random.default_rng(2)
    _, q = _arrays(rng, (2, 4, 16), "float32")
    _, pool = _arrays(rng, (4, 8, 2, 16), "float32")
    ops.reset_counts()
    ops.paged_micro_attention(q, pool, pool,
                              torch.tensor([[0, 1], [2, -1]]),
                              torch.tensor([8, 3]))
    ops.paged_prefill_attention(q, pool, pool, torch.tensor([3, -1]),
                                torch.tensor(5))
    ops.flash_prefill(q[None], pool[0, :2][None], pool[0, :2][None],
                      window=4)
    pools = pool[None].expand(2, -1, -1, -1, -1)
    ops.paged_micro_attention_ranks(q, pools, pools,
                                    torch.tensor([[[0, 1], [2, -1]]] * 2),
                                    torch.tensor([[8, 3]] * 2))
    ops.paged_prefill_attention_ranks(q, pools, pools,
                                      torch.tensor([[3, -1]] * 2),
                                      torch.tensor([5, 5]))
    ops.paged_micro_attention_ranks_merged(
        q, pools, pools, torch.tensor([[[0, 1], [2, -1]]] * 2),
        torch.tensor([[8, 3]] * 2))
    ops.paged_prefill_attention_ranks_merged(q, pools, pools,
                                             torch.tensor([[3, -1]] * 2),
                                             torch.tensor([5, 5]))
    plain_once = {"launches": 0, "plain_calls": 1, "float32_launches": 0}
    assert ops.counts() == {name: plain_once for name in (
        "paged_micro_attention", "paged_prefill_attention",
        "paged_micro_attention_ranks", "paged_prefill_attention_ranks",
        "paged_micro_attention_ranks_merged",
        "paged_prefill_attention_ranks_merged", "flash_prefill")}


def test_kernel_requests_never_fall_back(monkeypatch):
    """The CUDA launchers refuse CPU tensors, the wrappers refuse a
    device with no path, and a build without a CUDA toolkit raises."""
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(4, 8, 2, 16)
    table = torch.zeros(2, 2, dtype=torch.int32)
    tail = torch.full((2,), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_micro_attention_cuda(q, pool, pool, table, tail, scale=0.25)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_prefill_attention_cuda(q, pool, pool, table[0], tail[0],
                                     scale=0.25)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_prefill_cuda(q[None], pool[:1, :2], pool[:1, :2], scale=0.25)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no attention kernel path"):
        ops.paged_micro_attention(meta, pool, pool, table, tail)
    with pytest.raises(ValueError, match="no attention kernel path"):
        ops.flash_prefill(meta[None], pool[:1, :2], pool[:1, :2])
    with pytest.raises(ValueError, match="window"):
        ops.flash_prefill(q[None], pool[:1, :2], pool[:1, :2], window=-1)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_is_keyed_on_the_sources():
    """The library directory changes with any kernel source byte."""
    h = build.source_hash()
    assert build.build_dir().name == h and len(h) == 16
    assert {p.name for p in build.CSRC.glob("*.cu")} == \
        {f"{n}.cu" for n in build.KERNELS}


# ------------------------------------------------------------------ #
# The single-rank kernels' unit plans, TMA boxes and merges, and the bf16
# prefill precision contract (the design of the CUDA kernels, checked
# before any run on the card)
# ------------------------------------------------------------------ #
H100_SMS = 132


def _unit_case(kind, args, sms=H100_SMS):
    """(plan, R, rows a request, H, K, D, MB, bs) of a single-rank kernel
    at ``args`` (decode: R, H, K, MB, bs at D 128, bf16; prefill: C, H, K,
    D, MB, bs)."""
    if kind == "decode":
        R, H, K, MB, bs = args
        return (decode_unit_plan(R, H, K, 128, MB, bs, torch.bfloat16, sms),
                R, 1, H, K, 128, MB, bs)
    C, H, K, D, MB, bs = args
    return (prefill_unit_plan(C, H, K, D, MB, bs, sms, torch.bfloat16), 1,
            C, H, K, D, MB, bs)


def _segment_spans(plan, S):
    """Every block's segments of the unit plan the kernel makes on the
    card for valid tokens ``S [R]`` (rank_units at NR = 1): ``{(g, r):
    [(lo, hi)]}`` and each busy block's units."""
    up = rank_units.unit_plan(np.asarray(S)[None], plan["unit_tokens"],
                              plan["head_groups"], stacked=False)
    spans, walks = {}, []
    for b in range(plan["blocks"]):
        segs = rank_units.segments(up, b, plan["blocks"])
        walks.append(sum(len(sg["units"]) for sg in segs))
        for sg in segs:
            (k, _, lo, _), hi = sg["units"][0], sg["units"][-1][3]
            assert k == 0
            spans.setdefault((sg["g"], sg["r"]), []).append((lo, hi))
    return up, spans, walks


@pytest.mark.parametrize("kind,args", [
    # decode main shape: R=8 over ~4,090 tokens, qwen3 heads
    ("decode", (8, 16, 8, 259, 16)),
    # decode at the serving phase's batch: R=4 (long and local tables), 3
    ("decode", (4, 16, 8, 259, 16)),
    ("decode", (4, 16, 8, 64, 16)),
    ("decode", (3, 16, 8, 64, 16)),
    ("decode", (1, 16, 1, 256, 8)),         # MQA, G = 16, bs 8
    ("decode", (2, 8, 8, 5, 64)),           # MHA, bs 64, short
    ("decode", (8, 16, 8, 1, 16)),          # one slot
    # prefill chunk: main shape, a short chunk, D 256, 128-token blocks
    ("prefill", (512, 16, 8, 128, 191, 16)),
    ("prefill", (37, 16, 8, 128, 191, 16)),
    ("prefill", (33, 8, 2, 256, 23, 64)),
    ("prefill", (512, 16, 8, 128, 24, 128)),
    # D % 16 == 8, the 64-wide build, bs 24
    ("prefill", (50, 4, 2, 120, 133, 8)),
    ("prefill", (40, 8, 2, 40, 73, 24)),
])
def test_unit_plans_cover_every_valid_token_once(kind, args):
    """A single-rank kernel's plan (its wrapper's blocks, unit and head
    groups; the units found on the card, rank_units at NR = 1): over
    tails 1..bs and an empty table, every valid token of every request
    lies in exactly one unit of each of its groups, in order, and no
    block walks more than ceil(units / blocks) units."""
    plan, R, _, H, K, _, MB, bs = _unit_case(kind, args)
    rng = np.random.default_rng(MB * bs + R)
    nblk = rng.integers(1, MB + 1, size=R)
    nblk[0] = MB
    if R > 1:
        nblk[1] = 0                                # an empty table
    for tail in range(1, bs + 1):
        S = np.where(nblk > 0, (nblk - 1) * bs + tail, 0)
        up, spans, walks = _segment_spans(plan, S)
        B = min(plan["blocks"], max(up["T"], 1))
        assert max(walks) <= -(-up["T"] // B)
        assert sum(walks) == up["T"] == plan["head_groups"] * sum(
            -(-S // plan["unit_tokens"]))
        for g in range(R * plan["head_groups"]):
            r = g // plan["head_groups"]
            got = sorted(spans.get((g, r), []))
            ends = [0] + [hi for _, hi in got]
            assert [lo for lo, _ in got] == ends[:-1] and ends[-1] == S[r]


@pytest.mark.parametrize("bs,nblk,tail", [
    (8, 17, 1), (8, 9, 8), (16, 188, 11), (16, 4, 16), (24, 70, 5),
    (24, 3, 24), (64, 5, 1), (64, 20, 64), (128, 24, 65), (128, 1, 1),
    (128, 4, 128),
])
def test_tile_boxes_cover_each_tiles_valid_tokens_once(bs, nblk, tail):
    """The single-rank kernels' TMA loads (rank_units.tile_boxes: the
    producer warp's arithmetic) over every segment of the unit plan, at
    the prefill's 128- and 64-token tiles and the decode forms' 64, 32
    and 16:
    each tile's boxes cover its valid tokens once, in order, each inside
    one table block at a row that starts a swizzle atom (a multiple of
    8), never a -1 slot; a tile's boxes stop at its last valid token."""
    rng = np.random.default_rng(nblk * bs + tail)
    MB = nblk + 3
    table = -np.ones(MB, np.int32)
    table[:nblk] = rng.permutation(nblk + 5)[:nblk]
    S = (nblk - 1) * bs + tail
    for tile, U, hg in ((128, 128, 8), (64, 64, 8), (64, 256, 2),
                        (32, 256, 3), (16, 256, 1)):
        plan = {"unit_tokens": U, "head_groups": hg, "blocks": 7}
        _, spans, _ = _segment_spans(plan, [S])
        for (g, _), runs in spans.items():
            for lo, hi in runs:
                seen = []
                for t in rank_units.tile_boxes(table, bs, lo, hi, tile):
                    nv = min(tile, hi - t["t0"])
                    rows = rank_units.box_rows(bs, tile)
                    assert len(t["boxes"]) == -(-nv // rows)
                    for tok, blk, off, n in t["boxes"]:
                        assert blk >= 0 and off % 8 == 0 and off + n <= bs
                        assert blk == table[tok // bs] and off == tok % bs
                        seen += [x for x in range(tok, tok + n)
                                 if x < t["t0"] + nv]
                assert seen == list(range(lo, hi))


def _range_partial(fn, q, pk, pv, table, tail, bs, lo, hi):
    """The plain twin over tokens [lo, hi) of a table row (lo a multiple
    of bs): a table of those tokens' blocks, the last holding hi - its
    first token."""
    s0, s1 = lo // bs, -(-hi // bs)
    sub = table[..., s0:s1].contiguous()
    return fn(q, pk, pv, sub, torch.full(sub.shape[:-1], hi - (s1 - 1) * bs),
              scale=q.shape[-1] ** -0.5)


def _merged_over_units(kind, plan, q, pk, pv, table, tail, S, rows_of):
    """The single-rank kernel's decomposition with plain partials: each
    segment's partial over its tokens, a group's segments LSE-merged
    (merge_partials), written to the group's rows; (0, -inf, 0) for a
    group with no unit."""
    bs = pk.shape[1]
    fn = (paged_micro_attention_plain if kind == "decode"
          else paged_prefill_attention_plain)
    _, spans, _ = _segment_spans(plan, S)
    lead = q.shape[:-1]
    o = torch.zeros(q.shape)
    m = torch.full(lead, float("-inf"))
    l = torch.zeros(lead)
    for (g, r), runs in spans.items():
        parts = []
        for lo, hi in runs:
            if kind == "decode":
                part = _range_partial(fn, q[r:r + 1], pk, pv,
                                      table[r:r + 1], tail, bs, lo, hi)
            else:
                part = _range_partial(fn, q, pk, pv, table, tail, bs, lo, hi)
            parts.append(part)
        mo, mm, ml = merge_partials(*(torch.stack(x) for x in zip(*parts)),
                                    axis=0)
        mask = rows_of(g)
        if kind == "decode":
            o[r][mask], m[r][mask], l[r][mask] = (mo[0][mask], mm[0][mask],
                                                  ml[0][mask])
        else:
            o[mask], m[mask], l[mask] = mo[mask], mm[mask], ml[mask]
    return o, m, l


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_unit_partials_merge_to_the_unsplit_twin(dtype):
    """The decode kernel's plan on a small card (3 SMs: groups split over
    blocks): the plain twin over each segment's tokens, a group's
    segments LSE-merged, == the unsplit plain twin (an empty table, one
    shorter than a unit, a tail in the last unit)."""
    rng = np.random.default_rng(11)
    R, K, G, D, bs, MB = 3, 2, 2, 16, 16, 64
    nblks = [0, 3, MB]
    _, q = _arrays(rng, (R, K * G, D), dtype)
    _, pk = _arrays(rng, (sum(nblks) + 2, bs, K, D), dtype)
    _, pv = _arrays(rng, (sum(nblks) + 2, bs, K, D), dtype)
    perm = rng.permutation(sum(nblks) + 2)
    table = -np.ones((R, MB), np.int32)
    used = 0
    for r, n in enumerate(nblks):
        table[r, :n] = perm[used:used + n]
        used += n
    table = torch.from_numpy(table)
    tail = torch.tensor([bs, 5, 7], dtype=torch.int32)
    S = [0, 2 * bs + 5, (MB - 1) * bs + 7]
    plan = decode_unit_plan(R, K * G, K, D, MB, bs, torch.float32, 3)
    assert plan["blocks"] == 6 and plan["heads_per_block"] == G
    hg, heads = plan["head_groups"], plan["heads_per_block"]

    def rows_of(g):                     # the group's query heads
        kh, grp = divmod(g % hg, hg // K)
        g0 = kh * G + grp * heads
        mask = torch.zeros(K * G, dtype=torch.bool)
        mask[g0:min(g0 + heads, (kh + 1) * G)] = True
        return mask
    got = _merged_over_units("decode", plan, q, pk, pv, table, tail, S,
                             rows_of)
    want = paged_micro_attention_plain(q, pk, pv, table, tail,
                                       scale=D ** -0.5)
    _close(got, want, F32_TOL)
    assert bool(torch.isneginf(got[1][0]).all())


@pytest.mark.parametrize("nblk", [50, 7])
def test_prefill_unit_partials_merge_to_the_unsplit_twin(nblk):
    """The bf16 prefill kernel's plan on a small card (9 SMs: two blocks
    a 128-row tile), the same way: the 128-token units of each tile,
    merged per tile."""
    rng = np.random.default_rng(nblk)
    C, K, G, D, bs, MB = 70, 2, 2, 16, 16, 64
    _, q = _arrays(rng, (C, K * G, D), "bfloat16")
    _, pk = _arrays(rng, (nblk + 2, bs, K, D), "bfloat16")
    _, pv = _arrays(rng, (nblk + 2, bs, K, D), "bfloat16")
    table = -np.ones((MB,), np.int32)
    table[:nblk] = rng.permutation(nblk + 2)[:nblk]
    table = torch.from_numpy(table)
    tail = torch.tensor(9, dtype=torch.int32)
    plan = prefill_unit_plan(C, K * G, K, D, MB, bs, 9, torch.bfloat16)
    nrt = plan["head_groups"] // K
    assert plan["blocks"] == 8 and nrt == 2

    def rows_of(g):
        kh, rt = divmod(g, nrt)
        mask = torch.zeros((C, K * G), dtype=torch.bool)
        for gr in range(rt * 128, min((rt + 1) * 128, C * G)):
            mask[gr // G, kh * G + gr % G] = True
        return mask
    got = _merged_over_units("prefill", plan, q, pk, pv, table, tail,
                             [(nblk - 1) * bs + 9], rows_of)
    want = paged_prefill_attention_plain(q, pk, pv, table, tail,
                                         scale=D ** -0.5)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("NR", [1, 2, 3, 4])
def test_rank_plans_split_all_ranks_work_items(NR):
    """A rank decode plan is the single-rank decode plan over NR rank
    pools: its instantiation (every query head of a kv head a block, 64-
    or 32-token tiles, the ring), units of 256 tokens halved while the NR
    x R tables could not give every block one (and on the card while the
    valid tokens make fewer than 4 units a block: ``min_units``),
    ``group_blocks`` of the merge groups (stacked over ranks: every slot
    the card holds where that would leave an eighth idle), its shared
    memory grown by the plan of NR x R pairs; a rank prefill plan is the single-rank plan's
    instantiation (128-row merge groups, 128-token units in bf16 and
    32-token ones in float32 at D 128, one block an SM) with its block
    rule over P x the groups (two blocks a group merged; stacked, one an
    SM where the aligned count would leave an eighth idle) and its shared
    memory grown by the plan of NR ranks. Both with one ticket counter a
    merge group and a scratch slot a block and a group; the work itself
    (every rank's valid tokens) is planned on the card."""
    for R, H, K, MB in ((4, 16, 16, 256), (4, 16, 8, 64)):
        for dt in (torch.bfloat16, torch.float32):
            one = decode_unit_plan(R, H, K, 128, MB, 16, dt, H100_SMS)
            tc = dt == torch.bfloat16
            for stacked in (False, True):
                dec = rank_decode_plan(R, H, K, 128, MB, 16, dt, H100_SMS,
                                       NR, stacked)
                for key in ("heads_per_block", "head_groups", "tile_tokens",
                            "stages", "tensor_cores", "route",
                            "blocks_per_sm"):
                    assert dec[key] == one[key], key
                assert dec["heads_per_block"] == H // K
                # Float32 at one head a block: 3 blocks an SM on a 2-stage
                # ring (GT 1); else 2 blocks, 3 stages.
                per_sm = 3 if not tc and H == K else 2
                assert (dec["blocks_per_sm"], dec["stages"]) == (
                    per_sm, 5 - per_sm)
                P = NR if stacked else 1
                assert dec["groups"] == P * one["groups"] == P * R * K
                assert dec["ws_slots"] == dec["blocks"] + dec["groups"]
                rows = P * R
                assert dec["smem_bytes"] == one["smem_bytes"] + 4 * (
                    NR * R + rows - 2 * R)
                assert dec["smem_bytes"] * dec["blocks_per_sm"] \
                    <= SMEM_PER_SM
                # Group-aligned (a multiple or divisor of the merge
                # groups) within the card's slots; stacked over ranks,
                # every slot where that would idle an eighth of them.
                slots = per_sm * H100_SMS
                groups = dec["groups"]
                aligned = (groups * (slots // groups) if groups <= slots
                           else -(-groups // -(-groups // slots)))
                fill = stacked and NR > 1 and 8 * aligned < 7 * slots
                assert dec["blocks"] == (slots if fill else aligned)
                # 256-token units, halved at one rank of 64-slot tables
                # (128 units of 256 tokens for 256 blocks).
                assert dec["unit_tokens"] == (256 if MB == 256 or NR > 1
                                              else 128)
                # The card may halve the unit further (min_units): on the
                # CUDA cores while a block would get under a quarter unit
                # a head; on the tensor cores only stacked, at most two
                # heads a block, under four units a block.
                assert dec["min_units"] == (
                    max(1, dec["blocks"] * H // K // 4) if not tc
                    else 4 * dec["blocks"] if stacked else 0)
            assert one["min_units"] == 0
    for dt, tile in ((torch.bfloat16, 128), (torch.float32, 32)):
        one = prefill_unit_plan(512, 16, 16, 128, 256, 16, H100_SMS, dt)
        for stacked in (False, True):
            pre = rank_prefill_plan(512, 16, 16, 128, 256, 16, dt, H100_SMS,
                                    NR, stacked)
            P = NR if stacked else 1
            assert pre["rows_per_block"] == 128 == one["rows_per_block"]
            assert pre["unit_tokens"] == pre["kv_tile"] == tile
            assert pre["stages"] == one["stages"]
            assert pre["head_groups"] == 16 * 512 // 128
            assert pre["groups"] == pre["head_groups"] * P
            assert pre["ws_slots"] == pre["blocks"] + pre["groups"]
            assert pre["blocks_per_sm"] == 1
            assert pre["blocks"] == ({1: 128, 2: 128, 3: H100_SMS, 4: 128}[
                NR] if stacked else 128)
            assert pre["smem_bytes"] == one["smem_bytes"] + 4 * (
                -(-(NR + P + 1) // 4) - 1) * 4 <= SMEM_PER_SM
    # One rank and a short table: fewer blocks than the card holds, the
    # unit halved down to a tile.
    tiny = rank_decode_plan(1, 8, 8, 128, 2, 16, torch.float32, H100_SMS,
                            1, False)
    assert tiny["unit_tokens"] == 32 and tiny["blocks"] == 8
    # The rank forms' CUDA cores take at most 4 query heads a block (G 12:
    # three head groups a kv head); the single-rank form all 12.
    g12 = rank_decode_plan(2, 48, 4, 128, 128, 16, torch.float32, H100_SMS,
                           4, False)
    assert (g12["heads_per_block"], g12["head_groups"]) == (4, 12)
    assert decode_unit_plan(2, 48, 4, 128, 128, 16, torch.float32,
                            H100_SMS)["heads_per_block"] == 12
    with pytest.raises(ValueError, match="shared memory"):
        rank_decode_plan(4, 16, 8, 128, 64, 16, torch.bfloat16, H100_SMS,
                         4096, True)


def test_unit_plans_fill_the_card_at_the_main_shapes():
    """The plans the kernels' headers state. Decode (units of 256 valid
    tokens): the main shape, R = 8 over ~4,090 tokens of qwen3's heads,
    on the tensor cores, 256 blocks (4 a merge group, of the 264 the
    card holds) each walking exactly 4 of the 1,024 units; starcoder2's G
    12, every head of a kv head in one block; float32 G 16 at D 256 in
    four head groups on the CUDA cores. Prefill (128-row x 128-token
    units): 128 persistent blocks at 230,504 B (D 128, 3 stages), two a
    group, each 12 units; chameleon's 256 groups two a block; 4 stages at
    D 64, 2 (64-token tiles) at D 256; float32 (3xTF32) at D 128: 32-token
    units, two stages, the same 128 blocks, each 47 units, and one block
    an SM where the aligned count would leave an eighth idle. The rank
    kernels at the qwen2-moe global path's shapes (MHA 16 x 128, three
    ranks holding a request's 63 / 160 / 27 blocks of 16 tokens; a
    512-query chunk over a 32 / 160 / 27-block prefix): in decode the 304
    units of 256 tokens over 256 blocks in bf16 (4 a merge group, no
    block walking more than two) and 384 in float32 (3 an SM, one unit a
    block at most); in prefill two blocks a merge group, each exactly 14
    of its group's 28 128-token tiles (bf16) or 55 of its 110 32-token
    tiles (float32), across the three ranks."""
    bf16 = torch.bfloat16
    dec = decode_unit_plan(8, 16, 8, 128, 259, 16, bf16, H100_SMS)
    assert (dec["blocks"], dec["heads_per_block"], dec["tensor_cores"],
            dec["groups"]) == (256, 2, True, 64)
    _, _, walks = _segment_spans(dec, [255 * 16 + 11] * 8)
    assert max(walks) == min(walks) == 4 and sum(walks) == 64 * 16
    sc2 = decode_unit_plan(4, 48, 4, 128, 64, 16, torch.bfloat16, H100_SMS)
    assert (sc2["heads_per_block"], sc2["head_groups"],
            sc2["tensor_cores"]) == (12, 4, True)
    g16 = decode_unit_plan(2, 32, 2, 256, 256, 16, torch.float32, H100_SMS)
    assert (g16["heads_per_block"], g16["head_groups"],
            g16["tensor_cores"]) == (4, 8, False)
    for plan in (dec, sc2, g16):
        assert plan["smem_bytes"] * plan["blocks_per_sm"] <= SMEM_PER_SM
    pre = prefill_unit_plan(512, 16, 8, 128, 191, 16, H100_SMS, bf16)
    assert (pre["blocks"], pre["groups"], pre["kv_tile"], pre["stages"],
            pre["smem_bytes"]) == (128, 64, 128, 3, 230_504)
    _, _, walks = _segment_spans(pre, [187 * 16 + 11])
    assert max(walks) == min(walks) == 12
    cham = prefill_unit_plan(512, 64, 8, 128, 153, 16, H100_SMS, bf16)
    assert (cham["blocks"], cham["groups"]) == (128, 256)
    assert prefill_unit_plan(512, 24, 24, 64, 191, 16, H100_SMS, bf16)[
        "stages"] == 4
    assert prefill_unit_plan(33, 8, 2, 256, 23, 64, H100_SMS, bf16)[
        "stages"] == 2
    for D in (64, 128, 256):
        assert prefill_unit_plan(512, 16, 8, D, 191, 16, H100_SMS, bf16)[
            "smem_bytes"] <= SMEM_PER_SM
    # float32 (3xTF32): 32-token tiles and two stages at D 128, the same
    # 128 blocks two a group, 47 units each.
    f32 = prefill_unit_plan(512, 16, 8, 128, 191, 16, H100_SMS,
                            torch.float32)
    assert (f32["blocks"], f32["groups"], f32["kv_tile"], f32["stages"],
            f32["smem_bytes"]) == (128, 64, 32, 2, 230_544)
    _, _, walks = _segment_spans(f32, [187 * 16 + 11])
    assert max(walks) == min(walks) == 47
    # Where the group-aligned count would leave an eighth of the SMs idle
    # (musicgen's 96 groups, starcoder2's 192 two a block), float32
    # launches one block an SM; bf16 keeps the aligned count.
    for H, K, D in ((24, 24, 64), (48, 4, 128)):
        assert prefill_unit_plan(512, H, K, D, 191, 16, H100_SMS,
                                 torch.float32)["blocks"] == H100_SMS
        assert prefill_unit_plan(512, H, K, D, 191, 16, H100_SMS,
                                 bf16)["blocks"] == 96
    assert prefill_unit_plan(512, 64, 8, 128, 153, 16, H100_SMS,
                             torch.float32)["blocks"] == 128
    # The rank kernels.
    bs = 16
    S = np.array([[63 * bs, 38 * bs, 0, 0], [160 * bs, 0, 0, 0],
                  [27 * bs, 0, 0, 0]])
    for dt, blocks, walk in ((torch.bfloat16, 256, 512),
                             (torch.float32, 384, 256)):
        dec = rank_decode_plan(4, 16, 16, 128, 256, bs, dt, H100_SMS, 3,
                               False)
        assert (dec["blocks"], dec["groups"], dec["unit_tokens"]) == (
            blocks, 64, 256)
        U = rank_units.card_unit(S, dec["unit_tokens"], dec["tile_tokens"],
                                 dec["head_groups"], dec["min_units"])
        plan = rank_units.unit_plan(S, U, dec["head_groups"], stacked=False)
        assert plan["T"] == 16 * (4 + 3 + 10 + 2)
        walks = [sum(hi - lo for seg in rank_units.segments(plan, b,
                                                            dec["blocks"])
                     for _, _, lo, hi in seg["units"])
                 for b in range(dec["blocks"])]
        assert max(walks) == walk and sum(walks) == 16 * S.sum()
    Sp = np.array([[32 * bs], [160 * bs], [27 * bs]])
    for dt, walk, per_group in ((torch.bfloat16, 14, 4 + 20 + 4),
                                (torch.float32, 55, 16 + 80 + 14)):
        pre = rank_prefill_plan(512, 16, 16, 128, 256, bs, dt, H100_SMS, 3,
                                False)
        assert pre["blocks"] == 128 == 2 * pre["groups"]
        plan = rank_units.unit_plan(Sp, pre["unit_tokens"],
                                    pre["head_groups"], stacked=False)
        segs = [rank_units.segments(plan, b, pre["blocks"])
                for b in range(pre["blocks"])]
        tiles = [sum(len(seg["units"]) for seg in bs_) for bs_ in segs]
        assert max(tiles) == min(tiles) == walk
        assert sum(tiles) == 64 * per_group
        assert all(len(bs_) == 1 for bs_ in segs)  # one group a block


def _prefill_emulation(q, pk, pv, table, tail, *, scale, split_p):
    """The bf16 prefill kernel's arithmetic in plain PyTorch: bf16 q and K
    (products exact in float32), float32 softmax and l, and P V from the
    probabilities as bf16 ``hi`` + ``lo`` (``split_p``) or as one bf16
    rounding of p."""
    C, H, D = q.shape
    K = pk.shape[2]
    k, v = gather_local_kv(pk, pv, table[None])
    mask = local_mask_from_table(table[None], pk.shape[1],
                                 tail.reshape(1))[0]
    s = torch.einsum("ckgd,skd->ckgs", q.float().reshape(C, K, H // K, D),
                     k[0].float()) * scale
    m, p, l = _masked_softmax_parts(s, mask[None, None, None, :])
    hi = p.to(torch.bfloat16).float()
    o = torch.einsum("ckgs,skd->ckgd", hi, v[0].float())
    if split_p:
        lo = (p - hi).to(torch.bfloat16).float()
        o = o + torch.einsum("ckgs,skd->ckgd", lo, v[0].float())
    return o.reshape(C, H, D), m.reshape(C, H), l.reshape(C, H)


@functools.lru_cache(maxsize=1)
def _main_prefill_case():
    """The qwen3 path's main prefill shape in bf16: a 512-token chunk,
    H=16, K=8, D=128, over a ~3,000-token prefix (bs 16)."""
    rng = np.random.default_rng(13)
    C, H, K, D, bs, nblk = 512, 16, 8, 128, 16, 188
    _, q = _arrays(rng, (C, H, D), "bfloat16")
    _, pk = _arrays(rng, (nblk + 4, bs, K, D), "bfloat16")
    _, pv = _arrays(rng, (nblk + 4, bs, K, D), "bfloat16")
    table = -np.ones((nblk + 3,), np.int32)
    table[:nblk] = rng.permutation(nblk + 4)[:nblk]
    args = (q, pk, pv, torch.from_numpy(table),
            torch.tensor(11, dtype=torch.int32))
    want = paged_prefill_attention_plain(*args, scale=D ** -0.5)
    return args, want


def _finalized_error(got, want):
    return (finalize(got[0], got[2]) - finalize(want[0], want[2])) \
        .abs().max().item()


def test_prefill_hi_lo_contract_meets_tol_at_the_main_shape():
    """p as bf16 hi + lo, l from the float32 p: within 1e-4 of the
    float32 plain twin (finalized output, m, l)."""
    args, want = _main_prefill_case()
    got = _prefill_emulation(*args, scale=128 ** -0.5, split_p=True)
    assert _finalized_error(got, want) <= F32_TOL
    torch.testing.assert_close(got[1], want[1], atol=F32_TOL, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=F32_TOL)


def test_prefill_single_bf16_rounding_of_p_exceeds_tol():
    """Why the split exists: p rounded once to bf16 before P V misses
    1e-4 at the main shape."""
    args, want = _main_prefill_case()
    got = _prefill_emulation(*args, scale=128 ** -0.5, split_p=False)
    assert _finalized_error(got, want) > F32_TOL


# The bf16 flash-prefill kernel's precision contract, held to the
# tolerance of chip_smoke.py and tests/test_torch_cuda.py: one bf16 ulp of
# the output (2^-7 relative) beyond 1e-4.
FLASH_BF16_ATOL, FLASH_BF16_RTOL = 1e-4, 2 ** -7


def _flash_emulation(q, k, v, *, scale, window, q0, p_mode):
    """The bf16 flash kernel's arithmetic in plain PyTorch, for the query
    rows q [T,H,D] at positions q0 .. q0 + T - 1 over k/v [N,K,D] at
    positions 0 .. N - 1 (causal, optionally windowed): bf16 q and K
    (products exact in float32), float32 softmax and l, P V from the
    probabilities kept in float32 (``p_mode`` "f32": the plain twin's
    arithmetic), as bf16 hi + lo ("hi_lo") or rounded once to bf16
    ("single"); normalized in float32, rounded to q's dtype. The kernel
    rounds p relative to a running max; the relative rounding error per
    term is the same."""
    T, H, D = q.shape
    N, K, _ = k.shape
    s = torch.einsum("tkgd,nkd->tkgn", q.float().reshape(T, K, H // K, D),
                     k.float()) * scale
    qp = torch.arange(q0, q0 + T)[:, None]
    kp = torch.arange(N)[None, :]
    ok = kp <= qp
    if window:
        ok = ok & (kp > qp - window)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if p_mode == "f32":
        parts = [p]
    else:
        hi = p.to(torch.bfloat16).float()
        parts = [hi]
        if p_mode == "hi_lo":
            parts.append((p - hi).to(torch.bfloat16).float())
    o = sum(torch.einsum("tkgn,nkd->tkgd", x, v.float()) for x in parts)
    return (o / l).reshape(T, H, D).to(q.dtype)


# The two flash-prefill main shapes, bf16: (a) the hybrid admission (S =
# 6000, H = 16, K = 1, D = 256, window 2048), its last 64 query positions
# against their 2,048-key window (translated to start at key 0); (b)
# qwen3-0.6b's causal dense-prefill shape (S = 4000, H = 16, K = 8, D =
# 128), its last 128-row query tile over every key.
_FLASH_MAIN = {"a": dict(T=64, N=2111, H=16, K=1, D=256, window=2048),
               "b": dict(T=128, N=4000, H=16, K=8, D=128, window=0)}


@functools.lru_cache(maxsize=2)
def _flash_main_case(name):
    c = _FLASH_MAIN[name]
    rng = np.random.default_rng(17)
    _, q = _arrays(rng, (c["T"], c["H"], c["D"]), "bfloat16")
    _, k = _arrays(rng, (c["N"], c["K"], c["D"]), "bfloat16")
    _, v = _arrays(rng, (c["N"], c["K"], c["D"]), "bfloat16")
    kw = dict(scale=c["D"] ** -0.5, window=c["window"], q0=c["N"] - c["T"])
    want = _flash_emulation(q, k, v, p_mode="f32", **kw).float()
    return (q, k, v), kw, want


def _flash_misses(got, want):
    """Elements outside the bf16 contract's tolerance."""
    bad = (got.float() - want).abs() > FLASH_BF16_ATOL + \
        FLASH_BF16_RTOL * want.abs()
    return int(bad.sum())


def test_flash_emulation_f32_mode_is_the_plain_twin():
    """The emulation's float32 mode reproduces ``flash_prefill_plain``
    (the reference of the two tests below) on the rows it computes."""
    rng = np.random.default_rng(19)
    S, H, K, D, window, T = 300, 8, 2, 64, 100, 64
    _, q = _arrays(rng, (1, S, H, D), "bfloat16")
    _, k = _arrays(rng, (1, S, K, D), "bfloat16")
    _, v = _arrays(rng, (1, S, K, D), "bfloat16")
    plain = flash_prefill_plain(q, k, v, scale=D ** -0.5, window=window)
    got = _flash_emulation(q[0, -T:], k[0], v[0], scale=D ** -0.5,
                           window=window, q0=S - T, p_mode="f32")
    assert _flash_misses(got, plain[0, -T:].float()) == 0


@pytest.mark.parametrize("shape", ["a", "b"])
def test_flash_hi_lo_contract_meets_tol_at_the_main_shapes(shape):
    """p as bf16 hi + lo, l from the float32 p: every output element
    within 1e-4 + 2^-7 |plain| of the float32 plain arithmetic."""
    args, kw, want = _flash_main_case(shape)
    got = _flash_emulation(*args, p_mode="hi_lo", **kw)
    assert _flash_misses(got, want) == 0


@pytest.mark.parametrize("shape", ["a", "b"])
def test_flash_single_bf16_rounding_of_p_misses_tol(shape):
    """Why the kernel splits p: one bf16 rounding of p before P V puts
    elements outside the tolerance at both main shapes."""
    args, kw, want = _flash_main_case(shape)
    got = _flash_emulation(*args, p_mode="single", **kw)
    assert _flash_misses(got, want) > 0


# The prefill cells' and the ServeLayout prefill's causal shapes, bf16:
# the last 64 query positions of S = 32,768 over every key, at D 128 with
# G 2 (qwen3's and chameleon's grouping) and at D 64, MHA (musicgen).
_FLASH_LONG = {"d128-g2": dict(H=4, K=2, D=128),
               "d64-mha": dict(H=3, K=3, D=64)}


@pytest.mark.parametrize("shape", sorted(_FLASH_LONG))
def test_flash_hi_lo_contract_meets_tol_at_the_long_causal_shapes(shape):
    """p as bf16 hi + lo holds every output element within 1e-4 + 2^-7
    |plain| of the float32 plain arithmetic where the rows sum 32,768
    terms, the most any served path gives the kernel."""
    c, T, N = _FLASH_LONG[shape], 64, 32768
    rng = np.random.default_rng(23)
    _, q = _arrays(rng, (T, c["H"], c["D"]), "bfloat16")
    _, k = _arrays(rng, (N, c["K"], c["D"]), "bfloat16")
    _, v = _arrays(rng, (N, c["K"], c["D"]), "bfloat16")
    kw = dict(scale=c["D"] ** -0.5, window=0, q0=N - T)
    want = _flash_emulation(q, k, v, p_mode="f32", **kw).float()
    got = _flash_emulation(q, k, v, p_mode="hi_lo", **kw)
    assert _flash_misses(got, want) == 0


# ------------------------------------------------------------------ #
# The float32 kernels' 3xTF32 contract (flash prefill and the prefill
# chunk), emulated in plain PyTorch
# ------------------------------------------------------------------ #
def _tf32(x):
    """x as a tf32 operand of the tensor cores: its low 13 mantissa bits
    ignored (truncated toward zero), on the float32 bit pattern."""
    b = x.float().contiguous().view(torch.int32)
    return (b & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, products):
    """``einsum(eq, a, b)`` of float32 operands as the kernels run it:
    each operand x as hi, its raw value, and lo = x - tf32(x), both read
    by the tensor cores as tf32 (``_tf32``); the product as hi hi + hi lo
    + lo hi (``products`` 3) or hi hi alone (1); tf32 x tf32 is exact in
    float32, the sums are float32."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if products == 3:
        al, bl = _tf32(a.float() - ah), _tf32(b.float() - bh)
        out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
    return out


def test_tf32_split_truncates():
    """The emulation's split: a tf32 operand keeps 10 mantissa bits,
    truncated toward zero (the low 13 bits ignored, a tf32 value
    unchanged); hi alone is off by up to 2^-10 of x, hi + lo (lo read as
    tf32 too) holds x to 2^-20."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp - 2 ** -23,
                      1 + ulp, 3.0])
    assert _tf32(x).tolist() == [1.0, -1.0, 1.0, 1 + ulp, 3.0]
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(
        100_000).astype(np.float32))
    hi = _tf32(r)
    lo = _tf32(r - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - hi).abs() < 2.0 ** -10 * r.abs()).all()
    err = ((hi.double() + lo.double()) - r.double()).abs()
    assert (err <= 2.0 ** -20 * r.abs().double()).all()
    assert err.max().item() > 0


def _prefill_tf32_emulation(q, pk, pv, table, tail, *, scale, products):
    """The float32 prefill-chunk kernel's arithmetic in plain PyTorch:
    Q K^T and P V in tf32 products (``_tf32_product``), the softmax, m and
    l in float32 from the float32 p."""
    C, H, D = q.shape
    K = pk.shape[2]
    k, v = gather_local_kv(pk, pv, table[None])
    mask = local_mask_from_table(table[None], pk.shape[1],
                                 tail.reshape(1))[0]
    s = _tf32_product("ckgd,skd->ckgs", q.reshape(C, K, H // K, D), k[0],
                      products) * scale
    m, p, l = _masked_softmax_parts(s, mask[None, None, None, :])
    o = _tf32_product("ckgs,skd->ckgd", p, v[0], products)
    return o.reshape(C, H, D), m.reshape(C, H), l.reshape(C, H)


# float32 chunks of the prefill kernel's served shapes: qwen3's main
# shape (C 512, GQA 16/8 x 128 over a ~3,000-token prefix, bs 16) and
# musicgen's (MHA 24 x 64 over ~2,400 tokens).
_TF32_PREFILL = {"main": (512, 16, 8, 128, 16, 188),
                 "musicgen": (512, 24, 24, 64, 16, 150)}


@functools.lru_cache(maxsize=2)
def _tf32_prefill_case(name):
    C, H, K, D, bs, nblk = _TF32_PREFILL[name]
    rng = np.random.default_rng(29)
    q, pk, pv = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 for shape in ((C, H, D), (nblk + 4, bs, K, D),
                               (nblk + 4, bs, K, D)))
    table = -np.ones((nblk + 3,), np.int32)
    table[:nblk] = rng.permutation(nblk + 4)[:nblk]
    args = (q, pk, pv, torch.from_numpy(table),
            torch.tensor(11, dtype=torch.int32))
    want = paged_prefill_attention_plain(*args, scale=D ** -0.5)
    return args, D ** -0.5, want


@pytest.mark.parametrize("name", sorted(_TF32_PREFILL))
def test_prefill_3xtf32_contract_meets_tol(name):
    """Three tf32 products a float32 product (hi hi + hi lo + lo hi), l
    from the float32 p: the finalized output, m and l within 1e-4 of the
    float32 plain twin."""
    args, scale, want = _tf32_prefill_case(name)
    got = _prefill_tf32_emulation(*args, scale=scale, products=3)
    assert _finalized_error(got, want) <= F32_TOL
    torch.testing.assert_close(got[1], want[1], atol=F32_TOL, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=F32_TOL)


@pytest.mark.parametrize("name", sorted(_TF32_PREFILL))
def test_prefill_single_tf32_product_misses_tol(name):
    """Why three: one tf32 product (up to 2^-10 relative an operand) puts
    the finalized output, m and l outside 1e-4 at both chunks."""
    args, scale, want = _tf32_prefill_case(name)
    got = _prefill_tf32_emulation(*args, scale=scale, products=1)
    assert _finalized_error(got, want) > F32_TOL
    assert (got[1] - want[1]).abs().max().item() > F32_TOL
    assert ((got[2] - want[2]).abs() / want[2]).max().item() > F32_TOL


def _flash_tf32_emulation(q, k, v, *, scale, window, q0, products):
    """The float32 flash kernel's arithmetic (as ``_flash_emulation``,
    with Q K^T and P V in tf32 products), normalized in float32."""
    T, H, D = q.shape
    N, K, _ = k.shape
    s = _tf32_product("tkgd,nkd->tkgn", q.reshape(T, K, H // K, D), k,
                      products) * scale
    qp = torch.arange(q0, q0 + T)[:, None]
    kp = torch.arange(N)[None, :]
    ok = kp <= qp
    if window:
        ok = ok & (kp > qp - window)
    s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _tf32_product("tkgn,nkd->tkgd", p, v, products)
    return (o / p.sum(-1, keepdim=True)).reshape(T, H, D)


@functools.lru_cache(maxsize=2)
def _tf32_flash_case(name):
    """``_FLASH_MAIN``'s rows in float32, and their plain arithmetic."""
    c = _FLASH_MAIN[name]
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               for shape in ((c["T"], c["H"], c["D"]),
                             (c["N"], c["K"], c["D"]),
                             (c["N"], c["K"], c["D"])))
    kw = dict(scale=c["D"] ** -0.5, window=c["window"], q0=c["N"] - c["T"])
    want = _flash_emulation(q, k, v, p_mode="f32", **kw)
    return (q, k, v), kw, want


@pytest.mark.parametrize("shape", ["a", "b"])
def test_flash_3xtf32_contract_meets_tol_at_the_main_shapes(shape):
    """Three tf32 products a float32 product: every output element within
    1e-4 of the float32 plain arithmetic (FLASH_RTOL 0 in float32), at
    the hybrid admission's window and qwen3's causal prefill."""
    args, kw, want = _tf32_flash_case(shape)
    got = _flash_tf32_emulation(*args, products=3, **kw)
    assert (got - want).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("shape", ["a", "b"])
def test_flash_single_tf32_product_misses_tol(shape):
    """Why three: one tf32 product a float32 product (the operands
    truncated to tf32) misses 1e-4 at both main shapes (7e-4 and 6e-4 on
    these inputs; the three products: 6e-7 and 4e-7)."""
    args, kw, want = _tf32_flash_case(shape)
    got = _flash_tf32_emulation(*args, products=1, **kw)
    assert (got - want).abs().max().item() > F32_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", range(8, MAX_HEAD_DIM + 1, 8))
def test_flash_plans_fit_shared_memory_and_cover_the_head_dim(D, dtype):
    """Every head dim the wrapper takes has an instantiation at least as
    wide, whose block fits the H100's 232,448 B of shared memory: bf16,
    q (128 rows) and the ring of K and V tiles in 64-column boxes, plus
    alignment and barriers, under two consumer warpgroups that own 128
    rows; at most one persistent block an SM or a work item. The route is
    named."""
    B, S, H, K = 2, 6000, 16, 1
    plan = flash_plan(B, S, H, K, D, dtype, 132)
    assert D <= plan["dmax"] <= MAX_HEAD_DIM
    assert plan["smem_bytes"] <= SMEM_PER_SM
    if dtype == torch.bfloat16:
        dmax, tile, stages = plan["dmax"], plan["kv_tile"], plan["stages"]
        assert dmax in (64, 128, 256) and dmax % 64 == 0
        assert plan["smem_bytes"] == (1024 + 128 * dmax * 2
                                      + stages * 2 * tile * dmax * 2
                                      + 8 * (2 + 3 * stages))
        assert stages >= 2 and tile % 16 == 0
        assert plan["warpgroups"] * plan["rows_per_warpgroup"] == \
            plan["rows_per_block"] == 128
        assert plan["threads"] == 128 * (plan["warpgroups"] + 1)
        assert plan["items"] == -(-S // 128) * H * B
        assert plan["blocks"] == min(plan["items"], 132)
        assert plan["grid"] == (plan["blocks"], 1, 1)
        assert plan["route"].startswith("wgmma")
    else:
        # 3xTF32: each consumer's q_lo (and q_hi above D 128: below, it
        # is register fragments), two raw V tiles, the stages' four tf32
        # tiles (K_hi the raw K tile); two consumers of 64 rows up to D
        # 128, one above.
        dmax, tile, stages = plan["dmax"], plan["kv_tile"], plan["stages"]
        wgs = plan["warpgroups"]
        q_halves = 1 if dmax <= 128 else 2
        assert wgs == (2 if D <= 128 else 1)
        assert plan["smem_bytes"] == (1024 + wgs * q_halves * 64 * dmax * 4
                                      + (2 + 4 * stages) * tile * dmax * 4
                                      + 8 * (2 * 2 + 5 * stages))
        assert tile % 16 == 0 and stages >= 1
        assert plan["rows_per_block"] == 64 * wgs
        assert plan["threads"] == 128 * (wgs + 1)
        assert plan["items"] == -(-S // plan["rows_per_block"]) * H * B
        assert plan["blocks"] == min(plan["items"], 132)
        assert plan["route"].startswith("wgmma 3xTF32")


def test_flash_plans_at_the_main_shapes():
    """(a) the hybrid admission: D 256, 64-token tiles, 2 stages, 752
    items on 132 blocks in 197,696 B; (b) qwen3's dense prefill and (c)
    the ServeLayout prefill (B 2, S 32,768): D 128, 128-token tiles, 3
    stages in 230,488 B; (d) musicgen's cell (MHA 24 x 64): 4 stages of
    128-token tiles. A card with fewer SMs gets fewer blocks; a launch
    with fewer items than SMs one block an item. float32 (3xTF32): 64-row
    items of 16-token tiles, one stage, at D 256; 128-row items of
    32-token tiles, two stages, at D 128 (both in about 225 KB); two
    stages of 64-token tiles at D 64 in 193 KB."""
    a = flash_plan(1, 6000, 16, 1, 256, torch.bfloat16, 132)
    assert (a["kv_tile"], a["stages"], a["items"], a["blocks"],
            a["smem_bytes"]) == (64, 2, 752, 132, 197_696)
    b = flash_plan(1, 4000, 16, 8, 128, torch.bfloat16, 132)
    assert (b["kv_tile"], b["stages"], b["items"], b["blocks"],
            b["smem_bytes"]) == (128, 3, 512, 132, 230_488)
    c = flash_plan(2, 32768, 16, 8, 128, torch.bfloat16, 132)
    assert (c["items"], c["blocks"], c["smem_bytes"]) == (8192, 132, 230_488)
    d = flash_plan(2, 32768, 24, 24, 64, torch.bfloat16, 132)
    assert (d["kv_tile"], d["stages"], d["items"], d["smem_bytes"]) == \
        (128, 4, 12_288, 148_592)
    assert flash_plan(1, 4000, 16, 8, 128, torch.bfloat16, 114)["blocks"] \
        == 114
    assert flash_plan(1, 13, 4, 2, 128, torch.bfloat16, 132)["blocks"] == 4
    f = flash_plan(1, 6000, 16, 1, 256, torch.float32, 132)
    assert (f["rows_per_block"], f["kv_tile"], f["stages"], f["items"],
            f["blocks"], f["smem_bytes"]) == (64, 16, 1, 1504, 132, 230_472)
    f = flash_plan(1, 4000, 16, 8, 128, torch.float32, 132)
    assert (f["rows_per_block"], f["kv_tile"], f["stages"], f["items"],
            f["smem_bytes"]) == (128, 32, 2, 512, 230_512)
    f = flash_plan(2, 32768, 24, 24, 64, torch.float32, 132)
    assert (f["kv_tile"], f["stages"], f["smem_bytes"]) == (64, 2, 197_744)


def _live_keys(tile, S, window):
    """Keys of the last query row of query tile ``tile`` (128 rows) under
    the causal mask and the window: the most a row of the item reads."""
    last = min(S, (tile + 1) * 128) - 1
    return min(last + 1, window) if window else last + 1


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 3), S=st.integers(1, 3000), K=st.integers(1, 4),
       G=st.integers(1, 8), window=st.sampled_from([0, 1, 100, 700, 2048]),
       sms=st.integers(1, 140))
def test_flash_work_order_covers_every_item_once_longest_first(B, S, K, G,
                                                               window,
                                                               sms):
    """The bf16 plan's persistent blocks walk every (query tile, head,
    batch row) exactly once; each block's items come longest first (the
    live keys of an item's last row never grow along a block's walk),
    and every round hands out the longest items left: no block starts an
    item shorter than one another block has yet to start."""
    H = K * G
    plan = flash_plan(B, S, H, K, 128, torch.bfloat16, sms)
    walks = [flash_block_items(plan, j, B, S, H)
             for j in range(plan["blocks"])]
    items = [it for walk in walks for it in walk]
    n_qt = -(-S // 128)
    assert sorted(items) == sorted((t, h, b) for t in range(n_qt)
                                   for h in range(H) for b in range(B))
    for walk in walks:
        keys = [_live_keys(t, S, window) for t, _, _ in walk]
        assert keys == sorted(keys, reverse=True)
    rounds = max(len(w) for w in walks)
    for r in range(rounds - 1):
        now = [_live_keys(w[r][0], S, window) for w in walks if len(w) > r]
        later = [_live_keys(w[r + 1][0], S, window) for w in walks
                 if len(w) > r + 1]
        assert min(now) >= max(later)


@settings(max_examples=100, deadline=None)
@given(B=st.integers(1, 3), S=st.integers(1, 3000), K=st.integers(1, 4),
       G=st.integers(1, 8), D=st.sampled_from([40, 64, 128, 256]),
       sms=st.integers(1, 140))
def test_flash_float32_work_order_covers_every_item_once(B, S, K, G, D,
                                                         sms):
    """The float32 plan's persistent blocks (at most the SMs, at most one
    an item) walk every (query tile, head, batch row) exactly once, over
    its own query tiles: 128 rows up to D 128, 64 above."""
    H = K * G
    plan = flash_plan(B, S, H, K, D, torch.float32, sms)
    rows = plan["rows_per_block"]
    assert rows == (128 if D <= 128 else 64)
    assert 1 <= plan["blocks"] <= min(sms, plan["items"])
    items = [it for j in range(plan["blocks"])
             for it in flash_block_items(plan, j, B, S, H)]
    assert sorted(items) == sorted((t, h, b) for t in range(-(-S // rows))
                                   for h in range(H) for b in range(B))


@pytest.mark.parametrize("D", range(8, MAX_HEAD_DIM + 1, 8))
def test_float32_prefill_plans_fit_shared_memory(D):
    """The float32 prefill-chunk plan of every head dim the wrapper takes:
    an instantiation at least as wide, whose block fits the H100's
    232,448 B (each consumer's q_lo, and q_hi above D 128; two raw V
    tiles; the stages' four tf32 tiles; the plan; 5 barriers a stage;
    16 bytes of the stages' valid tokens),
    one block an SM at most, 64-row merge groups above D 128."""
    plan = prefill_unit_plan(512, 16, 8, D, 191, 16, H100_SMS,
                             torch.float32)
    dmax, tile, stages = plan["dmax"], plan["kv_tile"], plan["stages"]
    wgs = plan["warpgroups"]
    assert D <= dmax <= MAX_HEAD_DIM and dmax in (64, 128, 256)
    assert plan["rows_per_block"] == 64 * wgs == (128 if D <= 128 else 64)
    q_halves = 1 if dmax <= 128 else 2
    assert plan["smem_bytes"] == (1024 + wgs * q_halves * 64 * dmax * 4
                                  + (2 + 4 * stages) * tile * dmax * 4
                                  + 16 + 8 * (2 * 2 + 5 * stages) + 16)
    assert plan["smem_bytes"] <= SMEM_PER_SM
    assert plan["blocks"] <= H100_SMS and plan["unit_tokens"] == tile
    assert plan["route"].startswith("wgmma 3xTF32")


@pytest.mark.parametrize("args", [
    (512, 16, 8, 128, 191, 16),      # the main shape
    (512, 24, 24, 64, 191, 16),      # musicgen's heads (D 64)
    (33, 8, 2, 256, 23, 64),         # D 256: 64-row groups, 16-token units
    (512, 16, 8, 128, 24, 128),      # 128-token blocks
    (40, 8, 2, 40, 73, 24),          # bs 24, D 40
])
def test_float32_prefill_unit_plans_cover_every_valid_token_once(args):
    """The float32 kernel's plan (its units: the 64-, 32- or 16-token
    tile of its instantiation), over tails 1..bs: every valid token lies
    in exactly one unit of each group, in order, and no block walks more
    than ceil(units / blocks) units."""
    C, H, K, D, MB, bs = args
    plan = prefill_unit_plan(C, H, K, D, MB, bs, H100_SMS, torch.float32)
    for tail in range(1, bs + 1):
        S = np.array([(MB - 1) * bs + tail])
        up, spans, walks = _segment_spans(plan, S)
        B = min(plan["blocks"], max(up["T"], 1))
        assert max(walks) <= -(-up["T"] // B)
        assert sum(walks) == up["T"] == plan["head_groups"] * -(
            -S[0] // plan["unit_tokens"])
        for g in range(plan["head_groups"]):
            got = sorted(spans.get((g, 0), []))
            ends = [0] + [hi for _, hi in got]
            assert [lo for lo, _ in got] == ends[:-1] and ends[-1] == S[0]


def test_float32_prefill_unit_partials_merge_to_the_unsplit_twin():
    """The float32 kernel's plan at D 256 (64-row merge groups, 16-token
    units) on a small card (5 SMs: groups split over blocks): the plain
    twin over each segment's tokens, a group's segments LSE-merged ==
    the unsplit plain twin."""
    rng = np.random.default_rng(31)
    C, K, G, D, bs, MB, nblk = 70, 2, 2, 256, 16, 16, 11
    q, pk, pv = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 for shape in ((C, K * G, D), (nblk + 2, bs, K, D),
                               (nblk + 2, bs, K, D)))
    table = -np.ones((MB,), np.int32)
    table[:nblk] = rng.permutation(nblk + 2)[:nblk]
    table = torch.from_numpy(table)
    tail = torch.tensor(7, dtype=torch.int32)
    plan = prefill_unit_plan(C, K * G, K, D, MB, bs, 5, torch.float32)
    nrt = plan["head_groups"] // K
    assert plan["rows_per_block"] == 64 and nrt == 3

    def rows_of(g):
        kh, rt = divmod(g, nrt)
        mask = torch.zeros((C, K * G), dtype=torch.bool)
        for gr in range(rt * 64, min((rt + 1) * 64, C * G)):
            mask[gr // G, kh * G + gr % G] = True
        return mask
    got = _merged_over_units("prefill", plan, q, pk, pv, table, tail,
                             [(nblk - 1) * bs + 7], rows_of)
    want = paged_prefill_attention_plain(q, pk, pv, table, tail,
                                         scale=D ** -0.5)
    _close(got, want, F32_TOL)


# ------------------------------------------------------------------ #
# Flash prefill (causal, optionally sliding-window)
# ------------------------------------------------------------------ #
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _flash_inputs(seed, B, S, H, K, D, dtype):
    rng = np.random.default_rng(seed)
    return [_arrays(rng, shape, dtype)
            for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]


@pytest.mark.parametrize("B,S,H,K,D", [
    (1, 128, 4, 4, 16),      # MHA
    (2, 256, 8, 2, 32),      # GQA
    (1, 200, 4, 1, 112),     # MQA, ragged seq, unaligned head dim
    (1, 64, 3, 3, 8),        # odd head count
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_ref(B, S, H, K, D, dtype):
    """The plain twin and the CPU dispatch of ``ops.flash_prefill``
    against the Pallas kernel (interpret mode) and ``ref.py``, on the
    JAX package's flash-prefill sweep."""
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B * S + D, B, S, H, K, D,
                                                 dtype)
    pallas = jax_flash_prefill(qj, kj, vj, bq=64, bk=64, interpret=True)
    want = jax_ref.flash_prefill_ref(qj, kj, vj)
    plain = flash_prefill_plain(qt, kt, vt, scale=D ** -0.5)
    ops.reset_counts()
    got = ops.flash_prefill(qt, kt, vt)
    assert ops.counts()["flash_prefill"] == {
        "launches": 0, "plain_calls": 1, "float32_launches": 0}
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, S, H, D)
    assert torch.equal(got, plain)
    tol = FLASH_TOL[dtype]
    _close([got.float()], [pallas], tol)
    _close([got.float()], [want], tol)


@pytest.mark.parametrize("S,window", [
    (128, 16), (128, 64),    # the JAX package's sliding-window cases
    (150, 64),               # S not a multiple of the 64-token tile
    (150, 300),              # a window longer than the prompt
])
def test_flash_plain_sliding_window_matches_pallas_and_ref(S, window):
    B, H, K, D = 1, 4, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(S + window, B, S, H, K, D,
                                                 "float32")
    pallas = jax_flash_prefill(qj, kj, vj, window=window, bq=32, bk=32,
                               interpret=True)
    want = jax_ref.flash_prefill_ref(qj, kj, vj, window=window)
    got = ops.flash_prefill(qt, kt, vt, window=window)
    _close([got], [pallas], FLASH_TOL["float32"])
    _close([got], [want], FLASH_TOL["float32"])
    if window >= S:   # the window never binds: plain causal attention
        _close([got], [ops.flash_prefill(qt, kt, vt)], 0.0)
