"""The rank kernels' merged forms and their work plan, on the CPU.

The merged rank forms (``kernels.ops.paged_*_attention_ranks_merged``:
one launch over a stack of rank pools, the ranks' partials LSE-merged in
the launch) are held, through their plain twins, against the JAX
package's rank forms (``repro.kernels.ops.paged_micro_attention_ranks``
/ ``paged_prefill_attention_ranks``, a vmap of the Pallas kernel over the
rank axis, with ``backend="jnp"`` and in interpret mode) followed by its
``merge_partials``: one to four ranks, empty ranks, 16- and 128-token
blocks, float32, 1e-5 (the same float32 sums in another order).

The rank kernels plan their work on the card from the tables
(``csrc/paged_attn.cuh``); ``kernels/rank_units.py`` is that plan on the
host. A hypothesis test holds it to its properties over random tables;
an emulation runs it with plain partials over each block's units and
holds the merged and stacked results to the plain twins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.online_softmax import merge_partials as jax_merge_partials
from repro.kernels.ops import \
    paged_micro_attention_ranks as jax_paged_decode_ranks
from repro.kernels.ops import \
    paged_prefill_attention_ranks as jax_paged_prefill_ranks
from repro_torch.core.online_softmax import (_masked_softmax_parts, combine,
                                             empty_partial, merge_partials)
from repro_torch.kernels import ops, rank_units
from repro_torch.kernels.micro_attn_decode import (
    paged_micro_attention_ranks_merged_plain,
    paged_micro_attention_ranks_plain)
from repro_torch.kernels.micro_attn_prefill import (
    paged_prefill_attention_ranks_merged_plain,
    paged_prefill_attention_ranks_plain)

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

RANK_TOL = 1e-5


def _rank_tables(rng, NR, R, MB, bs, NB, empty):
    """Tables [NR, R, MB] over disjoint random blocks of each rank's pool
    (valid slots a prefix, 0..MB of them) and tails [NR, R]; the ranks in
    ``empty`` hold nothing."""
    tables = -np.ones((NR, R, MB), np.int32)
    tails = np.full((NR, R), bs, np.int32)
    for k in range(NR):
        if k in empty:
            continue
        perm, used = rng.permutation(NB), 0
        for r in range(R):
            n = min(int(rng.integers(0, MB + 1)), NB - used)
            tables[k, r, :n] = perm[used:used + n]
            used += n
            if n:
                tails[k, r] = rng.integers(1, bs + 1)
    return tables, tails


def _pools(rng, NR, NB, bs, K, D):
    """A layer's (strided) view of a global pool [NR, 2, NB, bs, K, D], as
    numpy (for JAX) and torch."""
    g = rng.standard_normal((2, NR, 2, NB, bs, K, D)).astype(np.float32)
    return (g[0][:, 1], g[1][:, 1], torch.from_numpy(g[0])[:, 1],
            torch.from_numpy(g[1])[:, 1])


def _close(got, want, tol=RANK_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("NR,empty", [(1, ()), (2, (1,)), (3, (0, 2)),
                                      (4, (2,))])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_merged_rank_twins_match_jax_ranks_then_merge(backend, NR, empty,
                                                      bs):
    """Both merged rank forms' plain twins == the JAX package's vmapped
    rank forms merged over the rank axis, on a strided layer view of a
    global pool with empty ranks; a request with no block on any rank
    gives (0, -inf, 0)."""
    NB, K, G, D, R, C = 12, 2, 2, 32, 3, 5
    MB = 3 if bs == 128 else 5
    H = K * G
    rng = np.random.default_rng(100 * NR + bs)
    pk_j, pv_j, pk, pv = _pools(rng, NR, NB, bs, K, D)
    tables, tails = _rank_tables(rng, NR, R, MB, bs, NB, empty)
    tables[:, 2] = -1                     # request 2: no block anywhere
    q = rng.standard_normal((R, H, D)).astype(np.float32)
    qc = rng.standard_normal((C, H, D)).astype(np.float32)
    tb, tl = torch.from_numpy(tables), torch.from_numpy(tails)
    scale = D ** -0.5
    got = paged_micro_attention_ranks_merged_plain(
        torch.from_numpy(q), pk, pv, tb, tl, scale=scale)
    want = jax_merge_partials(*jax_paged_decode_ranks(
        jnp.asarray(q), jnp.asarray(pk_j), jnp.asarray(pv_j),
        jnp.asarray(tables), jnp.asarray(tails), backend=backend), axis=0)
    assert got[0].shape == (R, H, D)
    _close(got, want)
    assert bool(torch.isneginf(got[1][2]).all())
    assert float(got[0][2].abs().sum()) == 0.0 == float(got[2][2].sum())
    got = paged_prefill_attention_ranks_merged_plain(
        torch.from_numpy(qc), pk, pv, tb[:, 0], tl[:, 0], scale=scale)
    want = jax_merge_partials(*jax_paged_prefill_ranks(
        jnp.asarray(qc), jnp.asarray(pk_j), jnp.asarray(pv_j),
        jnp.asarray(tables[:, 0]), jnp.asarray(tails[:, 0]),
        backend=backend), axis=0)
    assert got[0].shape == (C, H, D)
    _close(got, want)


def test_merged_wrappers_take_the_plain_path_on_the_cpu():
    """On CPU tensors the merged wrappers run their plain twins (counted),
    which equal merge_partials of the stacked wrappers."""
    rng = np.random.default_rng(3)
    _, _, pk, pv = _pools(rng, 3, 8, 16, 2, 16)
    tables, tails = _rank_tables(rng, 3, 2, 4, 16, 8, (1,))
    tb, tl = torch.from_numpy(tables), torch.from_numpy(tails)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    ops.reset_counts()
    for merged, stacked, t, tt in (
            (ops.paged_micro_attention_ranks_merged,
             ops.paged_micro_attention_ranks, tb, tl),
            (ops.paged_prefill_attention_ranks_merged,
             ops.paged_prefill_attention_ranks, tb[:, 0], tl[:, 0])):
        _close(merged(q, pk, pv, t, tt),
               merge_partials(*stacked(q, pk, pv, t, tt), axis=0), 0.0)
    c = ops.counts()
    for name in ("paged_micro_attention_ranks_merged",
                 "paged_prefill_attention_ranks_merged",
                 "paged_micro_attention_ranks",
                 "paged_prefill_attention_ranks"):
        assert c[name] == {"launches": 0, "plain_calls": 1,
                           "float32_launches": 0}


# ------------------------------------------------------------------ #
# The work plan: units of valid tokens (kernels/rank_units.py)
# ------------------------------------------------------------------ #
@st.composite
def _plans(draw):
    NR = draw(st.integers(1, 4))
    R = draw(st.integers(1, 4))
    MB = draw(st.integers(0, 12))
    bs = draw(st.sampled_from([8, 16, 24, 128]))
    nv = draw(st.lists(st.integers(0, MB), min_size=NR * R,
                       max_size=NR * R))
    # Tails out of [0, bs] too: the kernels clamp them.
    tl = draw(st.lists(st.integers(-1, bs + 2), min_size=NR * R,
                       max_size=NR * R))
    tables = -np.ones((NR, R, max(MB, 1)), np.int32)[..., :MB]
    for i, n in enumerate(nv):
        tables[i // R, i % R, :n] = np.arange(n)
    tails = np.asarray(tl, np.int32).reshape(NR, R)
    U = draw(st.sampled_from([64, 128, 256]))
    HG = draw(st.integers(1, 3))
    B = draw(st.integers(1, 40))
    stacked = draw(st.booleans())
    return tables, tails, bs, U, HG, B, stacked


@settings(max_examples=300, deadline=None)
@given(_plans())
def test_units_cover_every_valid_token_once(case):
    """Every valid token of every (rank, request) pair lies in exactly one
    unit of each merge group that reads the pair; no unit passes the
    pair's tail or holds more than U tokens; an empty pair has no unit;
    a group's partials come from consecutive blocks, one a block, each
    stored in its own scratch slot (none when the group has one)."""
    tables, tails, bs, U, HG, B, stacked = case
    NR, R = tables.shape[:2]
    S = rank_units.pair_tokens(tables, tails, bs)
    want_S = np.array([[0 if not (tables[k, r] >= 0).any() else
                        (int((tables[k, r] >= 0).sum()) - 1) * bs
                        + min(max(int(tails[k, r]), 0), bs)
                        for r in range(R)] for k in range(NR)])
    assert (S == want_S).all()
    plan = rank_units.unit_plan(S, U, HG, stacked)
    segs = rank_units.all_segments(plan, B)
    covered = {}                      # (g, k, r) -> [(lo, hi)]
    by_group = {}
    for seg in segs:
        by_group.setdefault(seg["g"], []).append(seg)
        for k, j, lo, hi in seg["units"]:
            assert 0 <= lo < hi <= S[k, seg["r"]] and hi - lo <= U
            assert lo == j * U
            covered.setdefault((seg["g"], k, seg["r"]), []).append((lo, hi))
    P = NR * R if stacked else R
    for rho in range(P):
        r, ranks = (rho % R, [rho // R]) if stacked else (rho, range(NR))
        for h in range(HG):
            g = rho * HG + h
            for k in ranks:
                spans = sorted(covered.get((g, k, r), []))
                if S[k, r] == 0:
                    assert not spans
                    continue
                ends = [0] + [hi for _, hi in spans]
                assert [lo for lo, _ in spans] == ends[:-1]
                assert ends[-1] == S[k, r]
            parts = by_group.get(g, [])
            if not any(S[k, r] for k in ranks):
                assert not parts
                continue
            blocks = [p["b"] for p in parts]
            assert blocks == list(range(parts[0]["first"],
                                        parts[0]["first"] + len(parts)))
            assert all(p["parts"] == len(parts) for p in parts)
    slots = [s["slot"] for s in segs if s["slot"] is not None]
    assert len(slots) == len(set(slots))
    assert all(0 <= s < B + P * HG for s in slots)
    assert sum(len(s["units"]) for s in segs) == plan["T"]


def _partial(q, kk, vv, scale):
    """Plain partial of q [N,H,D] over keys kk/vv [n,K,D] (all valid)."""
    N, H, D = q.shape
    K = kk.shape[1]
    s = torch.einsum("nkgd,skd->nkgs", q.reshape(N, K, H // K, D),
                     kk) * scale
    m, p, l = _masked_softmax_parts(s, torch.ones_like(s, dtype=torch.bool))
    o = torch.einsum("nkgs,skd->nkgd", p, vv)
    return o.reshape(N, H, D), m.reshape(N, H), l.reshape(N, H)


def _box_rows(pool, tables, unit, bs, tile):
    """A unit's K or V rows as its producer loads them, tile by tile: the
    TMA boxes of ``rank_units.segment_boxes`` (rank, block, offset, rows)
    cut from rank k's pool, the rows past each tile's valid tokens
    dropped (the kernels score them -inf and zero their V rows)."""
    rows = []
    for tl in rank_units.segment_boxes(tables, bs, [unit], tile):
        got = torch.cat([pool[k][blk, off:off + n]
                         for k, blk, off, n in tl["boxes"]])
        assert got.shape[0] >= tl["valid"]
        rows.append(got[:tl["valid"]])
    assert sum(r.shape[0] for r in rows) == unit[3] - unit[2]
    return torch.cat(rows)


def _emulate(kind, q, pk, pv, tables, tails, *, U, B, stacked, scale,
             rows_per_block=None, boxes=False, tile=None):
    """The paged kernels' decomposition with plain partials: each block's
    segments (the online softmax over a segment's units = combine of the
    units' partials), stored to its scratch slot or straight out, and
    each group's slots merged by ``merge_partials``; groups with no unit
    are (0, -inf, 0). ``rows_per_block``: a prefill group's rows, or a
    decode group's query heads (default: every head of a kv head, up to
    16, as the kernel on the tensor cores). ``boxes``: each unit's K/V
    rebuilt from its TMA boxes (``_box_rows``, tiles of ``tile`` tokens:
    default the unit), checked equal to the gathered rows. Returns
    stacked or merged (o, m, l)."""
    NR, _, bs, K, D = pk.shape
    decode = kind == "decode"
    N = 1 if decode else q.shape[0]       # query rows a request
    R = tables.shape[1] if decode else 1
    H = q.shape[1]
    G = H // K
    if decode:
        gt = rows_per_block or min(G, 16)
        ngr = -(-G // gt)
        HG = K * ngr
    else:
        nrt = -(-(N * G) // rows_per_block)
        HG = K * nrt
    tb = tables if decode else tables[:, None]
    tl = tails if decode else tails[:, None]
    S = rank_units.pair_tokens(tb.numpy(), tl.numpy(), bs)
    plan = rank_units.unit_plan(S, U, HG, stacked)
    P = plan["P"]

    def rows_of(h):                       # the group's (row, head) mask
        mask = torch.zeros((N, H), dtype=torch.bool)
        if decode:
            kh, grp = divmod(h, ngr)
            mask[:, kh * G + grp * gt:kh * G + min(G, (grp + 1) * gt)] = True
        else:
            kh, rt = divmod(h, nrt)
            for gr in range(rt * rows_per_block,
                            min((rt + 1) * rows_per_block, N * G)):
                mask[gr // G, kh * G + gr % G] = True
        return mask

    out = [empty_partial((P, N, H, D), (P, N, H), device="cpu")]
    out = list(out[0])
    slots = {}
    for seg in rank_units.all_segments(plan, B):
        r = seg["r"]
        qr = q[r:r + 1] if decode else q
        part = None
        for k, j, lo, hi in seg["units"]:
            t = torch.arange(lo, hi)
            blk = tb[k, r, t // bs].long()
            assert bool((blk >= 0).all())
            kk, vv = pk[k][blk, t % bs], pv[k][blk, t % bs]
            if boxes:
                unit = (k, j, lo, hi)
                assert torch.equal(_box_rows(pk, tb[:, r].numpy(), unit, bs,
                                             tile or U), kk)
                assert torch.equal(_box_rows(pv, tb[:, r].numpy(), unit, bs,
                                             tile or U), vv)
            p = _partial(qr.float(), kk.float(), vv.float(), scale)
            part = p if part is None else combine(part, p)
        if seg["parts"] > 1:
            assert seg["slot"] not in slots
            slots[seg["slot"]] = part
        else:
            mask = rows_of(seg["h"])
            for x, y in zip(out, part):
                x[seg["rho"]][mask] = y[mask]
    for g in range(P * HG):
        rho, h = divmod(g, HG)
        segs = [s for s in rank_units.all_segments(plan, B) if s["g"] == g]
        if len(segs) > 1:
            first = segs[0]["first"]
            parts = [slots.pop(first + i + g) for i in range(len(segs))]
            merged = merge_partials(*(torch.stack(x) for x in zip(*parts)),
                                    axis=0)
            mask = rows_of(h)
            for x, y in zip(out, merged):
                x[rho][mask] = y[mask]
    assert not slots
    if decode:
        lead = (NR, R) if stacked else (R,)
        return tuple(x.reshape(*lead, *x.shape[2:]) for x in out)
    return tuple(x if stacked else x[0] for x in out)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kind,G,bs,U,B,rows", [
    ("decode", 2, 16, 64, 7, None),       # GQA: two query heads a block
    ("decode", 1, 8, 64, 40, None),       # MHA, more blocks than units
    ("decode", 3, 128, 256, 3, None),     # G 3: three query heads a block
    ("prefill", 2, 16, 64, 5, 8),         # 3 row tiles a kv head
    ("prefill", 1, 24, 64, 11, 16),       # bs 24 does not divide a tile
    ("prefill", 2, 128, 64, 2, 64),       # 128-token blocks in place
])
def test_unit_plan_partials_merge_to_the_plain_twins(kind, G, bs, U, B,
                                                     rows, stacked):
    """The decomposition the rank kernels run — each block's segments,
    their partials stored to scratch slots, each group's last arrival
    merging them — gives the plain twins' stacked and merged partials
    (three ranks: one empty, requests spread unevenly, one empty)."""
    rng = np.random.default_rng(hash((kind, G, bs)) % 2 ** 32)
    NR, K, D, NB = 3, 2, 16, 40
    H = K * G
    MB = 6 if bs == 128 else 30
    _, _, pk, pv = _pools(rng, NR, NB, bs, K, D)
    tables, tails = _rank_tables(rng, NR, 3, MB, bs, NB, (1,))
    tables[:, 1] = -1
    tables[0, 0, :MB - 1] = rng.permutation(NB)[:MB - 1]
    tables[0, 0, MB - 1:] = -1
    tb, tl = torch.from_numpy(tables), torch.from_numpy(tails)
    scale = D ** -0.5
    if kind == "decode":
        q = torch.from_numpy(rng.standard_normal((3, H, D))
                             .astype(np.float32))
        twin = (paged_micro_attention_ranks_plain if stacked
                else paged_micro_attention_ranks_merged_plain)
        want = twin(q, pk, pv, tb, tl, scale=scale)
        got = _emulate(kind, q, pk, pv, tb, tl, U=U, B=B, stacked=stacked,
                       scale=scale)
    else:
        q = torch.from_numpy(rng.standard_normal((13, H, D))
                             .astype(np.float32))
        twin = (paged_prefill_attention_ranks_plain if stacked
                else paged_prefill_attention_ranks_merged_plain)
        want = twin(q, pk, pv, tb[:, 0], tl[:, 0], scale=scale)
        got = _emulate(kind, q, pk, pv, tb[:, 0], tl[:, 0], U=U, B=B,
                       stacked=stacked, scale=scale, rows_per_block=rows)
    assert got[0].shape == want[0].shape
    assert torch.equal(torch.isneginf(got[1]), torch.isneginf(want[1]))
    _close(got, want)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("tile,rows,bs", [
    (128, 128, 16),   # bf16 up to D 128 (16-token boxes)
    (64, 128, 24),    # bf16 at D 256, float32 at D 64 (8-token boxes)
    (32, 128, 8),     # float32 at D 128
    (16, 64, 128),    # float32 at D 256 (a box a tile of a 128-token block)
])
def test_hopper_prefill_box_walk_matches_jax_ranks(tile, rows, bs, stacked):
    """The Hopper prefill kernels' rank form, emulated at each
    instantiation's unit (one tile) and merge-group rows over four ranks
    of a strided layer view (one empty, one short of a tile, uneven
    prefixes, partial tails): every block's segments walked unit by unit,
    rank by rank, each unit's K/V rebuilt from the TMA boxes its producer
    issues (``rank_units.segment_boxes``: the (rank, block, offset, rows)
    of one rank's pool) equal to that rank's gathered prefix, every valid
    token in one unit of each group; the partials, combined along a
    segment and merged per group as the last arrival does, equal the JAX
    package's ``paged_prefill_attention_ranks`` (a vmap of the Pallas
    kernel, ``jnp`` backend), merged by its ``merge_partials`` unless
    stacked."""
    rng = np.random.default_rng(tile * 7 + bs)
    NR, K, G, D, C, NB = 4, 2, 2, 16, 9, 40
    MB = 3 if bs == 128 else 24
    pk_j, pv_j, pk, pv = _pools(rng, NR, NB, bs, K, D)
    tables = -np.ones((NR, 1, MB), np.int32)
    tails = np.full((NR, 1), bs, np.int32)
    for k, n in enumerate([MB // 2 + 1, MB - 1, 0, 1]):  # rank 2 empty
        tables[k, 0, :n] = rng.permutation(NB)[:n]
        tails[k, 0] = rng.integers(1, bs + 1) if n else bs
    tails[3, 0] = 5                     # rank 3: short of a tile
    tb, tl = torch.from_numpy(tables[:, 0]), torch.from_numpy(tails[:, 0])
    q = rng.standard_normal((C, K * G, D)).astype(np.float32)
    scale = D ** -0.5
    S = rank_units.pair_tokens(tables, tails, bs)
    assert S[2, 0] == 0 and 0 < S[3, 0] < tile and S.sum() > 2 * tile
    got = _emulate("prefill", torch.from_numpy(q), pk, pv, tb, tl, U=tile,
                   B=5, stacked=stacked, scale=scale, rows_per_block=rows,
                   boxes=True)
    want = jax_paged_prefill_ranks(
        jnp.asarray(q), jnp.asarray(pk_j), jnp.asarray(pv_j),
        jnp.asarray(tables[:, 0]), jnp.asarray(tails[:, 0]), backend="jnp")
    if not stacked:
        want = jax_merge_partials(*want, axis=0)
    assert got[0].shape == tuple(want[0].shape)
    _close(got, want)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("tile,U,G,heads,bs", [
    (64, 256, 2, 2, 16),    # bf16 (D 128 or 256): 64-token tiles, G heads
    (64, 64, 12, 12, 8),    # bf16 at a halved unit (one tile), G 12, bs 8
    (32, 256, 1, 1, 24),    # float32 at D 128, MHA, bs 24 (8-token boxes)
    (16, 256, 6, 4, 128),   # float32 at D 256: 4 heads a block, 128-token
])                          # blocks (a box a tile)
def test_hopper_decode_box_walk_matches_jax_ranks(tile, U, G, heads, bs,
                                                  stacked):
    """The decode kernel's rank form, emulated at each instantiation's
    tile, unit and heads a block over four ranks of a strided layer view
    (one empty, one-token tails, uneven tables): every block's segments
    walked unit by unit, rank by rank, a unit's K/V rebuilt from the TMA
    boxes its producer issues tile by tile (``rank_units.segment_boxes``:
    the (rank, block, offset, rows) of one rank's pool, each tile's valid
    tokens) equal to that pair's gathered tokens; in the merged form some
    segment goes on from one rank to the next, so a partial tile ends a
    unit inside it. The partials, combined along a segment and merged per
    group as the last arrival does, equal the JAX package's
    ``paged_micro_attention_ranks`` (a vmap of the Pallas kernel, ``jnp``
    backend), merged by its ``merge_partials`` unless stacked."""
    rng = np.random.default_rng(tile * 7 + bs + G)
    NR, K, D, R, NB, B = 4, 2, 16, 2, 40, 5
    MB = 4 if bs == 128 else 24
    pk_j, pv_j, pk, pv = _pools(rng, NR, NB, bs, K, D)
    tables = -np.ones((NR, R, MB), np.int32)
    tails = np.full((NR, R), bs, np.int32)
    for k, row in enumerate([[MB // 2 + 1, 1], [MB - 1, 0], [0, 0],
                             [1, MB // 3]]):   # rank 2 empty
        perm, used = rng.permutation(NB), 0
        for r, n in enumerate(row):
            tables[k, r, :n] = perm[used:used + n]
            used += n
            tails[k, r] = rng.integers(1, bs + 1) if n else bs
    tails[0, 1] = tails[3, 0] = 1          # one-token tails
    tb, tl = torch.from_numpy(tables), torch.from_numpy(tails)
    q = rng.standard_normal((R, K * G, D)).astype(np.float32)
    scale = D ** -0.5
    S = rank_units.pair_tokens(tables, tails, bs)
    assert S[2].sum() == 0 and S[0, 1] == S[3, 0] == 1
    HG = K * -(-G // heads)
    plan = rank_units.unit_plan(S, U, HG, stacked)
    tiles = [t for seg in rank_units.all_segments(plan, B)
             for t in rank_units.segment_boxes(tables[:, seg["r"]], bs,
                                               seg["units"], tile)]
    assert sum(t["last"] for t in tiles) == len(
        rank_units.all_segments(plan, B))
    assert stacked or any(t["valid"] < tile and not t["last"]
                          for t in tiles)
    got = _emulate("decode", torch.from_numpy(q), pk, pv, tb, tl, U=U, B=B,
                   stacked=stacked, scale=scale, rows_per_block=heads,
                   boxes=True, tile=tile)
    want = jax_paged_decode_ranks(
        jnp.asarray(q), jnp.asarray(pk_j), jnp.asarray(pv_j),
        jnp.asarray(tables), jnp.asarray(tails), backend="jnp")
    if not stacked:
        want = jax_merge_partials(*want, axis=0)
    assert got[0].shape == tuple(want[0].shape)
    _close(got, want)


@settings(max_examples=200, deadline=None)
@given(_plans(), st.sampled_from([16, 32, 64]), st.integers(0, 600))
def test_card_unit_halves_while_the_units_are_few(case, tile, min_units):
    """The unit a rank decode plan takes on the card
    (``rank_units.card_unit``, ``plan_units``' ``min_units``): the host's
    unit halved, never below the tile, and only while the valid tokens
    make fewer than ``min_units`` units; so it stops at the tile or at
    the first unit that makes enough. ``min_units`` 0 keeps the host's
    unit (the single-rank form)."""
    tables, tails, bs, U, HG, _, _ = case
    S = rank_units.pair_tokens(tables, tails, bs)
    U = max(U, tile)

    def units(u):
        return HG * int((-(-S // u)).sum())
    got = rank_units.card_unit(S, U, tile, HG, min_units)
    assert tile <= got <= U and U % got == 0 and got % tile == 0
    assert rank_units.card_unit(S, U, tile, HG, 0) == U
    if got < U:
        assert units(2 * got) < min_units
    assert got == tile or units(got) >= min_units or min_units == 0


def test_card_unit_at_the_rank_decode_shapes():
    """At ``chip_smoke.py``'s rank decode shapes, the unit each plan's
    kernel takes on the card (``rank_decode_plan``'s ``min_units``): the
    qwen2-moe global main shape keeps 256 tokens merged (bf16: 304 units
    for 256 blocks; float32: 384 blocks at one head, a quarter unit a
    head each) and halves to one 64-token tile stacked in bf16; starcoder2's
    G 12 in float32 (4 heads a block, 264 blocks) halves to 128; the mesh
    path's NR 1 slab in float32 to 64; long_500k keeps 256."""
    from repro_torch.kernels.micro_attn_decode import rank_decode_plan
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ((4, 16, 16, 128, 256, 16), 3, [[63, 38, 0, 0], [160, 0, 0, 0],
                                        [27, 0, 0, 0]],
         {(bf16, False): 256, (bf16, True): 64, (f32, False): 256}),
        ((2, 48, 4, 128, 128, 16), 4, [[0, 0], [100, 2], [0, 0], [7, 60]],
         {(bf16, False): 256, (f32, False): 128, (f32, True): 128}),
        ((4, 16, 8, 128, 256, 16), 1, [[90, 0, 12, 0]],
         {(bf16, False): 256, (f32, False): 64}),
        ((1, 16, 8, 128, 1025, 128), 4, [[1024]] * 4,
         {(bf16, False): 256, (f32, False): 256}),
    ]
    for args, NR, nblks, want in cases:
        S = np.asarray(nblks) * args[-1]
        for (dt, stacked), U in want.items():
            plan = rank_decode_plan(*args, dt, 132, NR, stacked)
            assert rank_units.card_unit(
                S, plan["unit_tokens"], plan["tile_tokens"],
                plan["head_groups"], plan["min_units"]) == U


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_rank_prefill_plans_share_the_single_rank_instantiation(dtype, D):
    """``rank_prefill_plan`` at qwen2-moe's global shapes (a 512-query
    chunk, MHA 16, 256-slot tables of 16 tokens) over 1-8 ranks: the
    single-rank plan's tile, stages, rows and threads; groups, tickets
    and scratch slots times P; shared memory the single-rank layout's
    with the plan grown by the ranks, within the card's 232,448 bytes;
    the two blocks a merge group of the single-rank rule when merged.
    Past what the plan's shared memory holds it raises ValueError."""
    from repro_torch.kernels.micro_attn_prefill import (
        SMEM_PER_SM, plan_bytes, prefill_unit_plan, rank_prefill_plan)
    dt = getattr(torch, dtype)
    one = prefill_unit_plan(512, 16, 16, D, 256, 16, 132, dt)
    for NR in (1, 2, 3, 4, 8):
        for stacked in (False, True):
            P = NR if stacked else 1
            pl = rank_prefill_plan(512, 16, 16, D, 256, 16, dt, 132, NR,
                                   stacked)
            for key in ("kv_tile", "unit_tokens", "stages",
                        "rows_per_block", "threads", "head_groups"):
                assert pl[key] == one[key], key
            assert pl["groups"] == P * one["groups"]
            assert pl["ws_slots"] == pl["blocks"] + pl["groups"]
            assert pl["smem_bytes"] == (one["smem_bytes"] - plan_bytes(1, 1)
                                        + plan_bytes(NR, P)) <= SMEM_PER_SM
            if not stacked:
                assert pl["blocks"] == one["blocks"]
    with pytest.raises(ValueError, match="shared memory"):
        rank_prefill_plan(512, 16, 16, 128, 256, 16, dt, 132, 4096, True)
