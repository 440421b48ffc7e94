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

The design of the CUDA kernels is checked here before any run on the
card: the split plans and their merges, the flash-prefill plans, and the
bf16 precision contracts of the prefill-chunk and flash-prefill kernels,
emulated in plain PyTorch at their main shapes.

The kernels themselves need the card: ``tests/test_torch_cuda.py``
(no JAX, so it also runs on a machine without it) holds them against
these plain twins there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attention import full_attention_decode as jax_full_decode
from repro.kernels import ref as jax_ref
from repro.kernels.ops import flash_prefill as jax_flash_prefill
from repro.kernels.ops import paged_micro_attention as jax_paged_decode
from repro.kernels.ops import paged_prefill_attention as jax_paged_prefill
from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import (_masked_softmax_parts, combine,
                                             finalize)
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_prefill import (MAX_HEAD_DIM,
                                               flash_plan,
                                               flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels.micro_attn_decode import (
    MAX_SPLITS, MIN_SPLIT_TOKENS, decode_plan, paged_micro_attention_cuda,
    paged_micro_attention_plain, plan_splits)
from repro_torch.kernels.micro_attn_prefill import (
    SMEM_PER_SM, paged_prefill_attention_cuda, paged_prefill_attention_plain,
    prefill_plan)

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
    assert ops.counts() == {
        "paged_micro_attention": {"launches": 0, "plain_calls": 1},
        "paged_prefill_attention": {"launches": 0, "plain_calls": 1},
        "flash_prefill": {"launches": 0, "plain_calls": 1}}


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
# Split-KV plans and the bf16 prefill precision contract (the design of
# the CUDA kernels, checked before any run on the card)
# ------------------------------------------------------------------ #
H100_SMS = 132


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
    # prefill chunk: main shape, a short chunk, D 256, float32
    ("prefill", (512, 16, 8, 128, 191, 16, torch.bfloat16)),
    ("prefill", (37, 16, 8, 128, 191, 16, torch.bfloat16)),
    ("prefill", (33, 8, 2, 256, 23, 64, torch.bfloat16)),
    ("prefill", (512, 16, 8, 128, 191, 16, torch.float32)),
    # D % 16 == 8 (the padded reduction), the 64-wide build
    ("prefill", (50, 4, 2, 120, 133, 8, torch.bfloat16)),
    ("prefill", (40, 8, 2, 40, 73, 24, torch.bfloat16)),
])
def test_kernel_plans_cover_every_slot_once(kind, args):
    """A kernel's plan: split s reads the whole slots [s*spb, min((s+1)*
    spb, MB)); the runs tile [0, MB) exactly once, none empty, and the
    grid holds every work item once per split."""
    if kind == "decode":
        plan = decode_plan(*args, H100_SMS)
        MB, bs = args[3], args[4]
    else:
        plan = prefill_plan(*args, H100_SMS)
        MB, bs = args[4], args[5]
    nsplit, spb = plan["nsplit"], plan["slots_per_split"]
    assert plan["grid"][2] == nsplit
    assert plan["grid"][0] * plan["grid"][1] == plan["items"]
    runs = [range(s * spb, min((s + 1) * spb, MB)) for s in range(nsplit)]
    assert all(len(r) for r in runs)
    assert [j for r in runs for j in r] == list(range(MB))
    assert nsplit == 1 or MB * bs >= nsplit * MIN_SPLIT_TOKENS


@pytest.mark.parametrize("items,MB,bs,sms,per_sm", [
    (64, 259, 16, 132, 4), (32, 64, 16, 132, 4), (24, 64, 16, 132, 4),
    (128, 191, 16, 132, 2), (16, 191, 16, 132, 2), (4, 23, 64, 132, 1),
    (64, 1, 16, 132, 4), (1, 1000, 8, 132, 4), (1, 4096, 16, 132, 3),
    (3, 17, 16, 7, 3),
    (64, 0, 16, 132, 4),
])
def test_plan_splits_tiles_the_table_in_whole_slots(items, MB, bs, sms,
                                                    per_sm):
    nsplit, spb = plan_splits(items, MB, bs, sms, per_sm)
    covered = []
    for s in range(nsplit):
        run = list(range(s * spb, min((s + 1) * spb, MB)))
        assert run or MB == 0               # no empty split
        covered += run
    assert covered == list(range(MB))       # every slot once, in order
    if nsplit > 1:          # ~256 tokens a split, no more blocks than fit
        assert MB * bs >= nsplit * MIN_SPLIT_TOKENS
        assert nsplit * items <= per_sm * sms and nsplit <= MAX_SPLITS


def test_split_plans_fill_the_card_at_the_main_shapes():
    """The grids the kernels' headers state: decode 64 work items x 6
    splits (one wave of ~3 blocks per SM); prefill 64 items of 128 rows x
    4 splits, one wave of 2 per SM (D = 256: 64-row blocks, 1 per SM)."""
    dec = decode_plan(8, 16, 8, 259, 16, H100_SMS)
    assert dec["grid"] == (8, 8, 6) and dec["heads_per_block"] == 2
    assert 2 * H100_SMS <= 64 * dec["nsplit"] <= 3 * H100_SMS
    assert decode_plan(4, 16, 8, 259, 16, H100_SMS)["grid"] == (8, 4, 12)
    assert decode_plan(4, 16, 8, 64, 16, H100_SMS)["grid"] == (8, 4, 4)
    pre = prefill_plan(512, 16, 8, 128, 191, 16, torch.bfloat16, H100_SMS)
    assert pre["grid"] == (8, 8, 4)
    assert pre["rows_per_block"] == 128 and pre["blocks_per_sm"] == 2
    assert 64 * 4 <= 2 * H100_SMS and pre["smem_bytes"] == 105_432
    wide = prefill_plan(33, 8, 2, 256, 23, 64, torch.bfloat16, H100_SMS)
    assert wide["rows_per_block"] == 64 and wide["blocks_per_sm"] == 1
    assert prefill_plan(512, 16, 8, 128, 191, 16, torch.float32,
                        H100_SMS)["nsplit"] == 1


def _split_view(table, tail, bs, s0, s1):
    """The table slots [s0, s1) as a table of their own: the request's
    tail applies only in the split that holds its last valid slot."""
    last = (table >= 0).sum(dim=-1) - 1
    sub_tail = torch.where((last >= s0) & (last < s1), tail,
                           torch.full_like(tail, bs))
    return table[..., s0:s1].contiguous(), sub_tail


def _merged_over_splits(fn, q, pk, pv, table, tail, bs, nsplit, spb):
    MB = table.shape[-1]
    part = None
    for s in range(nsplit):
        tb, tl = _split_view(table, tail, bs, s * spb,
                             min((s + 1) * spb, MB))
        p = fn(q, pk, pv, tb, tl, scale=q.shape[-1] ** -0.5)
        part = p if part is None else combine(part, p)
    return part


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_partials_merge_to_the_unsplit_twin(dtype):
    """The decode kernel's split: the plain twin over each split's slots,
    LSE-merged with ``combine``, == the unsplit plain twin (an empty
    table, one shorter than a split, a tail in the last split)."""
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
    plan = decode_plan(R, K * G, K, MB, bs, H100_SMS)
    assert plan["nsplit"] == 4
    got = _merged_over_splits(paged_micro_attention_plain, q, pk, pv, table,
                              tail, bs, plan["nsplit"],
                              plan["slots_per_split"])
    want = paged_micro_attention_plain(q, pk, pv, table, tail,
                                       scale=D ** -0.5)
    _close(got, want, F32_TOL)
    assert bool(torch.isneginf(got[1][0]).all())


@pytest.mark.parametrize("nblk", [50, 7])
def test_prefill_split_partials_merge_to_the_unsplit_twin(nblk):
    """The bf16 prefill kernel's split of the prefix, the same way."""
    rng = np.random.default_rng(nblk)
    C, K, G, D, bs, MB = 5, 2, 2, 16, 16, 64
    _, q = _arrays(rng, (C, K * G, D), "bfloat16")
    _, pk = _arrays(rng, (nblk + 2, bs, K, D), "bfloat16")
    _, pv = _arrays(rng, (nblk + 2, bs, K, D), "bfloat16")
    table = -np.ones((MB,), np.int32)
    table[:nblk] = rng.permutation(nblk + 2)[:nblk]
    table = torch.from_numpy(table)
    tail = torch.tensor(9, dtype=torch.int32)
    plan = prefill_plan(C, K * G, K, D, MB, bs, torch.bfloat16, H100_SMS)
    assert plan["nsplit"] == 4
    got = _merged_over_splits(paged_prefill_attention_plain, q, pk, pv,
                              table, tail, bs, plan["nsplit"],
                              plan["slots_per_split"])
    want = paged_prefill_attention_plain(q, pk, pv, table, tail,
                                         scale=D ** -0.5)
    _close(got, want, F32_TOL)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [40, 64, 112, 120, 128, 256])
def test_flash_plans_fit_shared_memory_and_cover_the_head_dim(D, dtype):
    """Every head dim the wrapper takes has an instantiation at least as
    wide, whose block fits the H100's 232,448 B of shared memory; bf16
    blocks own 128 rows, whose float32 output accumulator stays at 128
    registers a thread; the grid covers every (query tile, head, row)."""
    B, S, H, K = 2, 6000, 16, 1
    plan = flash_plan(B, S, H, K, D, dtype)
    assert D <= plan["dmax"] <= MAX_HEAD_DIM
    assert plan["smem_bytes"] <= SMEM_PER_SM
    assert plan["warps"] * plan["rows_per_warp"] == plan["rows_per_block"]
    n_qt = -(-S // plan["rows_per_block"])
    assert np.prod(plan["grid"]) == n_qt * H * B
    if dtype == torch.bfloat16:
        assert plan["rows_per_block"] == 128
        assert plan["rows_per_warp"] * plan["dmax"] // 32 <= 128


def test_flash_plans_at_the_main_shapes():
    """(a) 8 warps of 16 rows, q and two 64-token K/V stages in 202,752 B
    (one block an SM); (b) 4 warps of 32 rows in 104,448 B (two)."""
    a = flash_plan(1, 6000, 16, 1, 256, torch.bfloat16)
    assert (a["warps"], a["grid"], a["smem_bytes"]) == (8, (752, 1, 1),
                                                       202_752)
    b = flash_plan(1, 4000, 16, 8, 128, torch.bfloat16)
    assert (b["warps"], b["grid"], b["smem_bytes"]) == (4, (512, 1, 1),
                                                       104_448)
    assert 2 * (b["smem_bytes"] + 1024) <= SMEM_PER_SM
    f = flash_plan(1, 6000, 16, 1, 256, torch.float32)
    assert (f["grid"], f["smem_bytes"]) == ((94, 16, 1), 222_208)


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
    assert ops.counts()["flash_prefill"] == {"launches": 0, "plain_calls": 1}
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
