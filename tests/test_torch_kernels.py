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

The kernels themselves need the card: ``tests/test_torch_cuda.py``
(no JAX, so it also runs on a machine without it) holds them against
these plain twins there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attention import full_attention_decode as jax_full_decode
from repro.kernels import ref as jax_ref
from repro.kernels.ops import flash_prefill as jax_flash_prefill
from repro.kernels.ops import paged_micro_attention as jax_paged_decode
from repro.kernels.ops import paged_prefill_attention as jax_paged_prefill
from repro_torch.core.online_softmax import combine, finalize
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels.micro_attn_decode import (
    paged_micro_attention_cuda, paged_micro_attention_plain)
from repro_torch.kernels.micro_attn_prefill import (
    paged_prefill_attention_cuda, paged_prefill_attention_plain)

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
