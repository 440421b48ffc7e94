"""The port's CUDA kernels on the card, against their plain PyTorch twins.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they
carry the ``cuda`` marker and skip without one. The file imports no JAX,
so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 1e-4: kernel and twin both compute in float32 from the same
inputs and differ only in summation order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.micro_attn_decode import (
    paged_micro_attention_cuda, paged_micro_attention_plain)
from repro_torch.kernels.micro_attn_prefill import (
    paged_prefill_attention_cuda, paged_prefill_attention_plain)

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
    torch.cuda.synchronize()
    assert ops.counts() == {
        "paged_micro_attention": {"launches": 1, "plain_calls": 0},
        "paged_prefill_attention": {"launches": 1, "plain_calls": 0}}
