"""Paged DistAttention MicroAttention partial, decode: CUDA kernel + plain twin.

``paged_micro_attention_cuda`` launches ``csrc/micro_attn_decode.cu``,
which replaces the JAX package's Pallas TPU kernel
``repro/kernels/micro_attn_decode.py::paged_micro_attention_kernel``:
one query token per request attends over one rank's paged pool through
the request's block table and yields the unnormalized partial
``(o, m, l)`` of paper Eq. 2. The card bounds it by HBM bytes; the
source's header says how its design answers that.

``paged_micro_attention_plain`` is the same function in plain PyTorch,
computed in float32 throughout like the kernel (q, k and v upcast, the
probabilities never rounded to the storage dtype). The CPU runs it; the
card runs it only to check the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import _masked_softmax_parts
from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 64


def paged_micro_attention_plain(q, pool_k, pool_v, table, tail_len, *,
                                scale):
    """q [R,H,D]; pool_k/v [NB,bs,K,D]; table [R,MB] int32 -1-padded;
    tail_len [R] -> (o [R,H,D], m [R,H], l [R,H]) float32."""
    R, H, D = q.shape
    NB, bs, K, _ = pool_k.shape
    G = H // K
    k, v = gather_local_kv(pool_k, pool_v, table)
    mask = local_mask_from_table(table, bs, tail_len)
    s = torch.einsum("rkgd,rskd->rkgs", q.float().reshape(R, K, G, D),
                     k.float()) * scale
    m, p, l = _masked_softmax_parts(s, mask[:, None, None, :])
    o = torch.einsum("rkgs,rskd->rkgd", p, v.float())
    return o.reshape(R, H, D), m.reshape(R, H), l.reshape(R, H)


def check_inputs(q, pool_k, pool_v, table):
    """Raise ValueError on anything the CUDA kernels do not take."""
    if not (q.is_cuda and pool_k.is_cuda and pool_v.is_cuda
            and table.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only; CPU "
                         "tensors go to the plain version")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise ValueError(f"q and pools must share float32 or bfloat16, got "
                         f"{q.dtype}/{pool_k.dtype}/{pool_v.dtype}")
    NB, bs, K, D = pool_k.shape
    if pool_v.shape != pool_k.shape:
        raise ValueError("pool_k and pool_v shapes differ")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("pools must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("pools must start on a 16-byte boundary (the "
                         "kernels load K/V rows as 16-byte vectors)")
    H = q.shape[-2]
    if q.shape[-1] != D or H % K:
        raise ValueError(f"q heads/dim {tuple(q.shape[-2:])} do not fit "
                         f"K={K}, D={D}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D} must be <= {MAX_HEAD_DIM} and a "
                         f"multiple of 8")
    if bs > MAX_BLOCK_SIZE:
        raise ValueError(f"block size {bs} exceeds {MAX_BLOCK_SIZE}")


def paged_micro_attention_cuda(q, pool_k, pool_v, table, tail_len, *,
                               scale):
    """Launch the decode kernel on q's current stream (no synchronize).

    Same contract as ``paged_micro_attention_plain``; raises ValueError
    on inputs it does not take and RuntimeError if the launch fails.
    """
    check_inputs(q, pool_k, pool_v, table)
    R, H, D = q.shape
    NB, bs, K, _ = pool_k.shape
    MB = table.shape[1]
    dev = q.device
    o = torch.empty((R, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((R, H), dtype=torch.float32, device=dev)
    l = torch.empty((R, H), dtype=torch.float32, device=dev)
    if R == 0:
        return o, m, l
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    tail = torch.as_tensor(tail_len, device=dev).to(torch.int32).contiguous()
    lib = build.load("micro_attn_decode", "paged_decode_launch", _ARGTYPES)
    err = lib.paged_decode_launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), tail.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), R, H, K, D, bs, MB, float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_micro_attention_cuda.launches += 1
    return o, m, l


paged_micro_attention_cuda.launches = 0
