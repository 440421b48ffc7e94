"""Paged DistAttention MicroAttention partial, prefill chunk: CUDA kernel +
plain twin.

``paged_prefill_attention_cuda`` launches ``csrc/micro_attn_prefill.cu``,
which replaces the JAX package's Pallas TPU kernel
``repro/kernels/micro_attn_prefill.py::paged_prefill_micro_attention_kernel``:
a chunk of C queries, all positioned after the addressed prefix, attends
over one rank's paged pool through ONE shared block table (no causal
mask) and yields the unnormalized partial ``(o, m, l)`` of paper Eq. 2.
The card bounds it by FLOPs at chunk sizes of hundreds of tokens; the
source's header says how its design answers that.

``paged_prefill_attention_plain`` is the same function in plain PyTorch,
in float32 throughout like the kernel. The CPU runs it; the card runs it
only to check the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import _masked_softmax_parts
from repro_torch.kernels import build
from repro_torch.kernels.micro_attn_decode import (_ARGTYPES, _DTYPES,
                                                   check_inputs)


def paged_prefill_attention_plain(q, pool_k, pool_v, table, tail_len, *,
                                  scale):
    """q [C,H,D]; pool_k/v [NB,bs,K,D]; table [MB] int32 -1-padded shared
    by every query; tail_len [] -> (o [C,H,D], m [C,H], l [C,H]) f32."""
    C, H, D = q.shape
    NB, bs, K, _ = pool_k.shape
    G = H // K
    k, v = gather_local_kv(pool_k, pool_v, table[None])     # [1, S, K, D]
    tail = torch.as_tensor(tail_len, device=q.device).reshape(1)
    mask = local_mask_from_table(table[None], bs, tail)[0]  # [S]
    s = torch.einsum("ckgd,skd->ckgs", q.float().reshape(C, K, G, D),
                     k[0].float()) * scale
    m, p, l = _masked_softmax_parts(s, mask[None, None, None, :])
    o = torch.einsum("ckgs,skd->ckgd", p, v[0].float())
    return o.reshape(C, H, D), m.reshape(C, H), l.reshape(C, H)


def paged_prefill_attention_cuda(q, pool_k, pool_v, table, tail_len, *,
                                 scale):
    """Launch the prefill-chunk kernel on q's current stream.

    Same contract as ``paged_prefill_attention_plain``; raises ValueError
    on inputs it does not take and RuntimeError if the launch fails.
    """
    check_inputs(q, pool_k, pool_v, table)
    C, H, D = q.shape
    NB, bs, K, _ = pool_k.shape
    MB = table.shape[0]
    dev = q.device
    o = torch.empty((C, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((C, H), dtype=torch.float32, device=dev)
    l = torch.empty((C, H), dtype=torch.float32, device=dev)
    if C == 0:
        return o, m, l
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    tail = torch.as_tensor(tail_len, device=dev).to(torch.int32).reshape(1)
    lib = build.load("micro_attn_prefill", "paged_prefill_launch",
                     _ARGTYPES)
    err = lib.paged_prefill_launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), tail.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), C, H, K, D, bs, MB, float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged prefill kernel launch failed: CUDA error "
                           f"{err}")
    paged_prefill_attention_cuda.launches += 1
    return o, m, l


paged_prefill_attention_cuda.launches = 0
