"""Paged DistAttention MicroAttention partial, prefill chunk: CUDA kernel +
plain twin.

``paged_prefill_attention_cuda`` launches ``csrc/micro_attn_prefill.cu``,
which replaces the JAX package's Pallas TPU kernel
``repro/kernels/micro_attn_prefill.py::paged_prefill_micro_attention_kernel``:
a chunk of C queries, all positioned after the addressed prefix, attends
over one rank's paged pool through ONE shared block table (no causal
mask) and yields the unnormalized partial ``(o, m, l)`` of paper Eq. 2.
The card bounds it by FLOPs at chunk sizes of hundreds of tokens. bf16
pools run on the tensor cores (``mma.sync``), with the prefix split over
several blocks where the grid would leave SMs idle (``prefill_plan``);
float32 pools run on the CUDA cores. The source's header says how the
design answers the bound.

Precision contract of the bf16 kernel, held to 1e-4 against the float32
plain twin: q K^T is exact per product (bf16 x bf16 in fp32), only the
order of the fp32 sums differs; each float32 probability p enters P V as
two bf16 halves, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, against the
same bf16 V (at most 2^-16 relative per term, where one rounding of p,
2^-8, would exceed 1e-4 over a few thousand keys); ``l`` is summed from
the float32 p; m, the rescaling and the split merge stay float32.

``paged_prefill_attention_plain`` is the same function in plain PyTorch,
in float32 throughout like the Pallas kernel. The CPU runs it; the card
runs it only to check the kernel.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import _masked_softmax_parts
from repro_torch.kernels import build
from repro_torch.kernels.micro_attn_decode import (_DTYPES, _ptr, argtypes,
                                                   check_inputs,
                                                   current_stream,
                                                   device_sm_count,
                                                   partial_outputs,
                                                   plan_splits,
                                                   split_tickets)

SMEM_PER_SM = 232_448   # bytes of shared memory a block may use on an H100
_ARGTYPES = argtypes(5)


def rows_per_block(D: int, dtype: torch.dtype) -> int:
    """(query, head) rows a block, which picks the kernel's instantiation:
    the bf16 kernel's 4 warps own 32 rows each up to D = 128 and 16 above;
    float32 64."""
    return 128 if dtype == torch.bfloat16 and D <= 128 else 64


def mma_smem_bytes(D: int, rows: int, slots: int) -> int:
    """Shared memory of the bf16 kernel: ``rows`` q rows and a 2-stage
    ring of 64-token K/V tiles, rows of D rounded up to 16 plus 8 bf16;
    the pool rows and flags of 3 tiles and ``slots`` table entries. The
    C entry refuses a launch whose size differs from its own layout's
    (csrc mma_smem_bytes)."""
    stride = -(-D // 16) * 16 + 8
    return (rows + 2 * 2 * 64) * stride * 2 + 4 * (3 * 64 + 6 + slots)


@functools.lru_cache(maxsize=1024)
def prefill_plan(C: int, H: int, K: int, D: int, MB: int, bs: int,
                 dtype: torch.dtype, sm_count: int) -> Dict[str, object]:
    """The prefill-chunk kernel's launch, which the C entry takes as
    given: rows a block, split, grid and (bf16) shared memory. Cached:
    callers share the dict and must not change it.

    bf16 splits the prefix's slots (``plan_splits``) to fill every SM
    with as many 4-warp blocks as its shared memory holds; float32 runs
    one 8-warp block per (kv head, 64 rows), unsplit.
    """
    bm = rows_per_block(D, dtype)
    items = K * -(-(C * (H // K)) // bm)
    if dtype != torch.bfloat16:
        return {"nsplit": 1, "slots_per_split": max(MB, 1), "items": items,
                "grid": (K, items // K, 1), "rows_per_block": bm,
                "smem_bytes": 0, "route": "cuda cores, float32"}
    per_sm = max(1, min(4, SMEM_PER_SM // (mma_smem_bytes(D, bm, MB)
                                           + 1024)))
    nsplit, spb = plan_splits(items, MB, bs, sm_count, per_sm)
    return {"nsplit": nsplit, "slots_per_split": spb, "items": items,
            "grid": (K, items // K, nsplit), "rows_per_block": bm,
            "blocks_per_sm": per_sm,
            "smem_bytes": mma_smem_bytes(D, bm, spb),
            "route": "tensor cores, mma.sync bf16"}


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
    o, m, l = partial_outputs(C, H, D, dev)
    if C == 0:
        return o, m, l
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    tail = torch.as_tensor(tail_len, device=dev).to(torch.int32).reshape(1)
    plan = prefill_plan(C, H, K, D, MB, bs, q.dtype,
                        device_sm_count(dev.index))
    nsplit = plan["nsplit"]
    ws = tickets = None
    if nsplit > 1:
        ws = torch.empty((nsplit, C, H, D + 2), dtype=torch.float32,
                         device=dev)
        tickets = split_tickets("micro_attn_prefill", dev, plan["items"])
    lib = build.load("micro_attn_prefill", "paged_prefill_launch",
                     _ARGTYPES)
    err = lib.paged_prefill_launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), tail.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), _ptr(ws), _ptr(tickets), C, H, K, D, bs, MB, nsplit,
        plan["slots_per_split"], plan["rows_per_block"], plan["smem_bytes"],
        0 if tickets is None else tickets.numel(), float(scale),
        _DTYPES[q.dtype], current_stream(dev))
    if err:
        raise RuntimeError(f"paged prefill kernel launch failed: CUDA error "
                           f"{err}")
    paged_prefill_attention_cuda.launches += 1
    return o, m, l


paged_prefill_attention_cuda.launches = 0
