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

``paged_prefill_attention_ranks_cuda`` launches the same kernel once over
a stack of NR rank pools, each with its own prefix table — the
counterpart of the JAX package's vmap over the global pool's rank axis
(``repro/kernels/ops.py::paged_prefill_attention_ranks``). As for decode,
the pools may be a strided per-layer view of the global pool, read in
place.

Blocks larger than the kernel's 64 tokens (the launch cells' 128): the
two CUDA wrappers present a pool of ``bs``-token blocks as one of
``sub``-token blocks, ``sub`` the largest divisor of ``bs`` the kernel
takes (``sub_block_size``). The pool is a view of each rank's
contiguous slab (``[NB * bs // sub, sub, K, D]``, never a copy); the
tables and tails are expanded on the card by ``sub_block_tables`` (no
host read), which the CPU tests hold to the plain function over the
original pool.

``paged_prefill_attention_plain`` is the same function in plain PyTorch,
in float32 throughout like the Pallas kernel;
``paged_prefill_attention_ranks_plain`` stacks it over the ranks. The CPU
runs them; the card runs them only to check the kernel.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import _masked_softmax_parts
from repro_torch.kernels import build
from repro_torch.kernels.micro_attn_decode import (MAX_BLOCK_SIZE, _DTYPES,
                                                   _ptr, argtypes,
                                                   check_inputs,
                                                   current_stream,
                                                   device_sm_count,
                                                   partial_outputs,
                                                   plan_splits,
                                                   split_tickets,
                                                   stack_ranks)

SMEM_PER_SM = 232_448   # bytes of shared memory a block may use on an H100
MIN_SUB_BLOCK = 8       # the smallest sub-block a larger block is cut into
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
                 dtype: torch.dtype, sm_count: int,
                 NR: int = 1) -> Dict[str, object]:
    """The prefill-chunk kernel's launch over ``NR`` rank pools, which
    the C entry takes as given: rows a block, split, grid (``items``
    work items a rank) and (bf16) shared memory. Cached: callers share
    the dict and must not change it.

    bf16 splits the prefix's slots (``plan_splits``, for all ``items *
    NR`` work items) to fill every SM with as many 4-warp blocks as its
    shared memory holds; float32 runs one 8-warp block per (kv head, 64
    rows, rank), unsplit.
    """
    bm = rows_per_block(D, dtype)
    items = K * -(-(C * (H // K)) // bm)
    if dtype != torch.bfloat16:
        return {"nsplit": 1, "slots_per_split": max(MB, 1), "items": items,
                "ranks": NR, "grid": (K, items // K, NR),
                "rows_per_block": bm, "smem_bytes": 0,
                "route": "cuda cores, float32"}
    per_sm = max(1, min(4, SMEM_PER_SM // (mma_smem_bytes(D, bm, MB)
                                           + 1024)))
    nsplit, spb = plan_splits(items * NR, MB, bs, sm_count, per_sm)
    return {"nsplit": nsplit, "slots_per_split": spb, "items": items,
            "ranks": NR, "grid": (K, items // K, NR * nsplit),
            "rows_per_block": bm,
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


def paged_prefill_attention_ranks_plain(q, pools_k, pools_v, tables, tails,
                                        *, scale):
    """q [C,H,D]; pools_k/v [NR,NB,bs,K,D]; tables [NR,MB]; tails [NR]
    -> (o [NR,C,H,D], m [NR,C,H], l [NR,C,H]) float32."""
    return stack_ranks(paged_prefill_attention_plain, q, pools_k, pools_v,
                       tables, tails, scale=scale)


def sub_block_size(bs: int) -> int:
    """The block the kernel reads a pool of ``bs``-token blocks as:
    ``bs`` itself up to the kernel's 64, else the largest divisor of
    ``bs`` in [MIN_SUB_BLOCK, 64]; ValueError when there is none."""
    if bs <= MAX_BLOCK_SIZE:
        return bs
    for sub in range(MAX_BLOCK_SIZE, MIN_SUB_BLOCK - 1, -1):
        if bs % sub == 0:
            return sub
    raise ValueError(f"block size {bs} exceeds {MAX_BLOCK_SIZE} and has no "
                     f"divisor in [{MIN_SUB_BLOCK}, {MAX_BLOCK_SIZE}] to read "
                     f"it as sub-blocks")


def sub_block_tables(tables: torch.Tensor, tails, bs: int, sub: int):
    """Tables and tails of a pool of ``bs``-token blocks, for the same
    pool read as ``sub``-token blocks (``bs % sub == 0``, f = bs // sub).

    tables [..., MB] (-1 padded, valid slots a prefix) -> [..., MB * f]:
    block b becomes sub-blocks ``b * f + j`` (j < f); those past the tail
    of the last valid block become -1. tails [...] (valid tokens of the
    last valid block, read as the kernel reads them: clamped to [0, bs])
    -> the valid tokens of the last valid sub-block. Device ops only: no
    host read."""
    f = bs // sub
    dev = tables.device
    tab = tables.to(torch.int32)
    tail = torch.as_tensor(tails, device=dev).to(torch.int32).reshape(
        tab.shape[:-1]).clamp(0, bs)
    n_valid = (tab >= 0).sum(-1, dtype=torch.int32)            # [...]
    n_last = (tail + sub - 1) // sub                            # sub-blocks
    slot = torch.arange(tab.shape[-1], device=dev, dtype=torch.int32)
    j = torch.arange(f, device=dev, dtype=torch.int32)
    is_last = (slot == (n_valid - 1)[..., None])[..., None]    # [..., MB, 1]
    keep = (tab >= 0)[..., None] & (~is_last | (j < n_last[..., None, None]))
    out = torch.where(keep, tab[..., None] * f + j, -1).flatten(-2)
    new_tail = torch.where(n_last > 0, tail - (n_last - 1) * sub, sub)
    return out, new_tail


def _checked(q, pool_k, pool_v, tables, tails, *, ranked: bool):
    """Check the inputs (``check_inputs``, the block size as sub-blocks)
    and give (rank stride, pool_k, pool_v, tables, tails) with blocks the
    kernel takes: the pools as views of ``sub``-token blocks, the tables
    and tails expanded to match (the inputs themselves when ``bs`` is
    taken)."""
    bs = pool_k.shape[-3]
    sub = sub_block_size(bs)
    rank_stride = check_inputs(q, pool_k, pool_v, tables, ranked=ranked,
                               max_block_size=bs)
    if sub == bs:
        return rank_stride, pool_k, pool_v, tables, tails
    lead, NB = pool_k.shape[:-4], pool_k.shape[-4]
    shape = (*lead, NB * (bs // sub), sub, *pool_k.shape[-2:])
    tables, tails = sub_block_tables(tables, tails, bs, sub)
    return rank_stride, pool_k.view(shape), pool_v.view(shape), tables, tails


def _prefill_launch(counter, q, pool_k, pool_v, table, tail_len, scale,
                    NR: int, rank_stride: int):
    """Launch the prefill-chunk kernel over ``NR`` rank pools (checked
    inputs); returns float32 ``(o [NR*C,H,D], m, l [NR*C,H])`` and adds
    one to ``counter.launches`` after the launch."""
    C, H, D = q.shape
    bs, K = pool_k.shape[-3], pool_k.shape[-2]
    MB = table.shape[-1]
    dev = q.device
    o, m, l = partial_outputs(NR * C, H, D, dev)
    if C == 0:
        return o, m, l
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    tail = torch.as_tensor(tail_len, device=dev).to(torch.int32).reshape(
        NR).contiguous()
    plan = prefill_plan(C, H, K, D, MB, bs, q.dtype,
                        device_sm_count(dev.index), NR)
    nsplit = plan["nsplit"]
    ws = tickets = None
    if nsplit > 1:
        ws = torch.empty((nsplit, NR, C, H, D + 2), dtype=torch.float32,
                         device=dev)
        tickets = split_tickets("micro_attn_prefill", dev,
                                plan["items"] * NR)
    lib = build.load("micro_attn_prefill", "paged_prefill_launch",
                     _ARGTYPES)
    err = lib.paged_prefill_launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), tail.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), _ptr(ws), _ptr(tickets), NR, C, H, K, D, bs, MB,
        rank_stride, nsplit, plan["slots_per_split"],
        plan["rows_per_block"], plan["smem_bytes"],
        0 if tickets is None else tickets.numel(), float(scale),
        _DTYPES[q.dtype], current_stream(dev))
    if err:
        raise RuntimeError(f"paged prefill kernel launch failed: CUDA error "
                           f"{err}")
    counter.launches += 1
    return o, m, l


def paged_prefill_attention_cuda(q, pool_k, pool_v, table, tail_len, *,
                                 scale):
    """Launch the prefill-chunk kernel on q's current stream.

    Same contract as ``paged_prefill_attention_plain``; raises ValueError
    on inputs it does not take and RuntimeError if the launch fails.
    Blocks over 64 tokens are read as sub-blocks (``_checked``).
    """
    _, pool_k, pool_v, table, tail_len = _checked(q, pool_k, pool_v, table,
                                                  tail_len, ranked=False)
    return _prefill_launch(paged_prefill_attention_cuda, q, pool_k, pool_v,
                           table, tail_len, scale, 1, 0)


def paged_prefill_attention_ranks_cuda(q, pools_k, pools_v, tables, tails,
                                       *, scale):
    """Launch the prefill-chunk kernel ONCE over every rank pool.

    Same contract as ``paged_prefill_attention_ranks_plain``; the pools
    may be a strided view (each rank's slab contiguous), never copied.
    Blocks over 64 tokens are read as sub-blocks (``_checked``).
    """
    rank_stride, pools_k, pools_v, tables, tails = _checked(
        q, pools_k, pools_v, tables, tails, ranked=True)
    NR = pools_k.shape[0]
    C, H, D = q.shape
    o, m, l = _prefill_launch(paged_prefill_attention_ranks_cuda, q,
                              pools_k, pools_v, tables, tails, scale, NR,
                              rank_stride)
    return o.view(NR, C, H, D), m.view(NR, C, H), l.view(NR, C, H)


paged_prefill_attention_cuda.launches = 0
paged_prefill_attention_ranks_cuda.launches = 0
