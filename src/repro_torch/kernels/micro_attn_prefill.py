"""Paged DistAttention MicroAttention partial, prefill chunk: CUDA kernel +
plain twin.

``paged_prefill_attention_cuda`` launches ``csrc/micro_attn_prefill.cu``,
which replaces the JAX package's Pallas TPU kernel
``repro/kernels/micro_attn_prefill.py::paged_prefill_micro_attention_kernel``:
a chunk of C queries, all positioned after the addressed prefix, attends
over one rank's paged pool through ONE shared block table (no causal
mask) and yields the unnormalized partial ``(o, m, l)`` of paper Eq. 2.
The card bounds it by FLOPs at chunk sizes of hundreds of tokens. Both
dtypes run on ``wgmma`` fed by TMA boxes of the pool (blocks of up to
128 tokens, a multiple of 8, read in place), persistent blocks over
units (a tile of 128 rows of one kv head x a tile of the valid prefix)
planned on the card from the table (``prefill_unit_plan``;
``kernels/rank_units.py`` is the plan on the host), the partials merged
in the same launch: bf16 pools on bf16 ``wgmma``, float32 pools in
3xTF32 (a raw K tile is its own hi half; the producer's other warps
write K's lo half and V's halves transposed; 64-row tiles at D > 128). The source's header
says how the design answers the bound.

Precision contract of the bf16 kernel, held to 1e-4 against the float32
plain twin: q K^T is exact per product (bf16 x bf16 in fp32), only the
order of the fp32 sums differs; each float32 probability p enters P V as
two bf16 halves, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, against the
same bf16 V (at most 2^-16 relative per term, where one rounding of p,
2^-8, would exceed 1e-4 over a few thousand keys); ``l`` is summed from
the float32 p; m, the rescaling and the merge stay float32. The float32
kernel is held to the same 1e-4: every product of Q K^T and P V runs as
three tf32 products of the operands' halves (hi the raw value, whose low
13 bits the tensor cores ignore, ``lo = x - trunc_tf32(x)``: hi hi + hi
lo + lo hi), l from the float32 p.

``paged_prefill_attention_ranks_cuda`` (stacked partials, one a rank)
and ``paged_prefill_attention_ranks_merged_cuda`` (the ranks LSE-merged
in the launch) launch the same two kernels over a stack of NR rank
pools, each with its own prefix table, in one launch — the counterpart
of the JAX package's vmap over the global pool's rank axis
(``repro/kernels/ops.py::paged_prefill_attention_ranks``), followed, for
the merged form, by ``merge_partials(axis=0)``. The kernels are one a
dtype for both forms (the single-rank form is NR = 1): persistent blocks
take equal shares of every rank's tiles of valid prefix
(``rank_prefill_plan``), the K/V boxes come from a 5-D tensor map over
the rank slabs, and a merge group's partials (over its units and, merged,
over the ranks) are merged in the launch. As for decode, the pools may be
a strided per-layer view of the global pool, read in place; blocks of up
to 128 tokens, a multiple of 8, are read as they are.

``paged_prefill_attention_plain`` is the same function in plain PyTorch,
in float32 throughout like the Pallas kernel;
``paged_prefill_attention_ranks_plain`` stacks it over the ranks and
``paged_prefill_attention_ranks_merged_plain`` merges that stack. The
CPU runs them; the card runs them only to check the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import (_masked_softmax_parts,
                                             merge_partials)
from repro_torch.kernels import build
from repro_torch.kernels.micro_attn_decode import (SMEM_PER_SM, _DTYPES,
                                                   aligned_rows, argtypes,
                                                   check_box_blocks,
                                                   check_inputs,
                                                   current_stream,
                                                   device_sm_count,
                                                   group_blocks,
                                                   partial_outputs,
                                                   rank_blocks,
                                                   split_tickets,
                                                   stack_ranks)

ROW_TILE = 128          # (query, head) rows a unit of the bf16 kernel
# The single-rank entry: 10 pointers, seven shapes (C, H, K, D, bs, MB,
# NB), six ints of the plan, scale, dtype, stream.
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_RANK_ARGTYPES = argtypes(6)


def plan_bytes(NR: int, P: int) -> int:
    """Shared memory of the plan the kernels make on the card (csrc
    plan_bytes): ``NR`` ranks' valid tokens and ``P + 1`` merge-row
    starts, rounded up to 16 bytes."""
    return -(-4 * (NR + P + 1) // 16) * 16


def unit_smem_bytes(dmax: int, tile: int, stages: int, NR: int = 1,
                    P: int = 1) -> int:
    """Shared memory of the bf16 kernel (csrc PfLayout): each consumer
    warpgroup's 64 q rows, ``stages`` K and V tiles of ``tile`` tokens
    (all of DMAX), the merge's row weights (128 x 33 floats; in the q
    rows where they fit), 3 barriers a stage, each stage's valid tokens
    (16 bytes), the plan of ``NR`` ranks and ``P`` merge rows, 1,024
    bytes of slack."""
    q = 2 * 64 * dmax * 2
    merge = ROW_TILE * 33 * 4
    return (1024 + q + 2 * stages * tile * dmax * 2
            + (0 if q >= merge else merge) + 8 * 3 * stages + 16
            + plan_bytes(NR, P))


# The bf16 kernel's instantiations by DMAX: (K/V tile, ring stages).
PREFILL_RINGS = {64: (128, 4), 128: (128, 3), 256: (64, 2)}
# The float32 (3xTF32) kernel's by DMAX: (K/V tile, consumer warpgroups
# of 64 rows, stages, raw V slots).
TF32_PREFILL_RINGS = {64: (64, 2, 2, 2), 128: (32, 2, 2, 2),
                      256: (16, 1, 1, 2)}


def tf32_unit_smem_bytes(dmax: int, tile: int, consumers: int, stages: int,
                         raw_v: int, NR: int = 1, P: int = 1) -> int:
    """Shared memory of the float32 kernel (csrc PfF32Layout): each
    consumer's q_lo (64 rows of DMAX float32) and, above D 128, its q_hi
    (below, register-A fragments; the merge's row weights use these
    rows), the raw V slots, ``stages`` stages of four tf32 tiles (K_hi is
    the raw K tile), 8 bytes a barrier (2 a raw V slot, 5 a stage), each
    stage's valid tokens (16 bytes), the plan, 1,024 bytes of slack."""
    t = tile * dmax * 4
    q_halves = 1 if dmax <= 128 else 2
    return (1024 + consumers * q_halves * 64 * dmax * 4 + raw_v * t
            + stages * 4 * t + 8 * (2 * raw_v + 5 * stages) + 16
            + plan_bytes(NR, P))


def _plan(C: int, H: int, K: int, D: int, MB: int, bs: int, sm_count: int,
          dtype: torch.dtype, NR: int, stacked: bool) -> Dict[str, object]:
    """The launch of either form over NR rank pools (see
    ``prefill_unit_plan``)."""
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    P = NR if stacked else 1
    if dtype == torch.bfloat16:
        tile, stages = PREFILL_RINGS[dmax]
        wgs = 2
        smem = unit_smem_bytes(dmax, tile, stages, NR, P)
        route = "wgmma bf16 hi + lo, TMA boxes of the pool"
    else:
        tile, wgs, stages, rv = TF32_PREFILL_RINGS[dmax]
        smem = tf32_unit_smem_bytes(dmax, tile, wgs, stages, rv, NR, P)
        route = "wgmma 3xTF32, TMA boxes of the pool, split stage"
    if smem > SMEM_PER_SM:
        raise ValueError(f"{NR} ranks' plan does not fit the kernel's "
                         f"shared memory ({smem} > {SMEM_PER_SM} bytes)")
    rows = 64 * wgs
    hg = K * -(-(C * (H // K)) // rows)
    blocks = group_blocks(P * hg, sm_count)
    if (dtype == torch.float32 or P > 1) and 8 * blocks < 7 * sm_count:
        # A float32 unit carries three times the products: where the
        # group-aligned count leaves an eighth of the SMs idle (96 of 132
        # at musicgen's and starcoder2's heads) one block an SM is faster,
        # its merges notwithstanding; where it fills them, slower. Stacked
        # ranks' groups hold unequal work, so no alignment pays there.
        blocks = sm_count
    blocks = rank_blocks(1, blocks, hg * NR * -(-MB * bs // tile))
    return {"unit_tokens": tile, "kv_tile": tile,
            "rows_per_block": rows, "dmax": dmax, "stages": stages,
            "blocks": blocks,
            "blocks_per_sm": 1, "groups": P * hg, "head_groups": hg,
            "ws_slots": blocks + P * hg, "smem_bytes": smem,
            "warpgroups": wgs, "rows_per_warpgroup": 64,
            "threads": 128 * (wgs + 1), "route": route, "ranks": NR,
            "stacked": stacked}


@functools.lru_cache(maxsize=1024)
def prefill_unit_plan(C: int, H: int, K: int, D: int, MB: int, bs: int,
                      sm_count: int, dtype: torch.dtype
                      ) -> Dict[str, object]:
    """The prefill-chunk kernel's launch, which the C entry takes as
    given: the instantiation (DMAX 64, 128 or 256: D rounded up; its K/V
    tile, which is the unit, rows a merge group and stages: bf16
    ``PREFILL_RINGS``, 128 rows; float32 ``TF32_PREFILL_RINGS``),
    persistent ``blocks`` (``group_blocks`` of one an SM; float32: one an
    SM where that leaves an eighth of them idle; no more than the table
    could hold units), merge ``groups`` (kv head x tile of rows; one
    ticket counter each), scratch slots and shared memory. From
    shapes and the SM count alone: the work is planned on the card.
    Cached: callers share the dict and must not change it."""
    return _plan(C, H, K, D, MB, bs, sm_count, dtype, 1, False)


@functools.lru_cache(maxsize=1024)
def rank_prefill_plan(C: int, H: int, K: int, D: int, MB: int, bs: int,
                      dtype: torch.dtype, sm_count: int, NR: int,
                      stacked: bool) -> Dict[str, object]:
    """The rank forms' launch: ``prefill_unit_plan``'s instantiation,
    units and block rule over ``NR`` rank pools, with ``groups``,
    ticket counters and scratch slots times P (NR when ``stacked``, else
    1), the plan's shared memory for NR ranks, and, when stacked, one
    block an SM where the group-aligned count would leave an eighth of
    them idle. Cached: callers share the dict and must not change it."""
    return _plan(C, H, K, D, MB, bs, sm_count, dtype, NR, stacked)


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


def paged_prefill_attention_ranks_merged_plain(q, pools_k, pools_v, tables,
                                               tails, *, scale):
    """The stacked plain twin merged over the ranks: -> (o [C,H,D],
    m [C,H], l [C,H]) float32."""
    return merge_partials(*paged_prefill_attention_ranks_plain(
        q, pools_k, pools_v, tables, tails, scale=scale), axis=0)


def paged_prefill_attention_cuda(q, pool_k, pool_v, table, tail_len, *,
                                 scale):
    """Launch the prefill-chunk kernel on q's current stream.

    Same contract as ``paged_prefill_attention_plain``; raises ValueError
    on inputs it does not take and RuntimeError if the launch fails.
    Blocks of up to 128 tokens are read in place in both dtypes.
    """
    check_inputs(q, pool_k, pool_v, table)
    C, H, D = q.shape
    NB, bs, K = pool_k.shape[0], pool_k.shape[-3], pool_k.shape[-2]
    check_box_blocks(bs)
    MB = table.shape[-1]
    dev = q.device
    o, m, l = partial_outputs(C, H, D, dev)
    if C == 0:
        return o, m, l
    q = aligned_rows(q)
    table = table.to(torch.int32).contiguous()
    tail = torch.as_tensor(tail_len, device=dev).to(torch.int32).reshape(
        1).contiguous()
    plan = prefill_unit_plan(C, H, K, D, MB, bs, device_sm_count(dev.index),
                             q.dtype)
    ws = torch.empty((plan["ws_slots"], plan["rows_per_block"], D + 4),
                     dtype=torch.float32, device=dev)
    tickets = split_tickets("micro_attn_prefill", dev, plan["groups"])
    lib = build.load("micro_attn_prefill", "paged_prefill_launch",
                     _ARGTYPES)
    err = lib.paged_prefill_launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), tail.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), ws.data_ptr(), tickets.data_ptr(), C, H, K, D, bs, MB,
        NB, plan["blocks"], plan["rows_per_block"], plan["kv_tile"],
        plan["stages"], plan["smem_bytes"], tickets.numel(),
        float(scale), _DTYPES[q.dtype], current_stream(dev))
    if err:
        raise RuntimeError(f"paged prefill kernel launch failed: CUDA error "
                           f"{err}")
    paged_prefill_attention_cuda.launches += 1
    if q.dtype == torch.float32:
        paged_prefill_attention_cuda.float32_launches += 1
    return o, m, l


def _prefill_ranks_launch(counter, q, pools_k, pools_v, tables, tails,
                          scale, stacked: bool):
    """Launch the prefill kernel once over every rank pool of the stack
    (blocks of up to 128 tokens, a multiple of 8, read as they are);
    returns float32
    ``(o, m, l)`` stacked ``[NR, C, ...]`` or merged ``[C, ...]`` and adds
    one to ``counter.launches`` after the launch."""
    rank_stride = check_inputs(q, pools_k, pools_v, tables, ranked=True)
    NR, NB, bs, K, _ = pools_k.shape
    check_box_blocks(bs)
    C, H, D = q.shape
    MB = tables.shape[-1]
    dev = q.device
    lead = (NR, C) if stacked else (C,)
    o, m, l = partial_outputs(NR * C if stacked else C, H, D, dev)
    o, m, l = o.view(*lead, H, D), m.view(*lead, H), l.view(*lead, H)
    if C == 0:
        return o, m, l
    q = aligned_rows(q)
    tables = tables.to(torch.int32).contiguous()
    tails = torch.as_tensor(tails, device=dev).to(torch.int32).reshape(
        NR).contiguous()
    plan = rank_prefill_plan(C, H, K, D, MB, bs, q.dtype,
                             device_sm_count(dev.index), NR, stacked)
    ws = torch.empty((plan["ws_slots"], plan["rows_per_block"], D + 4),
                     dtype=torch.float32, device=dev)
    tickets = split_tickets("micro_attn_prefill_ranks", dev, plan["groups"])
    lib = build.load("micro_attn_prefill", "paged_prefill_ranks_launch",
                     _RANK_ARGTYPES)
    err = lib.paged_prefill_ranks_launch(
        q.data_ptr(), pools_k.data_ptr(), pools_v.data_ptr(),
        tables.data_ptr(), tails.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), ws.data_ptr(), tickets.data_ptr(), NR, C, H, K, D, bs,
        MB, NB, rank_stride, int(stacked), plan["blocks"],
        plan["rows_per_block"], plan["kv_tile"], plan["stages"],
        plan["smem_bytes"], tickets.numel(), float(scale),
        _DTYPES[q.dtype], current_stream(dev))
    if err:
        raise RuntimeError(f"paged prefill rank kernel launch failed: CUDA "
                           f"error {err}")
    counter.launches += 1
    if q.dtype == torch.float32:
        counter.float32_launches += 1
    return o, m, l


def paged_prefill_attention_ranks_cuda(q, pools_k, pools_v, tables, tails,
                                       *, scale):
    """Launch the prefill kernel ONCE over every rank pool, one partial
    a rank.

    Same contract as ``paged_prefill_attention_ranks_plain``; the pools
    may be a strided view (each rank's slab contiguous, the rank stride a
    multiple of 16 bytes), never copied; ValueError on a block size that
    is not a multiple of 8 (``check_box_blocks``).
    """
    return _prefill_ranks_launch(paged_prefill_attention_ranks_cuda, q,
                                 pools_k, pools_v, tables, tails, scale,
                                 stacked=True)


def paged_prefill_attention_ranks_merged_cuda(q, pools_k, pools_v, tables,
                                              tails, *, scale):
    """Launch the prefill kernel ONCE over every rank pool, the ranks
    merged in the launch.

    Same contract as ``paged_prefill_attention_ranks_merged_plain``.
    """
    return _prefill_ranks_launch(paged_prefill_attention_ranks_merged_cuda,
                                 q, pools_k, pools_v, tables, tails, scale,
                                 stacked=False)


def map_encodes() -> int:
    """Tensor maps the prefill library has encoded in this process (its
    cache of maps: a served step encodes none after its first); loads
    the library, so it needs CUDA."""
    lib = build.load("micro_attn_prefill", "paged_prefill_map_encodes", [])
    lib.paged_prefill_map_encodes.restype = ctypes.c_ulonglong
    return int(lib.paged_prefill_map_encodes())


for _launcher in (paged_prefill_attention_cuda,
                  paged_prefill_attention_ranks_cuda,
                  paged_prefill_attention_ranks_merged_cuda):
    _launcher.launches = 0
    _launcher.float32_launches = 0
