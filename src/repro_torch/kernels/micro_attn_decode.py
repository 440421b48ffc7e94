"""Paged DistAttention MicroAttention partial, decode: CUDA kernel + plain twin.

``paged_micro_attention_cuda`` launches ``csrc/micro_attn_decode.cu``,
which replaces the JAX package's Pallas TPU kernel
``repro/kernels/micro_attn_decode.py::paged_micro_attention_kernel``:
one query token per request attends over one rank's paged pool through
the request's block table and yields the unnormalized partial
``(o, m, l)`` of paper Eq. 2. The card bounds it by HBM bytes.

``paged_micro_attention_ranks_cuda`` (stacked partials, one a rank) and
``paged_micro_attention_ranks_merged_cuda`` (one partial a request, the
ranks LSE-merged in the launch) launch the same kernel over a stack of
NR rank pools, each request with its own table on each rank, in one
launch — the counterpart of the JAX package's vmap of the Pallas kernel
over the global pool's rank axis
(``repro/kernels/ops.py::paged_micro_attention_ranks``), followed, for
the merged form, by ``merge_partials(axis=0)``. The pools may be a
strided view (a layer of the global pool ``[NR, L, NB, bs, K, D]``);
only each rank's slab has to be contiguous, and the kernel reads it in
place.

The kernel is one a dtype for both contracts (the single-rank form is NR
= 1, rank stride 0, merged): persistent blocks take equal shares of
units of at most ``UNIT_TOKENS`` valid tokens of every (rank, request)
pair, planned on the card from the tables (``kernels/rank_units.py`` is
the plan on the host), with all the query heads of a kv head in one
block, K/V boxes from a 5-D TMA map over the rank slabs into a ring, and
a merge group's partials (over its units and, merged, over the ranks)
merged in the same launch. bf16 runs on the tensor cores (``mma.sync``,
the heads as the rows of an m16 tile, p as bf16 hi + lo), float32 on the
CUDA cores. Blocks of up to 128 tokens, a multiple of 8, are read in
place in both forms (``check_box_blocks``). ``decode_unit_plan`` sets
the launch from shapes and the SM count alone (never from the tables or
lengths, whose host read would synchronize the step). The source's
header says how its design answers the bound.

``paged_micro_attention_plain`` is the same function in plain PyTorch,
computed in float32 throughout like the kernel (q, k and v upcast, the
probabilities never rounded to the storage dtype);
``paged_micro_attention_ranks_plain`` stacks it over the ranks and
``paged_micro_attention_ranks_merged_plain`` merges that stack. The CPU
runs them; the card runs them only to check the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import (_masked_softmax_parts,
                                             merge_partials)
from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_DECODE_BLOCK_SIZE = 128  # the paged kernels' largest block (the launch cells')
BOX_ALIGN = 8             # TMA boxes start on a block's 8-token swizzle atom
SMEM_PER_SM = 232_448   # bytes of shared memory a block may use on an H100
UNIT_TOKENS = 256         # the most valid tokens a unit of the decode kernel
MAX_UNITS = 2 ** 31 - 1   # the unit kernels count units in int32
MMA_ROWS = 16             # query heads a tensor-core decode block holds


def argtypes(n_plan: int):
    """ctypes signature of a rank-form C entry: 10 pointers, the rank
    count and seven shapes (rows, H, K, D, bs, MB, NB), the pools' rank
    stride (64-bit), stacked and ``n_plan`` ints of the launch plan,
    scale, dtype, stream."""
    return ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_longlong]
            + [ctypes.c_int] * (1 + n_plan)
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


_ARGTYPES = argtypes(6)


def partial_outputs(rows: int, H: int, D: int, device: torch.device):
    """Uninitialized float32 ``o [rows, H, D]``, ``m`` and ``l [rows,
    H]``, contiguous views of one allocation (a wrapper's host time is
    much of a small launch's)."""
    n = rows * H
    o, m, l = torch.empty(n * (D + 2), dtype=torch.float32,
                          device=device).split([n * D, n, n])
    return o.view(rows, H, D), m.view(rows, H), l.view(rows, H)


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def decode_layout(D: int, itemsize: int, tensor_cores: bool, heads: int,
                  npair: int, P: int) -> Dict[str, int]:
    """The decode kernel's tile, ring and shared memory (csrc dec_layout):
    tiles of 64 tokens on the tensor cores, on the CUDA cores of 64 rows
    of up to 256 bytes, 32 of up to 512, 16 above (by the instantiation's
    width, DMAX 128 or 256), each the 128-byte boxes of D's columns; 3
    stages of K and V tiles, 2 where a tile of DMAX is over 16 KB or on
    the CUDA cores at one head a block; 3 barriers and a tag a stage; q
    (16 bf16 rows of DMAX + 8, or GT float32 rows of DMAX, GT the least
    power of two >= ``heads``); the 4 compute warps' partials of
    ``heads`` rows; the plan (``npair`` pairs' valid tokens and ``P + 1``
    merge-row starts); 1,024 bytes of slack."""
    dmax = 128 if D <= 128 else 256
    row = dmax * itemsize
    tt = 64 if tensor_cores or row <= 256 else 32 if row <= 512 else 16
    tile = tt * -(-D * itemsize // 128) * 128
    stages = (2 if tt * dmax * itemsize > 16384
              or (not tensor_cores and heads == 1) else 3)
    gt = 1 << (heads - 1).bit_length()
    q_bytes = MMA_ROWS * (dmax + 8) * 2 if tensor_cores else gt * dmax * 4
    q_off = 2 * stages * tile + -(-28 * stages // 16) * 16
    plan_off = q_off + q_bytes + 4 * heads * (D + 2) * 4
    return {"tile_tokens": tt, "stages": stages,
            "smem_bytes": 1024 + plan_off + 4 * (npair + P + 1)}


def _plan(R: int, H: int, K: int, D: int, MB: int, bs: int,
          dtype: torch.dtype, sm_count: int, NR: int, stacked: bool,
          ranked: bool) -> Dict[str, object]:
    """The launch of either form over NR rank pools (see
    ``decode_unit_plan`` and ``rank_decode_plan``)."""
    G = H // K
    itemsize = 2 if dtype == torch.bfloat16 else 4
    tc = dtype == torch.bfloat16
    # Every head of a kv head a block, up to 16; on the CUDA cores 4 at D
    # 256, and 4 in the rank forms, whose short walks leave a block's
    # arithmetic (which grows with its heads) on the critical path.
    most = MMA_ROWS if tc or (D <= 128 and not ranked) else 4
    heads = min(G, most)
    hg = K * -(-G // heads)
    npair = NR * R
    rows = npair if stacked else R     # merge rows
    lay = decode_layout(D, itemsize, tc, heads, npair, rows)
    smem = lay["smem_bytes"]
    if smem > SMEM_PER_SM:
        raise ValueError(f"{NR} ranks x {R} requests' plan does not fit the "
                         f"kernel's shared memory ({smem} > {SMEM_PER_SM} "
                         f"bytes)")
    # 2 blocks an SM (their registers); 1 at D 256 on the tensor cores and
    # over 8 heads on the CUDA cores, 3 at one head on the CUDA cores;
    # fewer where the shared memory holds fewer.
    regs = (1 if (tc and D > 128) or (not tc and heads > 8)
            else 3 if not tc and heads == 1 else 2)
    per_sm = max(1, min(regs, SMEM_PER_SM // (smem + 1024)))
    cap = group_blocks(rows * hg, per_sm * sm_count)
    if stacked and NR > 1 and 8 * cap < 7 * per_sm * sm_count:
        # Stacked ranks' groups hold unequal work: no alignment pays
        # where it would leave an eighth of the card idle.
        cap = per_sm * sm_count
    U = UNIT_TOKENS
    while U > lay["tile_tokens"] and npair * hg * -(-MB * bs // U) < cap:
        U //= 2
    blocks = rank_blocks(1, cap, npair * hg * -(-MB * bs // U))
    if not ranked:
        min_units = 0
    elif not tc:
        # A unit's arithmetic on the CUDA cores grows with the heads a
        # block computes: a quarter of a unit a block for each.
        min_units = max(1, blocks * heads // 4)
    elif stacked and heads <= 2:
        # Stacked pairs hold unequal work: four units a block.
        min_units = 4 * blocks
    else:
        min_units = 0
    return {"unit_tokens": U, "min_units": min_units,
            "blocks": blocks, "blocks_per_sm": per_sm,
            "heads_per_block": heads, "head_groups": hg,
            "groups": rows * hg, "ws_slots": blocks + rows * hg,
            "tensor_cores": tc, "tile_tokens": lay["tile_tokens"],
            "stages": lay["stages"], "smem_bytes": smem,
            "route": ("tensor cores, mma.sync bf16 hi + lo" if tc else
                      "cuda cores, float32"),
            "ranks": NR, "stacked": stacked}


@functools.lru_cache(maxsize=1024)
def decode_unit_plan(R: int, H: int, K: int, D: int, MB: int, bs: int,
                     dtype: torch.dtype, sm_count: int) -> Dict[str, object]:
    """The decode kernel's launch, which the C entry takes as given: the
    form (bf16 on the tensor cores, float32 on the CUDA cores), query
    heads a block (all G up to 16; on the CUDA cores 4 at D 256), merge
    ``groups`` (R x head groups; one ticket counter each), persistent
    ``blocks`` (``group_blocks`` of the groups and what the card holds
    at once: 2 an SM, 1 where the registers or shared memory hold one, 3
    on the CUDA cores at one head a block; no more than the tables could
    hold units), units of
    ``UNIT_TOKENS`` tokens (halved, down to a tile, while the tables
    could not give every block a unit), scratch slots and shared memory.
    From shapes and the SM count alone: the work is planned on the card.
    Cached: callers share the dict and must not change it."""
    return _plan(R, H, K, D, MB, bs, dtype, sm_count, 1, False, False)


def group_blocks(groups: int, cap: int) -> int:
    """Persistent blocks of a single-rank kernel: at most ``cap`` (as
    many as the card holds at once), cut to a multiple of its merge
    groups (k blocks a group) or a divisor of them (k groups a block), so
    that where the groups hold equal work every block's share starts and
    ends on a group's boundary: one run of units a group, no block
    straddling two (measured faster at every main shape but one, within
    4% there; PERF.md)."""
    if groups <= cap:
        return groups * (cap // groups)
    k = -(-groups // cap)
    return -(-groups // k)


def rank_blocks(per_sm: int, sm_count: int, max_units: int) -> int:
    """Persistent blocks of a unit kernel: as many as the card holds at
    once, no more than units the tables could hold; ValueError past the
    kernel's int32 unit count."""
    if max_units > MAX_UNITS:
        raise ValueError(f"{max_units} units exceed the rank kernel's "
                         f"int32 count")
    return max(1, min(per_sm * sm_count, max_units))


@functools.lru_cache(maxsize=1024)
def rank_decode_plan(R: int, H: int, K: int, D: int, MB: int, bs: int,
                     dtype: torch.dtype, sm_count: int, NR: int,
                     stacked: bool) -> Dict[str, object]:
    """The rank forms' launch: ``decode_unit_plan``'s rules over ``NR``
    rank pools: units counted over the NR x R tables; blocks a multiple
    or divisor of the merge groups, whose units run on from rank to rank
    (stacked, every slot the card holds where that would leave an eighth
    idle); ``groups``, ticket counters and scratch slots times NR when
    ``stacked``; the plan's shared memory for NR x R pairs (ValueError
    past the card's). Two rules of their own, from the A/B in PERF.md,
    since a rank's table is sized for the whole request but
    holds one rank's share, so the walks are short: on the CUDA cores at
    most 4 query heads a block (a block's arithmetic grows with them), and
    ``min_units``, the units below which the kernel halves the unit, down
    to a tile, from the valid tokens it finds: on the CUDA cores a
    quarter of a unit a block for each head, on the tensor cores four
    units a block when stacked with at most two heads a block (stacked
    pairs hold unequal work), else none. Cached: callers share the dict
    and must not change it."""
    return _plan(R, H, K, D, MB, bs, dtype, sm_count, NR, stacked, True)


@functools.lru_cache(maxsize=None)
def device_sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_TICKETS: Dict[Tuple[str, int], torch.Tensor] = {}


def split_tickets(kernel: str, device: torch.device,
                  n: int) -> torch.Tensor:
    """A zeroed uint32 counter per merge group of ``kernel``, kept per
    device and grown when more are needed. The kernels leave every
    counter at 0, so one buffer serves every launch on the stream."""
    key = (kernel, device.index)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 2 * (0 if t is None else t.numel())),
                        dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def stack_ranks(plain, q, pools_k, pools_v, tables, tails, *, scale):
    """A rank form's plain twin: ``plain`` on each rank's pool, table and
    tails, the partials stacked along a leading rank axis."""
    parts = [plain(q, pools_k[i], pools_v[i], tables[i], tails[i],
                   scale=scale) for i in range(pools_k.shape[0])]
    return tuple(torch.stack(x) for x in zip(*parts))


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


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def paged_micro_attention_ranks_plain(q, pools_k, pools_v, tables, tails,
                                      *, scale):
    """q [R,H,D]; pools_k/v [NR,NB,bs,K,D]; tables [NR,R,MB]; tails
    [NR,R] -> (o [NR,R,H,D], m [NR,R,H], l [NR,R,H]) float32."""
    return stack_ranks(paged_micro_attention_plain, q, pools_k, pools_v,
                       tables, tails, scale=scale)


def paged_micro_attention_ranks_merged_plain(q, pools_k, pools_v, tables,
                                             tails, *, scale):
    """The stacked plain twin merged over the ranks: -> (o [R,H,D],
    m [R,H], l [R,H]) float32."""
    return merge_partials(*paged_micro_attention_ranks_plain(
        q, pools_k, pools_v, tables, tails, scale=scale), axis=0)


def check_inputs(q, pool_k, pool_v, table, *,
                 ranked: bool = False) -> int:
    """Raise ValueError on anything the CUDA kernels do not take.

    ``ranked``: the pools are ``[NR, NB, bs, K, D]`` — any rank stride,
    each rank's slab contiguous. Every paged kernel indexes tokens, not
    slots, and reads blocks of up to ``MAX_DECODE_BLOCK_SIZE`` tokens
    (the launch cells' 128) in place. Returns the rank stride in elements
    (0 for one pool)."""
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
    layout = "[NR,NB,bs,K,D]" if ranked else "[NB,bs,K,D]"
    if pool_k.dim() != len(layout.split(",")):
        raise ValueError(f"pools must be {layout}, got "
                         f"{tuple(pool_k.shape)}")
    NB, bs, K, D = pool_k.shape[-4:]
    if pool_v.shape != pool_k.shape or pool_v.stride() != pool_k.stride():
        raise ValueError("pool_k and pool_v shapes or strides differ")
    slab_k, slab_v = (pool_k[0], pool_v[0]) if ranked else (pool_k, pool_v)
    if not (slab_k.is_contiguous() and slab_v.is_contiguous()):
        raise ValueError("pools must be contiguous (each rank's slab, "
                         "for the rank forms)")
    rank_stride = pool_k.stride(0) if ranked else 0
    if (pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16
            or rank_stride * pool_k.element_size() % 16):
        raise ValueError("pools (and each rank's slab) must start on a "
                         "16-byte boundary (the kernels load K/V rows as "
                         "16-byte vectors)")
    if ranked and table.shape[0] != pool_k.shape[0]:
        raise ValueError(f"{table.shape[0]} rank tables for "
                         f"{pool_k.shape[0]} rank pools")
    H = q.shape[-2]
    if q.shape[-1] != D or H % K:
        raise ValueError(f"q heads/dim {tuple(q.shape[-2:])} do not fit "
                         f"K={K}, D={D}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D} must be <= {MAX_HEAD_DIM} and a "
                         f"multiple of 8")
    if bs > MAX_DECODE_BLOCK_SIZE:
        raise ValueError(f"block size {bs} exceeds {MAX_DECODE_BLOCK_SIZE}")
    return rank_stride


def check_box_blocks(bs: int) -> None:
    """Raise ValueError on a block size a unit kernel's TMA boxes cannot
    address: a box starts on a 1,024-byte swizzle atom of shared memory,
    8 rows of 128 bytes (64 bf16 or 32 float32 columns), so every block
    size is a multiple of 8 tokens in both dtypes (no ServingConfig has
    another)."""
    if bs % BOX_ALIGN:
        raise ValueError(f"block size {bs} is not a multiple of "
                         f"{BOX_ALIGN}: the kernel's TMA boxes start on "
                         f"{BOX_ALIGN}-row swizzle atoms of 128-byte rows")


def aligned_rows(q: torch.Tensor) -> torch.Tensor:
    """q contiguous and on a 16-byte boundary (the kernels load its rows
    as 16-byte vectors)."""
    q = q.contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def _decode_launch(counter, q, pools_k, pools_v, tables, tails, scale, *,
                   ranked: bool, stacked: bool):
    """Launch the decode kernel once on q's current stream (no
    synchronize): over one pool ``[NB, bs, K, D]`` (the single-rank form:
    NR 1, rank stride 0, merged) or, ``ranked``, over every rank pool of
    a stack ``[NR, NB, bs, K, D]``. Raises ValueError on inputs it does
    not take (a block size that is not a multiple of 8 among them:
    ``check_box_blocks``) and RuntimeError if the launch fails; returns
    float32 ``(o, m, l)`` stacked ``[NR, R, ...]`` or merged ``[R, ...]``
    and adds one to ``counter.launches`` after the launch."""
    rank_stride = check_inputs(q, pools_k, pools_v, tables, ranked=ranked)
    NB, bs, K = pools_k.shape[-4:-1]
    check_box_blocks(bs)
    NR = pools_k.shape[0] if ranked else 1
    R, H, D = q.shape
    MB = tables.shape[-1]
    dev = q.device
    lead = (NR, R) if stacked else (R,)
    o, m, l = partial_outputs(NR * R if stacked else R, H, D, dev)
    o, m, l = o.view(*lead, H, D), m.view(*lead, H), l.view(*lead, H)
    if R == 0:
        return o, m, l
    q = aligned_rows(q)
    tables = tables.to(torch.int32).contiguous()
    tails = torch.as_tensor(tails, device=dev).to(torch.int32).reshape(
        NR, R).contiguous()
    sms = device_sm_count(dev.index)
    if ranked:
        plan = rank_decode_plan(R, H, K, D, MB, bs, q.dtype, sms, NR,
                                stacked)
    else:
        plan = decode_unit_plan(R, H, K, D, MB, bs, q.dtype, sms)
    ws = torch.empty((plan["ws_slots"], plan["heads_per_block"], D + 4),
                     dtype=torch.float32, device=dev)
    # The rank forms and the single-rank form never share counters.
    tickets = split_tickets("micro_attn_decode_ranks" if ranked
                            else "micro_attn_decode", dev, plan["groups"])
    lib = build.load("micro_attn_decode", "paged_decode_launch", _ARGTYPES)
    err = lib.paged_decode_launch(
        q.data_ptr(), pools_k.data_ptr(), pools_v.data_ptr(),
        tables.data_ptr(), tails.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), ws.data_ptr(), tickets.data_ptr(), NR, R, H, K, D, bs,
        MB, NB, rank_stride, int(stacked), plan["unit_tokens"],
        plan["min_units"], plan["blocks"], plan["heads_per_block"],
        plan["smem_bytes"], tickets.numel(), float(scale), _DTYPES[q.dtype],
        current_stream(dev))
    if err:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")
    counter.launches += 1
    if q.dtype == torch.float32:
        counter.float32_launches += 1
    return o, m, l


def paged_micro_attention_cuda(q, pool_k, pool_v, table, tail_len, *,
                               scale):
    """Launch the decode kernel on q's current stream (no synchronize).

    Same contract as ``paged_micro_attention_plain``; raises ValueError
    on inputs it does not take and RuntimeError if the launch fails.
    """
    return _decode_launch(paged_micro_attention_cuda, q, pool_k, pool_v,
                          table, tail_len, scale, ranked=False,
                          stacked=False)


def paged_micro_attention_ranks_cuda(q, pools_k, pools_v, tables, tails, *,
                                     scale):
    """Launch the decode kernel ONCE over every rank pool of the stack,
    one partial a (rank, request).

    Same contract as ``paged_micro_attention_ranks_plain``; the pools
    may be a strided view (each rank's slab contiguous, the rank stride a
    multiple of 16 bytes), never copied; ValueError on a block size that
    is not a multiple of 8 (``check_box_blocks``).
    """
    return _decode_launch(paged_micro_attention_ranks_cuda, q, pools_k,
                          pools_v, tables, tails, scale, ranked=True,
                          stacked=True)


def paged_micro_attention_ranks_merged_cuda(q, pools_k, pools_v, tables,
                                            tails, *, scale):
    """Launch the decode kernel ONCE over every rank pool of the stack,
    the ranks merged in the launch: one partial a request.

    Same contract as ``paged_micro_attention_ranks_merged_plain``.
    """
    return _decode_launch(paged_micro_attention_ranks_merged_cuda, q,
                          pools_k, pools_v, tables, tails, scale,
                          ranked=True, stacked=False)


for _launcher in (paged_micro_attention_cuda,
                  paged_micro_attention_ranks_cuda,
                  paged_micro_attention_ranks_merged_cuda):
    _launcher.launches = 0
    _launcher.float32_launches = 0
