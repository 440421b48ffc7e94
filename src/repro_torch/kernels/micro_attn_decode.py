"""Paged DistAttention MicroAttention partial, decode: CUDA kernel + plain twin.

``paged_micro_attention_cuda`` launches ``csrc/micro_attn_decode.cu``,
which replaces the JAX package's Pallas TPU kernel
``repro/kernels/micro_attn_decode.py::paged_micro_attention_kernel``:
one query token per request attends over one rank's paged pool through
the request's block table and yields the unnormalized partial
``(o, m, l)`` of paper Eq. 2. The card bounds it by HBM bytes; the
kernel splits each request's slot range over several thread blocks
(split-KV) and merges the split partials in the same launch. The
source's header says how its design answers the bound.

``plan_splits`` chooses the split on the host from shapes alone (never
from the tables or lengths, whose host read would synchronize the
step); the paged prefill-chunk kernel uses it too.

``paged_micro_attention_ranks_cuda`` launches the same kernel once over
a stack of NR rank pools — the counterpart of the JAX package's vmap of
the Pallas kernel over the global pool's rank axis
(``repro/kernels/ops.py::paged_micro_attention_ranks``): the rank is one
more grid axis. The pools may be a strided view (a layer of the global
pool ``[NR, L, NB, bs, K, D]``); only each rank's slab has to be
contiguous, and the kernel reads it in place.

``paged_micro_attention_plain`` is the same function in plain PyTorch,
computed in float32 throughout like the kernel (q, k and v upcast, the
probabilities never rounded to the storage dtype);
``paged_micro_attention_ranks_plain`` stacks it over the ranks. The CPU
runs them; the card runs them only to check the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.distattn import gather_local_kv, local_mask_from_table
from repro_torch.core.online_softmax import _masked_softmax_parts
from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 64        # the paged prefill kernel's largest (sub-)block
MAX_DECODE_BLOCK_SIZE = 128  # the decode kernel's (the launch cells' 128)
MIN_SPLIT_TOKENS = 256    # the least a split-KV block is given to read
MAX_SPLITS = 32           # the most splits a merge takes (csrc MAX_SPLITS)
DECODE_BLOCKS_PER_SM = 3  # decode blocks an SM holds (~71 KB each)


def argtypes(n_plan: int):
    """ctypes signature of a paged kernel's C entry: 10 pointers, the
    rank count and six shapes, the pool's rank stride (64-bit), ``n_plan``
    ints of the launch plan, scale, dtype, stream."""
    return ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_longlong]
            + [ctypes.c_int] * n_plan
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


_ARGTYPES = argtypes(4)


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


def plan_splits(items: int, MB: int, bs: int, sm_count: int,
                blocks_per_sm: int) -> Tuple[int, int]:
    """Split-KV plan: ``(nsplit, slots_per_split)``.

    Each of ``items`` work items (thread blocks before the split) reads
    the slots ``[0, MB)`` of a table with ``bs`` tokens a slot. Split s
    takes the whole slots ``[s * slots_per_split, min((s + 1) *
    slots_per_split, MB))``: the runs cover ``[0, MB)`` once, none empty.
    ``nsplit`` is the most that fits ``blocks_per_sm`` blocks on each of
    ``sm_count`` SMs, and no more than leaves every split at least
    ``MIN_SPLIT_TOKENS`` tokens of the table's capacity ``MB * bs``, nor
    than ``MAX_SPLITS``.
    Shapes only: the valid lengths are not known on the host.
    """
    if MB <= 0:
        return 1, 1
    cap = max(1, min(MB, MB * bs // MIN_SPLIT_TOKENS, MAX_SPLITS))
    want = max(1, blocks_per_sm * sm_count // max(items, 1))
    spb = -(-MB // min(cap, want))
    return -(-MB // spb), spb


@functools.lru_cache(maxsize=1024)
def decode_plan(R: int, H: int, K: int, MB: int, bs: int,
                sm_count: int, NR: int = 1) -> Dict[str, object]:
    """The decode kernel's launch over ``NR`` rank pools, which the C
    entry takes as given: query heads a block (``heads_per_block``: 1
    where G == 1, else 2), split and grid (``items`` work items a rank,
    the split planned for all ``items * NR``). Cached: callers share the
    dict and must not change it."""
    gt = 1 if H // K == 1 else 2
    groups = -(-(H // K) // gt)
    items = K * R * groups
    nsplit, spb = plan_splits(items * NR, MB, bs, sm_count,
                              DECODE_BLOCKS_PER_SM)
    return {"nsplit": nsplit, "slots_per_split": spb, "items": items,
            "ranks": NR, "heads_per_block": gt,
            "grid": (K, R * groups, NR * nsplit)}


@functools.lru_cache(maxsize=None)
def device_sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_TICKETS: Dict[Tuple[str, int], torch.Tensor] = {}


def split_tickets(kernel: str, device: torch.device,
                  n: int) -> torch.Tensor:
    """A zeroed uint32 counter per split-KV work item of ``kernel``, kept
    per device and grown when more are needed. The kernels leave every
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


def check_inputs(q, pool_k, pool_v, table, *, ranked: bool = False,
                 max_block_size: int = MAX_BLOCK_SIZE) -> int:
    """Raise ValueError on anything the CUDA kernels do not take.

    ``ranked``: the pools are ``[NR, NB, bs, K, D]`` — any rank stride,
    each rank's slab contiguous. ``max_block_size``: the largest block
    the calling kernel was checked at (the decode kernel indexes tokens
    by shift or division and stages tiles sized by the row alone, so it
    takes the launch cells' 128; the prefill kernel reads at most 64, so
    its wrappers read larger blocks as sub-blocks and pass their own).
    Returns the rank stride in elements (0 for one pool)."""
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
    if bs > max_block_size:
        raise ValueError(f"block size {bs} exceeds {max_block_size}")
    return rank_stride


def _decode_launch(counter, q, pool_k, pool_v, table, tail_len, scale,
                   NR: int, rank_stride: int):
    """Launch the decode kernel over ``NR`` rank pools (checked inputs);
    returns float32 ``(o [NR*R,H,D], m, l [NR*R,H])`` and adds one to
    ``counter.launches`` after the launch."""
    R, H, D = q.shape
    bs, K = pool_k.shape[-3], pool_k.shape[-2]
    MB = table.shape[-1]
    dev = q.device
    o, m, l = partial_outputs(NR * R, H, D, dev)
    if R == 0:
        return o, m, l
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    tail = torch.as_tensor(tail_len, device=dev).to(torch.int32).contiguous()
    plan = decode_plan(R, H, K, MB, bs, device_sm_count(dev.index), NR)
    nsplit = plan["nsplit"]
    ws = tickets = None
    if nsplit > 1:
        ws = torch.empty((nsplit, NR, R, H, D + 2), dtype=torch.float32,
                         device=dev)
        tickets = split_tickets("micro_attn_decode", dev,
                                plan["items"] * NR)
    lib = build.load("micro_attn_decode", "paged_decode_launch", _ARGTYPES)
    err = lib.paged_decode_launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), tail.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), _ptr(ws), _ptr(tickets), NR, R, H, K, D, bs, MB,
        rank_stride, nsplit, plan["slots_per_split"],
        plan["heads_per_block"], 0 if tickets is None else tickets.numel(),
        float(scale), _DTYPES[q.dtype], current_stream(dev))
    if err:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")
    counter.launches += 1
    return o, m, l


def paged_micro_attention_cuda(q, pool_k, pool_v, table, tail_len, *,
                               scale):
    """Launch the decode kernel on q's current stream (no synchronize).

    Same contract as ``paged_micro_attention_plain``; raises ValueError
    on inputs it does not take and RuntimeError if the launch fails.
    """
    check_inputs(q, pool_k, pool_v, table,
                 max_block_size=MAX_DECODE_BLOCK_SIZE)
    return _decode_launch(paged_micro_attention_cuda, q, pool_k, pool_v,
                          table, tail_len, scale, 1, 0)


def paged_micro_attention_ranks_cuda(q, pools_k, pools_v, tables, tails, *,
                                     scale):
    """Launch the decode kernel ONCE over every rank pool of the stack.

    Same contract as ``paged_micro_attention_ranks_plain``; the pools
    may be a strided view (only each rank's slab must be contiguous) and
    are never copied.
    """
    rank_stride = check_inputs(q, pools_k, pools_v, tables, ranked=True,
                               max_block_size=MAX_DECODE_BLOCK_SIZE)
    NR = pools_k.shape[0]
    R, H, D = q.shape
    o, m, l = _decode_launch(paged_micro_attention_ranks_cuda, q, pools_k,
                             pools_v, tables, tails, scale, NR, rank_stride)
    return o.view(NR, R, H, D), m.view(NR, R, H), l.view(NR, R, H)


paged_micro_attention_cuda.launches = 0
paged_micro_attention_ranks_cuda.launches = 0
