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

``paged_micro_attention_plain`` is the same function in plain PyTorch,
computed in float32 throughout like the kernel (q, k and v upcast, the
probabilities never rounded to the storage dtype). The CPU runs it; the
card runs it only to check the kernel.
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
MAX_BLOCK_SIZE = 64
MIN_SPLIT_TOKENS = 256    # the least a split-KV block is given to read
MAX_SPLITS = 32           # the most splits a merge takes (csrc MAX_SPLITS)
DECODE_BLOCKS_PER_SM = 3  # decode blocks an SM holds (~71 KB each)


def argtypes(n_plan: int):
    """ctypes signature of a paged kernel's C entry: 10 pointers, six
    shapes and ``n_plan`` ints of the launch plan, scale, dtype, stream."""
    return ([ctypes.c_void_p] * 10 + [ctypes.c_int] * (6 + n_plan)
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
                sm_count: int) -> Dict[str, object]:
    """The decode kernel's launch, which the C entry takes as given:
    query heads a block (``heads_per_block``: 1 where G == 1, else 2),
    split and grid. Cached: callers share the dict and must not change
    it."""
    gt = 1 if H // K == 1 else 2
    groups = -(-(H // K) // gt)
    items = K * R * groups
    nsplit, spb = plan_splits(items, MB, bs, sm_count, DECODE_BLOCKS_PER_SM)
    return {"nsplit": nsplit, "slots_per_split": spb, "items": items,
            "heads_per_block": gt, "grid": (K, R * groups, nsplit)}


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
    o, m, l = partial_outputs(R, H, D, dev)
    if R == 0:
        return o, m, l
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    tail = torch.as_tensor(tail_len, device=dev).to(torch.int32).contiguous()
    plan = decode_plan(R, H, K, MB, bs, device_sm_count(dev.index))
    nsplit = plan["nsplit"]
    ws = tickets = None
    if nsplit > 1:
        ws = torch.empty((nsplit, R, H, D + 2), dtype=torch.float32,
                         device=dev)
        tickets = split_tickets("micro_attn_decode", dev, plan["items"])
    lib = build.load("micro_attn_decode", "paged_decode_launch", _ARGTYPES)
    err = lib.paged_decode_launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), tail.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), _ptr(ws), _ptr(tickets), R, H, K, D, bs, MB, nsplit,
        plan["slots_per_split"], plan["heads_per_block"],
        0 if tickets is None else tickets.numel(), float(scale),
        _DTYPES[q.dtype], current_stream(dev))
    if err:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_micro_attention_cuda.launches += 1
    return o, m, l


paged_micro_attention_cuda.launches = 0
