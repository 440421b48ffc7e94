"""Causal sliding-window flash attention over a prompt: CUDA kernel + plain
twin.

``flash_prefill_cuda`` launches ``csrc/flash_prefill.cu``, which replaces
the JAX package's Pallas TPU kernel
``repro/kernels/flash_prefill.py::flash_prefill_kernel``: causal GQA
attention of q ``[B,S,H,D]`` over k/v ``[B,S,K,D]``, optionally limited
to the last ``window`` positions (``kp > qp - window``), normalized and
returned in q's dtype. The card bounds it by FLOPs at prompt lengths of
hundreds of tokens and more (at the hybrid admission, S=6000, H=16, K=1,
D=256, window 2048: 167 GFLOP, 0.169 ms at the bf16 tensor-core peak).

bf16 runs a kernel built for Hopper: ``wgmma`` for S = Q K^T (both
operands in shared memory) and for O += P V (P from registers, V read
transposed), fed by TMA loads of q and of a ring of K/V tiles that one
producer warp keeps in flight (``mbarrier`` handshakes), two consumer
warpgroups of 64 query rows each (``setmaxnreg`` moves registers to
them), and persistent blocks, one an SM, over a static longest-first
order of (query tile, head, batch row) work items. Only live K/V tiles
are loaded and only boundary tiles masked. float32 runs the same design
on the tf32 tensor cores in 3xTF32 (below): TMA loads raw K/V tiles, the
producer's other three warps split each into tf32 halves in a split
stage (V transposed: tf32 ``wgmma`` reads shared memory K-major only),
and each consumer stages its q as tf32 halves itself; two consumers of
64 rows up to D 128, one above (q's halves take 128 KB at D 256).
``flash_plan`` states each launch's geometry and order from the shapes
and the SM count; the C entry takes it and refuses any other. The
source's header says how the design answers the bound.

Precision contract of the bf16 kernel, held to ``1e-4 + 2**-7 *
|plain|`` (one bf16 ulp of the output) against the float32 plain twin:
q K^T is exact per product (bf16 x bf16 in fp32), only the order of the
fp32 sums differs; each float32 probability p enters P V as two bf16
halves, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, against the same
bf16 V (at most 2^-16 relative per term; one rounding of p, 2^-8, misses
the tolerance at both main shapes and at short prompts); ``l`` is summed
from the float32 p; m, the rescaling and ``1 / l`` are float32, and the
normalized output is rounded to bf16 once. The float32 kernel is held to
1e-4: every product of S = Q K^T and O += P V runs as three tf32
products of the operands' halves (hi the raw float32 value, whose low
13 bits the tensor cores ignore, ``lo = x - trunc_tf32(x)``: hi hi + hi
lo + lo hi, about 2^-20 relative a term; one tf32 product, up to 2^-9,
misses 1e-4); l, m, the rescaling and ``1 / l`` stay float32.

``flash_prefill_plain`` is the same function in plain PyTorch, in
float32 throughout like the kernel (the full ``[B,S,K,G,S]`` score
matrix, so only for the CPU and for checking the kernel on the card).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.micro_attn_decode import device_sm_count

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
BF16_ROWS = 128   # query rows a work item, bf16 (two warpgroups of 64)
WG_ROWS = 64      # query rows a consumer warpgroup
# bf16 instantiations by their largest head dim: K/V tile tokens and ring
# stages (as many as fit beside q in 232,448 B).
BF16_RING = {64: (128, 4), 128: (128, 3), 256: (64, 2)}
# float32 (3xTF32) instantiations by their largest head dim: K/V tile
# tokens, consumer warpgroups, stages, raw V slots (each consumer's q_lo,
# and its q_hi at D 256 (in registers below), the raw V slots and the
# stages' four tf32 tiles: 225 KB at most).
TF32_RING = {64: (64, 2, 2, 2), 128: (32, 2, 2, 2), 256: (16, 1, 1, 2)}


def tf32_smem_bytes(dmax: int, tile: int, consumers: int, stages: int,
                    raw_v: int) -> int:
    """Shared memory of a float32 instantiation (csrc F32Layout): each
    consumer's q_lo (64 rows of ``dmax`` float32) and, above D 128, its
    q_hi (below, q_hi is register-A fragments), ``raw_v`` raw V tiles,
    ``stages`` stages of K_hi (the raw K tile), K_lo, V^T_hi, V^T_lo; 8
    bytes a barrier (2 a raw V slot, 5 a stage), 1,024 bytes of
    alignment."""
    t = tile * dmax * 4
    q_halves = 1 if dmax <= 128 else 2
    return (1024 + consumers * q_halves * WG_ROWS * dmax * 4 + raw_v * t
            + stages * 4 * t + 8 * (2 * raw_v + 5 * stages))


@functools.lru_cache(maxsize=256)
def flash_plan(B: int, S: int, H: int, K: int, D: int, dtype: torch.dtype,
               sm_count: int) -> Dict[str, object]:
    """The flash-prefill kernel's launch, which the C entry takes as
    given: rows a work item, the instantiation's largest head dim
    (``dmax``), K/V tile, stages, blocks and dynamic shared memory.
    Cached: callers share the dict and must not change it.

    bf16: ``dmax`` 64, 128 or 256; 384 threads a block (a producer
    warpgroup and two consumer warpgroups of 64 rows); q (128 rows) and a
    ring of K and V tiles in 128-byte-swizzled boxes, plus 1,024 bytes of
    alignment and 8 a barrier. float32: ``TF32_RING``'s tile, consumer
    warpgroups (rows a work item: 64 each), stages and raw V slots, in
    ``tf32_smem_bytes``. Both: ``min(items, sm_count)`` persistent blocks
    over the ``items = ceil(S / rows) * H * B`` work items, in the order
    of ``flash_block_items``.
    """
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    if dtype == torch.bfloat16:
        kv_tile, stages = BF16_RING[dmax]
        wgs = 2
        smem = (1024 + BF16_ROWS * dmax * 2 + stages * 2 * kv_tile * dmax * 2
                + 8 * (2 + 3 * stages))
        route = "wgmma bf16, TMA ring, warp-specialised, persistent"
    else:
        kv_tile, wgs, stages, rv = TF32_RING[dmax]
        smem = tf32_smem_bytes(dmax, kv_tile, wgs, stages, rv)
        route = ("wgmma 3xTF32, TMA ring and split stage, "
                 "warp-specialised, persistent")
    rows = WG_ROWS * wgs
    items = -(-S // rows) * H * B
    blocks = min(items, sm_count)
    return {"rows_per_block": rows, "warpgroups": wgs,
            "rows_per_warpgroup": WG_ROWS, "threads": 128 * (wgs + 1),
            "dmax": dmax, "kv_tile": kv_tile, "stages": stages,
            "items": items, "blocks": blocks, "grid": (blocks, 1, 1),
            "smem_bytes": smem, "route": route}


def flash_item(i: int, B: int, S: int, H: int,
               rows: int) -> Tuple[int, int, int]:
    """Work item ``i`` of the longest-first order (query tiles of
    ``rows``) as (query tile, head, batch row): the query tile descends
    (the last tile has the most keys), then the batch row and the head
    ascend."""
    n_qt = -(-S // rows)
    hb = i % (H * B)
    return n_qt - 1 - i // (H * B), hb % H, hb // H


def flash_block_items(plan: Dict[str, object], block: int, B: int, S: int,
                      H: int) -> List[Tuple[int, int, int]]:
    """The work items persistent block ``block`` of a plan walks, in
    order, as the kernel computes them: item ``r * G + block`` in even
    rounds r, ``r * G + G - 1 - block`` in odd ones (G blocks), while
    below the plan's item count."""
    G, n = plan["blocks"], plan["items"]
    out = []
    for r in range(-(-n // G)):
        i = r * G + (G - 1 - block if r % 2 else block)
        if i < n:
            out.append(flash_item(i, B, S, H, plan["rows_per_block"]))
    return out


def flash_prefill_plain(q, k, v, *, scale, window=0):
    """q [B,S,H,D]; k/v [B,S,K,D] -> [B,S,H,D] in q's dtype; rows with no
    valid key give 0."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, D)
    s = torch.einsum("btkgd,bskd->btkgs", qf, k.float()) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = kp <= qp
    if window:
        ok = ok & (kp > qp - window)
    s = s.masked_fill(~ok[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    o = torch.einsum("btkgs,bskd->btkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def check_inputs(q, k, v):
    """Raise ValueError on anything the CUDA kernel does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only; CPU "
                         "tensors go to the plain version")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"want q [B,S,H,D] and k/v [B,S,K,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"head dim {D} must be <= {MAX_HEAD_DIM} and a "
                         f"multiple of 8")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (TMA "
                             f"and 16-byte vector loads need it)")


def flash_prefill_cuda(q, k, v, *, scale, window=0):
    """Launch the flash-prefill kernel on q's current stream.

    Same contract as ``flash_prefill_plain``; raises ValueError on inputs
    it does not take and RuntimeError if the launch fails.
    """
    check_inputs(q, k, v)
    B, S, H, D = q.shape
    K = k.shape[2]
    o = torch.empty_like(q)
    if B == 0 or S == 0 or H == 0:
        return o
    plan = flash_plan(B, S, H, K, D, q.dtype,
                      device_sm_count(q.device.index))
    lib = build.load("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    err = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, K,
        D, int(window), plan["rows_per_block"], plan["kv_tile"],
        plan["stages"], plan["blocks"], plan["smem_bytes"], float(scale),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash prefill kernel launch failed: CUDA error "
                           f"{err}")
    flash_prefill_cuda.launches += 1
    if q.dtype == torch.float32:
        flash_prefill_cuda.float32_launches += 1
    return o


flash_prefill_cuda.launches = 0
flash_prefill_cuda.float32_launches = 0
