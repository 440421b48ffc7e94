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
bf16 runs on the tensor cores (``mma.sync`` m16n8k16, the FlashAttention-2
register layout, a 2-stage ``cp.async`` ring of 64-token K/V tiles, 128
query rows a block, only live tiles visited and only boundary tiles
masked); float32 stays on the CUDA cores. ``flash_plan`` states each
launch's geometry, which the C entry takes and checks; the source's
header says how the design answers the bound.

Precision contract of the bf16 kernel, held to ``1e-4 + 2**-7 *
|plain|`` (one bf16 ulp of the output) against the float32 plain twin:
q K^T is exact per product (bf16 x bf16 in fp32), only the order of the
fp32 sums differs; each float32 probability p enters P V as two bf16
halves, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, against the same
bf16 V (at most 2^-16 relative per term; one rounding of p, 2^-8, misses
the tolerance at both main shapes and at short prompts); ``l`` is summed
from the float32 p; m, the rescaling and ``1 / l`` are float32, and the
normalized output is rounded to bf16 once.

``flash_prefill_plain`` is the same function in plain PyTorch, in
float32 throughout like the kernel (the full ``[B,S,K,G,S]`` score
matrix, so only for the CPU and for checking the kernel on the card).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
BF16_ROWS = 128   # query rows a block, bf16 (tensor cores)
F32_ROWS = 64     # query rows a block, float32 (CUDA cores)
KV_TILE = 64      # K/V tokens a shared-memory tile


@functools.lru_cache(maxsize=256)
def flash_plan(B: int, S: int, H: int, K: int, D: int,
               dtype: torch.dtype) -> Dict[str, object]:
    """The flash-prefill kernel's launch, which the C entry takes as
    given: rows a block, warps, the instantiation's largest head dim
    (``dmax``), grid and dynamic shared memory. Cached: callers share the
    dict and must not change it.

    bf16: 128 query rows a block, on a 1-D grid (query tile slowest, last
    tile first); 4 warps of 32 rows up to D = 128, 8 warps of 16 rows
    above (a 16 x 256 float32 accumulator is 128 registers a thread);
    shared memory holds q and a 2-stage ring of K and V tiles, rows of D
    rounded up to 16 plus 8 bf16. float32: 8 warps over 64 rows, grid
    (query tiles, H, B), q and K transposed, V and the probabilities, as
    float32 with rows padded by 4.
    """
    if dtype == torch.bfloat16:
        dmax = 64 if D <= 64 else 128 if D <= 128 else 256
        warps = 4 if D <= 128 else 8
        stride = -(-D // 16) * 16 + 8
        return {"rows_per_block": BF16_ROWS, "warps": warps,
                "rows_per_warp": BF16_ROWS // warps, "dmax": dmax,
                "grid": (-(-S // BF16_ROWS) * H * B, 1, 1),
                "smem_bytes": (BF16_ROWS + 2 * 2 * KV_TILE) * stride * 2,
                "route": "tensor cores, mma.sync bf16"}
    dpt = 8 if D <= 128 else 16
    pad = KV_TILE + 4
    return {"rows_per_block": F32_ROWS, "warps": 8, "rows_per_warp": 8,
            "dmax": 16 * dpt, "grid": (-(-S // F32_ROWS), H, B),
            "smem_bytes": 4 * (2 * D * pad + KV_TILE * 16 * dpt
                               + F32_ROWS * pad),
            "route": "cuda cores, float32"}


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
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernel loads rows as 16-byte vectors)")


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
    plan = flash_plan(B, S, H, K, D, q.dtype)
    lib = build.load("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    err = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, K,
        D, int(window), plan["rows_per_block"], plan["smem_bytes"],
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash prefill kernel launch failed: CUDA error "
                           f"{err}")
    flash_prefill_cuda.launches += 1
    return o


flash_prefill_cuda.launches = 0
