"""Causal sliding-window flash attention over a prompt: CUDA kernel + plain
twin.

``flash_prefill_cuda`` launches ``csrc/flash_prefill.cu``, which replaces
the JAX package's Pallas TPU kernel
``repro/kernels/flash_prefill.py::flash_prefill_kernel``: causal GQA
attention of q ``[B,S,H,D]`` over k/v ``[B,S,K,D]``, optionally limited
to the last ``window`` positions (``kp > qp - window``), normalized and
returned in q's dtype. The card bounds it by FLOPs at prompt lengths of
hundreds of tokens and more; the source's header says how its design
answers that.

``flash_prefill_plain`` is the same function in plain PyTorch, in
float32 throughout like the kernel (the full ``[B,S,K,G,S]`` score
matrix, so only for the CPU and for checking the kernel on the card).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


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
    lib = build.load("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    err = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, K,
        D, int(window), float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash prefill kernel launch failed: CUDA error "
                           f"{err}")
    flash_prefill_cuda.launches += 1
    return o


flash_prefill_cuda.launches = 0
