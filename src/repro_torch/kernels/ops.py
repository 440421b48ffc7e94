"""Dispatching wrappers of the port's attention kernels.

``paged_micro_attention`` (decode) and ``paged_prefill_attention``
(prefill chunk) keep the JAX package's signatures and ``(o, m, l)``
float32 outputs; ``flash_prefill`` (causal, optionally sliding-window,
whole-prompt attention) keeps its signature and returns the normalized
output in q's dtype. All three dispatch on the device of ``q``: a CUDA
tensor launches the hand-written kernel — or raises, never falling back
— and a CPU tensor runs the kernel's plain PyTorch twin. The TPU-only
wrapper work of the reference (padding D to 128 lanes and S to the tile,
the kv-head-major query layout) has no counterpart: the CUDA kernels
index heads and rows and mask the ragged end themselves. ``scale``
defaults to ``true_head_dim ** -0.5``.

Precision. The two paged kernels return what their float32 plain twins
return, within 1e-4, in both storage dtypes. Decode computes in float32
on the CUDA cores; it splits each request's slots over several blocks
(split-KV) and LSE-merges the splits in float32. The prefill chunk with
bf16 pools runs on the tensor cores: q K^T products of bf16 values are
exact in float32, each float32 probability p enters P V as two bf16
halves ``hi = bf16(p)`` and ``lo = bf16(p - hi)`` (one rounding of p
would exceed 1e-4 over a few thousand keys), and ``l`` is summed from
the float32 p; with float32 pools it stays on the CUDA cores. Flash
prefill with bf16 inputs runs on the tensor cores under the same
contract and returns what its float32 plain twin returns within 1e-4
plus one bf16 ulp of the output (both are rounded to bf16); with float32
inputs it stays on the CUDA cores, within 1e-4.

Each kernel carries a plain integer launch counter, ``launches`` on its
launcher (``*_cuda``), incremented right after a successful launch and
nowhere else; each wrapper counts its dispatches to the plain twin in
``plain_calls``. ``reset_counts`` and ``counts`` clear and read both, so
a run can show which path served it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flash_prefill import (flash_prefill_cuda,
                                               flash_prefill_plain)
from repro_torch.kernels.micro_attn_decode import (
    paged_micro_attention_cuda, paged_micro_attention_plain)
from repro_torch.kernels.micro_attn_prefill import (
    paged_prefill_attention_cuda, paged_prefill_attention_plain)


def _route(q: torch.Tensor) -> str:
    if q.device.type == "cuda":
        return "cuda"
    if q.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no attention kernel path for device {q.device}")


def paged_micro_attention(q, pool_k, pool_v, table, tail_len, *,
                          scale=None):
    """Paged DistAttention MicroAttention partial (decode).

    q [R,H,D]; pool_k/v [NB,bs,K,D]; table [R,MB] (-1 padded, seq order);
    tail_len [R] valid tokens in each request's LAST local slot.
    Returns (o [R,H,D] f32 unnormalized, m [R,H] f32, l [R,H] f32).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return paged_micro_attention_cuda(q, pool_k, pool_v, table,
                                          tail_len, scale=scale)
    paged_micro_attention.plain_calls += 1
    return paged_micro_attention_plain(q, pool_k, pool_v, table, tail_len,
                                       scale=scale)


def paged_prefill_attention(q, pool_k, pool_v, table, tail_len, *,
                            scale=None):
    """Paged DistAttention MicroAttention partial (prefill chunk).

    q [C,H,D] — chunk query rows, all positioned AFTER the addressed
    prefix; pool_k/v [NB,bs,K,D]; table [MB] (-1 padded, seq order)
    shared by every query; tail_len [] valid tokens in the prefix's final
    block. Returns (o [C,H,D] f32 unnormalized, m [C,H] f32, l [C,H] f32)
    — LSE-mergeable with the chunk-internal causal partial.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return paged_prefill_attention_cuda(q, pool_k, pool_v, table,
                                            tail_len, scale=scale)
    paged_prefill_attention.plain_calls += 1
    return paged_prefill_attention_plain(q, pool_k, pool_v, table,
                                         tail_len, scale=scale)


def flash_prefill(q, k, v, *, scale=None, window=0):
    """Causal flash attention, optionally sliding-window (local layers).

    q [B,S,H,D]; k/v [B,S,K,D] -> [B,S,H,D] in q's dtype. ``window`` > 0
    keeps, for query position qp, the keys kp with qp - window < kp <= qp.
    """
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _route(q) == "cuda":
        return flash_prefill_cuda(q, k, v, scale=scale, window=window)
    flash_prefill.plain_calls += 1
    return flash_prefill_plain(q, k, v, scale=scale, window=window)


# wrapper name -> (wrapper, its kernel's launcher)
WRAPPERS = {
    "paged_micro_attention": (paged_micro_attention,
                              paged_micro_attention_cuda),
    "paged_prefill_attention": (paged_prefill_attention,
                                paged_prefill_attention_cuda),
    "flash_prefill": (flash_prefill, flash_prefill_cuda),
}


def reset_counts() -> None:
    """Set every kernel's ``launches`` and wrapper's ``plain_calls`` to 0."""
    for wrapper, launcher in WRAPPERS.values():
        launcher.launches = 0
        wrapper.plain_calls = 0


def counts() -> Dict[str, Dict[str, int]]:
    """``{wrapper: {"launches": n, "plain_calls": n}}``."""
    return {name: {"launches": launcher.launches,
                   "plain_calls": wrapper.plain_calls}
            for name, (wrapper, launcher) in WRAPPERS.items()}


reset_counts()
