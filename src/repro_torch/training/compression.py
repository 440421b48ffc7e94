"""int8 gradient compression with error feedback.

The JAX package's ``repro.training.compression``: per-tensor symmetric
quantization, g ~ scale * int8 with ``scale = amax / 127`` (1 for a zero
tensor), rounding half to even (``torch.round``, like ``jnp.round``).
The quantization residual is carried in a float32 error-feedback buffer
and added back the next step, so compression adds no bias in the long
run. The train step applies it numerically before the update
(``TrainConfig.grad_compression``); ``grad_sync`` puts the int8
values and scales on the wire across pods.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training.tree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale float32 scalar)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads_with_ef(grads, ef):
    """Returns (tree of (q, scale) pairs, new error feedback): the new
    buffer holds each leaf's quantization residual."""
    pairs = tree_map(lambda g, e: _compress_one(g.float() + e), grads, ef)
    qtree = tree_map(lambda pr: pr[0], pairs)
    new_ef = tree_map(lambda pr: pr[1], pairs)
    return qtree, new_ef


def _compress_one(corrected: torch.Tensor):
    q, s = quantize_int8(corrected)
    return (q, s), corrected - dequantize_int8(q, s)


def decompress_grads(qtree):
    """Inverse of compress: the float32 gradient tree."""
    return tree_map(lambda qs: dequantize_int8(*qs), qtree)
