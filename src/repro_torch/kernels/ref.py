"""Plain PyTorch oracle of the JAX package's flash prefill kernel.

The paged MicroAttention kernels' plain versions stand beside their CUDA
launchers (``micro_attn_decode``/``micro_attn_prefill``) and compute in
float32 throughout, as the kernels do.
"""
from __future__ import annotations

import torch


def flash_prefill_ref(q, k, v, *, scale=None, window=0):
    """Causal (optionally sliding-window) attention.

    q: [B, S, H, D]; k, v: [B, S, K, D] -> [B, S, H, D] in q's dtype.
    """
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, S, K, G, D)
    s = torch.einsum("btkgd,bskd->btkgs", qf, k.float()) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = kp <= qp
    if window:
        ok = ok & (kp > qp - window)
    s = s.masked_fill(~ok[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("btkgs,bskd->btkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)
