"""Mixture-of-Experts FFN: shared + routed experts, top-k, plain dispatch.

The JAX package's sort-based dispatch with per-expert capacity
(``repro/models/moe.py``), ported for ``ep_groups = 0`` (expert-parallel
grouping comes with a later slice): the (token, k) assignments are sorted
by expert id (a STABLE sort, so the capacity drops keep the tokens JAX
keeps), each expert receives a fixed-capacity ``[E, C, d]`` buffer, the
expert FFNs run as batched matrix products over the expert axis
(``torch.matmul``; JAX leaves these products to XLA, outside any Pallas
kernel), and the outputs gather back with the gate weights.

Capacity: ``capacity_factor <= 0`` (serving) gives C = N, so nothing
drops; ``forward``'s default 1.25 drops past ``ceil(N * top_k / E *
1.25)`` tokens an expert, as in JAX.

Bytes: the fixed-capacity form multiplies every expert's weights by its
buffer whatever the routing, so a decode step reads all E experts'
weights each layer (qwen2-moe-a2.7b: 1.04 GB a layer in bf16). Computing
only the routed experts would need a host read of the routing each
layer; this port keeps JAX's schedule, which needs none.

No float atomics: the dispatch writes each kept assignment to its own
buffer row (dropped ones to one spare row that is never read), and the
combine gathers each token's ``top_k`` expert outputs back through the
inverse of the sort into ``[N, top_k, d]`` and sums over k — so bf16
streams do not vary from run to run on the card, as a float
``index_add_`` would. The dispatch reads nothing back to the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, torch_dtype


def _normal(gen, shape, std, dtype, device) -> torch.Tensor:
    """N(0, std^2) of ``shape`` in ``dtype``, drawn one leading slice at
    a time so that a full-width expert bank never exists in float32."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = (torch.randn(shape[1:], generator=gen, device=device,
                              dtype=torch.float32) * std).to(dtype)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, device, lead=()):
    """Router [*lead, d, E] and expert banks ``{wi, wg, wo}`` [*lead, n,
    d, dff] / [*lead, n, dff, d] (routed, and ``shared`` if any), with
    the JAX package's distributions."""
    d, dff = cfg.d_model, cfg.moe_d_ff
    dt = torch_dtype(cfg)
    glu = cfg.activation in ("swiglu", "geglu")

    def bank(n):
        lead_n = tuple(lead) + (n,)
        p = {"wi": _normal(gen, lead_n + (d, dff), d ** -0.5, dt, device)}
        if glu:
            p["wg"] = _normal(gen, lead_n + (d, dff), d ** -0.5, dt, device)
        p["wo"] = _normal(gen, lead_n + (dff, d), dff ** -0.5, dt, device)
        return p

    p = {"router": dense_init(gen, d, cfg.num_experts, dt, device=device,
                              lead=lead),
         "experts": bank(cfg.num_experts)}
    if cfg.num_shared_experts:
        p["shared"] = bank(cfg.num_shared_experts)
    return p


def _expert_ffn(bank, x_e: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x_e: [E, C, d] tokens grouped per expert (or [1, C, d], broadcast
    to every expert of the bank) -> [E, C, d]."""
    h = torch.matmul(x_e, bank["wi"])
    if cfg.activation == "swiglu":
        h = F.silu(h) * torch.matmul(x_e, bank["wg"])
    elif cfg.activation == "geglu":
        h = F.gelu(h, approximate="tanh") * torch.matmul(x_e, bank["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, bank["wo"])


def moe_capacity(n_tokens: int, cfg: ModelConfig,
                 capacity_factor: float = 1.25) -> int:
    """Per-expert buffer size C."""
    if capacity_factor <= 0:                       # no-drop mode (serving)
        return n_tokens
    c = math.ceil(n_tokens * cfg.top_k / cfg.num_experts * capacity_factor)
    return max(cfg.top_k, min(n_tokens, c))


def _route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router probabilities [N, E] (float32) and the top-k (gates, ids).
    The product runs in the storage dtype and is then cast, as in JAX."""
    probs = torch.softmax((xt @ router).float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    return probs, gates, idx


def _dispatch_combine(xt: torch.Tensor, params, cfg: ModelConfig,
                      C: int) -> torch.Tensor:
    """Sort-based dispatch for one token group. xt: [N, d] -> [N, d]."""
    E, topk = cfg.num_experts, cfg.top_k
    N, d = xt.shape
    dev = xt.device
    _, gates, idx = _route(xt, params["router"], topk)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    flat_e = idx.reshape(-1)                                  # [N*k]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // topk                                        # token ids
    sg = gates.reshape(-1)[order]
    # Assignments an expert (integer adds: exact in any order; unlike
    # torch.bincount, no host read of the ids' maximum).
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                 # exclusive
    pos = torch.arange(N * topk, device=dev) - starts[se]
    keep = pos < C
    # Kept assignment i -> buffer row se*C + pos (unique); dropped ones ->
    # the spare row E*C, never read.
    row = torch.where(keep, se * C + pos, E * C)
    buf = xt.new_zeros((E * C + 1, d))
    buf[row] = xt[st]
    y_buf = _expert_ffn(params["experts"], buf[:E * C].view(E, C, d), cfg)
    y = y_buf.reshape(E * C, d)[torch.where(keep, row, 0)]
    y = y * (sg * keep).to(xt.dtype)[:, None]
    # Back to (token, k) order through the inverse of the sort: each
    # token sums its own top_k rows, no scatter-add.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N * topk, device=dev)
    return y[inv].view(N, topk, d).sum(1)


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25,
              ep_groups: int = 0) -> torch.Tensor:
    """x: [B, T, d] -> [B, T, d]. Top-k routed + always-on shared experts."""
    if ep_groups and ep_groups > 1:
        raise NotImplementedError(
            "expert-parallel grouped MoE (ep_groups > 1) is not ported yet; "
            "it comes with a later slice of the port")
    B, T, d = x.shape
    xt = x.reshape(-1, d)
    C = moe_capacity(xt.shape[0], cfg, capacity_factor)
    y = _dispatch_combine(xt, params, cfg, C)
    if cfg.num_shared_experts:
        y = y + _expert_ffn(params["shared"], xt[None], cfg).sum(0).to(
            xt.dtype)
    return y.reshape(B, T, d).to(x.dtype)


def moe_aux_loss(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style), float32."""
    xt = x.reshape(-1, x.shape[-1])
    probs, _, idx = _route(xt, params["router"], cfg.top_k)
    hard = F.one_hot(idx, cfg.num_experts).sum(1).float()    # [N, E]
    return cfg.num_experts * torch.sum(hard.mean(0) * probs.mean(0))
