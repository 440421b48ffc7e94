"""Mixture-of-Experts FFN: shared + routed experts, top-k.

The JAX package's sort-based dispatch with per-expert capacity
(``repro/models/moe.py``), plain and expert-parallel grouped
(``ep_groups``, one code path: the plain dispatch is one group): the
(token, k) assignments are sorted by expert id (a STABLE sort, so the
capacity drops keep the tokens JAX keeps), each expert receives a fixed-capacity ``[E, C, d]`` buffer, the
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
``index_add_`` would. (Under autograd the gather of each token's rows
has an accumulating backward, which on the card adds in no fixed
order.) The dispatch reads nothing back to the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, torch_dtype, tp_split


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
                      C: int, G: int = 1, e0: int = 0) -> torch.Tensor:
    """Sort-based dispatch in ``G`` token groups of ``N / G`` tokens each,
    capacity ``C`` per expert and group. xt: [N, d] -> [N, d].

    Each group routes, sorts (stably) and drops past capacity on its own;
    the expert FFNs run once over ``[E, G*C, d]`` (group g's rows of
    expert e at ``g*C .. g*C + C - 1``, JAX's grouped layout), and each
    token gathers back its own ``top_k`` rows. ``G = 1`` is the plain
    dispatch. A bank of fewer than E experts holds experts ``[e0, e0 +
    E_loc)`` (split over the TP axis): the others' rows stay zero, and
    the result is this process's partial sum."""
    E, topk = cfg.num_experts, cfg.top_k
    N, d = xt.shape
    Ng, A = N // G, (N // G) * topk            # tokens, assignments a group
    dev = xt.device
    _, gates, idx = _route(xt, params["router"], topk)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    flat_e = idx.reshape(G, A)                                # [G, Ng*k]
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    grp = torch.arange(G, device=dev)[:, None]
    st = order // topk + grp * Ng                             # token ids
    sg = torch.gather(gates.reshape(G, A), 1, order)
    # Assignments an expert and group (integer adds: exact in any order;
    # unlike torch.bincount, no host read of the ids' maximum).
    counts = torch.zeros((G, E), dtype=flat_e.dtype, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts                 # exclusive
    pos = torch.arange(A, device=dev) - torch.gather(starts, 1, se)
    keep = pos < C
    # Kept assignment -> buffer row se*G*C + g*C + pos (unique); dropped
    # ones -> the spare row E*G*C, never read.
    row = torch.where(keep, se * (G * C) + grp * C + pos, E * G * C)
    buf = xt.new_zeros((E * G * C + 1, d))
    buf[row.reshape(-1)] = xt[st.reshape(-1)]
    bank = params["experts"]
    E_loc = bank["wi"].shape[0]
    y_buf = _expert_ffn(bank, buf[:E * G * C].view(E, G * C, d)[
        e0:e0 + E_loc], cfg)
    if E_loc < E:
        y_buf = torch.cat([y_buf.new_zeros((e0, G * C, d)), y_buf,
                           y_buf.new_zeros((E - e0 - E_loc, G * C, d))])
    y = y_buf.reshape(E * G * C, d)[torch.where(keep, row, 0).reshape(-1)]
    y = y * (sg * keep).to(xt.dtype).reshape(-1, 1)
    # Back to (token, k) order through the inverse of each group's sort:
    # each token sums its own top_k rows, no scatter-add.
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(A, device=dev).expand(G, A))
    inv = (inv + grp * A).reshape(-1)
    return y[inv].view(N, topk, d).sum(1)


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25,
              ep_groups: int = 0, *, specs=None, tp=None,
              seq_dim=None) -> torch.Tensor:
    """x: [B, T, d] -> [B, T, d]. Top-k routed + always-on shared experts.

    ``ep_groups > 1`` with ``N = B*T`` divisible by it is the JAX
    package's 2D expert-parallel formulation: the tokens split into
    ``ep_groups`` groups that each route, sort and drop on their own at
    capacity ``moe_capacity(N // ep_groups)``, one expert FFN runs over
    every group's buffers, and each group combines its own tokens. Other
    token counts take the plain path, as in JAX. JAX's sharding
    constraints (groups over "data", experts over "model") have no
    single-device counterpart and are left out.

    Placed (``specs``, ``tp``): every process routes all of ``x`` with
    the whole router (so its capacity drops are the single process's),
    applies its own experts (split over the TP axis) and its columns of
    the shared experts, and one all-reduce sums the split parts. With
    ``seq_dim`` (sequence parallelism) the result is this process's chunk
    of that dim: one reduce-scatter of the split parts, the whole ones
    cut locally.
    """
    B, T, d = x.shape
    xt = x.reshape(-1, d)
    N = xt.shape[0]
    G = ep_groups if ep_groups > 1 and N % ep_groups == 0 else 1
    C = moe_capacity(N // G, cfg, capacity_factor)
    ex_split = tp_split(None if specs is None else
                        specs["experts"]["wi"], 0, tp)
    e0 = tp.index * params["experts"]["wi"].shape[0] if ex_split else 0
    y = _dispatch_combine(xt, params, cfg, C, G, e0)
    ys, sh_split = None, False
    if cfg.num_shared_experts:
        ys = _expert_ffn(params["shared"], xt[None], cfg).sum(0).to(xt.dtype)
        sh_split = tp_split(None if specs is None else
                            specs["shared"]["wo"], -2, tp)
    outs = ((y, ex_split), (ys, sh_split))
    whole = [t.reshape(B, T, d) for t, split in outs
             if t is not None and not split]
    split = [t.reshape(B, T, d) for t, split in outs if split]
    if seq_dim is not None:
        whole = [tp.shard(t, seq_dim) for t in whole]
    if split:                 # one all-reduce (or reduce-scatter) over TP
        part = sum(t.float() for t in split)
        whole.insert(0, tp.sum(part, xt.dtype) if seq_dim is None else
                     tp.sum_scatter(part, seq_dim, xt.dtype))
    y = whole[0] if len(whole) == 1 else whole[0] + whole[1]
    return y.to(x.dtype)


def moe_aux_loss(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style), float32."""
    xt = x.reshape(-1, x.shape[-1])
    probs, _, idx = _route(xt, params["router"], cfg.top_k)
    hard = F.one_hot(idx, cfg.num_experts).sum(1).float()    # [N, E]
    return cfg.num_experts * torch.sum(hard.mean(0) * probs.mean(0))
