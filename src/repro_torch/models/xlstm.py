"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

mLSTM (Beck et al. 2024): per head h, matrix memory C in R^{hd x hd}:
    i_t = exp(w_i x_t), f_t = exp(w_f x_t) (log-domain stabilized by m_t)
    C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    out_t = C_t q_t / max(|n_t . q_t|, 1)

State is O(1) in sequence length — nothing grows, so there is nothing
for DistAttention to pool. sLSTM keeps recurrent (h -> gate) connections
and is inherently sequential.

Both recurrences run token by token over a prompt, as the JAX package's
``lax.scan`` does (a chunkwise-parallel mLSTM would be a feature the
reference lacks). There is no Pallas kernel here in the JAX package, so
none here either: this is plain PyTorch, float32 state, with the JAX
package's parameter keys, distributions and roundings (``h`` rounded to
the input dtype before the sLSTM recurrent product and before the group
norm; the stabilizers start at -1e30, so both ``exp`` terms of the first
step underflow to 0).

Placed weights (``specs``, ``tp``: the TP axis, as ``common.tp_split``
reads them). mLSTM: ``w_up``/``w_gate`` are split by columns, so this
process holds ``up / tp`` columns of the up-projection; ``wq``, ``wk``,
``wv`` and ``w_if`` by rows, their products one row-parallel sum of
which the process keeps its own heads (``num_heads / tp``: the memory
``(C, n, m)`` and the group norm run on those heads only); ``w_down`` by
rows. sLSTM: ``w_x``, ``w_h`` (gates packed ``i|f|z|o``) and ``w_ff_i``
(packed ``a|b``) split by contiguous columns would give one process
whole gates and another none, so they are gathered over "model" once a
layer and the recurrence runs replicated; ``w_ff_o`` stays row-parallel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (dense_init, row_parallel,
                                       torch_dtype, tp_split)

_M0 = -1e30         # initial log-domain stabilizer


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #
class MLstmState(NamedTuple):
    c: torch.Tensor   # [B, nh, hd, hd] f32 (stores v k^T)
    n: torch.Tensor   # [B, nh, hd] f32
    m: torch.Tensor   # [B, nh] f32 (log-domain stabilizer)


def mlstm_dims(cfg: ModelConfig):
    """(up-projected width, heads, head dim) of an mLSTM block."""
    up = int(cfg.d_model * cfg.mlstm_proj_factor)
    return up, cfg.num_heads, up // cfg.num_heads


def init_mlstm_block(gen: torch.Generator, cfg: ModelConfig, *, device,
                     lead=()):
    """mLSTM block weights with the JAX package's keys, shapes and
    distributions (``lead``: leading stack dims)."""
    d = cfg.d_model
    up, nh, _ = mlstm_dims(cfg)
    dt = torch_dtype(cfg)
    lead = tuple(lead)

    def dense(i, o):
        return dense_init(gen, i, o, dt, device=device, lead=lead)
    p = {"w_up": dense(d, up), "w_gate": dense(d, up), "wq": dense(up, up),
         "wk": dense(up, up), "wv": dense(up, up),
         "w_if": dense(up, 2 * nh)}                    # input+forget gates
    b_if = torch.cat([torch.zeros(nh, device=device),
                      torch.full((nh,), 3.0, device=device)])
    p["b_if"] = b_if.expand(lead + (2 * nh,)).clone()
    p["gn_scale"] = torch.ones(lead + (up,), device=device)
    p["w_down"] = dense(up, d)
    return p


def _mlstm_qkvg(p, x_up: torch.Tensor, nh: int, tp=None):
    """x_up [B, T, up] -> q, k, v [B, T, nh, hd], log_i, log_f [B, T, nh]
    (float32; k scaled by hd ** -0.5 after the cast). With ``tp`` (the
    up-projection split over it) ``x_up`` holds this process's columns,
    the four products are one row-parallel sum and the results hold its
    own ``nh / tp`` heads."""
    B, T, up = x_up.shape
    if tp is None:
        q, k, v, gif = (x_up @ p[n] for n in ("wq", "wk", "wv", "w_if"))
        b_if, heads = p["b_if"], nh
    else:
        heads, up = nh // tp.count, up * tp.count
        own = slice(tp.index * heads, (tp.index + 1) * heads)
        cols = slice(own.start * (up // nh), own.stop * (up // nh))
        y = tp.sum(torch.cat([x_up @ p[n] for n in ("wq", "wk", "wv",
                                                    "w_if")], -1))
        q, k, v, gif = y.split([up, up, up, 2 * nh], -1)
        q, k, v = q[..., cols], k[..., cols], v[..., cols]
        gif = torch.cat([gif[..., :nh][..., own], gif[..., nh:][..., own]],
                        -1)
        b_if = torch.cat([p["b_if"][:nh][own], p["b_if"][nh:][own]])
    hd = up // nh
    q = q.reshape(B, T, heads, hd).float()
    k = k.reshape(B, T, heads, hd).float() * (hd ** -0.5)
    v = v.reshape(B, T, heads, hd).float()
    gif = gif.float() + b_if
    return q, k, v, gif[..., :heads], F.logsigmoid(gif[..., heads:])


def mlstm_step(q, k, v, log_i, log_f, state: MLstmState):
    """One recurrent step; all inputs [B, nh, ...] float32."""
    m_new = torch.maximum(log_f + state.m, log_i)
    i = torch.exp(log_i - m_new)
    f = torch.exp(log_f + state.m - m_new)
    c = f[..., None, None] * state.c \
        + i[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f[..., None] * state.n + i[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", c, q)          # c stores v k^T
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n, q)), min=1.0)
    return num / den[..., None], MLstmState(c, n, m_new)


def mlstm_scan(p, x_up: torch.Tensor, nh: int, state: MLstmState,
               tp=None):
    """Sequential scan over T. Returns (h [B, T, up] f32, state) (``tp``:
    as ``_mlstm_qkvg``; then h holds this process's heads)."""
    B, T, up = x_up.shape
    q, k, v, log_i, log_f = _mlstm_qkvg(p, x_up, nh, tp)
    hs = []
    for t in range(T):
        h, state = mlstm_step(q[:, t], k[:, t], v[:, t], log_i[:, t],
                              log_f[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(B, T, up), state


def _group_norm(x: torch.Tensor, scale: torch.Tensor, nh: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Headwise group norm over [..., up] (population variance, float32),
    scaled, in x's dtype."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], nh, shp[-1] // nh).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale).to(x.dtype)


def mlstm_state_init(cfg: ModelConfig, batch: int, *, device,
                     lead=(), heads: Optional[int] = None) -> MLstmState:
    """Zero memories and -1e30 stabilizers (``lead``: stack dims;
    ``heads``: this process's heads, default all)."""
    _, nh, hd = mlstm_dims(cfg)
    nh = heads or nh
    lead = tuple(lead) + (batch, nh)
    return MLstmState(torch.zeros(lead + (hd, hd), device=device),
                      torch.zeros(lead + (hd,), device=device),
                      torch.full(lead, _M0, device=device))


def apply_mlstm_block(p, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[MLstmState] = None, *,
                      decode: bool = False, specs=None, tp=None):
    """x: [B, T, d] -> (y [B, T, d], state). Placed weights (``specs``,
    ``tp``): see the module docstring; the state holds this process's
    ``num_heads / tp`` heads."""
    B, T, d = x.shape
    nh = cfg.num_heads
    split = tp_split(None if specs is None else specs["w_up"], 1, tp)
    ltp = tp if split else None
    heads, gn_scale = nh, p["gn_scale"]
    if split:
        if nh % tp.count:
            raise ValueError(f"{nh} mLSTM heads do not split over a TP "
                             f"axis of {tp.count}")
        heads = nh // tp.count
        n = gn_scale.shape[-1] // tp.count
        gn_scale = gn_scale[tp.index * n:(tp.index + 1) * n]
    if state is None:
        state = mlstm_state_init(cfg, B, device=x.device, heads=heads)
    x_up = x @ p["w_up"]
    gate = F.silu(x @ p["w_gate"])
    if decode:
        q, k, v, log_i, log_f = _mlstm_qkvg(p, x_up, nh, ltp)
        h, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                              log_f[:, 0], state)
        h = h.reshape(B, 1, -1)
    else:
        h, state = mlstm_scan(p, x_up, nh, state, ltp)
    h = _group_norm(h.to(x.dtype), gn_scale, heads)
    return row_parallel(h * gate, p["w_down"], split, tp), state


# --------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------- #
class SLstmState(NamedTuple):
    c: torch.Tensor   # [B, d] f32 cell
    n: torch.Tensor   # [B, d] f32 normalizer
    h: torch.Tensor   # [B, d] f32 hidden (recurrent input)
    m: torch.Tensor   # [B, d] f32 stabilizer


def init_slstm_block(gen: torch.Generator, cfg: ModelConfig, *, device,
                     lead=()):
    """sLSTM block weights with the JAX package's keys, shapes and
    distributions; its gated FFN has projection factor 4/3."""
    d = cfg.d_model
    dt = torch_dtype(cfg)
    lead = tuple(lead)
    up = int(d * 4.0 / 3.0)

    def dense(i, o):
        return dense_init(gen, i, o, dt, device=device, lead=lead)
    return {"w_x": dense(d, 4 * d),                  # i, f, z, o from x
            "w_h": dense(d, 4 * d),                  # recurrent
            "b": torch.zeros(lead + (4 * d,), device=device),
            "gn_scale": torch.ones(lead + (d,), device=device),
            "w_ff_i": dense(d, 2 * up),
            "w_ff_o": dense(up, d)}


def slstm_step(p, xt: torch.Tensor, state: SLstmState):
    """One recurrent step. xt: [B, d] in the model dtype; the recurrent
    product reads ``h`` rounded to that dtype."""
    g = (xt @ p["w_x"]).float() \
        + (state.h.to(xt.dtype) @ p["w_h"]).float() + p["b"]
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + state.m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(log_f + state.m - m_new)
    c = f * state.c + i * torch.tanh(gz)
    n = f * state.n + i
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
    return h, SLstmState(c, n, h, m_new)


def slstm_state_init(cfg: ModelConfig, batch: int, *, device,
                     lead=()) -> SLstmState:
    """Zero cell, normalizer and hidden; -1e30 stabilizers."""
    shape = tuple(lead) + (batch, cfg.d_model)
    return SLstmState(torch.zeros(shape, device=device),
                      torch.zeros(shape, device=device),
                      torch.zeros(shape, device=device),
                      torch.full(shape, _M0, device=device))


def _tp_whole(p, specs, tp, names):
    """``p`` with each leaf of ``names`` whose columns are split over the
    TP axis gathered whole (one all-gather a leaf)."""
    if specs is None or tp is None:
        return p
    return {**p, **{n: tp.cat(p[n], 1) for n in names
                    if tp_split(specs[n], 1, tp)}}


def apply_slstm_block(p, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[SLstmState] = None, *,
                      decode: bool = False, specs=None, tp=None):
    """x: [B, T, d] -> (y, state). Inherently sequential (h -> gates).
    Placed weights (``specs``, ``tp``): see the module docstring; the
    state is whole in every process."""
    B, T, d = x.shape
    p = _tp_whole(p, specs, tp, ("w_x", "w_h", "w_ff_i"))
    if state is None:
        state = slstm_state_init(cfg, B, device=x.device)
    hs = []
    for t in range(1 if decode else T):
        h, state = slstm_step(p, x[:, t], state)
        hs.append(h)
    y = _group_norm(torch.stack(hs, dim=1).to(x.dtype), p["gn_scale"],
                    cfg.num_heads)
    a, b = torch.chunk(y @ p["w_ff_i"], 2, dim=-1)
    # jax.nn.gelu defaults to the tanh approximation.
    u = F.gelu(a, approximate="tanh") * b
    split = tp_split(None if specs is None else specs["w_ff_o"], 0, tp)
    if split:
        n = p["w_ff_o"].shape[0]                # this process's rows
        u = u[..., tp.index * n:(tp.index + 1) * n]
    return row_parallel(u, p["w_ff_o"], split, tp), state
