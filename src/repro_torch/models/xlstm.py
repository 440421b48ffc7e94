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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, torch_dtype

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


def _mlstm_qkvg(p, x_up: torch.Tensor, nh: int):
    """x_up [B, T, up] -> q, k, v [B, T, nh, hd], log_i, log_f [B, T, nh]
    (float32; k scaled by hd ** -0.5 after the cast)."""
    B, T, up = x_up.shape
    hd = up // nh
    q = (x_up @ p["wq"]).reshape(B, T, nh, hd).float()
    k = (x_up @ p["wk"]).reshape(B, T, nh, hd).float() * (hd ** -0.5)
    v = (x_up @ p["wv"]).reshape(B, T, nh, hd).float()
    gif = (x_up @ p["w_if"]).float() + p["b_if"]
    return q, k, v, gif[..., :nh], F.logsigmoid(gif[..., nh:])


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


def mlstm_scan(p, x_up: torch.Tensor, nh: int, state: MLstmState):
    """Sequential scan over T. Returns (h [B, T, up] f32, state)."""
    B, T, up = x_up.shape
    q, k, v, log_i, log_f = _mlstm_qkvg(p, x_up, nh)
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
                     lead=()) -> MLstmState:
    """Zero memories and -1e30 stabilizers (``lead``: stack dims)."""
    _, nh, hd = mlstm_dims(cfg)
    lead = tuple(lead) + (batch, nh)
    return MLstmState(torch.zeros(lead + (hd, hd), device=device),
                      torch.zeros(lead + (hd,), device=device),
                      torch.full(lead, _M0, device=device))


def apply_mlstm_block(p, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[MLstmState] = None, *,
                      decode: bool = False):
    """x: [B, T, d] -> (y [B, T, d], state)."""
    B, T, d = x.shape
    nh = cfg.num_heads
    if state is None:
        state = mlstm_state_init(cfg, B, device=x.device)
    x_up = x @ p["w_up"]
    gate = F.silu(x @ p["w_gate"])
    if decode:
        q, k, v, log_i, log_f = _mlstm_qkvg(p, x_up, nh)
        h, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                              log_f[:, 0], state)
        h = h.reshape(B, 1, -1)
    else:
        h, state = mlstm_scan(p, x_up, nh, state)
    h = _group_norm(h.to(x.dtype), p["gn_scale"], nh)
    return (h * gate) @ p["w_down"], state


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


def apply_slstm_block(p, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[SLstmState] = None, *,
                      decode: bool = False):
    """x: [B, T, d] -> (y, state). Inherently sequential (h -> gates)."""
    B, T, d = x.shape
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
    return (F.gelu(a, approximate="tanh") * b) @ p["w_ff_o"], state
