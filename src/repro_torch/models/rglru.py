"""Griffin/RecurrentGemma recurrent block: Conv1D(4) + RG-LRU, gated.

Block: x -> { gate branch: linear -> GeLU } * { recurrent branch:
linear -> causal Conv1D(width 4) -> RG-LRU } -> linear out.

RG-LRU (real-gated linear recurrent unit):
    r_t = sigmoid(W_r x_t + b_r)          recurrence gate
    i_t = sigmoid(W_i x_t + b_i)          input gate
    a_t = exp(c * r_t * log_sigmoid(L))   L learnable, c = -8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Over a prompt, ``rglru_scan`` evaluates the recurrence in closed form
chunk by chunk (the JAX package uses ``jax.lax.associative_scan``): with
``A_t`` the running sum of ``log a`` inside a chunk,
``h_t = exp(A_t) h_0 + sum_{s<=t} exp(A_t - A_s) b_s``. Since
``log a <= 0``, every ``exp(A_t - A_s)`` with ``s <= t`` is at most 1, so
the form is stable in float32; ``h`` carries from chunk to chunk, and
a prompt costs a few operations per chunk instead of per token. Decode
is the O(1)-state step ``rglru_step``. There is no Pallas kernel here in
the JAX package, so none here either: this is plain PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, torch_dtype

_C = 8.0
_CONV_W = 4
SCAN_CHUNK = 64     # tokens per closed-form chunk of ``rglru_scan``


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, *, device,
                     lead=()):
    """Recurrent-block weights with the JAX package's keys, shapes and
    distributions (``lead``: leading stack dims)."""
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = torch_dtype(cfg)
    lead = tuple(lead)

    def dense(i, o):
        return dense_init(gen, i, o, dt, device=device, lead=lead)
    p = {"w_gate": dense(d, w), "w_rec_in": dense(d, w)}
    p["conv_w"] = (torch.randn(lead + (_CONV_W, w), generator=gen,
                               device=device) * 0.1).to(dt)
    p["w_r"] = dense(w, w)
    p["w_i"] = dense(w, w)
    p["b_r"] = torch.zeros(lead + (w,), device=device)
    p["b_i"] = torch.zeros(lead + (w,), device=device)
    # Lambda init so a = sigmoid(L)^(c*r) sits in [0.9, 0.999] (Griffin).
    u = torch.rand(lead + (w,), generator=gen, device=device) \
        * (0.999 - 0.9) + 0.9
    p["log_sig_lambda"] = torch.log(u ** (1.0 / _C))           # [w] f32
    p["w_out"] = dense(w, d)
    return p


def _gates(p, x: torch.Tensor):
    """x: [..., w] (conv output) -> (log_a [..., w] f32, gated_in f32)."""
    r = torch.sigmoid((x @ p["w_r"]).float() + p["b_r"])
    i = torch.sigmoid((x @ p["w_i"]).float() + p["b_i"])
    log_a = _C * r * p["log_sig_lambda"]                        # <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return log_a, gated


def rglru_scan(p, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """RG-LRU over [B, T, w]. Returns (y [B,T,w] in x's dtype, h_T [B,w]
    float32)."""
    B, T, w = x.shape
    log_a, gated = _gates(p, x)                                 # [B,T,w] f32
    h = (torch.zeros((B, w), device=x.device) if h0 is None
         else h0.float())
    ys = []
    for c0 in range(0, T, SCAN_CHUNK):
        A = torch.cumsum(log_a[:, c0:c0 + SCAN_CHUNK], dim=1)   # [B,C,w]
        C = A.shape[1]
        causal = torch.ones((C, C), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        diff = A[:, :, None, :] - A[:, None, :, :]              # [B,t,s,w]
        decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
        hc = torch.exp(A) * h[:, None] + torch.einsum(
            "btsw,bsw->btw", decay, gated[:, c0:c0 + SCAN_CHUNK])
        h = hc[:, -1]
        ys.append(hc)
    y = torch.cat(ys, dim=1) if ys else gated
    return y.to(x.dtype), h


def rglru_step(p, x: torch.Tensor, h: torch.Tensor):
    """Single decode step. x: [B, w] conv output, h: [B, w] f32 state."""
    log_a, gated = _gates(p, x[:, None])
    h_new = torch.exp(log_a[:, 0]) * h + gated[:, 0]
    return h_new.to(x.dtype), h_new


def causal_conv1d(p, x: torch.Tensor, carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width 4 over [B, T, w]; carry [B, 3, w]
    holds the last 3 pre-conv inputs (x's dtype)."""
    B, T, w = x.shape
    if carry is None:
        carry = torch.zeros((B, _CONV_W - 1, w), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)                           # [B,T+3,w]
    out = torch.zeros((B, T, w), device=x.device)
    for i in range(_CONV_W):
        out = out + xp[:, i:i + T].float() * p["conv_w"][i].float()
    return out.to(x.dtype), xp[:, -(_CONV_W - 1):]


def apply_rglru_block(p, x: torch.Tensor, cfg: ModelConfig,
                      state: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None, *, decode: bool = False):
    """Full Griffin recurrent block. x: [B, T, d].

    state = (conv_carry [B,3,w], lru_h [B,w]); returns (y, new_state).
    """
    # jax.nn.gelu defaults to the tanh approximation.
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")          # [B,T,w]
    rec = x @ p["w_rec_in"]
    conv_carry, h = state if state is not None else (None, None)
    rec_c, conv_carry = causal_conv1d(p, rec, conv_carry)
    if decode:
        y_rec, h = rglru_step(p, rec_c[:, 0], h)
        y_rec = y_rec[:, None]
    else:
        y_rec, h = rglru_scan(p, rec_c, h)
    y = (gate * y_rec) @ p["w_out"]
    return y, (conv_carry, h)


def rglru_state_shape(cfg: ModelConfig, batch: int):
    """Shapes of (conv carry, RG-LRU state) for ``batch`` sequences."""
    w = cfg.lru_width or cfg.d_model
    return ((batch, _CONV_W - 1, w), (batch, w))
