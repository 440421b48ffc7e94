"""Shared model building blocks: norms, RoPE, activations, initializers.

Parameters are plain nested dicts of tensors with the JAX package's keys;
every block is a pair ``init_*(generator, cfg, device) -> params`` and a
function that applies it. Initializers draw from the same distributions
as the JAX package (not the same numbers: ``torch.Generator`` and
``jax.random`` differ); tests bridge JAX weights when they need equal ones.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


# --------------------------------------------------------------------- #
# Tensor parallelism: what a layer reads of a placed leaf
# --------------------------------------------------------------------- #
TP_AXIS = "model"


def spec_axes(entry):
    """The mesh axes of one spec entry (a name, a tuple of names, None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def tp_split(spec, dim: int, tp) -> bool:
    """Whether dim ``dim`` of a leaf placed by ``spec`` is split over the
    TP axis. ``tp`` is the TP axis (``distributed.placement.TPAxis``: its
    ``index``, ``count``, ``sum`` and ``cat``) or None: never split."""
    return tp is not None and spec is not None and \
        TP_AXIS in spec_axes(tuple(spec)[dim])


def row_parallel(x: torch.Tensor, w: torch.Tensor, split: bool,
                 tp) -> torch.Tensor:
    """``x @ w``; when ``w``'s rows are split over the TP axis, ``x``
    holds the matching columns and the partial products are summed over
    it (in float32, cast back)."""
    y = x @ w
    return tp.sum(y) if split else y


# --------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------- #
def init_norm(cfg: ModelConfig, dim: int, *, device, lead=()):
    """Norm parameters (float32), with optional leading stack dims."""
    shape = tuple(lead) + (dim,)
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(shape, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(shape, device=device),
                "bias": torch.zeros(shape, device=device)}
    if cfg.norm_type == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        xf = xf * params["scale"]
    else:  # layernorm / nonparametric_ln
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.var(xf, -1, keepdim=True, unbiased=False)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm_type == "layernorm":
            xf = xf * params["scale"] + params["bias"]
    return xf.to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the last (head_dim) axis — Qwen3 qk-norm."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


# --------------------------------------------------------------------- #
# Positional encodings
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half RoPE. x: [..., T, n_heads, head_dim]; positions [..., T]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    ang = positions[..., None].float() * freqs               # [..., T, hd/2]
    cos = torch.cos(ang)[..., None, :]                        # [..., T, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., T] -> [..., T, dim] classic transformer sinusoids."""
    half = dim // 2
    freq = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------- #
# Linear / embedding initializers
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               *, device, lead=()) -> torch.Tensor:
    """N(0, 1/in_dim) weights [*lead, in_dim, out_dim]."""
    w = torch.randn(tuple(lead) + (in_dim, out_dim), generator=gen,
                    device=device, dtype=torch.float32)
    return (w * in_dim ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, *,
               device) -> torch.Tensor:
    """N(0, 0.02^2) embedding table [vocab, dim]."""
    w = torch.randn((vocab, dim), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------- #
# FFN (dense)
# --------------------------------------------------------------------- #
def init_ffn(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None,
             *, device, lead=()):
    d, dff = cfg.d_model, d_ff or cfg.d_ff
    dt = torch_dtype(cfg)
    p = {"wi": dense_init(gen, d, dff, dt, device=device, lead=lead)}
    if cfg.activation in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, d, dff, dt, device=device, lead=lead)
    p["wo"] = dense_init(gen, dff, d, dt, device=device, lead=lead)
    return p


def apply_ffn(params, x: torch.Tensor, cfg: ModelConfig, *, specs=None,
              tp=None) -> torch.Tensor:
    """The dense FFN. Placed (``specs``, ``tp``): ``wi``/``wg`` hold this
    process's columns and ``wo`` the matching rows, and one all-reduce
    over the TP axis sums the partial outputs."""
    h = x @ params["wi"]
    if cfg.activation == "swiglu":
        h = F.silu(h) * (x @ params["wg"])
    elif cfg.activation == "geglu":
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(h, approximate="tanh") * (x @ params["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    split = tp_split(None if specs is None else specs["wo"], 0, tp)
    return row_parallel(h, params["wo"], split, tp)
