"""Model builder, dense family: init / full-sequence forward / decode step.

The JAX package stacks per-layer parameters along a leading layer axis
and scans over them; the port keeps that stacked layout (so the weight
bridge is key-for-key) and runs a Python loop over layers, slicing one
layer's parameters per iteration with ``layer_params``. Only the dense
family is ported; MoE, hybrid and SSM families raise and come with later
slices.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.online_softmax import finalize, micro_attention_decode
from repro_torch.models.attention import (apply_attention_train,
                                          init_attention, make_causal_core,
                                          qkv_project)
from repro_torch.models.common import (apply_ffn, apply_norm, dense_init,
                                       embed_init, init_ffn, init_norm,
                                       sinusoidal_embedding, torch_dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises RuntimeError when CUDA is asked for and absent — an entry
    point never carries on silently on the CPU; callers that want the
    CPU (the tests) say so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_dense(cfg: ModelConfig) -> None:
    """Raise for the families this slice of the port does not cover."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (only 'dense'); MoE "
            f"and the hybrid/ssm families come with later slices")


# ===================================================================== #
# Init
# ===================================================================== #
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Random weights with the JAX ``init_params`` distributions and keys.

    ``generator`` must live on ``device`` (default: a generator seeded 0).
    Per-layer leaves carry a leading ``num_layers`` axis, as in JAX.
    """
    require_dense(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    dt = torch_dtype(cfg)
    L = cfg.num_layers
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device=dev),
        "final_norm": init_norm(cfg, cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                  device=dev)
    p["layers"] = {
        "ln1": init_norm(cfg, cfg.d_model, device=dev, lead=(L,)),
        "attn": init_attention(gen, cfg, device=dev, lead=(L,)),
        "ln2": init_norm(cfg, cfg.d_model, device=dev, lead=(L,)),
        "ffn": init_ffn(gen, cfg, device=dev, lead=(L,)),
    }
    return p


def params_device(params) -> torch.device:
    """Device of the parameter tree (of its embedding table)."""
    return params["embed"].device


def layer_params(stacked, i: int):
    """Layer ``i``'s slice of a stacked parameter tree (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# ===================================================================== #
# Full-sequence forward
# ===================================================================== #
def _attn_layer_fwd(lp, x, positions, cfg, core):
    h = apply_norm(lp["ln1"], x, cfg)
    attn_out, kv = apply_attention_train(lp["attn"], h, positions, cfg, core)
    x = x + attn_out
    h = apply_norm(lp["ln2"], x, cfg)
    return x + apply_ffn(lp["ffn"], h, cfg), kv


def embed_tokens(params, cfg: ModelConfig, tokens, positions=None):
    x = params["embed"][tokens]
    if cfg.positional == "sinusoidal":
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None]
        x = x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    return x


def unembed(params, cfg: ModelConfig, x):
    x = apply_norm(params["final_norm"], x, cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w


def forward(params, cfg: ModelConfig, tokens, *, backend: str = "xla",
            chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward. Returns (logits [B,T,V], moe_aux)."""
    require_dense(cfg)
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    x = embed_tokens(params, cfg, tokens, positions)
    core = make_causal_core(cfg, backend=backend, chunk=chunk)
    for i in range(cfg.num_layers):
        x, _ = _attn_layer_fwd(layer_params(params["layers"], i), x,
                               positions, cfg, core)
    return unembed(params, cfg, x), torch.zeros((), device=dev)


# ===================================================================== #
# Single-device decode (dense in-memory cache; the greedy oracle)
# ===================================================================== #
class DecodeState(NamedTuple):
    """Simple (non-paged) cache: full KV tensors + recurrent states."""
    kv_k: Any          # [L, B, maxlen, K, hd]
    kv_v: Any
    lens: torch.Tensor  # [B] current sequence length
    rec: Any           # family-specific recurrent states (None: dense)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      prefix_lens=None, *, device) -> DecodeState:
    require_dense(cfg)
    dt = torch_dtype(cfg)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    lens = (torch.zeros((batch,), dtype=torch.int64, device=device)
            if prefix_lens is None else prefix_lens)
    kv_k = torch.zeros((L, batch, max_len, K, hd), dtype=dt, device=device)
    kv_v = torch.zeros((L, batch, max_len, K, hd), dtype=dt, device=device)
    return DecodeState(kv_k, kv_v, lens, None)


def full_attention_decode(q, k, v, mask, *, scale=None):
    """Reference single-shot decode attention (paper Eq. 1). q:[B,H,D]."""
    o, _, l = micro_attention_decode(q, k, v, mask, scale=scale)
    return finalize(o, l).to(q.dtype)


def _cached_attn_decode(lp, x, state_k, state_v, lens, cfg):
    """x: [B, 1, d]; writes the token's KV into the cache IN PLACE."""
    B = x.shape[0]
    q, k, v = qkv_project(lp, x, lens[:, None], cfg)
    rows = torch.arange(B, device=x.device)
    state_k[rows, lens] = k[:, 0]
    state_v[rows, lens] = v[:, 0]
    maxlen = state_k.shape[1]
    mask = torch.arange(maxlen, device=x.device)[None] <= lens[:, None]
    out = full_attention_decode(q[:, 0], state_k, state_v, mask)
    return out.reshape(B, 1, -1).to(x.dtype) @ lp["wo"]


def decode_step(params, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step for a batch. tokens: [B] -> (logits [B,V], state).

    The cache tensors are updated in place (the JAX version returns new
    arrays); the returned state shares them and advances ``lens``.
    """
    require_dense(cfg)
    lens = state.lens
    x = embed_tokens(params, cfg, tokens[:, None], positions=lens[:, None])
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = apply_norm(lp["ln1"], x, cfg)
        x = x + _cached_attn_decode(lp["attn"], h, state.kv_k[i],
                                    state.kv_v[i], lens, cfg)
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + apply_ffn(lp["ffn"], h, cfg)
    logits = unembed(params, cfg, x[:, 0])
    return logits, DecodeState(state.kv_k, state.kv_v, lens + 1, None)
