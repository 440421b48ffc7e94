"""Model builder: init / full-sequence forward / decode step.

Families ported so far:

  dense   — [ln1, attn, ln2, ffn] x L
  moe     — ``first_k_dense`` dense layers + [ln1, attn, ln2, moe] x L'
            (``dense_layers`` / ``moe_layers`` stacks)
  hybrid  — repeating ``block_pattern`` groups of RG-LRU and local
            (sliding-window) attention layers, plus leftover layers
            (RecurrentGemma)

The JAX package stacks per-layer parameters along a leading layer (or
group) axis and scans over them; the port keeps that stacked layout (so
the weight bridge is key-for-key) and runs a Python loop over layers,
slicing one layer's parameters per iteration (``attn_layer_params``,
``_layer_params``). The ssm family raises and comes with a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (full_attention_decode,
                                        sliding_window_mask_decode)
from repro_torch.models.attention import (apply_attention_train,
                                          init_attention, make_causal_core,
                                          qkv_project)
from repro_torch.models.common import (apply_ffn, apply_norm, dense_init,
                                       embed_init, init_ffn, init_norm,
                                       sinusoidal_embedding, torch_dtype)
from repro_torch.models.moe import apply_moe, init_moe, moe_aux_loss
from repro_torch.models.rglru import (apply_rglru_block, init_rglru_block,
                                      rglru_state_shape)

PORTED_FAMILIES = ("dense", "moe", "hybrid")
# Families whose KV lives in paged pools (every layer attends).
POOLED_FAMILIES = ("dense", "moe")


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


def require_family(cfg: ModelConfig, families=PORTED_FAMILIES) -> None:
    """Raise for a family the caller does not cover (by default: the
    families the port does not cover yet)."""
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported here yet (only "
            f"{', '.join(repr(f) for f in families)}); the ssm family "
            f"comes with a later slice")


# ===================================================================== #
# Init
# ===================================================================== #
def _init_attn_layer(gen, cfg: ModelConfig, *, device, lead=(),
                     moe: bool = False):
    p = {"ln1": init_norm(cfg, cfg.d_model, device=device, lead=lead),
         "attn": init_attention(gen, cfg, device=device, lead=lead),
         "ln2": init_norm(cfg, cfg.d_model, device=device, lead=lead)}
    if moe:
        p["moe"] = init_moe(gen, cfg, device=device, lead=lead)
    else:
        p["ffn"] = init_ffn(gen, cfg, device=device, lead=lead)
    return p


def _init_rglru_layer(gen, cfg: ModelConfig, *, device, lead=()):
    return {"ln1": init_norm(cfg, cfg.d_model, device=device, lead=lead),
            "rglru": init_rglru_block(gen, cfg, device=device, lead=lead),
            "ln2": init_norm(cfg, cfg.d_model, device=device, lead=lead),
            "ffn": init_ffn(gen, cfg, device=device, lead=lead)}


def _init_layer(kind: str, gen, cfg: ModelConfig, *, device, lead=()):
    init = _init_rglru_layer if kind == "rglru" else _init_attn_layer
    return init(gen, cfg, device=device, lead=lead)


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(number of whole ``block_pattern`` groups, leftover layers)."""
    n = len(cfg.block_pattern)
    return cfg.num_layers // n, cfg.num_layers % n


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Random weights with the JAX ``init_params`` distributions and keys.

    ``generator`` must live on ``device`` (default: a generator seeded 0).
    Dense: per-layer leaves carry a leading ``num_layers`` axis. MoE:
    ``dense_layers`` (the first ``first_k_dense`` layers, FFN width
    ``d_ff``, only if any) and ``moe_layers`` stacks. Hybrid:
    ``groups`` holds one entry ``f"{j}_{kind}"`` per pattern position with
    a leading ``n_groups`` axis, ``leftover`` the unstacked remaining
    layers — as in JAX.
    """
    require_family(cfg)
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
    if cfg.family == "dense":
        p["layers"] = _init_attn_layer(gen, cfg, device=dev, lead=(L,))
        return p
    if cfg.family == "moe":
        nd = cfg.first_k_dense
        if nd:
            p["dense_layers"] = _init_attn_layer(gen, cfg, device=dev,
                                                 lead=(nd,))
        p["moe_layers"] = _init_attn_layer(gen, cfg, device=dev,
                                           lead=(L - nd,), moe=True)
        return p
    n_groups, n_left = hybrid_groups(cfg)
    pat = cfg.block_pattern
    p["groups"] = {f"{j}_{kind}": _init_layer(kind, gen, cfg, device=dev,
                                              lead=(n_groups,))
                   for j, kind in enumerate(pat)}
    if n_left:
        p["leftover"] = {f"{j}_{kind}": _init_layer(kind, gen, cfg,
                                                    device=dev)
                         for j, kind in enumerate(pat[:n_left])}
    return p


def params_device(params) -> torch.device:
    """Device of the parameter tree (of its embedding table)."""
    return params["embed"].device


def layer_params(stacked, i: int):
    """Layer ``i``'s slice of a stacked parameter tree (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def attn_layer_params(params, cfg: ModelConfig, i: int):
    """Layer ``i``'s parameters of a dense or MoE model (views): MoE
    layers below ``first_k_dense`` come from ``dense_layers``, the rest
    from ``moe_layers``."""
    if cfg.family == "dense":
        return layer_params(params["layers"], i)
    nd = cfg.first_k_dense
    if i < nd:
        return layer_params(params["dense_layers"], i)
    return layer_params(params["moe_layers"], i - nd)


def ffn_or_moe(lp, h, cfg: ModelConfig,
               capacity_factor: float = 1.25) -> torch.Tensor:
    """The layer's feed-forward block: its dense FFN, or its MoE (a
    layer's parameters hold ``ffn`` or ``moe``, never both)."""
    if "moe" in lp:
        return apply_moe(lp["moe"], h, cfg, capacity_factor)
    return apply_ffn(lp["ffn"], h, cfg)


def _layer_params(params, cfg: ModelConfig, i: int):
    """Layer ``i``'s parameters of a hybrid model (views, no copy)."""
    pat = cfg.block_pattern
    n_groups, _ = hybrid_groups(cfg)
    g, j = divmod(i, len(pat))
    key = f"{j}_{pat[j]}"
    if g < n_groups:
        return layer_params(params["groups"][key], g)
    return params["leftover"][key]


# ===================================================================== #
# Full-sequence forward
# ===================================================================== #
def _attn_layer_fwd(lp, x, positions, cfg, core, *,
                    capacity_factor: float = 1.25):
    """One attention layer. Returns (x, (k, v), MoE aux loss — 0 for a
    dense FFN layer)."""
    h = apply_norm(lp["ln1"], x, cfg)
    attn_out, kv = apply_attention_train(lp["attn"], h, positions, cfg, core)
    x = x + attn_out
    h = apply_norm(lp["ln2"], x, cfg)
    aux = (moe_aux_loss(lp["moe"], h, cfg) if "moe" in lp
           else torch.zeros((), device=x.device))
    return x + ffn_or_moe(lp, h, cfg, capacity_factor), kv, aux


def _rglru_layer_fwd(lp, x, cfg, state=None, *, decode=False):
    h = apply_norm(lp["ln1"], x, cfg)
    mix, new_state = apply_rglru_block(lp["rglru"], h, cfg, state,
                                       decode=decode)
    x = x + mix
    h = apply_norm(lp["ln2"], x, cfg)
    return x + apply_ffn(lp["ffn"], h, cfg), new_state


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
            chunk: int = 512, capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward. Returns (logits [B,T,V], moe_aux —
    the MoE layers' summed load-balancing loss, 0 without MoE).

    MoE layers route with ``capacity_factor`` (the default drops tokens
    past capacity, as in JAX). Hybrid attention layers use the
    sliding-window core (``window=cfg.local_window``) of the same backend.
    """
    require_family(cfg)
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    x = embed_tokens(params, cfg, tokens, positions)
    aux = torch.zeros((), device=dev)
    if cfg.family in POOLED_FAMILIES:
        core = make_causal_core(cfg, backend=backend, chunk=chunk)
        for i in range(cfg.num_layers):
            x, _, a = _attn_layer_fwd(attn_layer_params(params, cfg, i), x,
                                      positions, cfg, core,
                                      capacity_factor=capacity_factor)
            aux = aux + a
    else:
        wcore = make_causal_core(cfg, backend=backend, chunk=chunk,
                                 window=cfg.local_window)
        for i in range(cfg.num_layers):
            lp = _layer_params(params, cfg, i)
            if cfg.layer_kind(i) == "rglru":
                x, _ = _rglru_layer_fwd(lp, x, cfg)
            else:
                x, _, _ = _attn_layer_fwd(lp, x, positions, cfg, wcore)
    return unembed(params, cfg, x), aux


# ===================================================================== #
# Single-device decode (dense in-memory cache; the greedy oracle)
# ===================================================================== #
class DecodeState(NamedTuple):
    """Simple (non-paged) cache: KV tensors + recurrent states."""
    kv_k: Any          # [L_attn, B, maxlen, K, hd]
    kv_v: Any
    lens: torch.Tensor  # [B] current sequence length
    rec: Any           # hybrid: (conv [n_rg,B,3,w], h [n_rg,B,w] f32);
    #                    dense, moe: None


def n_attn_layers(cfg: ModelConfig) -> int:
    """Attention layers of the model (every layer for dense and MoE)."""
    return sum(1 for i in range(cfg.num_layers)
               if cfg.layer_kind(i) == "attn")


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      prefix_lens=None, *, device) -> DecodeState:
    """Zero cache for ``batch`` sequences.

    Dense, MoE: KV of ``max_len`` tokens per layer. Hybrid: a ring of
    ``min(max_len, local_window)`` tokens per attention layer (slot =
    position % ring), plus zero RG-LRU and conv states, as in JAX.
    """
    require_family(cfg)
    dt = torch_dtype(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    lens = (torch.zeros((batch,), dtype=torch.int64, device=device)
            if prefix_lens is None else prefix_lens)
    n_attn = n_attn_layers(cfg)
    w = (max_len if cfg.family in POOLED_FAMILIES
         else min(max_len, cfg.local_window))
    kv_k = torch.zeros((n_attn, batch, w, K, hd), dtype=dt, device=device)
    kv_v = torch.zeros((n_attn, batch, w, K, hd), dtype=dt, device=device)
    rec = None
    if cfg.family == "hybrid":
        n_rg = cfg.num_layers - n_attn
        cshape, hshape = rglru_state_shape(cfg, batch)
        rec = (torch.zeros((n_rg,) + cshape, dtype=dt, device=device),
               torch.zeros((n_rg,) + hshape, device=device))
    return DecodeState(kv_k, kv_v, lens, rec)


def _cached_attn_decode(lp, x, state_k, state_v, lens, cfg, *, window=0):
    """x: [B, 1, d]; writes the token's KV into the cache IN PLACE.

    With ``window`` the cache is a ring (slot = position % its length)
    and the token attends to the last ``window`` positions it holds.
    """
    B = x.shape[0]
    q, k, v = qkv_project(lp, x, lens[:, None], cfg)
    rows = torch.arange(B, device=x.device)
    maxlen = state_k.shape[1]
    if window:
        pos = lens % maxlen                                  # ring buffer
        state_k[rows, pos] = k[:, 0]
        state_v[rows, pos] = v[:, 0]
        rel = torch.arange(maxlen, device=x.device)[None]
        # Absolute position of each ring slot given the write head.
        abs_pos = lens[:, None] - ((pos[:, None] - rel) % maxlen)
        mask = (abs_pos >= 0) & sliding_window_mask_decode(abs_pos, lens,
                                                           window)
    else:
        state_k[rows, lens] = k[:, 0]
        state_v[rows, lens] = v[:, 0]
        mask = torch.arange(maxlen, device=x.device)[None] <= lens[:, None]
    out = full_attention_decode(q[:, 0], state_k, state_v, mask)
    return out.reshape(B, 1, -1).to(x.dtype) @ lp["wo"]


def _attn_layer_decode(lp, x, ck, cv, lens, cfg, *, window=0):
    h = apply_norm(lp["ln1"], x, cfg)
    x = x + _cached_attn_decode(lp["attn"], h, ck, cv, lens, cfg,
                                window=window)
    h = apply_norm(lp["ln2"], x, cfg)
    return x + ffn_or_moe(lp, h, cfg, capacity_factor=-1.0)


def decode_step(params, cfg: ModelConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step for a batch. tokens: [B] -> (logits [B,V], state).

    The cache and recurrent-state tensors are updated in place (the JAX
    version returns new arrays); the returned state shares them and
    advances ``lens`` of every slot.
    """
    require_family(cfg)
    lens = state.lens
    x = embed_tokens(params, cfg, tokens[:, None], positions=lens[:, None])
    if cfg.family in POOLED_FAMILIES:
        for i in range(cfg.num_layers):
            x = _attn_layer_decode(attn_layer_params(params, cfg, i), x,
                                   state.kv_k[i], state.kv_v[i], lens, cfg)
    else:
        conv_c, lru_h = state.rec
        ai = ri = 0
        for i in range(cfg.num_layers):
            lp = _layer_params(params, cfg, i)
            if cfg.layer_kind(i) == "attn":
                x = _attn_layer_decode(lp, x, state.kv_k[ai],
                                       state.kv_v[ai], lens, cfg,
                                       window=cfg.local_window)
                ai += 1
            else:
                x, (cc, hh) = _rglru_layer_fwd(
                    lp, x, cfg, (conv_c[ri], lru_h[ri]), decode=True)
                conv_c[ri].copy_(cc)
                lru_h[ri].copy_(hh)
                ri += 1
    logits = unembed(params, cfg, x[:, 0])
    return logits, DecodeState(state.kv_k, state.kv_v, lens + 1, state.rec)
