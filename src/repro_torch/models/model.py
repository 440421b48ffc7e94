"""Model builder: init / full-sequence forward / decode step.

Families:

  dense   — [ln1, attn, ln2, ffn] x L
  moe     — ``first_k_dense`` dense layers + [ln1, attn, ln2, moe] x L'
            (``dense_layers`` / ``moe_layers`` stacks)
  hybrid  — repeating ``block_pattern`` groups of RG-LRU and local
            (sliding-window) attention layers, plus leftover layers
            (RecurrentGemma)
  ssm     — groups of ``slstm_every - 1`` mLSTM layers + 1 sLSTM layer,
            each [ln, block] with a residual (xLSTM; ``groups.mlstm``
            leaves stacked ``[n_groups, slstm_every - 1, ...]``,
            ``groups.slstm`` leaves ``[n_groups, ...]``)

The JAX package stacks per-layer parameters along a leading layer (or
group) axis and scans over them; the port keeps that stacked layout (so
the weight bridge is key-for-key) and runs a Python loop over layers,
slicing one layer's parameters per iteration (``attn_layer_params``,
``param_layer``, ``layer_params``); the full-sequence forward, which
training differentiates, unbinds each stack once (``unstack``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (full_attention_decode,
                                        sliding_window_mask_decode)
from repro_torch.models.attention import (apply_attention_train,
                                          expand_kv, heads_out, heads_qkv,
                                          init_attention, make_causal_core)
from repro_torch.models.common import (apply_ffn, apply_norm, dense_init,
                                       embed_init, init_ffn, init_norm,
                                       sinusoidal_embedding, torch_dtype,
                                       tp_split)
from repro_torch.models.moe import apply_moe, init_moe, moe_aux_loss
from repro_torch.models.rglru import (apply_rglru_block, init_rglru_block,
                                      rglru_state_shape)
from repro_torch.models.xlstm import (apply_mlstm_block, apply_slstm_block,
                                      init_mlstm_block, init_slstm_block,
                                      mlstm_state_init, slstm_state_init)

PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm")
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
    """Raise ValueError for a family the caller does not cover (by
    default: a family the port does not know)."""
    if cfg.family not in families:
        raise ValueError(
            f"family {cfg.family!r} is not supported here (only "
            f"{', '.join(repr(f) for f in families)})")


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


def ssm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(number of xLSTM groups, layers a group) — ``num_layers //
    slstm_every`` groups of ``slstm_every - 1`` mLSTM layers and one
    sLSTM layer; layers past the last whole group are not built, as in
    JAX."""
    return cfg.num_layers // cfg.slstm_every, cfg.slstm_every


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
    layers. Ssm: ``groups`` = {"mlstm": {"ln", "blk"} with leading
    ``[n_groups, slstm_every - 1]``, "slstm": {"ln", "blk"} with leading
    ``[n_groups]``} — as in JAX.
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
    if cfg.family == "ssm":
        ng, se = ssm_groups(cfg)
        ml, sl = (ng, se - 1), (ng,)
        p["groups"] = {
            "mlstm": {"ln": init_norm(cfg, cfg.d_model, device=dev, lead=ml),
                      "blk": init_mlstm_block(gen, cfg, device=dev,
                                              lead=ml)},
            "slstm": {"ln": init_norm(cfg, cfg.d_model, device=dev, lead=sl),
                      "blk": init_slstm_block(gen, cfg, device=dev,
                                              lead=sl)}}
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


def layer_params(stacked, *idx: int):
    """The ``idx`` slice of a stacked parameter tree (views, no copy):
    layer ``i``, or (group, layer) of the ssm family's mLSTM stack."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, *idx) for k, v in stacked.items()}
    return stacked[idx]


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


def ffn_or_moe(lp, h, cfg: ModelConfig, capacity_factor: float = 1.25,
               ep_groups: int = 0, *, specs=None, tp=None,
               seq_dim=None) -> torch.Tensor:
    """The layer's feed-forward block: its dense FFN, or its MoE (a
    layer's parameters hold ``ffn`` or ``moe``, never both). Placed
    weights: ``specs`` (the layer's) and ``tp``, the TP axis; with
    ``seq_dim``, this process's chunk of that dim (sequence
    parallelism)."""
    kind = "moe" if "moe" in lp else "ffn"
    sp = None if specs is None else specs[kind]
    if kind == "moe":
        return apply_moe(lp["moe"], h, cfg, capacity_factor, ep_groups,
                         specs=sp, tp=tp, seq_dim=seq_dim)
    return apply_ffn(lp["ffn"], h, cfg, specs=sp, tp=tp, seq_dim=seq_dim)


def layer_path(cfg: ModelConfig, i: int) -> Tuple[Tuple[str, ...],
                                                  Tuple[int, ...]]:
    """Where layer ``i``'s parameters live in the tree: (the dict keys of
    its stack, its index along the stack's leading dims). Dense and MoE
    as ``attn_layer_params``; hybrid by group and pattern position (a
    leftover layer has no stacked dim); ssm in
    ``layer_kinds``' order (an mLSTM layer at (group, j), the group's
    sLSTM at (group,))."""
    if cfg.family == "dense":
        return ("layers",), (i,)
    if cfg.family == "moe":
        nd = cfg.first_k_dense
        return (("dense_layers",), (i,)) if i < nd else \
            (("moe_layers",), (i - nd,))
    if cfg.family == "ssm":
        g, j = divmod(i, cfg.slstm_every)
        if j < cfg.slstm_every - 1:
            return ("groups", "mlstm"), (g, j)
        return ("groups", "slstm"), (g,)
    pat = cfg.block_pattern
    n_groups, _ = hybrid_groups(cfg)
    g, j = divmod(i, len(pat))
    key = f"{j}_{pat[j]}"
    return (("groups", key), (g,)) if g < n_groups else \
        (("leftover", key), ())


def param_layer(params, cfg: ModelConfig, i: int):
    """Layer ``i``'s parameters of any family (views, no copy)."""
    keys, idx = layer_path(cfg, i)
    tree = params
    for k in keys:
        tree = tree[k]
    return layer_params(tree, *idx) if idx else tree


# ===================================================================== #
# Full-sequence forward
# ===================================================================== #
def _sub(specs, key):
    return None if specs is None else specs[key]


def _attn_layer_fwd(lp, x, positions, cfg, core, *,
                    capacity_factor: float = 1.25, ep_groups: int = 0,
                    specs=None, tp=None):
    """One attention layer. Returns (x, (k, v), MoE aux loss — 0 for a
    dense FFN layer). Placed weights: ``specs`` (the layer's) and
    ``tp``; (k, v) are then the kv heads this process's query heads
    read."""
    h = apply_norm(lp["ln1"], x, cfg)
    attn_out, kv = apply_attention_train(lp["attn"], h, positions, cfg, core,
                                         specs=_sub(specs, "attn"), tp=tp)
    x = x + attn_out
    h = apply_norm(lp["ln2"], x, cfg)
    aux = (moe_aux_loss(lp["moe"], h, cfg) if "moe" in lp
           else torch.zeros((), device=x.device))
    return x + ffn_or_moe(lp, h, cfg, capacity_factor, ep_groups,
                          specs=specs, tp=tp), kv, aux


def _rglru_layer_fwd(lp, x, cfg, state=None, *, decode=False, specs=None,
                     tp=None):
    """One RG-LRU layer with its FFN: (x, new state). Placed weights:
    ``specs`` (the layer's) and ``tp``, the TP axis."""
    h = apply_norm(lp["ln1"], x, cfg)
    mix, new_state = apply_rglru_block(lp["rglru"], h, cfg, state,
                                       decode=decode,
                                       specs=_sub(specs, "rglru"), tp=tp)
    x = x + mix
    h = apply_norm(lp["ln2"], x, cfg)
    return x + apply_ffn(lp["ffn"], h, cfg, specs=_sub(specs, "ffn"),
                         tp=tp), new_state


def layer_kinds(cfg: ModelConfig):
    """The built layers in order, ``(i, kind, idx)``: ``idx`` is the ssm
    family's index of the layer's state in ``DecodeState.rec[kind]``
    ((group, j) of an mLSTM layer, (group,) of the sLSTM; None for the
    other families, whose states follow layer order)."""
    if cfg.family == "ssm":
        ng, se = ssm_groups(cfg)
        for i in range(ng * se):
            keys, idx = layer_path(cfg, i)
            yield i, keys[-1], idx
        return
    for i in range(cfg.num_layers):
        yield i, cfg.layer_kind(i), None


def plain_layers(params, cfg: ModelConfig):
    """The layer accessor of a plain parameter tree: ``i -> (layer i's
    parameters, None)`` (no specs: every weight whole)."""
    return lambda i: (param_layer(params, cfg, i), None)


def _ssm_layer_fwd(kind, lp, x, cfg, state=None, *, decode=False,
                   specs=None, tp=None):
    """One xLSTM layer with its residual: (x, new state). Placed weights:
    ``specs`` (the layer's) and ``tp``, the TP axis."""
    h = apply_norm(lp["ln"], x, cfg)
    apply = apply_mlstm_block if kind == "mlstm" else apply_slstm_block
    y, st = apply(lp["blk"], h, cfg, state, decode=decode,
                  specs=_sub(specs, "blk"), tp=tp)
    return x + y, st


def embed_tokens(params, cfg: ModelConfig, tokens=None, embeds=None,
                 positions=None, *, specs=None, tp=None, seq_dim=None):
    """Token embeddings, or the given ``embeds`` [B, T, d] (a modality
    frontend's output), plus the sinusoidal table where the model has
    one. Placed weights (``specs``, ``tp``) whose vocab rows are split
    over the TP axis: each process looks up its own rows (other ids give
    zero) and one all-reduce sums them. With ``seq_dim`` (sequence
    parallelism) the result is this process's chunk of that dim: the
    split lookup is reduce-scattered, ``embeds``, a whole table's rows
    and ``positions`` are cut locally."""
    def own(t):
        return t if seq_dim is None else tp.shard(t, seq_dim)
    if embeds is not None:
        x = own(embeds)
    elif tp_split(None if specs is None else specs["embed"], 0, tp):
        emb = params["embed"]
        ids = tokens - tp.index * emb.shape[0]
        inside = (ids >= 0) & (ids < emb.shape[0])
        x = torch.where(inside[..., None], emb[ids.clamp(0, emb.shape[0] - 1)],
                        0)
        x = tp.sum(x) if seq_dim is None else tp.sum_scatter(x, seq_dim)
    else:
        x = params["embed"][own(tokens)]
    if cfg.positional == "sinusoidal":
        if positions is None:
            n = x.shape[1] * (1 if seq_dim is None else tp.count)
            positions = torch.arange(n, device=x.device)[None]
        x = x + sinusoidal_embedding(own(positions), cfg.d_model).to(
            x.dtype)
    return x


def unembed(params, cfg: ModelConfig, x, *, specs=None, tp=None):
    """Final norm and logits [..., V]. Placed weights split over the TP
    axis: by vocab (the tied table's rows), each process makes its logit
    columns and they are gathered; by ``d`` (the untied ``unembed``'s
    rows: JAX's ``embed$`` rule matches it first), each multiplies its
    slice of ``x`` and the partial logits are summed."""
    x = apply_norm(params["final_norm"], x, cfg)
    key = "embed" if cfg.tie_embeddings else "unembed"
    leaf = params[key]                       # [V, d] tied, else [d, V]
    v_dim, d_dim = (0, 1) if cfg.tie_embeddings else (1, 0)
    w = leaf.T if cfg.tie_embeddings else leaf
    spec = None if specs is None else specs[key]
    if tp_split(spec, d_dim, tp):
        n = leaf.shape[d_dim]
        return tp.sum(x[..., tp.index * n:(tp.index + 1) * n] @ w)
    logits = x @ w
    if tp_split(spec, v_dim, tp):
        logits = tp.cat(logits, dim=-1)
    return logits


def unstack(stacked, n: int) -> list:
    """The ``n`` slices of a stacked parameter tree along its leading
    axis, one tree of views each. One ``unbind`` per leaf: under autograd
    the stack's gradient is then assembled once, where indexing layer by
    layer would add a zero tensor of the whole stack per layer."""
    if isinstance(stacked, dict):
        parts = {k: unstack(v, n) for k, v in stacked.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(stacked, 0))


def _layer_units(params, cfg: ModelConfig):
    """The forward's units in order, ``(checkpointed, kind, params)``
    (``forward`` maps each kind to ``fn(lp, x, aux) -> (x, aux)``): a
    layer (dense, MoE) or a group
    (hybrid, ssm) — what JAX scans and, with remat, checkpoints — and the
    hybrid family's leftover layers, which JAX does not checkpoint."""
    if cfg.family in POOLED_FAMILIES:
        nd = cfg.first_k_dense if cfg.family == "moe" else 0
        layers = (unstack(params["layers"], cfg.num_layers)
                  if cfg.family == "dense" else
                  (unstack(params["dense_layers"], nd) if nd else [])
                  + unstack(params["moe_layers"], cfg.num_layers - nd))
        return [(True, "attn", lp) for lp in layers]
    if cfg.family == "ssm":
        ng, se = ssm_groups(cfg)
        gp = params["groups"]
        return [(True, "ssm_group",
                 {"mlstm": unstack(m, se - 1), "slstm": s})
                for m, s in zip(unstack(gp["mlstm"], ng),
                                unstack(gp["slstm"], ng))]
    n_groups, n_left = hybrid_groups(cfg)
    pat = cfg.block_pattern
    units = [(True, "hybrid_group", g)
             for g in unstack(params["groups"], n_groups)]
    if n_left:
        left = params["leftover"]
        units += [(False, kind, left[f"{j}_{kind}"])
                  for j, kind in enumerate(pat[:n_left])]
    return units


def forward(params, cfg: ModelConfig, tokens=None, embeds=None, *,
            backend: str = "xla", chunk: int = 512,
            capacity_factor: float = 1.25, remat: bool = False,
            ep_groups: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward over ``tokens`` [B, T] or ``embeds``
    [B, T, d]. Returns (logits [B,T,V], moe_aux — the MoE layers' summed
    load-balancing loss, 0 without MoE).

    MoE layers route with ``capacity_factor`` (the default drops tokens
    past capacity, as in JAX) in ``ep_groups`` token groups (see
    ``apply_moe``). Hybrid attention layers use the sliding-window core
    (``window=cfg.local_window``) of the same backend. The ssm family has
    no attention (``backend`` is unused).

    ``remat=True`` (under autograd) checkpoints each unit JAX checkpoints
    — a layer of the dense and MoE families, a group of the hybrid and
    ssm ones; hybrid leftover layers are not — with
    ``torch.utils.checkpoint``. The values are the same as without it.
    JAX's policy keeps the matmul outputs that have no batch dimension
    (none of the units' activations); the port keeps only each unit's
    inputs and recomputes the rest in backward. JAX's
    ``layer_constraints`` re-pin GSPMD shardings inside the scan and have
    no single-device counterpart.
    """
    require_family(cfg)
    B, T = tokens.shape if embeds is None else embeds.shape[:2]
    dev = (tokens if embeds is None else embeds).device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    x = embed_tokens(params, cfg, tokens, embeds, positions)
    core = make_causal_core(cfg, backend=backend, chunk=chunk,
                            window=(cfg.local_window
                                    if cfg.family == "hybrid" else 0))

    def attn(lp, x, aux):
        x, _, a = _attn_layer_fwd(lp, x, positions, cfg, core,
                                  capacity_factor=capacity_factor,
                                  ep_groups=ep_groups)
        return x, aux + a

    def rglru(lp, x, aux):
        return _rglru_layer_fwd(lp, x, cfg)[0], aux

    def hybrid_group(gp, x, aux):
        for j, kind in enumerate(cfg.block_pattern):
            x, aux = (rglru if kind == "rglru" else attn)(
                gp[f"{j}_{kind}"], x, aux)
        return x, aux

    def ssm_group(gp, x, aux):
        for lp in gp["mlstm"]:
            x, _ = _ssm_layer_fwd("mlstm", lp, x, cfg)
        return _ssm_layer_fwd("slstm", gp["slstm"], x, cfg)[0], aux

    fns = {"attn": attn, "rglru": rglru, "hybrid_group": hybrid_group,
           "ssm_group": ssm_group}
    ckpt = remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=dev)
    for checkpointed, kind, lp in _layer_units(params, cfg):
        if ckpt and checkpointed:
            x, aux = checkpoint(fns[kind], lp, x, aux, use_reentrant=False)
        else:
            x, aux = fns[kind](lp, x, aux)
    return unembed(params, cfg, x), aux


# ===================================================================== #
# Single-device decode (dense in-memory cache; the greedy oracle)
# ===================================================================== #
class DecodeState(NamedTuple):
    """Simple (non-paged) cache: KV tensors + recurrent states."""
    kv_k: Any          # [L_attn, B, maxlen, K, hd]; ssm: None
    kv_v: Any
    lens: torch.Tensor  # [B] current sequence length
    rec: Any           # hybrid: (conv [n_rg,B,3,w], h [n_rg,B,w] f32);
    #                    ssm: {"mlstm": MLstmState [ng, se-1, B, ...],
    #                          "slstm": SLstmState [ng, B, ...]} f32;
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
    position % ring), plus zero RG-LRU and conv states. Ssm: no KV, the
    mLSTM/sLSTM states of every group (``max_len`` is unused) — as in
    JAX.
    """
    require_family(cfg)
    lens = (torch.zeros((batch,), dtype=torch.int64, device=device)
            if prefix_lens is None else prefix_lens)
    if cfg.family == "ssm":
        ng, se = ssm_groups(cfg)
        rec = {"mlstm": mlstm_state_init(cfg, batch, device=device,
                                         lead=(ng, se - 1)),
               "slstm": slstm_state_init(cfg, batch, device=device,
                                         lead=(ng,))}
        return DecodeState(None, None, lens, rec)
    dt = torch_dtype(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim
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


def _cached_attn_decode(lp, x, state_k, state_v, lens, cfg, *, window=0,
                        specs=None, tp=None):
    """x: [B, 1, d]; writes the token's KV into the cache IN PLACE.

    With ``window`` the cache is a ring (slot = position % its length)
    and the token attends to the last ``window`` positions it holds.
    Placed weights: the cache holds the kv heads this process's query
    heads read (``heads_qkv``).
    """
    q, k, v, h0, idx = heads_qkv(lp, x, lens[:, None], cfg, specs, tp)
    mask = cache_write(state_k, state_v, k[:, 0], v[:, 0], lens,
                       window=window)
    out = full_attention_decode(q[:, 0], expand_kv(state_k, idx),
                                expand_kv(state_v, idx), mask)
    return heads_out(lp, out[:, None], h0, cfg, x.dtype, specs, tp)


def cache_write(state_k, state_v, k, v, lens, *, window=0):
    """Write one token's ``k``/``v`` [B, K, hd] at position ``lens`` into
    a cache [B, maxlen, K, hd] IN PLACE; returns the [B, maxlen] mask of
    the slots the token attends to. With ``window`` the cache is a ring
    (slot = position % its length) and the mask keeps the last
    ``window`` positions it holds."""
    B, maxlen = state_k.shape[:2]
    rows = torch.arange(B, device=k.device)
    if window:
        pos = lens % maxlen                                  # ring buffer
        state_k[rows, pos] = k
        state_v[rows, pos] = v
        rel = torch.arange(maxlen, device=k.device)[None]
        # Absolute position of each ring slot given the write head.
        abs_pos = lens[:, None] - ((pos[:, None] - rel) % maxlen)
        return (abs_pos >= 0) & sliding_window_mask_decode(abs_pos, lens,
                                                           window)
    state_k[rows, lens] = k
    state_v[rows, lens] = v
    return torch.arange(maxlen, device=k.device)[None] <= lens[:, None]


def _attn_layer_decode(lp, x, ck, cv, lens, cfg, *, window=0, specs=None,
                       tp=None):
    h = apply_norm(lp["ln1"], x, cfg)
    x = x + _cached_attn_decode(lp["attn"], h, ck, cv, lens, cfg,
                                window=window, specs=_sub(specs, "attn"),
                                tp=tp)
    h = apply_norm(lp["ln2"], x, cfg)
    return x + ffn_or_moe(lp, h, cfg, capacity_factor=-1.0, specs=specs,
                          tp=tp)


def decode_layers(layer, cfg: ModelConfig, state: DecodeState, x, *,
                  tp=None) -> torch.Tensor:
    """``decode_step``'s layer loop over the embedded tokens ``x`` [B, 1,
    d]: ``layer(i)`` gives layer ``i``'s parameters and their specs (or
    None; ``plain_layers``), ``tp`` the TP axis of placed ones. The
    state's tensors are updated IN PLACE; under placed weights they hold
    this process's kv heads, RG-LRU columns and mLSTM heads, as
    ``prefill_layers`` makes them."""
    lens = state.lens
    window = cfg.local_window if cfg.family == "hybrid" else 0
    ai = ri = 0
    for i, kind, idx in layer_kinds(cfg):
        lp, ls = layer(i)
        if kind == "attn":
            x = _attn_layer_decode(lp, x, state.kv_k[ai], state.kv_v[ai],
                                   lens, cfg, window=window, specs=ls, tp=tp)
            ai += 1
        elif kind == "rglru":
            conv_c, lru_h = state.rec
            x, (cc, hh) = _rglru_layer_fwd(
                lp, x, cfg, (conv_c[ri], lru_h[ri]), decode=True, specs=ls,
                tp=tp)
            conv_c[ri].copy_(cc)
            lru_h[ri].copy_(hh)
            ri += 1
        else:
            rec = state.rec[kind]
            st = type(rec)(*(a[idx] for a in rec))
            x, st = _ssm_layer_fwd(kind, lp, x, cfg, st, decode=True,
                                   specs=ls, tp=tp)
            for dst, src in zip(rec, st):
                dst[idx].copy_(src)
    return x


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
    x = decode_layers(plain_layers(params, cfg), cfg, state, x)
    logits = unembed(params, cfg, x[:, 0])
    return logits, DecodeState(state.kv_k, state.kv_v, lens + 1, state.rec)
