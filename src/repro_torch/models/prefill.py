"""Dense prefill, batch-slot management, and the paged serving steps.

``prefill`` runs the full-sequence forward while capturing per-layer KV
(and, for the hybrid family, the RG-LRU and conv states) into a
``DecodeState`` — with ``decode_step`` it is the greedy oracle the
serving tests hold the paged path against, and the admission step of the
non-pooled (hybrid) serving path, which then moves the request's state
into a batch slot with ``repack_ring`` and ``write_slot``.

``prefill_chunk_paged`` is the serving admission step: it streams one
prompt chunk into the block pools — causal attention inside the chunk
plus one paged MicroAttention partial per rank over the already-written
prefix, LSE-merged (paper Eq. 3) — and scatters the chunk's KV rows
straight into pre-reserved blocks.

``decode_step_paged`` is the serving decode step: every request's KV
lives in block pools ``pool_k/pool_v: [L, NB, bs, K, hd]`` per rank,
addressed only through block tables; the new token's KV is written into
its tail block, then one paged partial per rank (owner first, then the
read-only creditor pools) is LSE-merged.

Both steps UPDATE THE OWNER POOL IN PLACE (``index_put_`` into the
layer's view) — the counterpart of the JAX package's buffer donation —
and return the same pool tensors, so a pool is never reallocated as a
request grows. Rows whose write target is the out-of-range sentinel
block ``NB`` (inactive decode slots, creditor-bound or padded prefill
rows; the JAX ``mode="drop"`` writes) are removed on the host before the
write: an out-of-range index would be a device-side assert on the card.
Tables keep the reference's bucketed widths (``kvpool.table_bucket``).
The paged steps serve the dense and MoE families; MoE layers route with
no capacity drop (``capacity_factor=-1``), as the JAX serving steps do.
The global pool's steps, over one cluster-wide pool tensor, are in
``repro_torch.serving.sharded_step``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.online_softmax import (combine, finalize,
                                             micro_attention_prefill)
from repro_torch.kernels.ops import (paged_micro_attention,
                                     paged_prefill_attention)
from repro_torch.models.attention import make_causal_core, qkv_project
from repro_torch.models.common import apply_norm
from repro_torch.models.model import (POOLED_FAMILIES, DecodeState,
                                      _attn_layer_fwd, _layer_params,
                                      _rglru_layer_fwd, attn_layer_params,
                                      embed_tokens, ffn_or_moe,
                                      init_decode_state, require_family,
                                      unembed)

Pools = Sequence[Tuple[torch.Tensor, torch.Tensor]]


# ===================================================================== #
# Prefill (dense oracle)
# ===================================================================== #
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int,
            backend: str = "xla", chunk: int = 512,
            capacity_factor: float = -1.0
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Uniform-length prefill. Returns (logits_last [B,V], DecodeState).

    The cache keeps the LAST min(T, ring) tokens in ring layout (slot =
    position % ring), as in the JAX package; ring = max_len for the
    dense and MoE families (MoE layers route with ``capacity_factor``,
    by default no drop), min(max_len, local_window) for the hybrid
    family, whose attention layers use the sliding-window core of
    ``backend``. The hybrid RG-LRU and conv states are stored in layer
    order, the order ``decode_step`` reads them in.
    """
    require_family(cfg)
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    x = embed_tokens(params, cfg, tokens, positions)
    state = init_decode_state(cfg, B, max_len, device=dev)
    ring = state.kv_k.shape[2]
    n = min(T, ring)
    slots = torch.arange(T - n, T, device=dev) % ring
    if cfg.family in POOLED_FAMILIES:
        core = make_causal_core(cfg, backend=backend, chunk=chunk)
        for i in range(cfg.num_layers):
            x, (k, v), _ = _attn_layer_fwd(
                attn_layer_params(params, cfg, i), x, positions, cfg, core,
                capacity_factor=capacity_factor)
            state.kv_k[i][:, slots] = k[:, T - n:]
            state.kv_v[i][:, slots] = v[:, T - n:]
    else:
        wcore = make_causal_core(cfg, backend=backend, chunk=chunk,
                                 window=cfg.local_window)
        conv, h = state.rec
        ai = ri = 0
        for i in range(cfg.num_layers):
            lp = _layer_params(params, cfg, i)
            if cfg.layer_kind(i) == "rglru":
                x, (cc, hh) = _rglru_layer_fwd(lp, x, cfg)
                conv[ri].copy_(cc)
                h[ri].copy_(hh)
                ri += 1
            else:
                x, (k, v), _ = _attn_layer_fwd(lp, x, positions, cfg, wcore)
                state.kv_k[ai][:, slots] = k[:, T - n:]
                state.kv_v[ai][:, slots] = v[:, T - n:]
                ai += 1
    lens = torch.full((B,), T, dtype=torch.int64, device=dev)
    logits = unembed(params, cfg, x[:, -1])
    return logits, state._replace(lens=lens)


# ===================================================================== #
# Slot management (the non-pooled engine batches single prefills into
# fixed decode slots)
# ===================================================================== #
def repack_ring(state: DecodeState, new_maxlen: int,
                n_keep: Optional[int] = None) -> DecodeState:
    """Move a prefill cache into a ring of ``new_maxlen`` slots holding
    the last ``n_keep`` tokens (default: as many as fit).

    The source is read in its own ring layout — slot = position % its
    length, which is the identity only while the prompt fits in it — so
    a prompt longer than the window repacks correctly (the JAX
    package's version slices the source as if it held every token).
    """
    T = int(state.lens[0])
    w_src = state.kv_k.shape[2]
    n = min(T, w_src, new_maxlen, T if n_keep is None else n_keep)
    pos = torch.arange(T - n, T, device=state.kv_k.device)
    src, dst = pos % w_src, pos % new_maxlen
    L, B = state.kv_k.shape[:2]
    shape = (L, B, new_maxlen) + tuple(state.kv_k.shape[3:])
    nk = torch.zeros(shape, dtype=state.kv_k.dtype, device=state.kv_k.device)
    nv = torch.zeros_like(nk)
    nk[:, :, dst] = state.kv_k[:, :, src]
    nv[:, :, dst] = state.kv_v[:, :, src]
    # Own copies: decode_step updates recurrent states in place.
    rec = None if state.rec is None else tuple(r.clone() for r in state.rec)
    return DecodeState(nk, nv, state.lens.clone(), rec)


def batch_axis_map(cfg: ModelConfig):
    """Batch-axis index of each DecodeState field's tensors."""
    require_family(cfg)
    if cfg.family in POOLED_FAMILIES:
        return {"kv": 1, "rec": None}
    return {"kv": 1, "rec": 1}


def write_slot(state: DecodeState, slot: int, req: DecodeState,
               cfg: ModelConfig) -> DecodeState:
    """Copy a single-request (B=1) DecodeState into batch slot ``slot``.

    Every field of the slot is overwritten — KV ring, RG-LRU state, conv
    carry and length — so a reused slot keeps nothing of its previous
    request. Updates ``state``'s tensors IN PLACE (JAX returns new
    arrays) and returns a state sharing them.
    """
    ax = batch_axis_map(cfg)

    def put(dst, src, axis):
        dst.select(axis, slot).copy_(src.select(axis, 0))

    if state.kv_k is not None:
        if state.kv_k.shape[2] != req.kv_k.shape[2]:
            raise ValueError("slot and request ring sizes must match")
        put(state.kv_k, req.kv_k, ax["kv"])                 # [L, B, ...]
        put(state.kv_v, req.kv_v, ax["kv"])
    if state.rec is not None:
        for dst, src in zip(state.rec, req.rec):            # [n_rg, B, ...]
            put(dst, src, ax["rec"])
    state.lens[slot] = req.lens[0]
    return state


# ===================================================================== #
# Paged steps
# ===================================================================== #
def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _write_plan(write_block, write_off, num_blocks: int, device):
    """(rows, blocks, offsets) long tensors of the rows that really write.

    The sentinel block id ``num_blocks`` (and anything else out of range)
    marks a row that writes nothing; those rows are dropped here, on the
    host, so no out-of-range index ever reaches the device.
    """
    wb = _host(write_block).astype(np.int64)
    wo = _host(write_off).astype(np.int64)
    sel = np.nonzero((wb >= 0) & (wb < num_blocks))[0]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dev(sel), dev(wb[sel]), dev(wo[sel])


def _as_int32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def _paged_attn_decode(lp, x, lens, pk, pv, remote, tables, tails, write,
                       cfg):
    """Paged DistAttention for one layer: write tail token, merge ranks.

    pk/pv: [NB, bs, K, hd] — the LOCAL pool's layer view (written in
    place); remote: creditor layer views (read-only); tables [P, B, MB],
    tails [P, B] (rank 0 = local).
    """
    B = x.shape[0]
    q, k, v = qkv_project(lp, x, lens[:, None], cfg)
    ql = q[:, 0]
    rows, wblk, woff = write
    pk.index_put_((wblk, woff), k[rows, 0].to(pk.dtype))
    pv.index_put_((wblk, woff), v[rows, 0].to(pv.dtype))
    part = paged_micro_attention(ql, pk, pv, tables[0], tails[0])
    for p, (rk, rv) in enumerate(remote, start=1):
        part = combine(part, paged_micro_attention(ql, rk, rv, tables[p],
                                                   tails[p]))
    out = finalize(part[0], part[2])
    return out.reshape(B, 1, -1).to(x.dtype) @ lp["wo"]


def decode_step_paged(params, cfg: ModelConfig, tokens, lens,
                      pool_k: torch.Tensor, pool_v: torch.Tensor,
                      tables, tails, write_block, write_off,
                      remote_pools: Pools = ()):
    """Paged DistAttention decode (dense and MoE serving path).

    tokens/lens: [B] (lens = absolute position of the new token);
    pool_k/pool_v: [L, NB, bs, K, hd] — the owner rank's pool, updated IN
    PLACE (the new token's KV lands in its tail block before attention,
    so the token attends to itself); tables/tails: [P, B, MB] / [P, B]
    over (owner pool, *creditor pools); write_block/write_off: [B] target
    of the new token in the OWNER pool, block id NB for inactive slots;
    remote_pools: creditor pool pairs, read-only.
    Returns (logits [B, V], pool_k, pool_v) — the same pool tensors.
    """
    require_family(cfg, POOLED_FAMILIES)
    dev = pool_k.device
    tokens = torch.as_tensor(_host(tokens), dtype=torch.int64).to(dev)
    lens = torch.as_tensor(_host(lens), dtype=torch.int64).to(dev)
    tables = _as_int32(tables, dev)
    tails = _as_int32(tails, dev)
    write = _write_plan(write_block, write_off, pool_k.shape[1], dev)
    x = embed_tokens(params, cfg, tokens[:, None], positions=lens[:, None])
    for i in range(cfg.num_layers):
        lp = attn_layer_params(params, cfg, i)
        h = apply_norm(lp["ln1"], x, cfg)
        x = x + _paged_attn_decode(
            lp["attn"], h, lens, pool_k[i], pool_v[i],
            [(rk[i], rv[i]) for rk, rv in remote_pools], tables, tails,
            write, cfg)
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + ffn_or_moe(lp, h, cfg, capacity_factor=-1.0)
    logits = unembed(params, cfg, x[:, 0])
    return logits, pool_k, pool_v


def _chunk_attn_paged(lp, x, positions, valid, pk, pv, remote, tables,
                      tails, write, cfg):
    """One layer of the streaming-prefill step for one prompt chunk.

    Every chunk query attends to (a) the tokens already streamed into the
    pools — one paged MicroAttention partial per rank over ``tables``,
    which address exactly the written prefix [0, t0) — and (b) the chunk
    itself under the causal mask. Partials LSE-merge (paper Eq. 3), so
    the result equals dense full-prefix attention. The chunk's KV rows
    that land on THIS rank are written into the local pool first; the
    pre-chunk tables mask them out, so only the causal partial sees them.
    """
    B, C = x.shape[:2]
    q, k, v = qkv_project(lp, x, positions, cfg)
    rows, wblk, woff = write
    pk.index_put_((wblk, woff), k[0, rows].to(pk.dtype))
    pv.index_put_((wblk, woff), v[0, rows].to(pv.dtype))
    part = paged_prefill_attention(q[0], pk, pv, tables[0, 0], tails[0, 0])
    for p, (rk, rv) in enumerate(remote, start=1):
        part = combine(part, paged_prefill_attention(q[0], rk, rv,
                                                     tables[p, 0],
                                                     tails[p, 0]))
    o_c, m_c, l_c = micro_attention_prefill(q, k, v, positions, positions,
                                            valid)
    part = combine(part, (o_c[0], m_c[0], l_c[0]))
    out = finalize(part[0], part[2])
    return out.reshape(B, C, -1).to(x.dtype) @ lp["wo"], k[0], v[0]


def prefill_chunk_paged(params, cfg: ModelConfig, tokens, t0: int,
                        n_valid: int, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, tables, tails, write_block,
                        write_off, remote_pools: Pools = ()):
    """One streaming-prefill step over prompt chunk [t0, t0+C).

    tokens: [C] chunk token ids (the final chunk is zero-padded; only the
    first ``n_valid`` entries are real); pool_k/pool_v: the owner rank's
    [L, NB, bs, K, hd] pool, updated IN PLACE; tables/tails: [P, 1, MB] /
    [P, 1] from ``prefix_tables`` addressing the already-written tokens
    [0, t0) on (owner, *creditors); write_block/write_off: [C] OWNER-pool
    target of each chunk token (block id NB for rows bound for a creditor
    or padding); remote_pools: creditor pool pairs, read-only.
    Returns (logits [1, V] at the last valid chunk position, pool_k,
    pool_v, k_chunk [L, C, K, hd], v_chunk) — the chunk KV export is what
    the engine streams to creditor pools for prefix rows.
    """
    require_family(cfg, POOLED_FAMILIES)
    dev = pool_k.device
    C = len(tokens)
    toks = torch.as_tensor(_host(tokens), dtype=torch.int64).to(dev)[None]
    ar = torch.arange(C, dtype=torch.int64, device=dev)
    positions = (t0 + ar)[None]
    valid = (ar < n_valid)[None]
    tables = _as_int32(tables, dev)
    tails = _as_int32(tails, dev)
    write = _write_plan(write_block, write_off, pool_k.shape[1], dev)
    x = embed_tokens(params, cfg, toks, positions)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = attn_layer_params(params, cfg, i)
        h = apply_norm(lp["ln1"], x, cfg)
        out, k, v = _chunk_attn_paged(
            lp["attn"], h, positions, valid, pool_k[i], pool_v[i],
            [(rk[i], rv[i]) for rk, rv in remote_pools], tables, tails,
            write, cfg)
        x = x + out
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + ffn_or_moe(lp, h, cfg, capacity_factor=-1.0)
        ks.append(k)
        vs.append(v)
    logits = unembed(params, cfg, x[:, n_valid - 1])
    return logits, pool_k, pool_v, torch.stack(ks), torch.stack(vs)
