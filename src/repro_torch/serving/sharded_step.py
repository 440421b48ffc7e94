"""Global-pool serving steps: paged DistAttention over ONE pool tensor.

``decode_step_global`` / ``prefill_chunk_global`` are the serving
cluster's steps in global-pool mode: the same paged math as the engines'
per-instance steps (``models/prefill.py``), but every rank's pool is a
slice of the cluster-wide ``GlobalKVPool`` tensor ``[NR, L, NB, bs, K,
hd]``. Each layer reads its view ``gk[:, l]`` (strided, never copied)
with ONE launch of a rank-form kernel over every rank
(``kernels.ops.paged_*_attention_ranks``, where the JAX package vmaps
its Pallas kernel over the rank axis), and the stacked per-rank partials
merge with ``merge_partials(axis=0)`` (paper Eq. 3).

The schedule is the JAX package's (``repro/serving/sharded_step.py``):
the pool is read-only during the layer loop. Decode tables EXCLUDE the
pending token; the new token joins each layer's attention as a self
partial (``micro_attention_decode`` over its own k, v), and every
layer's new KV row is written after the loop, in one scatter per pool.
Prefill tables address the already-written prefix [0, t0); the chunk
attends to itself causally, and its rows — owner- or creditor-bound —
are written after the loop.

Drop-mode writes: a row whose block is the sentinel ``NB`` (inactive
decode slot, padding), or whose rank or block lies outside the pool, is
removed on the host before the write, so no index wraps (JAX wraps a
negative index; torch does too) and none reaches the card out of range.

With a ``mesh`` (``distributed.mesh``) the rank axis is sharded over the
processes of ``pool_axes``, as the JAX package shards it over devices
under ``shard_map``: ``gk``/``gv`` are this process's slab ``[NR/shards,
L, NB, bs, K, hd]``; the tables and tails stay global and are sliced to
the local ranks; each layer launches the rank-form kernel ONCE over the
local slab, merges the local ranks with ``merge_partials(axis=0)`` and
then across the group with ``merge_partials_collective`` (so a process
that holds none of a request's blocks contributes ``(0, -inf, 0)``); the
deferred writes keep only the rows whose rank is local. Every process
computes the same logits. The ``ServeLayout`` steps (batch-sharded
serving, ``sharded_step.py:79-519`` of the JAX package) are a later
slice; only the layout itself is here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.online_softmax import (combine, finalize,
                                             merge_partials,
                                             merge_partials_collective,
                                             micro_attention_decode,
                                             micro_attention_prefill)
from repro_torch.distributed.mesh import pool_shards
from repro_torch.kernels.ops import (paged_micro_attention_ranks,
                                     paged_prefill_attention_ranks)
from repro_torch.models.attention import qkv_project
from repro_torch.models.common import apply_norm
from repro_torch.models.model import (POOLED_FAMILIES, attn_layer_params,
                                      embed_tokens, ffn_or_moe,
                                      require_family, unembed)
from repro_torch.models.prefill import _as_int32, _host, _write_plan


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """Mesh-axis assignment for the serving step."""
    batch_axes: Tuple[str, ...]          # ("data",) or ("pod","data")
    pool_axes: Tuple[str, ...]           # + ("model",) in seq_model mode
    tp_axis: str = "model"

    @property
    def seq_model(self) -> bool:
        """True when the TP axis also shards the pool's sequence dim."""
        return self.tp_axis in self.pool_axes

    @property
    def kv_head_axis(self):
        """In tp_head mode the pool's kv-head dim shards over the TP
        axis; in seq_model mode the sequence (NP) dim already covers it."""
        return None if self.seq_model else self.tp_axis


def _local_view(mesh, pool_axes, n_local: int, n_ranks: int):
    """(process group, first local rank) of a slab of ``n_local`` of the
    pool's ``n_ranks`` ranks: (None, 0) without a mesh."""
    if mesh is None:
        return None, 0
    shards = pool_shards(mesh, pool_axes)
    if shards.local_ranks(n_ranks) != n_local:
        raise ValueError(f"a slab of {n_local} ranks, but {n_ranks} ranks "
                         f"over {shards.count} shards")
    return shards.group, shards.index * n_local


def _global_write_plan(wrank, wblk, woff, n_ranks: int, num_blocks: int,
                       device):
    """(rows, ranks, blocks, offsets) long tensors of the rows that
    really write: rank in [0, n_ranks) and block in [0, num_blocks) (a
    foreign rank's row — negative, or past the slab — gets the sentinel
    block, which ``_write_plan`` drops)."""
    wr = _host(wrank).astype(np.int64)
    wb = np.where((wr >= 0) & (wr < n_ranks), _host(wblk), num_blocks)
    rows, blk, off = _write_plan(wb, woff, num_blocks, device)
    return rows, torch.from_numpy(wr).to(device)[rows], blk, off


def _global_write(g: torch.Tensor, rows: torch.Tensor, plan) -> None:
    """Write rows [L, n, K, hd] into g [NR, L, NB, bs, K, hd] IN PLACE:
    row ``sel[i]`` lands at (rank, every layer, block, offset)."""
    sel, wr, wb, wo = plan
    g[wr, :, wb, wo] = rows[:, sel].transpose(0, 1).to(g.dtype)


def _merge(part, group):
    """Merge stacked rank partials here, then across ``group``."""
    part = merge_partials(*part, axis=0)
    return part if group is None else merge_partials_collective(*part,
                                                                group)


def _global_pooled_decode(q1, gk_l, gv_l, tables, tails, scale, group):
    """Merged pooled partial for one layer. q1 [B,H,hd] shared by every
    rank; gk_l/gv_l [NR,NB,bs,K,hd] (this process's ranks); tables
    [NR,B,MB]; tails [NR,B]."""
    return _merge(paged_micro_attention_ranks(q1, gk_l, gv_l, tables, tails,
                                              scale=scale), group)


def _global_pooled_prefill(qc, gk_l, gv_l, tables, tails, scale, group):
    """Merged prefix partial for one prefill chunk. qc [C,H,hd];
    tables [NR,MB]; tails [NR]."""
    return _merge(paged_prefill_attention_ranks(qc, gk_l, gv_l, tables,
                                                tails, scale=scale), group)


def decode_step_global(params, cfg: ModelConfig, tokens, lens,
                       gk: torch.Tensor, gv: torch.Tensor, tables, tails,
                       wblk, woff, *, rank: int, mesh=None,
                       pool_axes: Tuple[str, ...] = ("data",)):
    """Paged DistAttention decode over the GLOBAL pool tensor.

    tokens/lens: [B]; gk/gv: [NR, L, NB, bs, K, hd] — the whole
    cluster's KV, updated IN PLACE after the layer loop; tables/tails:
    [NR, B, MB] / [NR, B] over ``GlobalKVPool.ranks``, edited so that
    the pending token's slot is excluded (it enters as a self partial);
    wblk/woff: [B] tail target in rank ``rank``'s slice (sentinel NB: no
    write); ``rank``: the calling engine's rank. With ``mesh``, gk/gv are
    this process's slab of the ranks sharded over ``pool_axes`` and the
    ranks' partials merge across processes; tables/tails stay global.
    Returns (logits [B, V], gk, gv) — the same tensors.
    """
    require_family(cfg, POOLED_FAMILIES)
    dev = gk.device
    NR, L, NB = gk.shape[:3]
    group, base = _local_view(mesh, pool_axes, NR, len(tables))
    tokens = torch.as_tensor(_host(tokens), dtype=torch.int64).to(dev)
    lens = torch.as_tensor(_host(lens), dtype=torch.int64).to(dev)
    tables = _as_int32(tables[base:base + NR], dev)
    tails = _as_int32(tails[base:base + NR], dev)
    B = tokens.shape[0]
    plan = _global_write_plan(np.full(B, rank - base), wblk, woff, NR, NB,
                              dev)
    scale = cfg.head_dim ** -0.5
    self_mask = torch.ones((B, 1), dtype=torch.bool, device=dev)
    x = embed_tokens(params, cfg, tokens[:, None], positions=lens[:, None])
    ks, vs = [], []
    for i in range(L):
        lp = attn_layer_params(params, cfg, i)
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = qkv_project(lp["attn"], h, lens[:, None], cfg)
        pooled = _global_pooled_decode(q[:, 0], gk[:, i], gv[:, i], tables,
                                       tails, scale, group)
        self_part = micro_attention_decode(q[:, 0], k, v, self_mask,
                                           scale=scale)
        o, _, l = combine(pooled, self_part)
        out = finalize(o, l).reshape(B, 1, -1).to(x.dtype)
        x = x + out @ lp["attn"]["wo"]
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + ffn_or_moe(lp, h, cfg, capacity_factor=-1.0)
        ks.append(k[:, 0])
        vs.append(v[:, 0])
    _global_write(gk, torch.stack(ks), plan)
    _global_write(gv, torch.stack(vs), plan)
    logits = unembed(params, cfg, x[:, 0])
    return logits, gk, gv


def prefill_chunk_global(params, cfg: ModelConfig, tokens, t0: int,
                         n_valid: int, gk: torch.Tensor, gv: torch.Tensor,
                         tables, tails, wrank, wblk, woff, *, mesh=None,
                         pool_axes: Tuple[str, ...] = ("data",)):
    """Streaming-prefill chunk [t0, t0+C) over the GLOBAL pool tensor.

    Same contract as ``prefill_chunk_paged`` except the pool is the
    whole cluster's [NR, L, NB, bs, K, hd] (updated IN PLACE after the
    layer loop) and the chunk's rows can land on ANY rank: wrank/wblk/
    woff [C] give each row's (rank, block, offset) — creditor-striped
    rows are rows with a creditor's rank, written by the same scatter as
    owner rows (block NB: padding, no write). tables/tails: [NR, MB] /
    [NR] addressing the written prefix [0, t0) on every rank. With
    ``mesh``, as ``decode_step_global``: gk/gv are the local slab and only
    rows bound for a local rank are written here. Returns
    (logits [1, V], gk, gv, k_chunk [L, C, K, hd], v_chunk).
    """
    require_family(cfg, POOLED_FAMILIES)
    dev = gk.device
    NR, L, NB = gk.shape[:3]
    group, base = _local_view(mesh, pool_axes, NR, len(tables))
    C = len(tokens)
    toks = torch.as_tensor(_host(tokens), dtype=torch.int64).to(dev)[None]
    ar = torch.arange(C, dtype=torch.int64, device=dev)
    positions = (t0 + ar)[None]
    valid = (ar < n_valid)[None]
    tables = _as_int32(tables[base:base + NR], dev)
    tails = _as_int32(tails[base:base + NR], dev)
    plan = _global_write_plan(_host(wrank).astype(np.int64) - base, wblk,
                              woff, NR, NB, dev)
    scale = cfg.head_dim ** -0.5
    x = embed_tokens(params, cfg, toks, positions=positions)
    ks, vs = [], []
    for i in range(L):
        lp = attn_layer_params(params, cfg, i)
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = qkv_project(lp["attn"], h, positions, cfg)
        # Prefix partial over the written tokens [0, t0) on EVERY rank
        # (the tables mask this chunk's rows out), then chunk-causal.
        part = _global_pooled_prefill(q[0], gk[:, i], gv[:, i], tables,
                                      tails, scale, group)
        o_c, m_c, l_c = micro_attention_prefill(q, k, v, positions,
                                                positions, valid)
        o, _, l = combine(part, (o_c[0], m_c[0], l_c[0]))
        out = finalize(o, l).reshape(1, C, -1).to(x.dtype)
        x = x + out @ lp["attn"]["wo"]
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + ffn_or_moe(lp, h, cfg, capacity_factor=-1.0)
        ks.append(k[0])
        vs.append(v[0])
    ks, vs = torch.stack(ks), torch.stack(vs)
    _global_write(gk, ks, plan)
    _global_write(gv, vs, plan)
    logits = unembed(params, cfg, x[:, n_valid - 1])
    return logits, gk, gv, ks, vs


__all__ = ["ServeLayout", "decode_step_global", "prefill_chunk_global"]
