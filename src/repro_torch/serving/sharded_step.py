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
computes the same logits.

The ``ServeLayout`` steps (the JAX package's mesh-level serving steps,
from which its launch layer builds the production cells) serve a batch
of R requests over a pool ``[L, NP, NB, bs, K, hd]`` of NP shards:

* ``serve_decode_step`` (write-then-attend): each layer writes the new
  token's K/V into its tail block (the sentinel block ``NB`` drops the
  write on every other shard), then ONE launch of the decode rank kernel
  (``paged_micro_attention_ranks``) over the layer's ``[NP, NB, bs, K,
  hd]`` view gives every shard's MicroAttention partial — where the JAX
  package vmaps ``paged_micro_attention_ref`` — merged with
  ``merge_partials(axis=0)``. Tails INCLUDE the new token.
* ``serve_decode_step_opt`` (read-only pool): the pool is only read in
  the layer loop, the new token joins each layer as a self partial, and
  every layer's new row is written after the loop in one scatter a pool.
  Tails EXCLUDE the new token. The JAX package picks between an
  owner-masked whole-pool partial and the gathered partial by a size
  test and ``REPRO_FORCE_GATHER`` (how GSPMD lowers a gather); both are
  the same partial, which the port computes with the rank kernel.
* ``prefill_layout`` (host index math, the data-local layout or the
  round-robin fallback) and ``serve_prefill_step``: the full-sequence
  forward on the flash core, each layer's K/V laid into a fresh pool by
  a drop-scatter.
* ``serve_prefill_step_state`` / ``serve_decode_step_state``: the
  hybrid and ssm families decode from their recurrent state (no pool);
  the hybrid attention layers prefill on the flash core with the
  window. ``gather_state`` puts a state split over a mesh back
  together.

JAX passes each shard's valid-block count ``nblk`` beside the tables
and marks slot ``nblk - 1`` as the partial one; the port's kernels read
the count from the ``-1`` padding. The steps check on the host that
``nblk == (tables >= 0).sum(-1)`` and that the valid slots form a
prefix, and raise otherwise. JAX's GSPMD knobs have no counterpart:
``layer_constraints`` (weight re-pinning inside the scan), the prefill's
``attn_chunk``, ``seq_parallel`` and carry pin. Both prefill steps take
``embeds=`` [B, S, d] (a modality frontend's output) in place of the
tokens, as JAX's do.

With a ``mesh`` the steps run SPMD over its processes, as the JAX
package's GSPMD program runs over devices. Each process holds its slab
of the shards of ``layout.pool_axes`` — ``[L, NP/shards, NB, bs, K_loc,
hd]``, with ``K_loc = K / tp`` kv heads in tp_head mode
(``layout.kv_head_axis`` set) and ``K`` in seq_model mode; tables,
tails and write targets stay global on the host and are sliced to the
local shards. Rows split over ``layout.batch_axes`` when R divides
their size and are replicated otherwise (``batch_rows``). A layer
gathers q over the batch axes (queries are broadcast, KV never moves),
launches the rank kernel once over the local shards and heads, merges
the local shards and then the pool group (``merge_partials_collective``)
and, in tp_head mode, gathers the heads over the TP axis; each process
keeps its own rows. MoE layers that drop past capacity see the whole
batch (gathered), so the capacity is the global one.

The three pooled steps take the weights replicated (a plain tree, whole
in every process) or placed over the mesh (``distributed.placement``'s
``PlacedParams``, as the JAX package's cells pass ``param_specs`` to
GSPMD): each layer all-gathers its FSDP leaves, q (and k/v where
``wk``/``wv`` split: whole kv heads over the production TP degree)
come out for this process's heads only, ``wo`` takes its own heads'
rows and one all-reduce over "model" sums the partial outputs (in
seq_model mode the pool needs every head, so q is gathered first); the
FFN is column- then row-split (one all-reduce), MoE experts split over
"model" (every process routes the whole batch with the whole router,
applies its experts and its columns of the shared experts, one
all-reduce); the vocab-split embedding looks up its rows and
all-reduces, the logits are gathered (or summed, for an untied
``unembed`` split over d). A placed tree needs the step's mesh.

The state steps take placed weights the same way (the JAX package's
ServeLayout cells place them by the same rules and split the states
over the batch axes): rows over ``layout.batch_axes``; the hybrid's
attention layers as above (recurrentgemma's 16 query heads split over
"model", its one kv head whole, so each process's ring holds the kv
heads its query heads read), its RG-LRU layers with the recurrent width
split over "model" (``models/rglru.py``: this process's columns of the
conv carry and of ``h``); xLSTM's mLSTM layers with this process's
heads and sLSTM layers replicated (``models/xlstm.py``). They run the
layer loops of ``prefill`` and ``decode_step`` (``prefill_layers``,
``decode_layers``) over the placed layers. The returned ``DecodeState``
holds this process's rows, columns and heads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.online_softmax import (combine, finalize,
                                             merge_partials,
                                             merge_partials_collective,
                                             micro_attention_decode,
                                             micro_attention_prefill)
from repro_torch.distributed.mesh import pool_shards
from repro_torch.distributed.placement import PlacedParams, all_gather_cat
from repro_torch.kernels.ops import (paged_micro_attention_ranks,
                                     paged_prefill_attention_ranks)
from repro_torch.models.attention import (expand_kv, heads_out, kv_range,
                                          make_causal_core, qkv_project,
                                          split_heads)
from repro_torch.models.common import apply_norm, torch_dtype, tp_split
from repro_torch.models.model import (POOLED_FAMILIES, DecodeState,
                                      attn_layer_params, decode_layers,
                                      embed_tokens, ffn_or_moe, param_layer,
                                      params_device,
                                      require_family, unembed)
from repro_torch.models.prefill import (_as_int32, _host, _write_plan,
                                        prefill_layers)
from repro_torch.models.xlstm import MLstmState, SLstmState, mlstm_dims


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

    def pool_spec(self) -> Tuple:
        """Placement of the pool's ``[NP, NB, bs, K, hd]`` dims (prepend
        None for the L dim): the mesh axis a dim is split over, the tuple
        of them for several, or None — what the JAX package's
        ``PartitionSpec`` holds."""
        axes = self.pool_axes
        return (axes[0] if len(axes) == 1 else axes, None, None,
                self.kv_head_axis, None)


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


# --------------------------------------------------------------------- #
# The ServeLayout steps: a batch of requests over a pool of NP shards
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class _Placement:
    """What this process holds of a step's pool, heads and batch.

    Pool shards ``[base, base + n_local)`` (merged across
    ``pool_group``), kv heads ``[k0, k0 + K_loc)`` with their query heads
    ``[h0, h0 + H_loc)`` (gathered over ``head``), batch rows ``[r0, r0
    + R_loc)`` (gathered over ``batch``). Without a mesh: everything,
    and no group."""
    base: int
    n_local: int
    pool_group: object
    k0: int
    K_loc: int
    h0: int
    H_loc: int
    head: object
    r0: int
    R_loc: int
    batch: object


def _placement(mesh, layout: ServeLayout, cfg: ModelConfig, NP: int,
               R: int) -> _Placement:
    K, H = cfg.num_kv_heads, cfg.num_heads
    if mesh is None:
        return _Placement(0, NP, None, 0, K, 0, H, None, 0, R, None)
    # The pool's placement, as the JAX package gives it to GSPMD: the
    # shard dim over spec[0], the kv-head dim over spec[3] (or not split).
    spec = layout.pool_spec()
    shard_axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    pool = pool_shards(mesh, shard_axes)
    n_local = pool.local_ranks(NP)
    k0, K_loc, head = 0, K, None
    if spec[3] is not None:
        tp = pool_shards(mesh, (spec[3],))
        if K % tp.count:
            raise ValueError(f"{K} kv heads do not split over a TP axis "
                             f"of {tp.count}: use seq_model mode")
        K_loc = K // tp.count
        k0 = tp.index * K_loc
        head = tp if tp.count > 1 else None
    G = H // K
    own = batch_rows(mesh, layout, R)
    batch = None if own == slice(0, R) else \
        pool_shards(mesh, layout.batch_axes)
    return _Placement(pool.index * n_local, n_local,
                      pool.group if pool.count > 1 else None, k0, K_loc,
                      k0 * G, K_loc * G, head, own.start,
                      own.stop - own.start, batch)


def batch_rows(mesh, layout: ServeLayout, R: int) -> slice:
    """The batch rows a process of ``mesh`` keeps in the ServeLayout
    steps (all R without a mesh, or when R does not divide over the
    batch axes)."""
    if mesh is not None:
        rows = pool_shards(mesh, layout.batch_axes)
        if rows.count > 1 and R % rows.count == 0:
            n = R // rows.count
            return slice(rows.index * n, (rows.index + 1) * n)
    return slice(0, R)


def gather_batch(x: torch.Tensor, mesh, layout: ServeLayout,
                 R: int) -> torch.Tensor:
    """A step's rows of this process (``batch_rows``) concatenated into
    the whole batch of ``R`` in every process (``x`` itself without a mesh
    or where the rows are replicated): the next step takes every
    request's token."""
    if batch_rows(mesh, layout, R) == slice(0, R):
        return x
    return all_gather_cat(x, pool_shards(mesh, layout.batch_axes))


def _check_tables(tables, nblk) -> np.ndarray:
    """Host int32 tables [NP, R, MB] whose valid slots are a prefix of
    ``nblk`` slots each; raise ValueError otherwise (the kernels read the
    partial slot from the -1 padding, JAX from ``nblk``)."""
    tab = _host(tables).astype(np.int32)
    valid = tab >= 0
    if (valid[..., 1:] & ~valid[..., :-1]).any():
        raise ValueError("a block table's valid slots do not form a "
                         "prefix (a -1 slot before a valid one)")
    count = valid.sum(-1)
    nb = _host(nblk).astype(np.int64)
    if nb.shape != count.shape or not np.array_equal(count, nb):
        raise ValueError("nblk differs from the tables' valid slots "
                         "(tables >= 0).sum(-1)")
    return tab


def _ffn(lp, ls, h, cfg: ModelConfig, capacity_factor: float,
         pl: _Placement, tp) -> torch.Tensor:
    """The layer's FFN/MoE on this process's rows (``ls``, ``tp``: the
    layer's specs and the TP axis of placed weights). An MoE that drops
    past capacity routes the whole batch (gathered over the batch axes),
    so its capacity and drops are the single-process step's."""
    if "moe" in lp and capacity_factor > 0 and pl.batch is not None:
        y = ffn_or_moe(lp, all_gather_cat(h, pl.batch), cfg, capacity_factor,
                       specs=ls, tp=tp)
        return y[pl.r0:pl.r0 + pl.R_loc]
    return ffn_or_moe(lp, h, cfg, capacity_factor, specs=ls, tp=tp)


class _Weights:
    """A step's parameters: the plain tree (every weight whole in every
    process), or a ``PlacedParams`` over the step's mesh, whose leaves
    are read with their specs and whose FSDP dims are gathered a layer
    at a time."""

    def __init__(self, params, cfg: ModelConfig, mesh):
        self.cfg = cfg
        self.placed = params if isinstance(params, PlacedParams) else None
        self.params = params
        self.tp = None
        if self.placed is not None:
            if mesh is None:
                raise ValueError("a placed parameter tree needs the step's "
                                 "mesh=")
            if self.placed.mesh is not mesh and self.placed.mesh != mesh:
                raise ValueError("the parameter tree is placed over another "
                                 "mesh than the step's")
            self.tp = self.placed.tp

    @property
    def device(self) -> torch.device:
        return (self.placed.device if self.placed is not None
                else params_device(self.params))

    def _top(self, keys):
        if self.placed is None:
            return self.params, None
        return self.placed.top(keys)

    def embed(self, tokens, positions, embeds=None) -> torch.Tensor:
        """Token embeddings (or ``embeds``, a frontend's output) with the
        model's positional table."""
        if embeds is not None:
            return embed_tokens(None, self.cfg, embeds=embeds,
                                positions=positions)
        top, sp = self._top(("embed",))
        return embed_tokens(top, self.cfg, tokens, positions=positions,
                            specs=sp, tp=self.tp)

    def unembed(self, x) -> torch.Tensor:
        key = "embed" if self.cfg.tie_embeddings else "unembed"
        top, sp = self._top((key, "final_norm"))
        return unembed(top, self.cfg, x, specs=sp, tp=self.tp)

    def layer(self, i: int):
        """(layer ``i``'s leaves, their specs or None), any family."""
        if self.placed is None:
            return param_layer(self.params, self.cfg, i), None
        return self.placed.layer(self.cfg, i)

    def split(self, ls, name: str, dim: int) -> bool:
        return ls is not None and tp_split(ls["attn"][name], dim, self.tp)

    def qkv(self, ls, q, k, v, h0: int, H_loc: int, k0: int, K_loc: int):
        """q heads ``[h0, h0 + H_loc)`` and kv heads ``[k0, k0 + K_loc)``
        of a layer's projections, whichever of them this process made."""
        cfg = self.cfg
        sk = self.split(ls, "wk", 1)
        return (split_heads(q, self.split(ls, "wq", 1), cfg.num_heads, h0,
                            H_loc, self.tp),
                split_heads(k, sk, cfg.num_kv_heads, k0, K_loc, self.tp),
                split_heads(v, sk, cfg.num_kv_heads, k0, K_loc, self.tp))

    def attn_out(self, lp, ls, out, h0: int, heads_group, dtype):
        """The output projection of attention heads ``out [..., n, hd]``
        (heads ``[h0, h0 + n)``): with ``wo``'s rows split over the TP
        axis, this process's own heads by its rows, summed over the axis;
        else every head (gathered over ``heads_group``) by the whole
        ``wo``."""
        if not self.split(ls, "wo", 0):
            out = all_gather_cat(out, heads_group, dim=out.dim() - 2)
        return heads_out(lp["attn"], out, h0, self.cfg, dtype,
                         None if ls is None else ls["attn"], self.tp)


def _check_pool(pool_k, pool_v, pl: _Placement, L: int, K: int, hd: int):
    """Raise ValueError unless the pools are this process's slab."""
    want = (L, pl.n_local, pool_k.shape[2], pool_k.shape[3], pl.K_loc, hd)
    if tuple(pool_k.shape) != want or pool_v.shape != pool_k.shape:
        raise ValueError(f"pool {tuple(pool_k.shape)}: this process holds "
                         f"[L, NP_local, NB, bs, K_local, hd] = {want} "
                         f"(K = {K})")


def _serve_decode(params, cfg, layout, pool_k, pool_v, tables, nblk, tails,
                  wblk, woff, tokens, lens, *, capacity_factor,
                  return_logits, mesh, deferred):
    """Both decode schedules: ``deferred`` is the read-only one."""
    if cfg.family not in POOLED_FAMILIES:
        raise ValueError("sharded decode pools KV only for attention archs; "
                         "hybrid/ssm use serve_decode_step_state")
    dev = pool_k.device
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    W = _Weights(params, cfg, mesh)
    tab = _check_tables(tables, nblk)
    NP, R = tab.shape[:2]
    pl = _placement(mesh, layout, cfg, NP, R)
    _check_pool(pool_k, pool_v, pl, L, K, hd)
    NB = pool_k.shape[2]
    local = slice(pl.base, pl.base + pl.n_local)
    tables_l = _as_int32(tab[local], dev)
    tails_l = _as_int32(_host(tails)[local], dev)
    # The new rows that land on this process's shards, as (shard, row):
    # the sentinel block NB drops, as JAX's mode="drop" does.
    sel, wb, wo = _write_plan(_host(wblk)[local].reshape(-1),
                              _host(woff)[local].reshape(-1), NB, dev)
    ps, rs = sel // R, sel % R
    own = slice(pl.r0, pl.r0 + pl.R_loc)
    toks = torch.as_tensor(_host(tokens)[own], dtype=torch.int64).to(dev)
    lens = torch.as_tensor(_host(lens)[own], dtype=torch.int64).to(dev)
    scale = hd ** -0.5
    self_mask = torch.ones((pl.R_loc, 1), dtype=torch.bool, device=dev)
    x = W.embed(toks[:, None], lens[:, None])
    ks, vs = [], []
    for i in range(L):
        lp, ls = W.layer(i)
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = W.qkv(ls, *qkv_project(lp["attn"], h, lens[:, None], cfg),
                        pl.h0, pl.H_loc, pl.k0, pl.K_loc)
        q1 = all_gather_cat(q[:, 0], pl.batch)           # [R, H_loc, hd]
        k1, v1 = k[:, 0], v[:, 0]                        # [R_loc, K_loc, hd]
        if deferred:
            ks.append(k1)
            vs.append(v1)
        else:
            pk_l, pv_l = pool_k[i], pool_v[i]
            pk_l[ps, wb, wo] = all_gather_cat(k1, pl.batch)[rs].to(pk_l.dtype)
            pv_l[ps, wb, wo] = all_gather_cat(v1, pl.batch)[rs].to(pv_l.dtype)
        o, m, l = _global_pooled_decode(q1, pool_k[i], pool_v[i], tables_l,
                                        tails_l, scale, pl.pool_group)
        part = (o[own], m[own], l[own])
        if deferred:
            part = combine(part, micro_attention_decode(
                q[:, 0], k, v, self_mask, scale=scale))
        out = finalize(part[0], part[2])                 # [R_loc, H_loc, hd]
        x = x + W.attn_out(lp, ls, out, pl.h0, pl.head, x.dtype)[:, None]
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + _ffn(lp, ls, h, cfg, capacity_factor, pl, W.tp)
    if deferred:
        # All layers' new rows in one scatter a pool.
        # [L, R, K_loc, hd]
        kall = all_gather_cat(torch.stack(ks), pl.batch, dim=1)
        vall = all_gather_cat(torch.stack(vs), pl.batch, dim=1)
        pool_k[:, ps, wb, wo] = kall[:, rs].to(pool_k.dtype)
        pool_v[:, ps, wb, wo] = vall[:, rs].to(pool_v.dtype)
    logits = W.unembed(x[:, 0])
    if return_logits:
        return logits, pool_k, pool_v
    return torch.argmax(logits, dim=-1).to(torch.int32), pool_k, pool_v


def serve_decode_step(params, cfg: ModelConfig, layout: ServeLayout,
                      pool_k: torch.Tensor, pool_v: torch.Tensor, tables,
                      nblk, tails, wblk, woff, tokens, lens, *,
                      capacity_factor: float = 1.25,
                      return_logits: bool = False, mesh=None):
    """One decode iteration for R requests over the pool's NP shards,
    write-then-attend.

    pool_k/v: [L, NP, NB, bs, K, hd] (with ``mesh``: this process's slab
    [L, NP/shards, NB, bs, K_loc, hd]), updated IN PLACE and returned;
    tables [NP, R, MB] (-1 padded), nblk/tails [NP, R] — the tails
    INCLUDE the new token, written into its tail block (wblk/woff [NP,
    R]; block NB: no write on that shard) before the layer's attention;
    tokens/lens [R]. MoE layers drop past ``capacity_factor`` (-1: no
    drop). Returns (next tokens [R] int32, or logits [R, V] with
    ``return_logits``, pool_k, pool_v); with ``mesh``, of this process's
    rows (``batch_rows``).
    """
    return _serve_decode(params, cfg, layout, pool_k, pool_v, tables, nblk,
                         tails, wblk, woff, tokens, lens,
                         capacity_factor=capacity_factor,
                         return_logits=return_logits, mesh=mesh,
                         deferred=False)


def serve_decode_step_opt(params, cfg: ModelConfig, layout: ServeLayout,
                          pool_k: torch.Tensor, pool_v: torch.Tensor,
                          tables, nblk, tails, wblk, woff, tokens, lens, *,
                          capacity_factor: float = 1.25,
                          return_logits: bool = False, mesh=None):
    """The read-only-pool schedule of ``serve_decode_step``: the same
    math, the pool only read in the layer loop, the new token a self
    partial in each layer (Eq. 3 is associative), and every layer's new
    row written after the loop in one scatter a pool.

    NOTE: ``tails``/``nblk`` here describe the pool WITHOUT the new
    token (the caller advances them after the step).
    """
    return _serve_decode(params, cfg, layout, pool_k, pool_v, tables, nblk,
                         tails, wblk, woff, tokens, lens,
                         capacity_factor=capacity_factor,
                         return_logits=return_logits, mesh=mesh,
                         deferred=True)


def prefill_layout(B: int, S: int, bs: int, NP: int,
                   n_data: Optional[int] = None):
    """Block placement at prefill time: (wblk [NP, B, S], woff [B, S],
    NB_loc), int32 numpy.

    With ``B % n_data == 0`` the data-local layout: request b's blocks
    live on its own data rank's ``NP / n_data`` shards (block j on
    sub-shard ``j % n_sub``), so the writes need no communication.
    Otherwise round-robin over all shards. A token's entry is its block
    on the shard that holds it and the out-of-range sentinel ``NB_loc``
    on every other shard (the pool has exactly ``NB_loc`` blocks).
    """
    nblocks = -(-S // bs)
    pos = np.arange(S, dtype=np.int32)
    blk = pos // bs
    woff = np.ascontiguousarray(np.broadcast_to(pos % bs, (B, S)))
    p_idx = np.arange(NP, dtype=np.int32)[:, None, None]
    b_idx = np.arange(B, dtype=np.int32)[:, None]
    if n_data and B % n_data == 0:
        n_sub = NP // n_data
        per_data = B // n_data
        shard_of = (b_idx // per_data) * n_sub + (blk % n_sub)[None]
        per_req = -(-nblocks // n_sub)
        NB_loc = per_data * per_req
        local = (b_idx % per_data) * per_req + (blk // n_sub)[None]
        wblk = np.where(shard_of[None] == p_idx, local[None], NB_loc)
        return wblk.astype(np.int32), woff, NB_loc
    per_req = -(-nblocks // NP)
    NB_loc = B * per_req
    owner = b_idx * per_req + (blk // NP)[None]
    wblk = np.where((blk % NP)[None, None, :] == p_idx, owner[None], NB_loc)
    return wblk.astype(np.int32), woff, NB_loc


def _prefill_writer(S: int, bs: int, pl, NB_loc: int, wblk, device):
    """The per-layer pool write of ``serve_prefill_step``: a function of
    (pool layer view [n_local, NB_loc, bs, K_loc, hd], this process's
    rows of K or V [R_loc, S, K_loc, hd]) that scatters every row bound
    for a local shard into its (block, offset); the sentinel block drops.
    In the data-local layout a process's shards hold only its own rows,
    so the write is local; the round-robin fallback gathers the rows.
    (The JAX package also lays an aligned data-local pool by a reshape,
    which keeps GSPMD from all-gathering the rows; the scatter here
    gathers nothing it does not need.)"""
    wb = wblk[pl.base:pl.base + pl.n_local]               # [n_local, B, S]
    sl, bb, tt = np.nonzero(wb < NB_loc)
    gather = not set(bb.tolist()) <= set(range(pl.r0, pl.r0 + pl.R_loc))
    r0 = 0 if gather else pl.r0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
    idx = (dev(sl), dev(wb[sl, bb, tt]), dev(tt % bs), dev((bb - r0) * S + tt))

    def write(pool_l, k):
        k = all_gather_cat(k, pl.batch) if gather else k
        s_, b_, o_, src = idx
        pool_l[s_, b_, o_] = k.reshape(-1, *k.shape[2:])[src].to(pool_l.dtype)
    return write


def serve_prefill_step(params, cfg: ModelConfig, layout: ServeLayout,
                       tokens, *, block_size: int, NP: int,
                       n_data: Optional[int] = None, embeds=None,
                       capacity_factor: float = 1.25, mesh=None):
    """Prefill B requests of length S and write their KV into a fresh
    pool laid out by ``prefill_layout``.

    The full-sequence forward runs the flash-prefill core (the kernel on
    a CUDA tensor, its plain twin on a CPU tensor: the same causal GQA
    function as the JAX package's "xla" core). Each layer's K/V goes
    into the pool by one scatter that drops the sentinel block. Returns
    (first tokens [B] int32, pool_k, pool_v [L, NP, NB_loc, bs, K, hd]);
    with ``mesh``, this process's rows and slab.
    """
    if cfg.family not in POOLED_FAMILIES:
        raise ValueError("pooled prefill is for attention archs")
    W = _Weights(params, cfg, mesh)
    dev = W.device
    B, S = _host(tokens).shape if embeds is None else embeds.shape[:2]
    bs = block_size
    wblk, _, NB_loc = prefill_layout(B, S, bs, NP, n_data=n_data)
    pl = _placement(mesh, layout, cfg, NP, B)
    write = _prefill_writer(S, bs, pl, NB_loc, wblk, dev)
    L, hd = cfg.num_layers, cfg.head_dim
    shape = (L, pl.n_local, NB_loc, bs, pl.K_loc, hd)
    pool_k = torch.zeros(shape, dtype=torch_dtype(cfg), device=dev)
    pool_v = torch.zeros_like(pool_k)
    own = slice(pl.r0, pl.r0 + pl.R_loc)
    positions = torch.arange(S, device=dev)[None].expand(pl.R_loc, S)
    core = make_causal_core(cfg, backend="flash")
    H, K = cfg.num_heads, cfg.num_kv_heads
    toks, emb = _own_inputs(tokens, embeds, own, dev)
    x = W.embed(toks, positions, emb)
    for i in range(L):
        lp, ls = W.layer(i)
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = qkv_project(lp["attn"], h, positions, cfg)
        sq, sk = W.split(ls, "wq", 1), W.split(ls, "wk", 1)
        # Attention over the heads this process made: its own with q
        # split over the TP axis (and the kv heads they read), else all.
        h0, n = (W.tp.index * q.shape[2], q.shape[2]) if sq else (0, H)
        lo, hi, idx = kv_range(cfg, h0, n)
        out = core(q, *(expand_kv(split_heads(t, sk, K, lo, hi - lo, W.tp),
                                  idx) for t in (k, v)))
        x = x + W.attn_out(lp, ls, out, h0, None, x.dtype)
        write(pool_k[i], split_heads(k, sk, K, pl.k0, pl.K_loc, W.tp))
        write(pool_v[i], split_heads(v, sk, K, pl.k0, pl.K_loc, W.tp))
        h = apply_norm(lp["ln2"], x, cfg)
        x = x + _ffn(lp, ls, h, cfg, capacity_factor, pl, W.tp)
    logits = W.unembed(x[:, -1])
    return torch.argmax(logits, dim=-1).to(torch.int32), pool_k, pool_v


def _own_inputs(tokens, embeds, own: slice, device):
    """(tokens, embeds) of the batch rows ``own``: the token ids as a long
    tensor, or the embeddings [rows, S, d] (then no tokens)."""
    if embeds is not None:
        return None, torch.as_tensor(embeds)[own].to(device)
    tok = _host(tokens).astype(np.int64)[own]
    return torch.from_numpy(np.ascontiguousarray(tok)).to(device), None


def _check_state_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("hybrid", "ssm"):
        raise ValueError("the state steps serve the hybrid and ssm "
                         "families; attention archs use the pooled steps")


def serve_prefill_step_state(params, cfg: ModelConfig, layout: ServeLayout,
                             tokens, *, max_len: int, embeds=None,
                             mesh=None, return_logits: bool = False):
    """Hybrid/ssm prefill: (first tokens [B] int32, DecodeState) — the
    recurrent (and windowed) state these families decode from; no pool.
    The hybrid attention layers run the flash-prefill core with the
    window; ``embeds`` [B, S, d] replaces the token embeddings.

    With ``mesh`` the batch rows split over ``layout.batch_axes`` (as
    the JAX package's cells place them; replicated when B does not
    divide): the first tokens and the state are this process's rows
    (``batch_rows``). Weights replicated (a plain tree) or placed (a
    ``PlacedParams`` over ``mesh``): then the state holds this process's
    columns of the RG-LRU width and of the conv carry, its mLSTM heads
    and the kv heads its query heads read (``gather_state`` puts a state
    back together). ``return_logits``: the last position's logits [rows,
    V] in place of the tokens."""
    _check_state_family(cfg)
    W = _Weights(params, cfg, mesh)
    dev = W.device
    B, T = _host(tokens).shape if embeds is None else embeds.shape[:2]
    own = batch_rows(mesh, layout, B)
    toks, emb = _own_inputs(tokens, embeds, own, dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(
        own.stop - own.start, T)
    core = make_causal_core(cfg, backend="flash", window=cfg.local_window)
    x, state = prefill_layers(W.layer, cfg, W.embed(toks, positions, emb),
                              max_len=max_len, core=core, tp=W.tp)
    logits = W.unembed(x[:, -1])
    if return_logits:
        return logits, state
    return torch.argmax(logits, dim=-1).to(torch.int32), state


def serve_decode_step_state(params, cfg: ModelConfig, layout: ServeLayout,
                            state, tokens, *, mesh=None,
                            return_logits: bool = False):
    """Hybrid/ssm decode: one step of the recurrence (the state updated
    in place and returned, ``lens`` advanced). DistAttention does not
    apply: there is no KV pool. ``tokens`` [B] are every row's; with
    ``mesh``, ``state`` and the result are this process's rows, heads
    and columns, as ``serve_prefill_step_state`` gives them;
    ``return_logits``: logits [rows, V] in place of the next tokens."""
    _check_state_family(cfg)
    W = _Weights(params, cfg, mesh)
    dev = W.device
    tok = _host(tokens).astype(np.int64)
    own = batch_rows(mesh, layout, len(tok))
    toks = torch.from_numpy(np.ascontiguousarray(tok[own])).to(dev)
    lens = state.lens
    x = W.embed(toks[:, None], lens[:, None])
    x = decode_layers(W.layer, cfg, state, x, tp=W.tp)
    logits = W.unembed(x[:, 0])
    if not return_logits:
        logits = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, state._replace(lens=lens + 1)


def _state_split_dims(cfg: ModelConfig, state: DecodeState):
    """(tensor, batch dim, dim split over "model" or None) of every
    tensor of a state step's DecodeState, in ``DecodeState`` order."""
    out = [(state.lens, 0, None)]
    if cfg.family == "ssm":
        _, nh, _ = mlstm_dims(cfg)
        m = state.rec["mlstm"]
        out += [(t, 2, 3 if m.m.shape[3] < nh else None) for t in m]
        out += [(t, 1, None) for t in state.rec["slstm"]]
        return out
    K, w = cfg.num_kv_heads, cfg.lru_width or cfg.d_model
    kdim = 3 if state.kv_k.shape[3] < K else None
    out += [(state.kv_k, 1, kdim), (state.kv_v, 1, kdim)]
    conv, h = state.rec
    wdim = -1 if h.shape[-1] < w else None
    return out + [(conv, 1, wdim), (h, 1, wdim)]


def gather_state(state: DecodeState, cfg: ModelConfig, mesh,
                 layout: ServeLayout, R: int) -> DecodeState:
    """A state step's DecodeState of this process (``batch_rows``, and
    its share of heads and columns under placed weights) put back
    together: every row, head and column, in every process (collective;
    ``state`` itself without a mesh)."""
    if mesh is None:
        return state
    rows = None if batch_rows(mesh, layout, R) == slice(0, R) else \
        pool_shards(mesh, layout.batch_axes)
    names = mesh.mesh_dim_names
    model = pool_shards(mesh, ("model",)) if "model" in names else None
    whole = []
    for t, bdim, mdim in _state_split_dims(cfg, state):
        t = all_gather_cat(t, rows, bdim)
        if mdim is not None:
            t = all_gather_cat(t, model, mdim % t.dim())
        whole.append(t)
    lens, rest = whole[0], whole[1:]
    if cfg.family == "ssm":
        n = len(state.rec["mlstm"])
        return DecodeState(None, None, lens, {
            "mlstm": MLstmState(*rest[:n]), "slstm": SLstmState(*rest[n:])})
    return DecodeState(rest[0], rest[1], lens, (rest[2], rest[3]))


__all__ = ["ServeLayout", "batch_rows", "decode_step_global",
           "gather_batch", "prefill_chunk_global", "prefill_layout",
           "serve_decode_step",
           "serve_decode_step_opt", "serve_decode_step_state", "gather_state",
           "serve_prefill_step", "serve_prefill_step_state"]
