"""Paper-§7.4 baselines: RingAttention, head-partition TP, and ship-KV.

The JAX package's ``repro.core.baselines`` (``shard_map`` bodies over a
named mesh axis), as SPMD functions over a ``torch.distributed`` process
group: each process calls them with its own shard. They are the
comparison forms of the paper's Fig. 11; DistAttention over the same
layout (``distattn_decode``) ships only the query's merge scalars and
one value vector. ``ring_attention_prefill`` exchanges KV blocks point
to point, which gloo supports for CPU tensors only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distattn import merge_over_axes
from repro_torch.core.online_softmax import (combine, empty_partial,
                                             finalize,
                                             micro_attention_decode,
                                             micro_attention_prefill)


def _ring_shift(tensors, group):
    """Each tensor of this process goes to the next process of the
    group and the previous one's arrives (JAX's ``ppermute`` by +1)."""
    me, P = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (me + 1) % P)
    prv = dist.get_global_rank(group, (me - 1) % P)
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, t, prv, group) for t in out])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def ring_attention_prefill(q, k, v, q_pos, kv_pos, kv_valid, group, *,
                           scale=None):
    """RingAttention (Liu et al.): KV blocks rotate, queries stay.

    q [B,T,H,D] this process's query block; k/v [B,S,K,D] its KV block;
    positions absolute. Each step every process ships its whole KV block
    to the next one (the communication the paper's Fig. 11 charges Ring
    with), accumulating online-softmax partials locally.
    """
    if q.device.type != "cpu":
        raise NotImplementedError("ring_attention_prefill exchanges blocks "
                                  "point to point: CPU tensors only")
    P = dist.get_world_size(group)
    B, T, H, D = q.shape
    acc = empty_partial((B, T, H, D), (B, T, H), device=q.device)
    valid = kv_valid.to(torch.uint8)
    for i in range(P):
        acc = combine(acc, micro_attention_prefill(
            q, k, v, q_pos, kv_pos, valid.bool(), scale=scale))
        if i + 1 < P:
            k, v, kv_pos, valid = _ring_shift((k, v, kv_pos, valid), group)
    return finalize(acc[0], acc[2]).to(q.dtype)


def tp_head_attention_decode(q_local, k_local, v_local, mask, *, scale=None):
    """Megatron-style TP attention: KV sharded by heads, sequence whole.

    q_local [B,H/P,D], k/v_local [B,S,K/P,D] — every process holds the
    FULL sequence for its head group (this is what forces KV-head
    replication when kv_heads < P, the memory cost DistAttention
    removes). No collective here; the o-proj outside is row-parallel.
    """
    o, _, l = micro_attention_decode(q_local, k_local, v_local, mask,
                                     scale=scale)
    return finalize(o, l).to(q_local.dtype)


def _gather_seq(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def ship_kv_decode(q, k_local, v_local, mask_local, group, *, scale=None):
    """Strawman of paper Fig. 4(a): gather the distributed KV to every
    process and run full attention locally. Communication = the whole
    KVCache."""
    k = _gather_seq(k_local, group)
    v = _gather_seq(v_local, group)
    mask = _gather_seq(mask_local.to(torch.uint8), group).bool()
    o, _, l = micro_attention_decode(q, k, v, mask, scale=scale)
    return finalize(o, l).to(q.dtype)


def distattn_decode(q, k_local, v_local, mask_local, group, *, scale=None):
    """DistAttention over the same layout as ``ship_kv_decode`` for an
    apples-to-apples Fig. 11 comparison: communication = q-scalars +
    merge."""
    o, m, l = micro_attention_decode(q, k_local, v_local, mask_local,
                                     scale=scale)
    return merge_over_axes(o, m, l, group).to(q.dtype)


__all__ = ["distattn_decode", "ring_attention_prefill", "ship_kv_decode",
           "tp_head_attention_decode"]
