"""Placement rules over a mesh: every parameter's split, and where the KV
pool and the batch go.

Conventions (the JAX package's ``repro/distributed/sharding.py``; one
pod: axes ("data", "model"), several: ("pod", "data", "model")):

* TP over "model": column-parallel in-projections, row-parallel
  out-projections, vocab-parallel embeddings, expert-parallel MoE.
* FSDP over "data": weights also split on their non-TP dim; at serve
  time only for archs whose weights would not fit replicated
  (``serve_fsdp``).
* The serving pool: KV blocks over the batch axes, kv heads over
  "model" when they divide it (tp_head mode), else the blocks over
  "model" too (seq_model mode).

A spec is a plain tuple with one entry per dim: a mesh axis name, a
tuple of names, or None (JAX's ``PartitionSpec``, entry for entry).
Paths are the parameter tree's nested dict keys joined by "/", the
strings the JAX rules match (the bridge keeps the keys). ``mesh`` is a
``torch.distributed`` ``DeviceMesh`` (``make_mesh``); only its axis
names and sizes are read, so a stand-in with ``mesh_dim_names`` and
``size(i)`` serves the tests. ``distributed.placement`` executes the
specs; the ServeLayout steps take their layout from
``ServeLayout(batch_axes(mesh), serve_pool_axes(cfg, mesh))``.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.hardware import H100, HardwareSpec

# The TP degree the q/kv rules test whole heads against: the production
# mesh's 16, not the mesh at hand's (the JAX rules' constant).
PRODUCTION_TP = 16


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, in its axis order."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _rules(cfg: ModelConfig, f):
    """(regex on the parameter path, spec): the first match wins. ``f``
    is the FSDP axis (or None), "model" the TP axis."""
    m = "model"
    # kv projections are column-parallel only when whole kv heads divide
    # the production TP degree; otherwise the split would land inside
    # head_dim, and replicating the small wk/wv is cheaper.
    kv_tp = m if cfg.num_kv_heads % PRODUCTION_TP == 0 else None
    q_tp = m if cfg.num_heads % PRODUCTION_TP == 0 else None
    return [
        # --- embeddings ---
        (r"embed$",               (m, f)),
        (r"unembed$",             (f, m)),
        # --- attention ---
        (r"attn/wq$",             (f, q_tp)),
        (r"attn/wk$",             (f, kv_tp)),
        (r"attn/wv$",             (f, kv_tp)),
        (r"attn/wo$",             (q_tp, f)),
        (r"attn/(q|k)_norm$",     ()),
        # --- dense FFN ---
        (r"ffn/w[ig]$",           (f, m)),
        (r"ffn/wo$",              (m, f)),
        # --- MoE: experts over model (EP), internals over fsdp ---
        (r"moe/router$",          (f, None)),
        (r"moe/experts/w[ig]$",   (m, f, None)),
        (r"moe/experts/wo$",      (m, None, f)),
        (r"moe/shared/w[ig]$",    (None, f, m)),
        (r"moe/shared/wo$",       (None, m, f)),
        # --- RG-LRU (recurrent width over model) ---
        (r"rglru/w_gate$",        (f, m)),
        (r"rglru/w_rec_in$",      (f, m)),
        (r"rglru/conv_w$",        (None, m)),
        (r"rglru/w_[ri]$",        (m, None)),
        (r"rglru/b_[ri]$",        ()),
        (r"rglru/log_sig_lambda$", ()),
        (r"rglru/w_out$",         (m, f)),
        # --- xLSTM ---
        (r"blk/w_up$",            (f, m)),
        (r"blk/w_gate$",          (f, m)),
        (r"blk/w[qkv]$",          (m, None)),
        (r"blk/w_if$",            (m, None)),
        (r"blk/b_if$",            ()),
        (r"blk/gn_scale$",        ()),
        (r"blk/w_down$",          (m, f)),
        (r"blk/w_x$",             (f, m)),
        (r"blk/w_h$",             (f, m)),
        (r"blk/b$",               ()),
        (r"blk/w_ff_i$",          (f, m)),
        (r"blk/w_ff_o$",          (m, f)),
        # --- norms / everything 1-D ---
        (r".*",                   ()),
    ]


def _spec_for_path(path: str, ndim: int, rules) -> Tuple:
    """The first matching rule's spec, with None prepended for stacked
    layer (or group) dims; a leaf of lower rank than its rule (a tied or
    smoke-size weight) keeps the rule's first ``ndim`` entries."""
    for pat, spec in rules:
        if re.search(pat, path):
            pad = ndim - len(spec)
            if pad < 0:
                return tuple(spec)[:ndim]
            return (None,) * pad + tuple(spec)
    return ()


def _map_with_path(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params_shape, *, fsdp: bool,
                fsdp_axis="data"):
    """The spec tree of ``params_shape`` (a parameter tree: tensors of
    any device, meta included — only their rank is read). Stacked
    leading dims are not split. Pass the specs through
    ``validate_divisibility`` before placing them."""
    rules = _rules(cfg, fsdp_axis if fsdp else None)
    return _map_with_path(lambda path, leaf: _spec_for_path(
        path, leaf.ndim, rules), params_shape)


def _axis_total(ax, sizes: Dict[str, int]) -> int:
    total = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        total *= sizes[a]
    return total


def validate_divisibility(specs, shapes, mesh):
    """The spec tree with every entry whose mesh size does not divide its
    dim replaced by None, padded with None to each leaf's rank."""
    sizes = _axis_sizes(mesh)

    def fix(spec, leaf):
        dims = tuple(leaf.shape)
        full = tuple(spec) + (None,) * (len(dims) - len(spec))
        return tuple(None if ax is None or dims[i] % _axis_total(ax, sizes)
                     else ax for i, ax in enumerate(full))

    def walk(s, t):
        if isinstance(t, dict):
            return {k: walk(s[k], v) for k, v in t.items()}
        return fix(s, t)
    return walk(specs, shapes)


# --------------------------------------------------------------------- #
# Serving-layout decisions
# --------------------------------------------------------------------- #
def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes a serving batch splits over: "pod" and "data"."""
    return tuple(a for a in _axis_sizes(mesh) if a in ("pod", "data"))


def serve_pool_axes(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    """Where the KV pool's shards live. ``kv_heads % tp == 0``: tp_head
    mode, kv heads over "model" and the pool over the batch axes only;
    otherwise seq_model mode, DistAttention over the batch axes AND
    "model" (sequence sharding replaces head-TP, paper §7.4)."""
    tp = _axis_sizes(mesh)["model"]
    axes = batch_axes(mesh)
    if cfg.num_kv_heads % tp == 0:
        return axes
    return axes + ("model",)


def serve_fsdp(cfg: ModelConfig, mesh, hw: HardwareSpec = H100) -> bool:
    """Split the weights over "data" at serve time only when a TP shard
    of them (bf16) would take more than 60% of a device's memory — the
    H100's 80 GB by default (the JAX package decides against v5e's 16
    GB: pass its ``HardwareSpec`` to get that decision)."""
    tp = _axis_sizes(mesh)["model"]
    return cfg.param_count() * 2 / tp > 0.6 * hw.hbm_bytes


__all__ = ["PRODUCTION_TP", "batch_axes", "param_specs", "serve_fsdp",
           "serve_pool_axes", "validate_divisibility"]
