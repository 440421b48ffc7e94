"""Serving-layout decisions over a mesh: where the KV pool and the batch go.

The JAX package's ``repro/distributed/sharding.py`` holds two kinds of
rules: the ``PartitionSpec`` of every parameter (TP over "model", FSDP
over "data", experts over "model") with ``validate_divisibility`` and
``serve_fsdp``, and the two serving-layout decisions here. The port
keeps its weights replicated in every process of a mesh, so only the
layout decisions are ported for now; the parameter rules come with their
execution as placements over the mesh.

``mesh`` is a ``torch.distributed`` ``DeviceMesh`` (``make_mesh``); only
its axis names and sizes are read. The ServeLayout steps take their
layout from these: ``ServeLayout(batch_axes(mesh), serve_pool_axes(cfg,
mesh))``, as the JAX package's launch layer builds it.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, in its axis order."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


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


__all__ = ["batch_axes", "serve_pool_axes"]
