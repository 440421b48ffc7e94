"""Wire-level compressed gradient sync across the pod (DCN) axis.

The JAX package's ``repro.training.grad_sync``, over a
``torch.distributed`` process group: each process (pod) holds its own
gradient tree; every leaf is quantized to int8 with one float32 scale
(``training.compression.quantize_int8``), the int8 values and the scales
are all-gathered over the group, and each process averages the
dequantized gradients. Bytes on the wire drop 4x against float32 (2x
against bf16). Gradients are different across the group and equal
within a pod, as in JAX; every process of the group returns the same
averaged tree.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.compression import quantize_int8
from repro_torch.training.tree import tree_map


def _sync_one(g: torch.Tensor, group) -> torch.Tensor:
    q, s = quantize_int8(g)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q, group=group)             # n x int8 [...]
    dist.all_gather(ss, s, group=group)             # n x float32 []
    deq = torch.stack(qs).float() * torch.stack(ss).reshape(
        (n,) + (1,) * g.ndim)
    return torch.mean(deq, dim=0).to(g.dtype)


def grad_sync_compressed(grads, group):
    """The group-averaged gradient tree: int8 all-gather + local mean."""
    return tree_map(lambda g: _sync_one(g, group), grads)


def make_grad_sync(mesh, axis_name: str = "pod"):
    """Compressed cross-pod gradient averaging over ``mesh``'s
    ``axis_name`` axis: ``sync(grads) -> averaged grads``, called by every
    process of the mesh with its own pod's gradients."""
    group = mesh.get_group(axis_name)

    def sync(grads):
        return grad_sync_compressed(grads, group)
    return sync


def wire_bytes(grads) -> dict:
    """Bytes one process sends per sync: int8 values and one float32
    scale a leaf, against the float32 tree."""
    leaves = []
    tree_map(leaves.append, grads)
    n = sum(t.numel() for t in leaves)
    return {"int8": n + 4 * len(leaves), "float32": 4 * n}


__all__ = ["grad_sync_compressed", "make_grad_sync", "wire_bytes"]
