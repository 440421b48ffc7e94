"""Nested-dict tensor trees: the parameter, gradient and moment trees."""
from __future__ import annotations

from typing import Any, Callable, List

import torch

CHUNK = 1 << 24     # elements of one slice in the per-leaf float32 math


def tree_leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a nested dict, keys in sorted order (JAX's
    flattening order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flat_chunks(t: torch.Tensor) -> List[torch.Tensor]:
    """1-D views of ``t`` of at most ``CHUNK`` elements, so that the
    float32 temporaries of a large leaf stay small (a full-width expert
    bank would otherwise need several GB of them). ``t`` must be
    contiguous: the chunks are written through."""
    return list(t.view(-1).split(CHUNK))
