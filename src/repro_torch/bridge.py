"""Weight bridge: the JAX package's parameter tree <-> the port's tensors.

``from_numpy_tree`` takes the JAX ``init_params`` tree with every leaf
already converted to a numpy array (``jax.tree.map(np.asarray, params)``
— the caller does that, so this module never imports JAX) and returns
the port's tree: the same nested dict keys, each leaf a tensor of the
same dtype on ``device``. bfloat16 leaves travel through float32, which
is exact in both directions. ``to_numpy_tree`` goes back, every leaf as
float32 numpy, so a round trip can be checked bit for bit.

On the card no JAX weights exist: ``init_params`` (re-exported from
``repro_torch.models.model``) draws seeded random weights with the JAX
package's distributions.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.model import init_params, resolve_device

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16, "int32": torch.int32}

__all__ = ["from_numpy_tree", "to_numpy_tree", "init_params"]


def _leaf_to_torch(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    name = arr.dtype.name
    if name not in _TORCH_DTYPES:
        raise TypeError(f"no bridge for leaf dtype {name}")
    wide = arr.astype(np.float32) if name == "bfloat16" else arr
    t = torch.from_numpy(np.array(wide, copy=True))
    return t.to(device=device, dtype=_TORCH_DTYPES[name])


def from_numpy_tree(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays (JAX dtypes) -> same dict of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, dev) for k, v in tree.items()}
    return _leaf_to_torch(tree, dev)


def to_numpy_tree(tree: Any) -> Any:
    """Nested dict of tensors -> same dict of float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()
