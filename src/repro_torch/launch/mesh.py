"""Production mesh shapes (one pod 16x16, several pods 2x16x16).

The JAX package's ``repro.launch.mesh`` builds ``jax.make_mesh`` over
512 fake host devices so XLA can lower a cell for them. The port plans
its cells without lowering, so a mesh here is only a shape: a
``MeshShape`` has the two things ``distributed.sharding`` and
``distributed.placement.spec_bytes`` read of a ``DeviceMesh``,
``mesh_dim_names`` and ``size(i)``, and makes no process group. The
runtime mesh over ``torch.distributed`` processes stays
``distributed.mesh.make_mesh``.
"""
from __future__ import annotations

import math
from typing import Tuple


class MeshShape:
    """An abstract device mesh: axis names and sizes, no devices."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axes)

    def size(self, i=None) -> int:
        """The size of axis ``i``, or of the whole mesh."""
        return math.prod(self.shape) if i is None else self.shape[i]

    @property
    def name(self) -> str:
        """``"16x16"`` / ``"2x16x16"``: the JAX dry run's mesh name."""
        return "x".join(str(n) for n in self.shape)

    def __repr__(self) -> str:
        return f"MeshShape({self.shape}, {self.mesh_dim_names})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """One pod, (16, 16) on ("data", "model"), or two, (2, 16, 16) with
    "pod" first."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> MeshShape:
    """A small mesh shape (the JAX package's CPU-test mesh)."""
    return MeshShape(shape, axes)


__all__ = ["MeshShape", "make_production_mesh", "make_test_mesh"]
