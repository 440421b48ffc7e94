"""Process meshes: the port's counterpart of the JAX package's device mesh.

The JAX package shards the global pool's rank axis over the devices of a
``jax.sharding.Mesh`` with axes ``("data", "model")``
(``repro.launch.mesh.make_test_mesh``) and runs its steps as one program
over them. The port runs SPMD with replicated control instead: every
process of a ``torch.distributed`` job runs the same serving host logic
on the same request stream, holds the KV slab of the pool ranks its mesh
position owns, and issues every collective in the same order as every
other process. A mesh is a ``DeviceMesh`` over the job's default process
group (gloo or NCCL, whatever it was initialized with; the control
scalars of ``agreed_clock`` and ``check_replicated`` go to the card for
NCCL):

    dist.init_process_group("gloo", init_method="file:///tmp/store",
                            rank=rank, world_size=4)
    mesh = make_mesh((2, 2))                  # axes ("data", "model")
    shards = pool_shards(mesh, ("data", "model"))

``pool_shards`` answers what JAX reads from ``mesh.shape[ax]`` and
``jax.lax.axis_index`` inside ``shard_map``: the process group the pool
is sharded over, this process's shard along it, and which process holds
each shard. ``agreed_clock`` and ``check_replicated`` keep replicated
control replicated: a decision may read only a clock every process
agrees on, and a digest of each step's plan must be equal everywhere.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.model import resolve_device

MESH_AXES = ("data", "model")


def make_mesh(shape: Sequence[int] = (2, 1),
              axes: Sequence[str] = MESH_AXES, *, device=None):
    """A ``DeviceMesh`` of ``shape`` over every process of the initialized
    default group, process ``r`` at row-major position ``r``. ``device``
    is the processes' device type: ``"cuda"`` unless the caller asks for
    ``"cpu"``, as every entry point of the port."""
    from torch.distributed.device_mesh import init_device_mesh
    dtype = resolve_device(device).type
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"a mesh of shape {tuple(shape)} does not cover "
                         f"the {dist.get_world_size()} processes")
    return init_device_mesh(dtype, tuple(shape), mesh_dim_names=tuple(axes))


@dataclass(frozen=True)
class PoolShards:
    """Where a mesh puts the shards of the pool's rank axis, seen from
    this process.

    ``group``: the processes that together hold one whole pool (the
    collective merge and the block reads run over it); ``index``: this
    process's shard, ``count``: the shards; ``owners[s]``: the global
    process rank holding shard ``s`` in this process's group.
    """
    group: object
    index: int
    count: int
    owners: Tuple[int, ...]

    def local_ranks(self, n_ranks: int) -> int:
        """Pool ranks each shard holds (``n_ranks`` must divide)."""
        if n_ranks % self.count:
            raise ValueError(f"{n_ranks} ranks not divisible over "
                             f"{self.count} shards")
        return n_ranks // self.count

    def owner(self, rank: int, r_loc: int) -> int:
        """Global process rank holding pool rank ``rank``."""
        return self.owners[rank // r_loc]


def mesh_group(mesh):
    """The process group of every process of ``mesh`` (the whole job: a
    mesh from ``make_mesh`` spans the default group)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every process of the job")
    return dist.group.WORLD


def pool_shards(mesh, pool_axes: Sequence[str]) -> PoolShards:
    """The shards of a pool whose rank axis is split over ``pool_axes``
    (any non-empty set of the mesh's axes), in the axes' order — shard
    ``s`` holds ranks ``[s * r_loc, (s + 1) * r_loc)``, as JAX's
    ``PartitionSpec(pool_axes)`` places them. Worked out once per mesh
    and axes, then kept on the mesh (the steps ask every call)."""
    cache = vars(mesh).setdefault("_pool_shards", {})
    pool_axes = tuple(pool_axes)
    if pool_axes not in cache:
        cache[pool_axes] = _pool_shards(mesh, pool_axes)
    return cache[pool_axes]


def _pool_shards(mesh, pool_axes: Tuple[str, ...]) -> PoolShards:
    names = list(mesh.mesh_dim_names)
    unknown = [ax for ax in pool_axes if ax not in names]
    if unknown or not pool_axes:
        raise ValueError(f"pool axes {pool_axes} not in mesh axes {names}")
    dims = [names.index(ax) for ax in pool_axes]
    if len(pool_axes) == 1:
        group = mesh.get_group(pool_axes[0])
    elif sorted(pool_axes) == sorted(names):
        group = mesh_group(mesh)
    else:
        group = _subset_group(mesh, dims)
    coord = list(mesh.get_coordinate())
    sizes = [mesh.size(d) for d in dims]
    index = int(np.ravel_multi_index([coord[d] for d in dims], sizes))
    owners = []
    for s in range(int(np.prod(sizes))):
        at = list(coord)
        for d, c in zip(dims, np.unravel_index(s, sizes)):
            at[d] = int(c)
        owners.append(int(mesh.mesh[tuple(at)]))
    return PoolShards(group, index, len(owners), tuple(owners))


def _subset_group(mesh, dims):
    """The process group of the processes that differ from this one only
    in the mesh dims ``dims`` (a proper subset of two or more). Every
    process creates every such group, in the same order (``new_group``
    is collective over the job), and keeps its own."""
    other = [d for d in range(mesh.ndim) if d not in dims]
    size = int(np.prod([mesh.size(d) for d in dims]))
    rows = mesh.mesh.permute(other + list(dims)).reshape(-1, size).tolist()
    me, mine = dist.get_rank(), None
    for ranks in rows:
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def shard_rank_base(mesh, pool_axes: Sequence[str], r_loc: int) -> int:
    """First global pool rank this process owns (JAX's
    ``_shard_rank_base``)."""
    return pool_shards(mesh, pool_axes).index * r_loc


def host_staged(backend, device) -> bool:
    """Whether a point-to-point send of a tensor on ``device`` over a
    process group of ``backend`` goes through host memory. NCCL sends
    CUDA tensors and gloo host ones; gloo runs its collectives on CUDA
    tensors (all-reduce, broadcast, all-gather, reduce-scatter), but a
    send of one aborts the process (torch 2.11, CUDA 12.8:
    ``scripts/gloo_probe.py``)."""
    return str(backend) == dist.Backend.GLOO and \
        torch.device(device).type == "cuda"


@dataclass
class HostStaging:
    """The copies a process made between its card and host memory for
    the sends its backend cannot make from the card (``host_staged``):
    only the transport is staged."""
    copies: int = 0
    bytes: int = 0          # card -> host and host -> card

    def to_host(self, tensors):
        """``tensors`` copied to host memory, counted."""
        return [self._count(t).cpu() for t in tensors]

    def to_device(self, tensors, device):
        """Host ``tensors`` copied back to ``device``, counted."""
        return [self._count(t).to(device) for t in tensors]

    def _count(self, t: torch.Tensor) -> torch.Tensor:
        self.copies += 1
        self.bytes += t.numel() * t.element_size()
        return t


def _control_device(group) -> torch.device:
    """Where a host scalar goes for a collective over ``group``: NCCL
    takes only CUDA tensors (the process's current card), gloo host
    ones."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agreed_clock(group, now: Optional[float] = None) -> float:
    """One clock reading every process of ``group`` shares: the largest
    of their ``now`` (``time.monotonic()`` by default). Decisions that
    read a clock (arrival rates, urgency, timeouts) read this one under
    replicated control, or the processes' plans would drift apart."""
    t = torch.tensor([time.monotonic() if now is None else float(now)],
                     dtype=torch.float64, device=_control_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t[0])


def _digest(obj) -> int:
    """A 62-bit digest of ``repr(obj)`` (plain data: ints, tuples, lists)."""
    h = hashlib.blake2b(repr(obj).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 2


def check_replicated(group, what: str, obj) -> None:
    """Raise ``RuntimeError`` in EVERY process of ``group`` unless
    ``obj``'s digest is the same in all of them: one all-reduce MAX of
    ``(d, -d)`` gives the largest and the smallest digest at once."""
    d = _digest(obj)
    t = torch.tensor([d, -d], dtype=torch.int64,
                     device=_control_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise RuntimeError(
            f"replicated control diverged: the {what} digest differs "
            f"between processes (here {d:#x}, min {lo:#x}, max {hi:#x})")


__all__ = ["HostStaging", "MESH_AXES", "PoolShards", "agreed_clock",
           "check_replicated", "host_staged", "make_mesh", "mesh_group",
           "pool_shards", "shard_rank_base"]
