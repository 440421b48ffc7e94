"""Parameter placements over a mesh: each process keeps its shard of each
weight, as the JAX package's ServeLayout cells give GSPMD their
``in_shardings``.

``place_params(params, specs, mesh)`` keeps, for every leaf, this
process's contiguous shard along each dim its spec splits (in the
mesh's coordinates: the shard index of a dim split over several axes is
row-major over them, as ``PartitionSpec`` orders it), one leaf at a
time: a leaf may be a numpy array (a bridged JAX leaf), sliced before it
moves to the device. ``seeded_params`` draws the weights itself, one
leaf (or one layer of a stacked leaf) at a time, so that no process ever
holds the whole tree; without a mesh it gives the whole tree of the same
values. ``gather_params`` puts a placed tree back together (tests,
checkpoints).

A ``PlacedParams`` is explicit: the local shards, their specs (as
``distributed.sharding`` gives them) and the mesh. The ServeLayout steps
read it through ``layer`` and ``top``, which all-gather the FSDP dims
(every axis but "model") of the leaves a layer uses right before it uses
them, and through ``tp``, the "model" axis's collectives: ``sum`` (the
row-parallel all-reduce, in float32) and ``cat`` (an all-gather).
"""
from __future__ import annotations

import itertools
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import pool_shards
from repro_torch.models.common import TP_AXIS, spec_axes as _axes
from repro_torch.models.model import (init_params, layer_path,
                                      resolve_device)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def shard_slices(shape, spec, mesh) -> Tuple[slice, ...]:
    """This process's slice of a leaf of ``shape`` placed by ``spec``."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = _axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        sh = pool_shards(mesh, axes)
        if n % sh.count:
            raise ValueError(f"dim {n} does not split over {axes} "
                             f"({sh.count}): validate_divisibility first")
        size = n // sh.count
        out.append(slice(sh.index * size, (sh.index + 1) * size))
    return tuple(out)


def gather_dims(x: torch.Tensor, spec, mesh, *, keep=()) -> torch.Tensor:
    """``x`` (a local shard placed by ``spec``) all-gathered along every
    dim split over axes not in ``keep``."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes and not set(axes) & set(keep):
            x = all_gather_cat(x, pool_shards(mesh, axes), dim)
    return x


def all_gather_cat(x: torch.Tensor, shards, dim: int = 0) -> torch.Tensor:
    """Concatenate every shard's ``x`` along ``dim``, in shard order
    (``shards``: a ``PoolShards`` of the axes, or None: ``x`` itself)."""
    if shards is None or shards.count == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shards.count)]
    dist.all_gather(parts, x, group=shards.group)
    order = [dist.get_group_rank(shards.group, o) for o in shards.owners]
    return torch.cat([parts[i] for i in order], dim)


class TPAxis:
    """This process's place on the TP ("model") axis of a mesh, and the
    two collectives of tensor parallelism over it."""

    def __init__(self, shards):
        self.shards = shards
        self.index, self.count = shards.index, shards.count

    def sum(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """The all-reduced sum of row-parallel partials, summed in float32
        and cast to ``dtype`` (default: ``x``'s)."""
        y = x.float().contiguous()
        dist.all_reduce(y, group=self.shards.group)
        return y.to(dtype or x.dtype)

    def cat(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every process's ``x`` concatenated along ``dim`` in TP order."""
        return all_gather_cat(x, self.shards, dim)


@dataclass
class PlacedParams:
    """A parameter tree placed over ``mesh``: ``local`` holds this
    process's shard of each leaf, ``specs`` each leaf's spec (one entry a
    dim of the whole leaf, stacked dims included)."""
    local: Dict[str, Any]
    specs: Dict[str, Any]
    mesh: Any

    def __getitem__(self, key):
        raise TypeError("a placed parameter tree runs only in the "
                        "ServeLayout steps; gather_params() gives the "
                        "whole tree")

    @property
    def device(self) -> torch.device:
        """The device the local shards live on."""
        return self.local["embed"].device

    @property
    def tp(self) -> Optional[TPAxis]:
        """The TP axis, or None when the mesh has none of 2 or more."""
        names = self.mesh.mesh_dim_names
        if TP_AXIS not in names or \
                self.mesh.size(names.index(TP_AXIS)) == 1:
            return None
        return TPAxis(pool_shards(self.mesh, (TP_AXIS,)))

    def _unshard(self, local, specs, drop: int = 0):
        """(leaves with their FSDP dims gathered, their specs without the
        ``drop`` leading stacked dims and with only the TP axis left)."""
        def one(x, spec):
            spec = tuple(spec)[drop:]
            x = gather_dims(x, spec, self.mesh, keep=(TP_AXIS,))
            return x, tuple(e if TP_AXIS in _axes(e) else None
                            for e in spec)
        pairs = _tree_map(one, local, specs)        # (tensor, spec) leaves
        return (_tree_map(lambda p: p[0], pairs),
                _tree_map(lambda p: p[1], pairs))

    def top(self, keys=("embed", "unembed", "final_norm")):
        """The model-level leaves ``keys`` (those present), FSDP-gathered,
        and their specs."""
        keys = [k for k in keys if k in self.local]
        return self._unshard({k: self.local[k] for k in keys},
                             {k: self.specs[k] for k in keys})

    def sub(self, keys, idx=()):
        """The leaves under the dict ``keys`` at index ``idx`` of their
        leading stacked dims, FSDP-gathered, and their specs (those dims
        dropped)."""
        local, specs = self.local, self.specs
        for k in keys:
            local, specs = local[k], specs[k]
        if idx:
            local = _tree_map(lambda x: x[tuple(idx)], local)
        return self._unshard(local, specs, drop=len(idx))

    def layer(self, cfg: ModelConfig, i: int):
        """Layer ``i``'s leaves (any family: ``models.model.layer_path``
        says where they live), FSDP-gathered, and their specs (the
        stacked dims dropped)."""
        return self.sub(*layer_path(cfg, i))


def place_params(params, specs, mesh, *, device=None) -> PlacedParams:
    """Keep this process's shard of every leaf of ``params`` (tensors, or
    numpy arrays as ``jax.tree.map(np.asarray, ...)`` gives them), one
    leaf at a time. Numpy leaves are sliced before they move to
    ``device`` (default: the tensors' own device, or ``"cuda"``); a
    tensor's shard is a copy, so the whole leaf can be dropped."""
    def one(leaf, spec):
        sl = shard_slices(leaf.shape, spec, mesh)
        if isinstance(leaf, np.ndarray):
            bf16 = leaf.dtype.name == "bfloat16"      # through float32
            t = torch.from_numpy(np.array(leaf[sl], dtype=np.float32 if bf16
                                          else leaf.dtype))
            return t.to(device=resolve_device(device),
                        dtype=torch.bfloat16 if bf16 else t.dtype)
        part = leaf[sl]
        dev = leaf.device if device is None else resolve_device(device)
        return part.to(dev, copy=True).contiguous()
    return PlacedParams(_tree_map(one, params, specs), specs, mesh)


def param_shapes(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors (shapes, dtypes)."""
    return init_params(cfg, torch.Generator(), device="meta")


def _leaf_seed(seed: int, path: str, i: int) -> int:
    return zlib.crc32(f"{seed}/{path}/{i}".encode())


# Stacked leading dims of the leaves under each top-level key (a stacked
# leaf is drawn one layer at a time); the ssm family's mLSTM stack has two.
_STACKED = {"layers": 1, "dense_layers": 1, "moe_layers": 1, "groups": 1}


def _n_stacked(path: str) -> int:
    if path.startswith("groups/mlstm/"):
        return 2
    top, sep, _ = path.partition("/")
    return _STACKED.get(top, 0) if sep else 0


def _draw(path: str, shape, dtype, gen, device) -> torch.Tensor:
    """One leaf (or one layer of a stacked leaf) with the distribution
    ``init_params`` gives it: norm scales 1, biases 0, the embedding
    N(0, 0.02^2), every matrix N(0, 1 / fan_in); RG-LRU's conv N(0,
    0.1^2) and Lambda with ``sigmoid(L)^8`` uniform in [0.9, 0.999];
    mLSTM's gate bias 0 for the input half and 3 for the forget half."""
    name = path.rsplit("/", 1)[-1]
    if name in ("scale", "q_norm", "k_norm", "gn_scale"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ("bias", "b", "b_r", "b_i"):
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "b_if":
        nh = shape[-1] // 2
        return torch.cat([torch.zeros(shape[:-1] + (nh,), device=device),
                          torch.full(shape[:-1] + (nh,), 3.0,
                                     device=device)], -1).to(dtype)
    if name == "log_sig_lambda":
        u = torch.rand(shape, generator=gen, device=device) \
            * (0.999 - 0.9) + 0.9
        return torch.log(u ** (1.0 / 8.0)).to(dtype)
    if name == "conv_w":
        std = 0.1
    else:
        std = 0.02 if path == "embed" else shape[-2] ** -0.5
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * std).to(dtype)


def seeded_params(cfg: ModelConfig, seed: int = 0, *, mesh=None,
                  specs=None, device=None):
    """Seeded random weights of any family, drawn one leaf at a time — a
    stacked leaf one layer at a time, each layer from its own generator
    — so the values do not depend on the mesh. Without ``mesh``: the
    whole tree. With it: a ``PlacedParams`` by ``specs`` (validated), of
    which this process only ever holds its shards and one layer of one
    leaf."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def one(path, meta, spec):
        sl = shard_slices(meta.shape, spec, mesh) if mesh is not None \
            else (slice(None),) * meta.ndim
        ns = _n_stacked(path)
        lead = tuple(meta.shape[:ns])
        local = [len(range(*s_.indices(d))) for s_, d in zip(sl, meta.shape)]
        out = torch.empty(local, dtype=meta.dtype, device=dev)
        ranges = [range(*s_.indices(d)) for s_, d in zip(sl[:ns], lead)]
        for j, idx in enumerate(itertools.product(*ranges)):
            i = int(np.ravel_multi_index(idx, lead)) if ns else 0
            gen = torch.Generator(device=dev).manual_seed(
                _leaf_seed(seed, path, i))
            layer = _draw(path, tuple(meta.shape[ns:]), meta.dtype, gen, dev)
            out.view(-1, *local[ns:])[j] = layer[sl[ns:]]
        return out

    def walk(tree, sp, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, None if sp is None else sp[k],
                            f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        return one(path, tree, sp)
    local = walk(shapes, specs)
    return local if mesh is None else PlacedParams(local, specs, mesh)


def gather_params(placed: PlacedParams):
    """The whole tree of a placed one, in every process (collective)."""
    return _tree_map(lambda x, spec: gather_dims(x, spec, placed.mesh),
                     placed.local, placed.specs)


def local_bytes(params) -> int:
    """Bytes of the weights this process holds (a plain or placed tree)."""
    tree = params.local if isinstance(params, PlacedParams) else params
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def spec_bytes(shapes, specs, mesh_sizes: Dict[str, int]) -> int:
    """Bytes one process holds of a tree of ``shapes`` (meta tensors)
    placed by ``specs`` over a mesh of ``{axis: size}`` (no process group
    needed): the prediction ``local_bytes`` is held to."""
    def one(meta, spec):
        n = meta.numel()
        for entry in spec:
            for ax in _axes(entry):
                n //= mesh_sizes[ax]
        return n * meta.element_size()
    return sum(_leaves(_tree_map(one, shapes, specs)))


__all__ = ["PlacedParams", "TPAxis", "all_gather_cat", "gather_dims",
           "gather_params", "local_bytes", "param_shapes", "place_params",
           "seeded_params", "shard_slices", "spec_bytes"]
