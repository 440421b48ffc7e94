"""Atomic checkpoint/restore with a manifest, in the JAX package's format.

Layout (``repro.checkpoint.checkpointer``'s, so that each package
restores the other's checkpoints):

    <dir>/step_<N:08d>/
        manifest.json     {"step": N, "leaves": [{"i", "path", "shape",
                          "dtype"}, ...]}
        leaf_<i>.npy      one file per leaf; bfloat16 stored as uint16
    <dir>/step_<N:08d>.tmp   staged, then ``os.rename`` -> atomic commit.

A leaf's ``path`` is JAX's ``tree_flatten_with_path`` key string: the
keys from the root joined by ``/``, a dict key as ``['name']``, a
NamedTuple field as ``.name``, dict keys in sorted order (``['opt']/.m/['embed']``, ``['opt']/.step``); ``None``
holds no leaf. Restart picks the highest complete step (manifest
present); a crash mid-save leaves only a ``.tmp`` directory, which is
ignored and reaped at the next save.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import TrainState

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "int32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _map_with_path(fn: Callable[[str, torch.Tensor], Any], tree,
                   path: str = ""):
    """``tree`` with each tensor leaf replaced by ``fn(path, leaf)``,
    visiting leaves in JAX's flattening order."""
    def sub(key):
        return f"{path}/{key}" if path else key
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], sub(f"[{k!r}]"))
                for k in sorted(tree)}
    if isinstance(tree, tuple):                   # a NamedTuple
        return type(tree)(*(_map_with_path(fn, getattr(tree, f),
                                           sub(f".{f}"))
                            for f in tree._fields))
    return fn(path, tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:             # numpy has no bfloat16
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy()).to(_DTYPES[dtype])
    return t.to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves = []

        def write(path, leaf):
            i = len(leaves)
            arr = _to_numpy(leaf)
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            leaves.append({"i": i, "path": path, "shape": list(arr.shape),
                           "dtype": _NAMES[leaf.dtype]})
        _map_with_path(write, tree)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": leaves}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
        self._gc()
        return final

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (shapes must match),
        each leaf on its ``like`` leaf's device, in the saved dtype."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            by_path = {e["path"]: e for e in json.load(f)["leaves"]}

        def read(path, leaf):
            e = by_path[path]
            arr = np.load(os.path.join(d, f"leaf_{e['i']}.npy"))
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch at {path}: saved "
                                 f"{list(arr.shape)}, want "
                                 f"{list(leaf.shape)}")
            return _from_numpy(arr, e["dtype"], leaf.device)
        return _map_with_path(read, like)

    # ------------------------------------------------------------------ #
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, name,
                                                    "manifest.json")):
                out.append(int(name[5:]))
        return sorted(out)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        for name in os.listdir(self.dir):           # reap crashed saves
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)


def save_train_state(ckpt: Checkpointer, step: int, state: TrainState) -> str:
    return ckpt.save(step, {"params": state.params, "opt": state.opt,
                            "ef": state.ef})


def restore_train_state(ckpt: Checkpointer, step: int,
                        like: TrainState) -> TrainState:
    tree = ckpt.restore(step, {"params": like.params, "opt": like.opt,
                               "ef": like.ef})
    return TrainState(tree["params"], AdamWState(*tree["opt"]), tree["ef"])


def latest_step(directory: str) -> Optional[int]:
    return Checkpointer(directory).latest()
