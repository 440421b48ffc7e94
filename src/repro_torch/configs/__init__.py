"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

The port serves the dense and hybrid families; their architectures are
registered here (``qwen3-0.6b``: GQA with qk-norm; ``olmo-1b``: MHA with
non-parametric LayerNorm; ``recurrentgemma-9b``: RG-LRU layers and local
MQA attention). The other architectures of the JAX package join as their
families are ported.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, reduce_config

_ARCH_MODULES: Dict[str, str] = {
    "olmo-1b":           "repro_torch.configs.olmo_1b",
    "qwen3-0.6b":        "repro_torch.configs.qwen3_0_6b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str, **kw) -> ModelConfig:
    return reduce_config(get_config(arch_id), **kw)


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
    "get_config", "get_smoke_config", "reduce_config",
]
