"""AdamW on tensor trees, with optional bf16 moment storage.

The JAX package's ``repro.training.optimizer``, computed the same way:
every gradient and moment is upcast to float32, the gradient tree is
clipped by its global norm, the learning rate is read at the step
before the increment and the bias corrections at the step after it,
weight decay applies to every leaf (embeddings and norms too), and the
moments are stored in ``moment_dtype``. ``torch.optim.AdamW`` is not
used: it does its arithmetic in the parameter's dtype, which for bf16
parameters is not what JAX computes.

The update is in place (parameters and moments are overwritten and
returned), as the serving steps update their caches: a second copy of
the parameters and moments would not fit beside a full-width MoE bank.
The scalars (step, learning rate, clip scale, bias corrections) stay on
the device, so a step reads nothing back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.training.tree import flat_chunks, tree_leaves, tree_map

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"      # "bfloat16" halves optimizer memory


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar: updates taken so far
    m: Any
    v: Any


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    dt = _MOMENT_DTYPES[cfg.moment_dtype]
    leaves = tree_leaves(params)
    dev = leaves[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay; float32, on ``step``'s device."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1).float() / max(1, cfg.warmup_steps),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(torch.pi * prog))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares."""
    sums = [sum(torch.sum(torch.square(c.float()))
                for c in flat_chunks(x.contiguous()))
            for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step. Returns (params, new state, {"grad_norm", "lr"});
    the parameter and moment tensors are updated in place."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + g * g * (1 - cfg.b2)
        update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
        m.copy_(m32)
        v.copy_(v32)

    for leaves in zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state.m), tree_leaves(state.v)):
        p, g, m, v = leaves
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"leaf shapes differ: {p.shape} {g.shape} "
                             f"{m.shape} {v.shape}")
        for chunks in zip(flat_chunks(p), flat_chunks(g.contiguous()),
                          flat_chunks(m), flat_chunks(v)):
            upd(*chunks)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}
