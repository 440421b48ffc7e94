"""Train step: masked LM loss, remat, microbatch accumulation, AdamW.

The JAX package's ``repro.training.train_step`` on plain autograd. The
model runs the plain ``"xla"`` attention core, as JAX trains with it
(the flash kernel has no backward in either package), so a train step
launches none of the port's kernels. Gradients come from
``torch.autograd.grad`` on the parameter leaves; with ``microbatches >
1`` each microbatch's gradient is added into float32 buffers, as JAX's
scan does (not summed in the parameters' dtype). With
``grad_compression`` the gradients pass through int8 quantization with
error feedback before the update (numerically, as in JAX; the pod-axis
average on the wire is ``training.grad_sync``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward, params_device, resolve_device
from repro_torch.training.compression import (compress_grads_with_ef,
                                              decompress_grads,
                                              init_error_feedback)
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)
from repro_torch.training.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    moe_aux_weight: float = 0.01
    capacity_factor: float = 1.25
    grad_compression: bool = False
    attn_chunk: int = 512
    moe_ep_groups: int = 0   # >1: grouped MoE dispatch (models.moe)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any                  # error-feedback buffers (or None)


def init_train_state(params, adam_cfg: AdamWConfig, tcfg: TrainConfig,
                     device=None) -> TrainState:
    """Zero moments (and error feedback) beside ``params``, which must
    live on ``device`` (default: CUDA; raises without it)."""
    dev = resolve_device(device)
    if params_device(params) != dev:
        raise ValueError(f"params live on {params_device(params)}, "
                         f"not on {dev}")
    ef = init_error_feedback(params) if tcfg.grad_compression else None
    return TrainState(params, init_adamw(params, adam_cfg), ef)


def lm_loss(params, cfg: ModelConfig, tokens, mask, tcfg: TrainConfig,
            embeds=None):
    """tokens [B, S+1]; mask [B, S]. Returns (loss, metrics): the masked
    NLL of the next token (float32 logits) over ``max(mask.sum(), 1)``
    plus ``moe_aux_weight`` times the MoE load-balancing loss."""
    inp = tokens[:, :-1]
    tgt = tokens[:, 1:]
    logits, aux = forward(params, cfg, inp, embeds, backend="xla",
                          chunk=tcfg.attn_chunk, remat=tcfg.remat,
                          capacity_factor=tcfg.capacity_factor,
                          ep_groups=tcfg.moe_ep_groups)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, tgt[..., None].long())[..., 0]
    nll = (lse - tgt_logit) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = nll.sum() / denom
    loss = ce + tcfg.moe_aux_weight * aux
    return loss, {"ce": ce, "aux": aux, "tokens": denom}


def loss_and_grads(params, cfg: ModelConfig, tokens, mask,
                   tcfg: TrainConfig, embeds=None,
                   on_phase: Optional[Callable[[str], None]] = None):
    """(loss, metrics, gradient tree) of ``lm_loss`` with respect to every
    parameter leaf; a leaf the loss does not reach gets a zero gradient,
    as in JAX."""
    leaves = tree_leaves(params)
    live = {id(p): p.detach().requires_grad_(True) for p in leaves}
    p_live = tree_map(lambda p: live[id(p)], params)
    with torch.enable_grad():
        loss, metrics = lm_loss(p_live, cfg, tokens, mask, tcfg, embeds)
        if on_phase is not None:
            on_phase("forward")
        wrt = [live[id(p)] for p in leaves]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    if on_phase is not None:
        on_phase("backward")
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda p: by_id[id(p)], params)


def train_step(state: TrainState, tokens, mask, *, cfg: ModelConfig,
               tcfg: TrainConfig, adam_cfg: AdamWConfig, embeds=None,
               on_phase: Optional[Callable[[str], None]] = None
               ) -> Tuple[TrainState, dict]:
    """One optimizer step (optionally accumulated over microbatches).
    Returns (new state, {"loss", "grad_norm", "lr"}), every value a
    device scalar; the parameters and moments are updated in place.

    ``on_phase(name)``, if given, is called as each phase ends:
    "forward" (the loss), "backward" (the gradients, remat's recompute
    included) — once a microbatch — and "optimizer" (compression and
    the update); a caller records a CUDA event there to split the step's
    device time.
    """
    n = max(1, tcfg.microbatches)
    if n == 1:
        loss, _, grads = loss_and_grads(state.params, cfg, tokens, mask,
                                        tcfg, embeds, on_phase)
    else:
        B = tokens.shape[0]
        if B % n:
            raise ValueError(f"global batch {B} must divide into {n} "
                             f"microbatches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), state.params)
        loss = 0.0
        for tk, mk, eb in zip(tokens.chunk(n), mask.chunk(n),
                              (embeds.chunk(n) if embeds is not None
                               else [None] * n)):
            l, _, g = loss_and_grads(state.params, cfg, tk, mk, tcfg, eb,
                                     on_phase)
            for a, gi in zip(tree_leaves(acc), tree_leaves(g)):
                a.add_(gi)
            del g
            loss = loss + l
        grads = tree_map(lambda a: a.div_(n), acc)
        loss = loss / n

    ef = state.ef
    if tcfg.grad_compression:
        qgrads, ef = compress_grads_with_ef(grads, ef)
        grads = decompress_grads(qgrads)
    params, opt, opt_metrics = adamw_update(state.params, grads, state.opt,
                                            adam_cfg)
    if on_phase is not None:
        on_phase("optimizer")
    return TrainState(params, opt, ef), {"loss": loss, **opt_metrics}
