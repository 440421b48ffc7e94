"""Trainer: real train steps of one architecture on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --seq 256 --batch 4 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 8 --seq 4096 --batch 4          # full width, on the card

The JAX package's ``python -m repro.launch.train`` with the same
settings: seeded random weights, ``AdamWConfig(lr, warmup_steps=max(2,
steps // 10), total_steps=steps)``, ``TrainConfig(remat=True)``, the
seeded data pipeline (``DataConfig(seed=0)``) and, with ``--ckpt-dir``,
a checkpoint every 50 steps. ``run`` is the same trainer as a
function, returning one record per step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --aot

``--aot`` plans the production-mesh ``train_4k`` cell
(``launch.dryrun.run_cell``: bytes a process with gradients and AdamW
moments, fit, ideal step time) where JAX's lowers and compiles it with
XLA; it touches only meta tensors, so it needs no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint import Checkpointer, save_train_state
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import init_params, resolve_device
from repro_torch.training.data import DataConfig, batch_for_step
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             train_step)

CKPT_EVERY = 50


def run(arch: str, *, steps: int, seq: int, batch: int, smoke: bool = False,
        layers: Optional[int] = None, ep_groups: int = 0, lr: float = 3e-4,
        ckpt_dir: Optional[str] = None, device=None,
        around_step: Optional[Callable] = None,
        log: Optional[Callable[[str], None]] = print) -> List[dict]:
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens.

    ``smoke`` takes the reduced config, ``layers`` cuts the depth (full
    width kept), ``ep_groups`` sets ``TrainConfig.moe_ep_groups``. The
    device defaults to CUDA (raises without it). ``around_step(step,
    run_step)``, if given, runs each step by calling ``run_step(**kw)``
    (``kw`` passed on to ``train_step``, e.g. ``on_phase``) and returns
    its output, so a caller can trace or time a chosen step.

    Returns one record per step: ``step``, ``loss``, ``grad_norm``,
    ``lr``, ``seconds`` (host time of the step, ended by reading its
    loss) and ``tokens_per_s``.
    """
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if log:
        log(f"training {cfg.name} ({cfg.num_layers} layers): "
            f"{cfg.param_count() / 1e6:.1f}M params on {dev}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    acfg = AdamWConfig(lr=lr, warmup_steps=max(2, steps // 10),
                       total_steps=steps)
    tcfg = TrainConfig(remat=True, moe_ep_groups=ep_groups)
    state = init_train_state(params, acfg, tcfg, dev)
    del params
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=batch, seed=0)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    records = []
    for step in range(steps):
        toks, mask = batch_for_step(dc, step)
        toks = torch.from_numpy(toks).to(dev)
        mask = torch.from_numpy(mask).to(dev)
        t0 = time.perf_counter()

        def run_step(**kw):
            return train_step(state, toks, mask, cfg=cfg, tcfg=tcfg,
                              adam_cfg=acfg, **kw)
        state, out = (around_step(step, run_step) if around_step
                      else run_step())
        rec = {"step": step, "loss": float(out["loss"]),
               "grad_norm": float(out["grad_norm"]),
               "lr": float(out["lr"])}
        rec["seconds"] = time.perf_counter() - t0
        rec["tokens_per_s"] = batch * seq / rec["seconds"]
        records.append(rec)
        if not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm")):
            raise FloatingPointError(f"step {step}: {rec}")
        if log and step % max(1, steps // 10) == 0:
            log(f"step {step:5d}  loss {rec['loss']:.4f}  "
                f"gnorm {rec['grad_norm']:.3f}  {rec['seconds']:.2f}s")
        if ckpt and step and step % CKPT_EVERY == 0:
            save_train_state(ckpt, step, state)
    if log:
        log(f"done: final loss {records[-1]['loss']:.4f}")
    return records


def main(argv=None):
    """Run the trainer; returns its records (with ``--aot``: the cell's
    ``launch.roofline.RooflineReport``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without it) or cpu")
    ap.add_argument("--aot", action="store_true",
                    help="plan the production-mesh train_4k cell instead "
                         "of training")
    args = ap.parse_args(argv)
    if args.aot:
        from repro_torch.launch.dryrun import run_cell
        return run_cell(args.arch, "train_4k")
    return run(args.arch, steps=args.steps, seq=args.seq, batch=args.batch,
               smoke=args.smoke, lr=args.lr, ckpt_dir=args.ckpt_dir,
               device=args.device)


if __name__ == "__main__":
    main()
