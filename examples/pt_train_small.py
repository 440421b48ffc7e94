"""Train a ~100M-param dense model for a few hundred steps on the port,
with checkpoint/restart in the middle (fault-tolerance demo).

    PYTHONPATH=src python examples/pt_train_small.py [--steps 200]
    PYTHONPATH=src python examples/pt_train_small.py --steps 4 --device cpu

``examples/train_small.py`` step by step, on ``repro_torch``: the same
slimmed qwen3 (8 layers, vocab 8,192), AdamW schedule, seeded data and
prints; seeded random weights from a ``torch.Generator``; the train
step runs eagerly (no ``jit``) and updates the state in place. The
checkpoint lands under the temporary directory unless ``--ckpt-dir``
says otherwise.
"""
import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import (Checkpointer, restore_train_state,
                                    save_train_state)
from repro_torch.configs import get_config
from repro_torch.models.model import init_params, resolve_device
from repro_torch.training.data import DataConfig, batch_for_step
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             train_step)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small"))
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without it) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params: a slimmed qwen3-0.6b (fewer layers, smaller vocab).
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), num_layers=8,
                              vocab_size=8192, name="qwen3-100m")
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params")

    def fresh():
        return init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    acfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    tcfg = TrainConfig(remat=True, microbatches=1)
    state = init_train_state(fresh(), acfg, tcfg, dev)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                    global_batch=4, seed=0)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)

    def step_fn(state, step):
        toks, mask = batch_for_step(dc, step)
        return train_step(state, torch.from_numpy(toks).to(dev),
                          torch.from_numpy(mask).to(dev), cfg=cfg,
                          tcfg=tcfg, adam_cfg=acfg)

    half = args.steps // 2
    t0 = time.time()
    for step in range(half):
        state, out = step_fn(state, step)
        if step % 20 == 0:
            print(f"step {step:4d} loss {float(out['loss']):.4f} "
                  f"({(time.time() - t0):.0f}s)")
    save_train_state(ckpt, half - 1, state)
    print(f">>> checkpoint @ step {half - 1}; simulating restart")

    # "Crash" — rebuild everything from disk and resume.
    like = init_train_state(fresh(), acfg, tcfg, dev)
    state = restore_train_state(ckpt, ckpt.latest(), like)
    losses = []
    for step in range(half, args.steps):
        state, out = step_fn(state, step)
        losses.append(float(out["loss"]))
        if step % 20 == 0:
            print(f"step {step:4d} loss {float(out['loss']):.4f}")
    print(f"final loss {float(out['loss']):.4f} "
          f"(random-chance {math.log(cfg.vocab_size):.2f})")
    return losses


if __name__ == "__main__":
    main()
