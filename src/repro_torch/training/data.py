"""Deterministic synthetic data pipeline (seeded, stateless: step -> batch).

A copy of the JAX package's ``repro.training.data`` (numpy only), kept
here so the port imports nothing of ``repro``; it yields the same
batches bit for bit.

Restart-safe by construction: the batch for step N is a pure function of
(seed, step), so checkpoint/restart resumes the exact token stream with no
pipeline state to persist. Mimics a packed LM pipeline: documents of
Zipf-ish length packed into fixed-length rows with EOS separators.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_token: int = 0


def batch_for_step(cfg: DataConfig, step: int) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Returns (tokens [B, S+1] int32, loss_mask [B, S] float32).

    tokens[:, :-1] are inputs, tokens[:, 1:] targets; mask zeroes the
    positions crossing document boundaries.
    """
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    B, S = cfg.global_batch, cfg.seq_len
    toks = rng.integers(1, cfg.vocab_size, size=(B, S + 1), dtype=np.int64)
    mask = np.ones((B, S), np.float32)
    # Pack documents: draw boundaries with Zipf-like lengths.
    for b in range(B):
        pos = 0
        while pos < S:
            ln = int(min(S - pos, max(8, rng.pareto(1.2) * 64)))
            pos += ln
            if pos < S:
                toks[b, pos] = cfg.eos_token
                mask[b, pos] = 0.0          # don't predict across docs
                pos += 1
    return toks.astype(np.int32), mask


def data_iterator(cfg: DataConfig, start_step: int = 0
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    step = start_step
    while True:
        yield batch_for_step(cfg, step)
        step += 1
