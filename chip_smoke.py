#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out report.json]

Phases, each of which fails the run (non-zero exit) if anything is off:

1. Kernels. Build the hand-written CUDA kernels from ``src/repro_torch/
   csrc`` (one ``nvcc`` per source, in parallel), then hold each against
   its plain PyTorch version on the card, in bf16 and fp32. The paged
   kernels at the qwen3 serving path's shapes (H=16, K=8, D=128, bs=16;
   decode R=8 over ~4k tokens each; a prefill chunk over a ~3k-token
   prefix) and on edge cases (empty table, partial tails, -1 padding,
   MHA, MQA, the largest head dim and block size). The flash-prefill
   kernel at the recurrentgemma-9b admission shape (S=6000, H=16, K=1,
   D=256, window 2048), at qwen3-0.6b's dense-prefill shape (S=4000,
   H=16, K=8, D=128, causal) and on edge cases (ragged S, S < window,
   B=2 with and without a window, MHA with D=112 and H=3, windows of one
   and of 100 tokens, S of 1 and 13, D 40 and 120, G 16 at D 128 and
   256); the split-KV and
   tensor-core edges of the paged kernels (long and empty tables, splits
   past a short request, bs 8, 24 and 64, G 1, 2 and 16, D 40, 64, 72,
   112, 120 and 256, D % 16 == 8 among them), and a timed decode row at
   the serving phase's batch and table width (R=4, 64 slots). Prints the
   plan (split, grid, rows a block, shared memory) of each kernel at its
   main shapes. Times the kernel, the plain version and
   ``scaled_dot_product_attention`` over the same inputs (a yardstick the
   port never calls) eagerly with CUDA events, as every earlier report
   did (``ms``, ``library_ms``), and also as CUDA-graph replays, without
   the host's per-call work (``graph_ms``, ``library_graph_ms``), next to
   the least time the card could take for the same bytes and FLOPs
   (data-sheet peaks); for flash prefill it also names the CUDA kernels
   that serve the yardstick call (which ``sdpa`` backend). The rank forms
   of the paged kernels (one launch over every rank pool of the global
   pool) at the qwen2-moe-a2.7b global path's shapes (MHA 16 x 128, three
   ranks, a strided layer view of a 24-layer pool; decode R=4 over
   256-slot tables, a 512-query chunk) and edges (one and four ranks,
   empty ranks, G 1 and 2), in bf16 and fp32, also timed as NR
   single-rank launches on the same inputs (``nr_launch_ms``). The chunks
   the memory hierarchy launches: the copy-on-write path's one-query
   chunk (C = 1) over a 3,007-token prefix whose last block holds bs - 1
   rows, single-rank (timed) and in rank form (NR 3, one rank empty), and
   a warm admission's 128-token tail over a 768-token prefix ending at a
   block boundary.
2. Serving, qwen3-0.6b. ``LLMServer`` serves it at full width (28
   layers, bf16, seeded random weights) with three instances on the
   card; the longest prompt stripes its prefix across two creditors at
   admission and moves KV reactively during decode. Every request must
   finish, both paged kernels' launch counters must be > 0 and no step
   may run a plain version. Reports tokens/s, TTFT, TBT, KV moved and
   peak memory, for this first (cold) run and for a warm repeat of the
   same workload. A short traced window of a warm server (one more
   prompt's admission chunk and a few decode steps, ``torch.profiler``)
   then reports the device's busy share of that window and the kernels
   with the most device time. Then the same workload in global-pool mode
   (``global_pool=True``: one pool tensor for the three instances): every
   request must finish, KV must move, the pool tensor must never be
   reallocated, and each engine decode step must launch the decode rank
   kernel once per layer (28) and no single-rank paged kernel.
   The memory hierarchy, overload and fault phases below serve qwen3's
   first 14 of 28 layers (``QWEN3_EXT_LAYERS``: views of its weights).
   Then, once per pool mode, the memory hierarchy: ``prefix_cache=True``
   and a 96-frame host tier, 128 blocks an instance, every request on
   instance 0: a cold request (a 768-token prefix + 128 tokens), three
   warm ones (the prefix, new suffixes), an exact repeat (the COW path),
   two unrelated 600-token prompts whose pressure spills cached frames to
   the host tier, one more shared-prefix request whose hit prefetches
   from the host, and in global mode the 4,000-token spanning prompt
   (its chain adopted on >= 2 instances); 32 new tokens each. Every
   request must finish, the hits cover >= 3 x 768 tokens, a COW copy,
   a spill and a prefetch happen, no pool is reallocated, only the CUDA
   paged kernels run, and once the cache is cleared every allocator is
   free. Reports TTFT (cold, warm p50, COW, host hit), tokens/s, the
   host-tier bytes each way with their device time, peak memory. Then,
   once per pool mode, overload: ``OverloadPolicy(enabled=True)``, three
   instances of two slots filled by six best-effort requests (the
   4,000-token spanning prompt and five of 600 tokens, 64 new tokens),
   then two urgent 300-token arrivals (a priority, a deadline): >= 1
   preemption, as many resumes, every request finishes, the preempt
   tier ends empty and the allocators return to their state before
   admission. Reports pause and resume times and the bytes spilled.
   Then, once per pool mode, faults (two transfer retries a chain). A
   creditor crash: the server serves the 4,000-, 600- and 300-token
   prompts unfailed, then again, and once the longest has 4 tokens
   ``kill_instance`` takes down a creditor hosting its span: the
   request replays once (a re-prefill of ``prompt + output[:-1]``, the
   paged kernels' counters rising during it; in global mode still one
   decode rank launch per layer and engine step), the dead instance
   holds no block, every request finishes, every allocator drains, no
   pool is reallocated. Reports the steps to detection, the replay's
   host time and the delay from detection to the next token, the
   replayed tokens and how many tokens each stream shares with the
   unfailed one. A seeded plan: a ``FaultPlan`` with one event of each
   kind (a stager timeout, a host fetch error, a host frame
   corruption, a move-leg failure, a crash, a silence past the
   heartbeat timeout) with the prefix cache, a host tier and
   preemption on: every request finishes (or FAILs only past its
   replay budget), the server's fault counters show each event, both
   host tiers end empty once the cache is cleared and no allocator
   leaks.
   Then the global pool sharded over processes (the mesh phase): the
   same three prompts on four instances in global-pool mode (qwen3 at
   14 of its 28 layers: the groups' gloo steps are host-bound), served by
   ``LLMServer(..., mesh=, layout=)`` in W = 2 processes on a (2, 1)
   mesh (``pool_axes=("data",)``: two ranks a process) and in W = 4 on
   a (2, 2) mesh (``("data", "model")``: one rank each), spawned on the
   one card and talking over gloo (NCCL refuses two ranks on one GPU),
   the kernels built once here first. In every process: every request
   finishes, the streams equal process 0's, the 4,000-token prompt
   stripes over two creditors, a move leg crosses processes, the decode
   rank kernel launches once per layer and engine step (no single-rank
   paged kernel, no plain version), no slab is reallocated, and the
   slab holds 4 / W ranks. W = 2 also serves float32 prompts of 1,500
   and 600 tokens at 4 layers, whose greedy streams (with a move) must
   equal the single-process global path's here and the dense oracle's
   argmax, and averages seeded gradient tensors of qwen3's parameter
   tree with ``make_grad_sync`` (int8 all-gather), which must equal the
   one-process average bit for bit. Reports TBT, tokens/s, the
   collectives' calls and host time, the bytes broadcast per move leg,
   the wire bytes of the gradient sync and each process's peak memory.
   Each mesh group also serves ``sharded_check.py``'s three layouts
   through the ServeLayout steps (olmo-1b and qwen2-moe-a2.7b tp_head,
   qwen3-0.6b seq_model; full width, 4 layers, float32, B = 2, a
   320-token prefill, 6 decode steps a schedule, 128-token blocks over
   4 shards): every process's slab is 1/shards of the pool (its kv
   heads in tp_head mode) and its streams equal the single-process
   steps' here. Each group then runs the placement job: every process
   draws qwen3-0.6b (bf16, 28 layers) with ``seeded_params`` placed by
   ``validate_divisibility(param_specs(...))`` over (1, 2) at W = 2,
   (1, 4) and (2, 2) at W = 4, and must hold exactly the bytes the spec
   tree gives; a ``serve_prefill_step`` of B = 2 x S = 4,096, then 8
   decode steps of each schedule on the placed weights and on the whole
   tree, interleaved (TBT side by side; 28 decode rank launches a step,
   28 flash launches a prefill); at W = 2 also qwen2-moe-a2.7b placed
   over (1, 2) at full depth (its bytes, a 512-token prefill, 4 decode
   steps a schedule); then float32 at 4 layers, on every mesh, with
   forced FSDP over (2, 2), and on a ("pod", "data", "model") = (2, 1,
   2) mesh with the pool over ("pod", "data"): placed logits within
   1e-5 relative of the whole tree's, the streams equal in every
   process, to the whole tree's and to the single-process steps' here.
   It also reports whether gloo takes bf16 CUDA tensors. Each group
   then runs the state steps on placed weights: recurrentgemma-9b (11
   of 38 layers: three groups and two leftover layers; bf16, B = 2 x S
   = 4,096, past its 2,048-token window) and xlstm-350m (24 layers, B =
   2 x S = 256)
   drawn with
   ``seeded_params`` placed over (1, 2) at W = 2 and (1, 4) at W = 4,
   holding exactly the spec tree's bytes: ``serve_prefill_step_state``
   (the hybrid's first flash launch held to its plain version, one
   flash launch per local-attention layer, on 16 / tp query heads over
   the one kv head) and 8 ``serve_decode_step_state`` steps, every
   process's streams equal; the same steps on the whole tree in this
   process give the bf16 share of equal tokens. Float32 parity past one
   group (recurrentgemma 8 layers: two groups and two leftover layers;
   xlstm 16: two groups) on (1, 2) and on (2, 2) with forced FSDP:
   placed logits and gathered states (``gather_state``) within 1e-5
   relative of the whole tree's without a mesh (run in the group's
   first process, broadcast; 1e-4 for xLSTM's whole model), or within 4
   times the steps' change when every weight is raised by one ulp, where
   that is larger (xLSTM); the whole tree's logits held the same way to
   its full-sequence ``forward`` over the streamed tokens; tokens
   equal. W = 2 also runs the serving
   extensions under its mesh (four global-pool instances, qwen3 at 14
   layers, bf16): the host tier (every cached replica spilled, then a
   host hit and a device hit), overload (a best-effort request in every
   slot, an urgent arrival pauses a victim, which resumes), a creditor
   crash of the 4,000-token request after 4 tokens (replayed), and a
   seeded ``FaultPlan`` (``from_seed``: six events, prefix cache, host
   tier and preemption on): in every process equal streams, request
   states, counters; every request finishes (or fails past its replay
   budget); no slab reallocated; every allocator free; only the rank
   kernels. Reports the host bytes each process holds, pause, resume
   and replay times and collectives per decode step. The same four
   scenarios at float32 and 4 layers must equal the single-process
   cluster's here, counter for counter, with every stream the dense
   oracle's.
   Also with the qwen3 weights, once per pool mode: the serving phase's
   prompts with 128-token blocks (``block_size=128``, 20 blocks a pool:
   the same 2,560 tokens): every request finishes, every paged prefill
   launch reads a 64-token sub-block view of the pool (same addresses),
   the first against its plain version within 1e-4; and, at float32 and
   4 layers, the 4,000-token creditor-spanning prompt greedy-equal to
   the dense oracle. The kernel phase adds the prefill chunk (C = 512)
   and its rank form (NR = 3) at 128-token blocks.
   Then the ServeLayout steps in one process (``serving/sharded_step``;
   NP = 4 shards on the card, 128-token blocks): (a) ``serve_prefill_step``
   of B = 2 prompts (prefill_32k's batch of 32 cut to 2) at S = 32,768
   (every block full) and S = 32,704 (64 free slots in each request's
   last block): 28 flash launches each, no plain call; layer 0's pool
   rows of the two agree on the common tokens; (b) 32 decode steps of
   each schedule (``serve_decode_step``, write-then-attend;
   ``serve_decode_step_opt``, read-only pool) from the 32,704-token
   pool: 28 decode rank launches a step and nothing else, equal first
   tokens; (c) long_500k: R = 1
   over a seeded 60,129,542,144-byte pool (4,096 blocks, 1,024 a shard,
   1,025-slot tables, filled one layer slice at a time), 16 steps of
   each schedule up to a 524,288-token context, TBT against the byte
   bound, peak memory under 80 GB, one layer's launch against its plain
   version; (d) float32 at 4 layers (B = 2, S = 1,500, a partial block,
   12 steps): both schedules greedy-equal to the dense oracle, one
   ``decode_step_dist`` step against ``decode_step``; (e) ``python -m
   repro_torch.launch.serve`` as ``main([...])`` on a smoke config. The
   kernel phase adds the decode rank form at 128-token blocks (R = 1
   over 1,025-slot tables on four shards; R = 2 at (b)'s shape) and
   flash prefill at (a)'s shape (B = 2, S = 32,768, GQA 16/8 x 128,
   causal; its plain version one (batch, head) slice at a time).
3. Serving, recurrentgemma-9b. ``LLMServer`` serves the hybrid model at
   full width (20 of its 38 layers: 14 RG-LRU, 6 local-attention,
   ``HYBRID_SERVE_LAYERS``; bf16, seeded
   random weights) with two non-pooled instances: prompts of 6,000,
   3,000, 1,000 and 400 tokens, two of them longer than the 2,048-token
   window. Every request must finish, the flash-prefill kernel must
   launch exactly once per attention layer per admission, and no plain
   version may run. A traced window of a warm hybrid server (a late
   6,000-token admission and a few decode steps) reports the device's
   busy share and the kernels with the most device time. Each traced
   window also reports the device time of the port's own kernels.
4. Serving, qwen2-moe-a2.7b. ``LLMServer`` serves the MoE model at full
   width (24 layers, 60 routed experts top-4 plus 4 shared; bf16, seeded
   random weights) in global-pool mode with the qwen3 phase's config and
   prompts, under the global phase's checks; then a traced window with a
   late 512-token admission.
5. Serving, xlstm-350m (the ssm family). ``LLMServer`` serves it at
   full width (8 of its 24 layers: 7 mLSTM, 1 sLSTM,
   ``SSM_SERVE_LAYERS``; bf16, seeded random
   weights) with two non-pooled instances of four slots: prompts of
   1,024, 512, 256 and 64 tokens. Every request must finish and no
   kernel of the port may run (xLSTM has none). Reports tokens/s, TTFT,
   TBT, peak memory and the mLSTM state of a slot. A traced window (a
   late 64-token admission and a few decode steps) reports the
   device's busy share; then a ``FaultPlan`` crash of the busiest
   instance: its requests replay on the survivor and every request
   finishes.
6. Parity, float32. qwen3-0.6b: a creditor-spanning request served
   through ``LLMServer``, in both pool modes; qwen2-moe-a2.7b at full
   width and 4 layers in global-pool mode, the prompt striped over both
   creditors; recurrentgemma-9b at full width and 5 layers
   (one (rglru, rglru, attn) group plus two leftover RG-LRU layers): a
   3,000-token prompt, past the window. Each must give the dense
   oracle's (``prefill`` with the plain "xla" core + ``decode_step``)
   greedy stream, and its per-step logits must match the oracle's
   teacher-forced logits within the stated tolerance. qwen3 also, in both
   pool modes, with the prefix cache, a host tier and preemption on: a
   warm partial-prefix hit, a full-prompt COW hit, a hit prefetched from
   the host tier, and a creditor-spanning request paused after 4 tokens
   and resumed with its recorded layout, each held to the oracle the
   same way; and, in both pool modes, each on a fresh server, token
   replay of a creditor-spanning request after a creditor crash
   (``kill_instance``), after an owner crash (a ``FaultPlan`` event), and
   after its pause when a ``host_corrupt`` event spoils its first
   preempt-tier frame (the resume falls back to replay): every logit,
   the re-prefill's too, is held to the oracle's logit for the output
   index it predicts. xlstm-350m at full width: a 1,024-token prompt
   through ``LLMServer`` against the port's own ``prefill`` +
   ``decode_step``.
7. Training (no kernel of the port may run: training uses the plain
   attention core, as JAX does). qwen3-0.6b at full width and depth
   (28 layers, bf16, remat) through the port's trainer
   (``launch.train.run``) at S = 4,096 and B = 4 for 6 steps, and
   qwen2-moe-a2.7b at full width and 4 of 24 layers with
   ``ep_groups=4`` at S = 2,048 and B = 4 for 5 steps: every loss and
   gradient norm finite; reports the median step time (the first two
   steps and the traced last one excluded), tokens/s, MFU, the least
   time the card could take, the peak memory, and the traced step's
   device busy share, its device time of forward, backward and
   optimizer, and its top kernels. Then one float32 train step a family
   (qwen3 2 layers, qwen2-moe 1 layer with ``ep_groups=2``,
   recurrentgemma one 3-layer group: B = 2 x S = 256; xLSTM one 8-layer
   group: B = 1 x S = 128), on the card and on the CPU from the same
   weights (the CPU step's top operators reported): loss and
   gradient norm within 1e-5 relative, each gradient within 1e-4 of its
   largest, or within 4 times the model's own change when every weight
   is raised by one ulp, where that is larger (xLSTM). Then a restart:
   qwen3 at 2 layers, bf16, 6 steps with a checkpoint after step 2,
   restored into a fresh state bit for bit; its 3 continued steps must
   give the uninterrupted run's losses and gradient norms within 1e-3
   relative.

After each model's phases its servers and weights are dropped and the
card must hold (almost) nothing: a dropped server frees its memory at
once, with no garbage collection.

Prints the card's name and power limit, then per-phase lines, then one
JSON line with every kernel's numbers, then the card's name and power
limit again exactly as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without
CUDA, and when run outside the repository (it needs ``src/repro_torch``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,     # dense tensor-core bf16
              torch.float32: 67e12}       # float32 outside tensor cores
# Kernel vs plain twin (float32 math on the same inputs), on the finalized
# output, m and l. Decode and float32 prefill compute in float32 and differ
# only in summation order (and, split-KV, in merge order). The bf16
# prefill kernel runs on tensor cores under a stated contract: q K^T
# products of bf16 values are exact in float32, each probability enters
# P V as bf16 hi + lo (one bf16 rounding would miss 1e-4), and l is summed
# from the float32 probabilities; so the same 1e-4 holds.
TOL = 1e-4
# A bf16 flash-prefill output is rounded from float32 on both sides, so
# the two may differ by one bf16 ulp (2**-7 of the value) beyond TOL.
FLASH_RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 0.0}
PARITY_RTOL = 1e-3  # served vs oracle logits, float32, |diff| / max|logit|
WARM_REPEATS = 0    # untraced repeats of the serving workload (the
#                     pool-mode A/B, scripts/pool_mode_ab.py, repeats it;
#                     0 since the memory-hierarchy and overload phases)
TRACE_STEPS = 6     # server steps in the traced window
# Names of the port's CUDA kernels (csrc/), as a traced window lists them.
PORT_KERNEL_SYMBOLS = ("paged_decode_kernel", "paged_prefill",
                       "flash_prefill")
TRAIN_UNTIMED = 2   # first train steps not timed (allocator warm-up)
# float32 train step, card against CPU: loss and gradient norm (relative),
# each leaf's gradient (max |diff| over its largest magnitude).
TRAIN_STEP_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# ... or, for a worse-conditioned model, this many times the model's own
# change under a one-ulp raise of every weight (the CPU and the card
# round differently at every operation; xlstm-350m's float32 gradients
# move by about 4.5e-4 of a leaf's largest under one ulp, as this phase
# reads it on an H100).
TRAIN_ULPS = 4
# bf16 continuation after a restore on the card, each step's loss and
# gradient norm (relative): the gather backward's adds are unordered.
RESTART_RTOL = 1e-3
# Training phases: qwen3-0.6b at full width and depth at train_4k's
# sequence length; qwen2-moe-a2.7b at full width, 4 of 24 layers (full
# depth needs about 14.3e9 x 12 B of weights, gradients and moments).
TRAIN_DENSE = {"steps": 6, "seq": 4096, "batch": 4}
TRAIN_MOE = {"steps": 5, "seq": 2048, "batch": 4, "layers": 4,
             "ep_groups": 4}
# float32 card-vs-CPU steps: (arch, layers, TrainConfig fields, batch
# x seq); the hybrid model's 3 layers are one (rglru, rglru, attn)
# group, xLSTM's 8 one group of 7 mLSTM + 1 sLSTM; qwen2-moe one MoE
# layer. Two sequences of 256 tokens, where the CPU reference's time
# does not follow the tokens (AdamW's elementwise ops over the
# parameters lead it); one of 128 for xLSTM, whose CPU step is its
# sequential scan, a few operators a token (``train_parity_phase``
# reports the CPU operators that take the time).
TRAIN_PARITY = (("qwen3-0.6b", 2, {}, (2, 256)),
                ("qwen2-moe-a2.7b", 1, {"moe_ep_groups": 2}, (2, 256)),
                ("recurrentgemma-9b", 3, {}, (2, 256)),
                ("xlstm-350m", 8, {}, (1, 128)))


def tree_leaves(tree) -> list:
    """Every tensor of a nested parameter dict."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def release_memory() -> None:
    """Return the cached blocks of freed tensors to the card. A dropped
    server frees its weights and pools at once (its engines, prefix
    cache, host tiers and preemptor hold the cluster weakly: no
    reference cycle), so no garbage collection is needed first."""
    torch.cuda.empty_cache()


def check_released(report, model: str, limit: int = 512 << 20) -> None:
    """After a model's phases and ``del`` of its weights, the card must
    hold (almost) nothing: a reference cycle would keep a server's
    weights and pools alive until a garbage collection (qwen3-0.6b's
    alone are 1.19 GB). What stays is the math libraries' workspaces
    (268,436,992 B after the qwen3 phases on an H100)."""
    release_memory()
    held = torch.cuda.memory_allocated()
    report.setdefault("allocated_after_release", {})[model] = held
    if held > limit:
        raise AssertionError(f"{held} B still allocated after dropping "
                             f"{model}'s servers and weights")


def reset_peak_memory() -> None:
    """Start a peak-memory reading from live tensors only."""
    release_memory()
    torch.cuda.reset_peak_memory_stats()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls,
    measured with CUDA events after ``warmup`` calls. Where one call's
    host work (the Python wrapper, the launch) outlasts its device work,
    this is the host's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn`` call: ``iters`` calls
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events, so the host's per-call work is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def cuda_kernel_names(fn) -> list:
    """The CUDA kernels one ``fn`` call runs, longest first (from
    ``torch.profiler``): which backend serves a library call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    return [e.key[:120] for e in events]


# --------------------------------------------------------------------- #
# Phase 1: kernels
# --------------------------------------------------------------------- #
def make_pool(gen, NB, bs, K, D, dtype, device):
    pk = torch.randn((NB, bs, K, D), generator=gen, device=device).to(dtype)
    pv = torch.randn((NB, bs, K, D), generator=gen, device=device).to(dtype)
    return pk, pv


def make_tables(rng, R, MB, nblks, NB, bs):
    """-1-padded tables [R, MB] over disjoint random blocks, random tails."""
    perm = rng.permutation(NB)
    table = -np.ones((R, MB), np.int32)
    tail = np.full(R, bs, np.int32)
    used = 0
    for r, n in enumerate(nblks):
        table[r, :n] = perm[used:used + n]
        used += n
        if n:
            tail[r] = rng.integers(1, bs + 1)
    return table, tail


def valid_tokens(table, tail, bs) -> int:
    n = (table >= 0).sum(axis=1)
    return int(np.where(n > 0, (n - 1) * bs + tail, 0).sum())


def compare(got, want, tol):
    """max |finalize(o, l)| error, max |m| error and max relative l
    error between two partials; raises if any exceeds ``tol`` or if the
    kernel produced a NaN."""
    from repro_torch.core.online_softmax import finalize
    (go, gm, gl), (wo, wm, wl) = got, want
    for t in got:
        if torch.isnan(t).any():
            raise AssertionError("kernel produced NaN")
    if not torch.equal(torch.isneginf(gm), torch.isneginf(wm)):
        raise AssertionError("empty-row pattern of m differs")
    fin = (finalize(go, gl) - finalize(wo, wl)).abs().max().item()
    finite = ~torch.isneginf(wm)
    m_err = ((gm - wm)[finite].abs().max().item() if finite.any()
             else 0.0)
    l_err = ((gl - wl).abs() / wl.abs().clamp_min(1e-30)).max().item()
    if max(fin, m_err, l_err) > tol:
        raise AssertionError(f"kernel disagrees: out {fin:.3g} m {m_err:.3g}"
                             f" l(rel) {l_err:.3g} > tol {tol}")
    return fin


def decode_case(name, R, H, K, D, bs, ctx_blocks, dtype, device, *,
                empty_rows=0, pad=3, nblks=None, timed=False):
    """The decode wrapper the model calls (``ops``, default scale) on
    CUDA tensors against the kernel's plain version. Request r holds
    ``ctx_blocks`` blocks (0 for the first ``empty_rows``), or
    ``nblks[r]`` where given; tables are ``max(blocks) + pad`` wide."""
    from repro_torch.core.distattn import gather_local_kv
    from repro_torch.kernels.micro_attn_decode import (
        paged_micro_attention_plain)
    from repro_torch.kernels.ops import paged_micro_attention
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    gen = torch.Generator(device=device).manual_seed(1)
    if nblks is None:
        nblks = [0 if r < empty_rows else ctx_blocks for r in range(R)]
    NB = sum(nblks) + 4
    pk, pv = make_pool(gen, NB, bs, K, D, dtype, device)
    table, tail = make_tables(rng, R, max(nblks) + pad, nblks, NB, bs)
    q = torch.randn((R, H, D), generator=gen, device=device).to(dtype)
    tb = torch.from_numpy(table).to(device)
    tl = torch.from_numpy(tail).to(device)
    scale = D ** -0.5
    got = paged_micro_attention(q, pk, pv, tb, tl)
    torch.cuda.synchronize()
    want = paged_micro_attention_plain(q, pk, pv, tb, tl, scale=scale)
    err = compare(got, want, TOL)
    row = {"case": name, "dtype": str(dtype), "R": R, "H": H, "K": K,
           "D": D, "bs": bs, "tokens": valid_tokens(table, tail, bs),
           "max_abs_err": err, "tol": TOL}
    if timed:
        itemsize = pk.element_size()
        S = row["tokens"]
        nbytes = (2 * S * K * D * itemsize + q.numel() * itemsize
                  + table.nbytes + tail.nbytes + (R * H * D + 2 * R * H) * 4)
        flops = 4 * S * H * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        row["ms"] = time_ms(lambda: paged_micro_attention(q, pk, pv, tb,
                                                          tl))
        row["graph_ms"] = device_ms(lambda: paged_micro_attention(
            q, pk, pv, tb, tl))
        row["plain_ms"] = time_ms(lambda: paged_micro_attention_plain(
            q, pk, pv, tb, tl, scale=scale), iters=5)
        k, v = gather_local_kv(pk, pv, tb)            # [R, S_pad, K, D]
        kk = k.transpose(1, 2).contiguous()
        vv = v.transpose(1, 2).contiguous()
        qq = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qq, kk, vv,
                                                 enable_gqa=True))
        row["library_graph_ms"] = device_ms(lambda: sdpa(qq, kk, vv,
                                                         enable_gqa=True))
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def prefill_case(name, C, H, K, D, bs, ctx_blocks, dtype, device, *,
                 pad=3, tail=None, timed=False):
    """The prefill-chunk wrapper the model calls (``ops``, default
    scale) on CUDA tensors against the kernel's plain version; ``tail``
    fixes the rows of the prefix's last block (else random)."""
    from repro_torch.core.distattn import gather_local_kv
    from repro_torch.kernels.micro_attn_prefill import (
        paged_prefill_attention_plain)
    from repro_torch.kernels.ops import paged_prefill_attention
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    gen = torch.Generator(device=device).manual_seed(2)
    NB = ctx_blocks + 4
    pk, pv = make_pool(gen, NB, bs, K, D, dtype, device)
    table, tails = make_tables(rng, 1, ctx_blocks + pad, [ctx_blocks], NB,
                               bs)
    if tail is not None:
        tails[0] = tail
    tail = tails
    q = torch.randn((C, H, D), generator=gen, device=device).to(dtype)
    tb = torch.from_numpy(table[0]).to(device)
    tl = torch.tensor(int(tail[0]), dtype=torch.int32, device=device)
    scale = D ** -0.5
    got = paged_prefill_attention(q, pk, pv, tb, tl)
    torch.cuda.synchronize()
    want = paged_prefill_attention_plain(q, pk, pv, tb, tl, scale=scale)
    err = compare(got, want, TOL)
    row = {"case": name, "dtype": str(dtype), "C": C, "H": H, "K": K,
           "D": D, "bs": bs, "tokens": valid_tokens(table, tail, bs),
           "max_abs_err": err, "tol": TOL}
    if timed:
        itemsize = pk.element_size()
        S = row["tokens"]
        nbytes = (2 * S * K * D * itemsize + q.numel() * itemsize
                  + table.nbytes + 4 + (C * H * D + 2 * C * H) * 4)
        flops = 4 * C * S * H * D
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        row["ms"] = time_ms(lambda: paged_prefill_attention(q, pk, pv, tb,
                                                            tl))
        row["graph_ms"] = device_ms(lambda: paged_prefill_attention(
            q, pk, pv, tb, tl))
        row["plain_ms"] = time_ms(lambda: paged_prefill_attention_plain(
            q, pk, pv, tb, tl, scale=scale), iters=5)
        k, v = gather_local_kv(pk, pv, tb[None])
        kk = k.transpose(1, 2).contiguous()            # [1, K, S_pad, D]
        vv = v.transpose(1, 2).contiguous()
        qq = q.transpose(0, 1)[None].contiguous()      # [1, H, C, D]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qq, kk, vv,
                                                 enable_gqa=True))
        row["library_graph_ms"] = device_ms(lambda: sdpa(qq, kk, vv,
                                                         enable_gqa=True))
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def live_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) prompt attention computes:
    query position qp sees min(qp + 1, window) keys."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_case(name, B, S, H, K, D, window, dtype, device, *, timed=False):
    """The flash-prefill wrapper the model calls (``ops``, default
    scale) on CUDA tensors against the kernel's plain version."""
    from repro_torch.kernels.flash_prefill import (flash_plan,
                                                  flash_prefill_plain)
    from repro_torch.kernels.ops import flash_prefill
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(
        name.encode()))
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    scale = D ** -0.5
    got = flash_prefill(q, k, v, window=window)
    torch.cuda.synchronize()
    want = flash_prefill_plain(q, k, v, scale=scale, window=window)
    if torch.isnan(got).any():
        raise AssertionError(f"{name}: kernel produced NaN")
    diff = (got.float() - want.float()).abs()
    bad = diff > TOL + FLASH_RTOL[dtype] * want.float().abs()
    if bad.any():
        raise AssertionError(f"{name}: kernel disagrees at {int(bad.sum())}"
                             f" elements (max |diff| {diff.max().item():.3g})")
    tol = f"{TOL} + {FLASH_RTOL[dtype]:.3g}*|plain|"
    row = {"case": name, "dtype": str(dtype), "B": B, "S": S, "H": H,
           "K": K, "D": D, "window": window,
           "max_abs_err": diff.max().item(), "tol": tol}
    del want, diff, bad
    if timed:
        itemsize = q.element_size()
        pairs = B * live_pairs(S, window)
        flops = 4 * H * D * pairs
        nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * itemsize
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        row["live_pairs"] = pairs
        row["plan"] = flash_plan(B, S, H, K, D, dtype)
        row["ms"] = time_ms(lambda: flash_prefill(q, k, v, window=window),
                            iters=10)
        row["graph_ms"] = device_ms(lambda: flash_prefill(q, k, v,
                                                          window=window),
                                    iters=10)
        row["plain_ms"] = time_ms(lambda: flash_prefill_plain(
            q, k, v, scale=scale, window=window), iters=3, warmup=1)
        qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window and window < S:
            pos = torch.arange(S, device=device)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)

            def library():
                return sdpa(qq, kk, vv, attn_mask=mask, enable_gqa=True)
        else:
            def library():
                return sdpa(qq, kk, vv, is_causal=True, enable_gqa=True)
        row["library_ms"] = time_ms(library, iters=10)
        row["library_graph_ms"] = device_ms(library, iters=10)
        row["library_kernels"] = cuda_kernel_names(library)
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def rank_case(name, kind, NR, H, K, D, dtype, device, *, rows, nblks, MB,
              L=2, bs=16, NB=160, tail_rows=None, timed=False):
    """A rank form the global pool's steps call (``ops``, default scale)
    on one layer's view of a global pool [NR, L, NB, bs, K, D] — strided,
    read in place — against its plain version. ``kind`` "decode": q
    [rows, H, D], request r holding ``nblks[rank][r]`` blocks on each
    rank; "prefill": a chunk of ``rows`` queries over one prefix holding
    ``nblks[rank]`` blocks on each rank. Timed rows add the time of NR
    single-rank launches on the same inputs (``nr_launch_ms``).
    ``tail_rows`` fixes the rows of each non-empty rank's last block
    (else random)."""
    from repro_torch.core.distattn import gather_local_kv
    from repro_torch.kernels import ops
    from repro_torch.kernels.micro_attn_decode import (
        paged_micro_attention_ranks_plain)
    from repro_torch.kernels.micro_attn_prefill import (
        paged_prefill_attention_ranks_plain)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    gen = torch.Generator(device=device).manual_seed(3)
    gk, gv = (torch.randn((NR, L, NB, bs, K, D), generator=gen,
                          device=device).to(dtype) for _ in range(2))
    pk, pv = gk[:, L // 2], gv[:, L // 2]
    decode = kind == "decode"
    R = rows if decode else 1
    tabs = [make_tables(rng, R, MB, nb if decode else [nb], NB, bs)
            for nb in nblks]
    table = np.stack([t for t, _ in tabs])
    tail = np.stack([t for _, t in tabs])
    if tail_rows is not None:
        tail[table[..., 0] >= 0] = tail_rows
    if not decode:
        table, tail = table[:, 0], tail[:, 0]
    q = torch.randn((rows, H, D), generator=gen, device=device).to(dtype)
    tb = torch.from_numpy(table).to(device)
    tl = torch.from_numpy(tail).to(device)
    scale = D ** -0.5
    wrapper, one = ((ops.paged_micro_attention_ranks,
                     ops.paged_micro_attention) if decode else
                    (ops.paged_prefill_attention_ranks,
                     ops.paged_prefill_attention))
    plain = (paged_micro_attention_ranks_plain if decode
             else paged_prefill_attention_ranks_plain)
    got = wrapper(q, pk, pv, tb, tl)
    torch.cuda.synchronize()
    want = plain(q, pk, pv, tb, tl, scale=scale)
    err = compare(got, want, TOL)
    S = sum(valid_tokens(t if decode else t[None], tt if decode else tt[None],
                         bs) for t, tt in zip(table, tail))
    row = {"case": name, "dtype": str(dtype), "NR": NR,
           ("R" if decode else "C"): rows, "H": H, "K": K, "D": D, "bs": bs,
           "MB": MB, "rank_stride": pk.stride(0), "tokens": S,
           "max_abs_err": err, "tol": TOL}
    if timed:
        itemsize = pk.element_size()
        nbytes = (2 * S * K * D * itemsize + q.numel() * itemsize
                  + table.nbytes + tail.nbytes
                  + NR * rows * H * (D + 2) * 4)
        flops = 4 * S * H * D * (1 if decode else rows)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3

        def per_rank():
            for i in range(NR):
                one(q, pk[i], pv[i], tb[i], tl[i])
        row["ms"] = time_ms(lambda: wrapper(q, pk, pv, tb, tl))
        row["graph_ms"] = device_ms(lambda: wrapper(q, pk, pv, tb, tl))
        row["nr_launch_ms"] = time_ms(per_rank)
        row["nr_launch_graph_ms"] = device_ms(per_rank)
        row["plain_ms"] = time_ms(lambda: plain(q, pk, pv, tb, tl,
                                                scale=scale), iters=5)
        # Yardstick: one sdpa call over every rank's gathered (padded)
        # rows, the ranks as batch rows.
        kk, vv = (torch.cat(t) for t in zip(*(
            gather_local_kv(pk[i], pv[i], tb[i] if decode else tb[i][None])
            for i in range(NR))))
        kk = kk.transpose(1, 2).contiguous()        # [NR*R, K, S_pad, D]
        vv = vv.transpose(1, 2).contiguous()
        qq = (q[:, :, None, :].repeat(NR, 1, 1, 1) if decode else
              q.transpose(0, 1)[None].repeat(NR, 1, 1, 1).contiguous())
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qq, kk, vv,
                                                 enable_gqa=True))
        row["library_graph_ms"] = device_ms(lambda: sdpa(qq, kk, vv,
                                                         enable_gqa=True))
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def kernel_plans(chunk: int):
    """The launch each kernel plans at its main shapes on this card (from
    shapes and the SM count alone)."""
    from repro_torch.kernels.flash_prefill import flash_plan
    from repro_torch.kernels.micro_attn_decode import (decode_plan,
                                                       device_sm_count)
    from repro_torch.kernels.micro_attn_prefill import prefill_plan
    sms = device_sm_count(torch.cuda.current_device())
    out = {"sm_count": sms}
    for dt in (torch.bfloat16, torch.float32):
        out[f"decode-main-{dt}"] = decode_plan(8, 16, 8, 259, 16, sms)
        out[f"decode-serving-R4-{dt}"] = decode_plan(4, 16, 8, 64, 16, sms)
        out[f"prefill-main-{dt}"] = prefill_plan(chunk, 16, 8, 128, 191,
                                                 16, dt, sms)
        out[f"flash-main-{dt}"] = flash_plan(1, 6000, 16, 1, 256, dt)
        out[f"flash-qwen3-{dt}"] = flash_plan(1, 4000, 16, 8, 128, dt)
        # The rank forms at the qwen2-moe global path's shapes (MHA 16 x
        # 128, three ranks, 256-slot tables).
        out[f"decode-ranks-main-{dt}"] = decode_plan(4, 16, 16, 256, 16,
                                                     sms, 3)
        out[f"prefill-ranks-main-{dt}"] = prefill_plan(chunk, 16, 16, 128,
                                                       256, 16, dt, sms, 3)
        # The rank forms at the mesh path's shapes (qwen3 heads, a slab of
        # two ranks at W = 2 and of one at W = 4).
        for nr in (2, 1):
            for MB in (128, 256):
                out[f"decode-ranks-mesh-nr{nr}-mb{MB}-{dt}"] = decode_plan(
                    4, 16, 8, MB, 16, sms, nr)
            out[f"prefill-ranks-mesh-nr{nr}-{dt}"] = prefill_plan(
                chunk, 16, 8, 128, 256, 16, dt, sms, nr)
        # The memory hierarchy's chunks: the COW path's one-query chunk
        # over a ~3,000-token prefix (single-rank and rank form) and a
        # warm admission's 128-token tail over a 768-token prefix.
        out[f"prefill-cow-c1-{dt}"] = prefill_plan(1, 16, 8, 128, 191, 16,
                                                   dt, sms)
        out[f"prefill-ranks-cow-c1-{dt}"] = prefill_plan(1, 16, 8, 128,
                                                         256, 16, dt, sms,
                                                         3)
        out[f"prefill-warm-c128-{dt}"] = prefill_plan(128, 16, 8, 128, 51,
                                                      16, dt, sms)
    return out


def kernel_phase(device, chunk: int):
    """Every kernel against its plain version; returns (rows, main rows)."""
    rows = []
    main = {}
    for dt in (torch.bfloat16, torch.float32):
        # Serving path shapes: qwen3-0.6b heads, 16-token blocks.
        r = decode_case(f"decode-main-{dt}", 8, 16, 8, 128, 16, 256, dt,
                        device, timed=True)
        rows.append(r)
        main.setdefault("decode", r)
        r = prefill_case(f"prefill-main-{dt}", chunk, 16, 8, 128, 16, 188,
                         dt, device, timed=True)
        rows.append(r)
        main.setdefault("prefill", r)
        # Edge cases.
        rows.append(decode_case(f"decode-empty-rows-{dt}", 4, 16, 8, 128,
                                16, 5, dt, device, empty_rows=2))
        rows.append(decode_case(f"decode-all-empty-{dt}", 3, 16, 8, 128, 16,
                                0, dt, device, empty_rows=3))
        rows.append(decode_case(f"decode-mha-{dt}", 3, 16, 16, 128, 16, 9,
                                dt, device))
        rows.append(decode_case(f"decode-mqa-{dt}", 3, 16, 1, 128, 16, 9,
                                dt, device))
        rows.append(decode_case(f"decode-d256-bs64-{dt}", 2, 8, 2, 256, 64,
                                5, dt, device))
        rows.append(decode_case(f"decode-d112-bs8-{dt}", 3, 4, 1, 112, 8,
                                7, dt, device))
        rows.append(decode_case(f"decode-d120-{dt}", 2, 4, 2, 120, 16, 0,
                                dt, device, nblks=[250, 40]))
        rows.append(decode_case(f"decode-d72-{dt}", 1, 8, 4, 72, 16, 200,
                                dt, device))
        rows.append(decode_case(f"decode-d40-bs8-{dt}", 1, 4, 1, 40, 8, 500,
                                dt, device))
        rows.append(prefill_case(f"prefill-empty-{dt}", 37, 16, 8, 128, 16,
                                 0, dt, device))
        rows.append(prefill_case(f"prefill-mha-{dt}", 40, 16, 16, 128, 16,
                                 9, dt, device))
        rows.append(prefill_case(f"prefill-mqa-{dt}", 13, 16, 1, 128, 16, 9,
                                 dt, device))
        rows.append(prefill_case(f"prefill-d256-bs64-{dt}", 33, 8, 2, 256,
                                 64, 5, dt, device))
        # Split-KV decode at the serving phase's batch and table width
        # (R=4, max_local_len 1024 = 64 slots), timed, and the split edges: one long request, an empty table and one shorter
        # than a split, full tables (the tail in the last split), bs 8
        # with G 1, bs 64 with G 16, G 16 at D 256.
        rows.append(decode_case(f"decode-serving-R4-{dt}", 4, 16, 8, 128,
                                16, 61, dt, device, timed=True))
        rows.append(decode_case(f"decode-R1-long-{dt}", 1, 16, 8, 128, 16,
                                250, dt, device))
        rows.append(decode_case(f"decode-split-empty-short-{dt}", 3, 16, 8,
                                128, 16, 0, dt, device, nblks=[0, 3, 250]))
        rows.append(decode_case(f"decode-tail-last-split-{dt}", 2, 8, 4,
                                128, 16, 128, dt, device, pad=0))
        rows.append(decode_case(f"decode-bs8-g1-{dt}", 2, 8, 8, 128, 8, 0,
                                dt, device, nblks=[500, 37]))
        rows.append(decode_case(f"decode-bs64-g16-{dt}", 2, 16, 1, 128, 64,
                                0, dt, device, nblks=[64, 10], pad=0))
        rows.append(decode_case(f"decode-g16-d256-{dt}", 2, 32, 2, 256, 16,
                                0, dt, device, nblks=[200, 0]))
        # Prefill chunk edges: C*G = 74 rows over a long prefix, D 112 in
        # the 128-wide build, D % 16 == 8 (120, 72, and 40 in the 64-wide
        # build: the reduction zero-padded to 16), bs 24 (does not divide
        # the 64-token tile), D 256 over a long prefix.
        rows.append(prefill_case(f"prefill-c37-long-{dt}", 37, 16, 8, 128,
                                 16, 187, dt, device))
        rows.append(prefill_case(f"prefill-d112-bs8-{dt}", 50, 4, 2, 112, 8,
                                 130, dt, device))
        rows.append(prefill_case(f"prefill-bs24-d64-{dt}", 40, 12, 4, 64,
                                 24, 70, dt, device))
        rows.append(prefill_case(f"prefill-d120-bs8-{dt}", 50, 4, 2, 120, 8,
                                 130, dt, device))
        rows.append(prefill_case(f"prefill-d72-{dt}", 45, 12, 4, 72, 16, 60,
                                 dt, device))
        rows.append(prefill_case(f"prefill-d40-bs24-{dt}", 40, 8, 2, 40, 24,
                                 70, dt, device))
        rows.append(prefill_case(f"prefill-d256-long-{dt}", 33, 8, 2, 256,
                                 64, 20, dt, device))
        # The memory hierarchy's chunks (qwen3 heads): the COW path
        # re-runs a full-prompt hit's last token as a one-query chunk over
        # a prefix whose last block holds bs - 1 rows (3,007 tokens),
        # single-rank (timed) and in rank form with an empty rank; a warm
        # admission streams its 128-token tail over a 768-token cached
        # prefix ending at a block boundary.
        rows.append(prefill_case(f"prefill-cow-c1-{dt}", 1, 16, 8, 128, 16,
                                 188, dt, device, tail=15, timed=True))
        rows.append(rank_case(f"prefill-ranks-cow-c1-{dt}", "prefill", 3,
                              16, 8, 128, dt, device, rows=1, MB=256,
                              nblks=[120, 0, 68], tail_rows=15))
        rows.append(prefill_case(f"prefill-warm-c128-{dt}", 128, 16, 8, 128,
                                 16, 48, dt, device, tail=16))
        # Flash prefill: (a) the recurrentgemma-9b admission of the
        # hybrid serving phase, (b) qwen3-0.6b's dense-prefill shape.
        r = flash_case(f"flash-main-{dt}", 1, 6000, 16, 1, 256, 2048, dt,
                       device, timed=True)
        rows.append(r)
        main.setdefault("flash", r)
        rows.append(flash_case(f"flash-qwen3-{dt}", 1, 4000, 16, 8, 128, 0,
                               dt, device, timed=True))
        # Edge cases; then prompts shorter than one m16 tile, D % 16 == 8
        # (the reduction zero-padded to 16), G 16 at both wide builds, a
        # window that is not a multiple of the 64-token tile, and B 2 with
        # a window.
        # Rank forms at the qwen2-moe global path's shapes: MHA 16 x 128,
        # three ranks, a layer's view of a 24-layer global pool; decode
        # R=4 (a request striped over all three ranks, a local one, two
        # empty slots), a 512-query chunk over a prefix striped 32 / 160 /
        # 27 blocks. Edges: one and four ranks, empty ranks, G 2.
        r = rank_case(f"decode-ranks-main-{dt}", "decode", 3, 16, 16, 128,
                      dt, device, rows=4, MB=256, L=24, timed=True,
                      nblks=[[63, 38, 0, 0], [160, 0, 0, 0],
                             [27, 0, 0, 0]])
        rows.append(r)
        main.setdefault("decode_ranks", r)
        r = rank_case(f"prefill-ranks-main-{dt}", "prefill", 3, 16, 16,
                      128, dt, device, rows=chunk, MB=256, L=24,
                      timed=True, nblks=[32, 160, 27])
        rows.append(r)
        main.setdefault("prefill_ranks", r)
        # The mesh path's own shapes: each process launches the rank
        # forms over its slab of qwen3's 28-layer global pool (160 blocks
        # a rank), two ranks at W = 2 and one at W = 4: decode R=4 over
        # the served tables (a request striped over both local ranks,
        # local ones, an empty slot; a process holding none of a batch's
        # blocks), a 512-query chunk over a striped prefix.
        for nr, nb in ((2, [[64, 20, 38, 0], [150, 0, 0, 0]]),
                       (1, [[90, 0, 12, 0]]), (1, [[0, 0, 0, 0]])):
            empty = "-empty" if not any(map(any, nb)) else ""
            for MB in (128, 256):
                rows.append(rank_case(
                    f"decode-ranks-mesh-nr{nr}{empty}-mb{MB}-{dt}", "decode",
                    nr, 16, 8, 128, dt, device, rows=4, MB=MB, L=28,
                    nblks=[[min(b, MB) for b in r] for r in nb]))
        for nr, nb in ((2, [64, 160]), (1, [96]), (1, [0])):
            rows.append(rank_case(
                f"prefill-ranks-mesh-nr{nr}-{nb[-1]}-{dt}", "prefill", nr, 16,
                8, 128, dt, device, rows=chunk, MB=256, L=28, nblks=nb))
        # The ServeLayout path's block size, 128 tokens, at its two decode
        # shapes (qwen3 GQA 16/8 x 128, NP = 4 shards): long_500k, R = 1
        # over every shard's 1,024 blocks through 1,025-slot tables; and
        # the 32k batch, R = 2, each request's 128 blocks on two shards.
        r = rank_case(f"decode-ranks-bs128-long500k-{dt}", "decode", 4, 16,
                      8, 128, dt, device, rows=1, MB=1025, L=1, bs=128,
                      NB=1024, nblks=[[1024]] * 4, timed=True)
        rows.append(r)
        main.setdefault("decode_ranks_long500k", r)
        r = rank_case(f"decode-ranks-bs128-R2-{dt}", "decode", 4, 16, 8, 128,
                      dt, device, rows=2, MB=130, L=1, bs=128, NB=128,
                      nblks=[[128, 0], [128, 0], [0, 128], [0, 128]],
                      timed=True)
        rows.append(r)
        main.setdefault("decode_ranks_R2", r)
        # 128-token blocks in the paged prefill (read as 64-token
        # sub-blocks of the same pool): the chunk at the serving shape
        # (C = 512, qwen3 GQA 16/8 x 128) over 24 blocks (3,072 tokens),
        # and the rank form at NR = 3 over a prefix striped 4 / 20 / 0
        # blocks, each with a partial last block.
        r = prefill_case(f"prefill-bs128-{dt}", chunk, 16, 8, 128, 128, 24,
                         dt, device, tail=65, timed=True)
        rows.append(r)
        main.setdefault("prefill_bs128", r)
        r = rank_case(f"prefill-ranks-bs128-nr3-{dt}", "prefill", 3, 16, 8,
                      128, dt, device, rows=chunk, MB=32, L=2, bs=128,
                      NB=24, nblks=[4, 20, 0], tail_rows=65, timed=True)
        rows.append(r)
        main.setdefault("prefill_ranks_bs128", r)
        # The ServeLayout mesh job's shapes (SL_MESH: B = 2, a 320-token
        # prefill in 128-token blocks over 4 shards, 2 blocks a shard,
        # 4-slot tables, 4 layers): one process holds all 4 shards, a
        # slab of 2 (W = 2; W = 4 tp_head) or of 1 (W = 4 seq_model);
        # MHA 16/16 (olmo-1b, qwen2-moe), its 8/8 half over a TP axis of
        # 2, GQA 16/8 (qwen3).
        for nr, nb in ((4, [[2, 0], [1, 0], [0, 2], [0, 1]]),
                       (2, [[2, 0], [1, 0]]), (1, [[2, 0]])):
            for H, K in ((16, 16), (8, 8), (16, 8)):
                rows.append(rank_case(
                    f"decode-ranks-mesh-bs128-nr{nr}-h{H}k{K}-{dt}",
                    "decode", nr, H, K, 128, dt, device, rows=2, MB=4, L=4,
                    bs=128, NB=2, nblks=nb))
        for nr, K, G, nb in ((1, 16, 1, [[40, 3]]),
                             (4, 8, 2, [[0, 0], [100, 2], [0, 0], [7, 60]]),
                             (3, 8, 2, [[0, 0], [0, 0], [0, 0]])):
            rows.append(rank_case(f"decode-ranks-nr{nr}-g{G}-{dt}", "decode",
                                  nr, K * G, K, 128, dt, device, rows=2,
                                  MB=128, nblks=nb))
            rows.append(rank_case(f"prefill-ranks-nr{nr}-g{G}-{dt}",
                                  "prefill", nr, K * G, K, 128, dt, device,
                                  rows=77, MB=128,
                                  nblks=[b[-1] for b in nb]))
        for args in (("ragged-S", 1, 1037, 16, 1, 256, 256),
                     ("S-below-window", 1, 500, 16, 1, 256, 2048),
                     ("B2-gqa-causal", 2, 300, 8, 2, 128, 0),
                     ("mha-d112-h3", 1, 200, 3, 3, 112, 64),
                     ("window-1", 1, 130, 4, 1, 64, 1),
                     ("S1", 1, 1, 16, 1, 256, 2048),
                     ("S13", 1, 13, 16, 8, 128, 0),
                     ("d40", 1, 300, 8, 2, 40, 0),
                     ("d120-window", 1, 300, 8, 2, 120, 100),
                     ("g16-d128", 1, 700, 16, 1, 128, 0),
                     ("g16-d256-window", 1, 700, 32, 2, 256, 300),
                     ("window-100-S1037", 1, 1037, 16, 1, 256, 100),
                     ("B2-window", 2, 777, 16, 1, 256, 200)):
            rows.append(flash_case(f"flash-{args[0]}-{dt}", *args[1:], dt,
                                   device))
    # The ServeLayout prefill's causal shape: prefill_32k with B = 2.
    r = flash_long_case("flash-serve-prefill-S32768-bf16", 2, 32768, 16, 8,
                        128, torch.bfloat16, device)
    rows.append(r)
    main["flash_serve_prefill"] = r
    return rows, main


# --------------------------------------------------------------------- #
# Phase 2 and 3: serving
# --------------------------------------------------------------------- #
def serving_config():
    """Three instances on one card, pools small enough that the longest
    prompt stripes across two creditors and moves KV during decode."""
    from repro_torch.serving import ServingConfig
    return ServingConfig.h100(
        n_instances=3, max_batch=4, max_local_len=1024, pool_blocks=160,
        block_size=16, prefill_chunk=512, move_chunk_tokens=256,
        schedule_every=8)


def make_prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def serve(params, cfg, config, prompts, n_new, device):
    """Serve ``prompts`` greedily through LLMServer; returns (handles,
    server, wall seconds)."""
    from repro_torch.serving import LLMServer, SamplingParams
    server = LLMServer(params, cfg, config, device=device)
    handles = [server.submit(p, SamplingParams(max_new_tokens=n_new))
               for p in prompts]
    t0 = time.perf_counter()
    server.drain(max_steps=20_000)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return handles, server, time.perf_counter() - t0


def moves_executed(server) -> int:
    """KV moves (reactive or Algorithm-1 legs) executed during decode."""
    return sum(len(e.stats.tokens_moved_steps)
               for e in server.cluster.engines.values())


class AdmissionSpy:
    """Records, per streaming admission, how many creditors the prompt's
    prefix was striped across."""

    def __enter__(self):
        import repro_torch.serving.engine as engine_mod
        self.cls = engine_mod.InstanceEngine
        self.orig = self.cls._admit_streaming
        self.stripes = []
        spy = self

        def admit(eng, req, tokens, n_over, n_local):
            out = spy.orig(eng, req, tokens, n_over, n_local)
            spy.stripes.append(len(eng.remote_insts.get(req.req_id, ())))
            return out
        self.cls._admit_streaming = admit
        return self

    def __exit__(self, *exc):
        self.cls._admit_streaming = self.orig


def e2e_numbers(server, handles, wall):
    fm = server.frontend_metrics(handles, wall_s=wall)
    return {"tokens": fm["tokens"], "wall_s": wall,
            "throughput_tok_s": fm["throughput_tok_s"],
            "ttft_p50_s": fm["ttft_p50"],
            "ttft_max_s": max(h.metrics["ttft"] for h in handles),
            "tbt_p50_s": fm["tbt_p50"], "tbt_p99_s": fm["tbt_p99"]}


def all_finished(handles):
    from repro_torch.serving import RequestState
    states = [h.status for h in handles]
    if any(s != RequestState.FINISHED for s in states):
        raise AssertionError(f"not every request finished: {states}")


def served(counts, name, device) -> int:
    """Calls of a kernel's wrapper that ran it: launches on the card,
    plain-twin calls on the CPU."""
    c = counts[name]
    return c["launches"] if device.type == "cuda" else c["plain_calls"]


def check_counts(counts, path_kernels, device):
    """Every kernel of the path ran on it (launches on the card, plain
    twins on the CPU); on the card no plain version ran at all."""
    for name in path_kernels:
        if served(counts, name, device) <= 0:
            raise AssertionError(f"{name}: never ran on the serving path")
    for name, c in counts.items():
        if device.type == "cuda" and c["plain_calls"]:
            raise AssertionError(f"{name}: {c['plain_calls']} plain-version "
                                 f"calls on the serving path")


def serving_phase(params, cfg, device, prompt_lens, n_new):
    """The main path, once and counted, then ``WARM_REPEATS`` untraced
    repeats of the same workload for their end-to-end numbers."""
    from repro_torch.kernels import ops
    prompts = make_prompts(cfg, prompt_lens, 7)
    config = serving_config()
    if device.type == "cuda":
        reset_peak_memory()
    with AdmissionSpy() as spy:
        ops.reset_counts()
        handles, server, wall = serve(params, cfg, config, prompts, n_new,
                                      device)
        counts = ops.counts()
    stripes = spy.stripes
    all_finished(handles)
    if max(stripes) < 2:
        raise AssertionError(f"no prompt striped across >= 2 creditors at "
                             f"admission (creditors per admission: "
                             f"{stripes})")
    moves = moves_executed(server)
    if moves < 1:
        raise AssertionError("no KV move happened during decode")
    check_counts(counts, ("paged_micro_attention", "paged_prefill_attention"),
                 device)
    steps = decode_steps(server)
    report = {
        "prompt_lens": list(prompt_lens), "n_new": n_new,
        "creditors_per_admission": stripes, "moves_during_decode": moves,
        "decode_steps": steps, "decode_launches_per_step":
            served(counts, "paged_micro_attention", device) / steps,
        **e2e_numbers(server, handles, wall),
        "kv_moved_bytes": server.cluster.throughput_stats["kv_moved_bytes"],
        "pool_copy_steps": sum(e.stats.pool_copy_steps
                               for e in server.cluster.engines.values()),
        "counts": counts,
    }
    if report["pool_copy_steps"]:
        raise AssertionError("a decode step reallocated a pool tensor")
    if device.type == "cuda":
        report["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    report["warm"] = []
    for _ in range(WARM_REPEATS):
        handles, server, wall = serve(params, cfg, config, prompts, n_new,
                                      device)
        all_finished(handles)
        report["warm"].append(e2e_numbers(server, handles, wall))
    return report


def decode_steps(server) -> int:
    """Engine decode steps of a run (each runs every layer once)."""
    return sum(e.stats.decode_steps for e in server.cluster.engines.values())


def global_serving_phase(params, cfg, device, prompt_lens, n_new):
    """The global-pool main path, once and counted: the serving phase's
    config with ``global_pool=True``. Every request must finish, the
    longest prompt stripe over two creditors, KV move, the pool tensor
    never be reallocated, and every engine decode step launch the decode
    rank kernel once per layer (no single-rank paged launch at all)."""
    from repro_torch.kernels import ops
    prompts = make_prompts(cfg, prompt_lens, 7)
    config = serving_config().replace(global_pool=True)
    t0 = time.perf_counter()
    reset_peak_memory()
    with AdmissionSpy() as spy:
        ops.reset_counts()
        handles, server, wall = serve(params, cfg, config, prompts, n_new,
                                      device)
        counts = ops.counts()
    all_finished(handles)
    if max(spy.stripes) < 2:
        raise AssertionError(f"no prompt striped across >= 2 creditors "
                             f"({spy.stripes})")
    check_counts(counts, ("paged_micro_attention_ranks",
                          "paged_prefill_attention_ranks"), device)
    for name in ("paged_micro_attention", "paged_prefill_attention"):
        if served(counts, name, device):
            raise AssertionError(f"{name} ran on the global path")
    cl = server.cluster
    steps = decode_steps(server)
    per_step = served(counts, "paged_micro_attention_ranks", device) / steps
    if per_step != cfg.num_layers:
        raise AssertionError(f"{per_step} decode launches per engine step, "
                             f"not one per layer ({cfg.num_layers})")
    report = {"prompt_lens": list(prompt_lens), "n_new": n_new,
              "layers": cfg.num_layers, "creditors_per_admission":
                  spy.stripes, "moves_during_decode": moves_executed(server),
              "decode_steps": steps, "decode_launches_per_step": per_step,
              **e2e_numbers(server, handles, wall),
              "kv_moved_bytes": cl.throughput_stats["kv_moved_bytes"],
              "pool_copy_steps": sum(e.stats.pool_copy_steps
                                     for e in cl.engines.values()),
              "pool_bytes": 2 * cl.gpool.k.numel() * cl.gpool.k.element_size(),
              "peak_mem_bytes": torch.cuda.max_memory_allocated(),
              "phase_s": time.perf_counter() - t0, "counts": counts}
    if report["kv_moved_bytes"] <= 0:
        raise AssertionError("no KV moved on the global path")
    if report["pool_copy_steps"]:
        raise AssertionError("a decode step reallocated the global pool")
    return report


# --------------------------------------------------------------------- #
# The launch cells' 128-token blocks on the serving path
# --------------------------------------------------------------------- #
def bs128_config(global_pool: bool):
    """The serving phase's config with 128-token blocks, each pool cut to
    the same token capacity (160 x 16 = 20 x 128 = 2,560 tokens)."""
    return serving_config().replace(block_size=128, pool_blocks=20,
                                    global_pool=global_pool)


class SubBlockSpy:
    """Every prefill-kernel launch's block sizes and pool addresses as the
    wrappers present them (``micro_attn_prefill._checked``), and, for the
    first launch of each form, the kernel's partials against the plain
    version on the same (128-token-block) inputs."""

    def __enter__(self):
        from repro_torch.kernels import micro_attn_prefill as mp_, ops
        self.mods = (mp_, ops)
        self.orig = (mp_._checked, ops.paged_prefill_attention_cuda,
                     ops.paged_prefill_attention_ranks_cuda)
        self.calls, self.errs = [], {}
        checked, one, ranks = self.orig
        spy = self

        def spy_checked(q, pool_k, pool_v, tables, tails, *, ranked):
            out = checked(q, pool_k, pool_v, tables, tails, ranked=ranked)
            spy.calls.append((pool_k.shape[-3], out[1].shape[-3],
                              out[1].data_ptr() == pool_k.data_ptr()
                              and out[2].data_ptr() == pool_v.data_ptr()))
            return out

        def checked_once(name, fn, plain):
            def call(q, pk, pv, table, tail, *, scale):
                got = fn(q, pk, pv, table, tail, scale=scale)
                if name not in spy.errs and bool((table >= 0).any()):
                    spy.errs[name] = compare(got, plain(
                        q, pk, pv, table, tail, scale=scale), TOL)
                return got
            return call
        mp_._checked = spy_checked
        ops.paged_prefill_attention_cuda = checked_once(
            "single", one, mp_.paged_prefill_attention_plain)
        ops.paged_prefill_attention_ranks_cuda = checked_once(
            "ranks", ranks, mp_.paged_prefill_attention_ranks_plain)
        return self

    def __exit__(self, *exc):
        mp_, ops = self.mods
        (mp_._checked, ops.paged_prefill_attention_cuda,
         ops.paged_prefill_attention_ranks_cuda) = self.orig


def bs128_phase(params, cfg, device, prompt_lens, n_new, *, global_pool):
    """qwen3 served with 128-token blocks (``bs128_config``): every
    request finishes, the longest prompt stripes over two creditors, the
    paged prefill kernel launches on 64-token sub-block views of the
    pool (never a copy), its first launch within 1e-4 of the plain
    version, and no plain version runs."""
    from repro_torch.kernels import ops
    prompts = make_prompts(cfg, prompt_lens, 7)
    config = bs128_config(global_pool)
    kernels = (("paged_micro_attention_ranks", "paged_prefill_attention_ranks")
               if global_pool else
               ("paged_micro_attention", "paged_prefill_attention"))
    reset_peak_memory()
    with AdmissionSpy() as spy, SubBlockSpy() as sub:
        ops.reset_counts()
        handles, server, wall = serve(params, cfg, config, prompts, n_new,
                                      device)
        counts = ops.counts()
    all_finished(handles)
    check_counts(counts, kernels, device)
    if max(spy.stripes) < 2:
        raise AssertionError(f"bs 128: no prompt striped over >= 2 "
                             f"creditors ({spy.stripes})")
    if not sub.calls or any(c != (128, 64, True) for c in sub.calls):
        raise AssertionError(f"bs 128: prefill launches not on 64-token "
                             f"sub-block views of the pool: "
                             f"{sorted(set(sub.calls))}")
    if served(counts, kernels[1], device) != len(sub.calls):
        raise AssertionError("bs 128: a prefill launch bypassed the "
                             "sub-block view")
    err = max(sub.errs.values())
    if err > TOL:
        raise AssertionError(f"bs 128: the prefill kernel {err} from plain")
    cl = server.cluster
    copies = sum(e.stats.pool_copy_steps for e in cl.engines.values())
    if copies:
        raise AssertionError("bs 128: a step reallocated a pool")
    return {"global_pool": global_pool, "block_size": 128,
            "pool_blocks": config.pool_blocks,
            "prompt_lens": list(prompt_lens), "n_new": n_new,
            "creditors_per_admission": spy.stripes,
            "moves_during_decode": moves_executed(server),
            "decode_steps": decode_steps(server),
            "prefill_launches": served(counts, kernels[1], device),
            "decode_launches": served(counts, kernels[0], device),
            "sub_block_launches": len(sub.calls),
            "first_launch_max_abs_err": sub.errs,
            **e2e_numbers(server, handles, wall),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "counts": counts}


# --------------------------------------------------------------------- #
# Memory hierarchy and overload survival (qwen3-0.6b)
# --------------------------------------------------------------------- #
PREFIX_LEN, SUFFIX_LEN = 768, 128   # shared prefix (48 blocks), suffixes


def pool_ptrs(cluster) -> list:
    """Storage addresses of every pool tensor of a cluster."""
    if cluster.gpool is not None:
        return [cluster.gpool.k.data_ptr(), cluster.gpool.v.data_ptr()]
    return [p.data_ptr() for e in cluster.engines.values()
            for p in (e.pool_k, e.pool_v)]


def alloc_state(cluster) -> dict:
    """Every allocator's free list, reservations and request chains."""
    return {i: (sorted(e.rmanager.pool.alloc._free),
                e.rmanager.pool.alloc.reserved,
                {r: list(rb.blocks)
                 for r, rb in e.rmanager.pool.requests.items()})
            for i, e in cluster.engines.items()}


def check_all_free(cluster) -> None:
    """Every allocator back to free == num_blocks, reserved == 0."""
    for i, e in cluster.engines.items():
        a = e.rmanager.pool.alloc
        if a.free_count != a.num_blocks or a.reserved:
            raise AssertionError(f"instance {i}: {a.free_count} of "
                                 f"{a.num_blocks} blocks free, "
                                 f"{a.reserved} reserved")


def check_path_kernels(counts, global_pool, device) -> None:
    """The pooled path's prefill-chunk and decode kernels (rank forms in
    global mode) ran, and no plain version did."""
    names = (("paged_micro_attention_ranks", "paged_prefill_attention_ranks")
             if global_pool else
             ("paged_micro_attention", "paged_prefill_attention"))
    check_counts(counts, names, device)


class UploadSpy:
    """Times (CUDA events on the compute stream) and counts every
    ``write_block_rows`` call whose rows come from host memory: the H2D
    upload of a host-tier frame plus its write into the pool."""

    def __enter__(self):
        import repro_torch.serving.engine as engine_mod
        self.cls = engine_mod.InstanceEngine
        self.orig = self.cls.write_block_rows
        self.events, self.bytes = [], 0
        spy = self

        def write(eng, block, k, v):
            if k.device.type != "cpu":
                return spy.orig(eng, block, k, v)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            spy.orig(eng, block, k, v)
            end.record()
            spy.events.append((start, end))
            spy.bytes += int(k.nbytes + v.nbytes)
        self.cls.write_block_rows = write
        return self

    def __exit__(self, *exc):
        self.cls.write_block_rows = self.orig

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class ChainInsertSpy:
    """Records the instances of every chain the prefix cache adopts
    through ``insert_chain_multi`` (creditor-spanning requests)."""

    def __enter__(self):
        from repro_torch.serving.prefixcache import RadixPrefixCache
        self.cls = RadixPrefixCache
        self.orig = self.cls.insert_chain_multi
        self.chains = []
        spy = self

        def insert(cache, placements, tokens):
            spy.chains.append(sorted({i for i, _ in placements}))
            return spy.orig(cache, placements, tokens)
        self.cls.insert_chain_multi = insert
        return self

    def __exit__(self, *exc):
        self.cls.insert_chain_multi = self.orig


def hierarchy_config(global_pool: bool):
    """The serving config with the prefix cache and a 96-frame host tier;
    128 blocks an instance, so the pressure stage has to evict (spill)
    cached frames."""
    return serving_config().replace(prefix_cache=True, host_tier_blocks=96,
                                    pool_blocks=128, global_pool=global_pool)


def hierarchy_phase(params, cfg, device, global_pool: bool, n_new=32):
    """qwen3 with the memory hierarchy, once and counted, every request
    submitted to instance 0 (``Cluster.submit_to``; Algorithm-1 moves may
    still carry some of its blocks, and so cache replicas, elsewhere): a
    cold request (a 768-token shared prefix + a 128-token
    suffix), three warm ones (the prefix, new suffixes), an exact repeat
    (the COW path), pressure (three unrelated 600-token prompts on each
    instance holding the prefix's first block) that makes the least
    recently used cached frames — the warm requests' tails, then the
    prefix's first blocks — spill to the host tier, one more
    shared-prefix request (its hit prefetches those blocks from the
    host; three pressure prompts of 40 blocks each in a pool of 128
    evict more than the warm tails, and the phase checks that the
    prefix's first block left every device), and in global mode the 4,000-token creditor-spanning prompt,
    whose chain is adopted on >= 2 instances."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (LLMServer, Request, RequestHandle,
                                     SamplingParams)
    t_phase = time.perf_counter()
    reset_peak_memory()
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    cold, *warm, last = [prefix + rng.integers(0, cfg.vocab_size,
                                                SUFFIX_LEN).tolist()
                         for _ in range(5)]
    sp = SamplingParams(max_new_tokens=n_new)
    server = LLMServer(params, cfg, hierarchy_config(global_pool),
                       device=device)
    cl = server.cluster
    cache, tier = cl.prefix_cache, cl.host_tier
    ptrs = pool_ptrs(cl)
    walls, handles = {}, {}
    ids = iter(range(1_000_000, 2_000_000))

    def run(stage, prompts, insts=None):
        t0 = time.perf_counter()
        reqs = [Request(prompt=p, sampling=sp, req_id=next(ids))
                for p in prompts]
        for i, r in enumerate(reqs):
            cl.submit_to(r, insts[i] if insts else 0)
        for _ in range(20_000):
            if all(r.done for r in reqs):
                break
            server.step()
        torch.cuda.synchronize()
        walls[stage] = time.perf_counter() - t0
        handles[stage] = [RequestHandle(server, r) for r in reqs]

    with UploadSpy() as up, ChainInsertSpy() as chains:
        ops.reset_counts()
        run("cold", [cold])
        run("warm", warm)
        run("cow", [cold])
        # Algorithm-1 moves may have carried prefix blocks (and so cache
        # replicas) to other instances: the pressure goes to every
        # instance holding the prefix's first block.
        bs = cl.block_size
        holders = sorted(cache.root.children[tuple(prefix[:bs])].replicas)
        cached_before = {i: cache.device_blocks(i) for i in cl.engines}
        run("pressure", make_prompts(cfg, (600,) * (3 * len(holders)), 31),
            insts=[i for i in holders for _ in range(3)])
        spilled_after_pressure = sum(e.stats.host_spill_bytes
                                     for e in cl.engines.values())
        first = cache.root.children.get(tuple(prefix[:bs]))
        if first is None or not first.on_host or first.replicas:
            raise AssertionError("the pressure stage left the shared "
                                 "prefix's first block on a device")
        run("host_hit", [last])
        if global_pool:
            run("spanning", make_prompts(cfg, [4000], 7))
        counts = ops.counts()
    stats = [e.stats for e in cl.engines.values()]
    hit_tokens = sum(s.cache_hit_tokens for s in stats)
    spill = sum(s.host_spill_bytes for s in stats)
    prefetch = sum(s.host_prefetch_bytes for s in stats)
    hs = [h for stage in handles.values() for h in stage]
    all_finished(hs)
    if hit_tokens < 3 * PREFIX_LEN:
        raise AssertionError(f"cache hit tokens {hit_tokens} < "
                             f"{3 * PREFIX_LEN}")
    if cache.stats.cow_copies < 1:
        raise AssertionError("the repeated prompt took no COW copy")
    if not spilled_after_pressure or not prefetch:
        raise AssertionError(f"host tier unused: spilled "
                             f"{spilled_after_pressure} B under pressure, "
                             f"prefetched {prefetch} B (tier "
                             f"{tier.stats}, cache {cache.stats})")
    if global_pool and not any(len(c) >= 2 for c in chains.chains):
        raise AssertionError(f"no spanning chain adopted on >= 2 instances "
                             f"({chains.chains})")
    if pool_ptrs(cl) != ptrs or sum(s.pool_copy_steps for s in stats):
        raise AssertionError("a pool tensor was reallocated")
    check_path_kernels(counts, global_pool, device)
    report = {
        "global_pool": global_pool, "n_new": n_new,
        "prefix_len": PREFIX_LEN, "suffix_len": SUFFIX_LEN,
        "pool_blocks": cl.config.pool_blocks,
        "host_tier_blocks": cl.config.host_tier_blocks,
        "ttft_cold_s": handles["cold"][0].metrics["ttft"],
        "ttft_warm_p50_s": float(np.median([h.metrics["ttft"]
                                            for h in handles["warm"]])),
        "ttft_cow_s": handles["cow"][0].metrics["ttft"],
        "ttft_host_hit_s": handles["host_hit"][0].metrics["ttft"],
        "tokens": sum(len(h._req.output) for h in hs),
        "stage_wall_s": walls,
        "cache_hit_tokens": hit_tokens,
        "cow_copies": cache.stats.cow_copies,
        "cache_device_evictions": cache.stats.device_evictions,
        "cached_frames_before_pressure": cached_before,
        "pressure_instances": holders,
        "host_spill_bytes": spill, "host_prefetch_bytes": prefetch,
        "d2h_device_ms": tier.stats.d2h_ms,
        "d2h_dispatch_s": tier.stats.spill_s,
        "h2d_upload_bytes": up.bytes, "h2d_upload_ms": up.ms(),
        "host_fetch_stalls": tier.stats.fetch_stalls,
        "host_evictions": tier.stats.evictions,
        "spanning_chains": chains.chains,
        "kv_moved_bytes": cl.throughput_stats["kv_moved_bytes"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "counts": counts}
    report["throughput_tok_s"] = report["tokens"] / sum(walls.values())
    cache.clear()
    tier.drain(block=True)
    if tier.used_blocks:
        raise AssertionError(f"{tier.used_blocks} host frames left after "
                             f"clearing the cache")
    check_all_free(cl)
    report["phase_s"] = time.perf_counter() - t_phase
    return report


class PauseSpy:
    """Host wall time of every preemptor pause and resume attempt."""

    def __enter__(self):
        from repro_torch.serving.preempt import Preemptor
        self.cls = Preemptor
        self.orig = (Preemptor.pause, Preemptor._resume_one)
        self.pause_s, self.resume_s = [], []
        spy = self

        def pause(pre, req, now=None):
            t0 = time.perf_counter()
            ok = spy.orig[0](pre, req, now=now)
            if ok:
                spy.pause_s.append(time.perf_counter() - t0)
            return ok

        def resume(pre, rec):
            t0 = time.perf_counter()
            ok = spy.orig[1](pre, rec)
            if ok:
                spy.resume_s.append(time.perf_counter() - t0)
            return ok
        Preemptor.pause, Preemptor._resume_one = pause, resume
        return self

    def __exit__(self, *exc):
        self.cls.pause, self.cls._resume_one = self.orig


def overload_phase(params, cfg, device, global_pool: bool, n_new=64):
    """qwen3 under overload, once and counted: three instances of two
    slots, six best-effort requests in every slot (the 4,000-token
    spanning prompt and five of 600 tokens), then two urgent arrivals of
    300 tokens (one with priority, one with a deadline) that the server
    makes room for by pausing victims; the victims resume later."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (LLMServer, OverloadPolicy, Request,
                                     RequestHandle, SamplingParams)
    t_phase = time.perf_counter()
    reset_peak_memory()
    config = serving_config().replace(
        max_batch=2, pool_blocks=320, global_pool=global_pool,
        overload=OverloadPolicy(enabled=True))
    server = LLMServer(params, cfg, config, device=device)
    cl = server.cluster
    pre = cl.preemptor
    ptrs = pool_ptrs(cl)
    before = alloc_state(cl)
    sp = SamplingParams(max_new_tokens=n_new)
    best = [Request(prompt=p, sampling=sp, req_id=1_000_000 + i)
            for i, p in enumerate(make_prompts(cfg, (4000,) + (600,) * 5,
                                               37))]
    with PauseSpy() as spy:
        ops.reset_counts()
        t0 = time.perf_counter()
        for i, r in enumerate(best):        # two a slot-pair, in order
            cl.submit_to(r, i // 2)
        for _ in range(200):
            if all(r.output for r in best):
                break
            server.step()
        else:
            raise AssertionError("the best-effort requests never all ran")
        urgent = [server.submit(p, sp, **kw) for p, kw in zip(
            make_prompts(cfg, (300, 300), 41),
            ({"priority": 1}, {"deadline_s": 30.0}))]
        for _ in range(20_000):
            if all(r.done for r in best) and all(h.done for h in urgent):
                break
            server.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.counts()
    all_finished(urgent + [RequestHandle(server, r) for r in best])
    st = pre.stats
    if st.preemptions < 1 or st.resumes != st.preemptions:
        raise AssertionError(f"{st.preemptions} preemptions, {st.resumes} "
                             f"resumes")
    if pre.paused or pre.tier.used_blocks:
        raise AssertionError("the preempt tier did not end empty")
    server.step()
    if alloc_state(cl) != before:
        raise AssertionError("the allocators did not return to their state "
                             "before admission")
    if pool_ptrs(cl) != ptrs or sum(e.stats.pool_copy_steps
                                    for e in cl.engines.values()):
        raise AssertionError("a pool tensor was reallocated")
    check_path_kernels(counts, global_pool, device)
    toks = sum(len(r.output) for r in best) + sum(len(h._req.output)
                                                  for h in urgent)
    return {"global_pool": global_pool, "n_new": n_new,
            "pool_blocks": config.pool_blocks,
            "preemptions": st.preemptions, "resumes": st.resumes,
            "failed_pauses": st.failed_pauses,
            "failed_resumes": st.failed_resumes,
            "victims": [r.req_id - 1_000_000 for r in best
                        if r.preemptions],
            "spilled_blocks": st.spilled_blocks,
            "spilled_tokens": st.spilled_tokens,
            "spilled_bytes": pre.tier.stats.spilled_bytes,
            "fetched_bytes": pre.tier.stats.fetched_bytes,
            "d2h_device_ms": pre.tier.stats.d2h_ms,
            "pause_s": spy.pause_s, "resume_s": spy.resume_s,
            "urgent_ttft_s": [h.metrics["ttft"] for h in urgent],
            "tokens": toks, "wall_s": wall,
            "throughput_tok_s": toks / wall,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "phase_s": time.perf_counter() - t_phase, "counts": counts}


# --------------------------------------------------------------------- #
# Fault injection and token-replay recovery (qwen3-0.6b)
# --------------------------------------------------------------------- #
def fault_config(global_pool: bool, **over):
    """The serving config with two transfer retries a chain."""
    from repro_torch.serving import FaultPolicy
    return serving_config().replace(
        global_pool=global_pool, faults=FaultPolicy(max_transfer_retries=2),
        **over)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def check_allocators_clean(cluster) -> None:
    """Two more steps flush pending hosted releases; then every allocator,
    quarantined ranks included, is free (``check_all_free``) and holds no
    request record."""
    for _ in range(2):
        cluster.step()
    check_all_free(cluster)
    for i, e in cluster.engines.items():
        if e.rmanager.pool.requests:
            raise AssertionError(f"instance {i} kept request records "
                                 f"{list(e.rmanager.pool.requests)}")


def check_done_or_replay_failed(reqs, max_replays: int) -> None:
    """Every request FINISHED, or FAILED only past its replay budget."""
    from repro_torch.serving import RequestState
    for r in reqs:
        if r.state == RequestState.FINISHED:
            continue
        if r.state == RequestState.FAILED and r.replays >= max_replays:
            continue
        raise AssertionError(f"request {r.req_id} ended {r.state} after "
                             f"{r.replays} replays")


class ReplaySpy:
    """Host time of every replay admission (the re-prefill of ``prompt +
    output[:-1]``, synchronized at its end), and the time and step at
    which each dead instance was detected (``Cluster._handle_dead``)."""

    def __enter__(self):
        import repro_torch.serving.engine as engine_mod
        from repro_torch.serving.cluster import Cluster
        self.eng_cls, self.cl_cls = engine_mod.InstanceEngine, Cluster
        self.orig = (self.eng_cls._admit_streaming, self.eng_cls._admit_dense,
                     Cluster._handle_dead)
        self.replays, self.detected = [], []
        spy = self

        def timed(orig):
            def admit(eng, req, *a):
                replay = req.needs_replay and bool(req.output)
                t0 = time.monotonic()
                out = orig(eng, req, *a)
                if replay:
                    sync(eng.device)
                    spy.replays.append({
                        "req_id": req.req_id, "inst": eng.inst_id,
                        "tokens": len(req.prompt) + len(req.output) - 1,
                        "host_s": time.monotonic() - t0})
                return out
            return admit

        def handle_dead(cl, dead):
            spy.detected.append({"t": time.monotonic(),
                                 "step": cl._step_count, "dead": list(dead)})
            return spy.orig[2](cl, dead)
        self.eng_cls._admit_streaming = timed(self.orig[0])
        self.eng_cls._admit_dense = timed(self.orig[1])
        Cluster._handle_dead = handle_dead
        return self

    def __exit__(self, *exc):
        (self.eng_cls._admit_streaming, self.eng_cls._admit_dense,
         self.cl_cls._handle_dead) = self.orig


def shared_tokens(a, b) -> dict:
    """Leading tokens two streams share, and positions where they agree."""
    lead = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))
    return {"leading": lead, "equal": sum(x == y for x, y in zip(a, b)),
            "of": len(a)}


def fault_phase(params, cfg, device, global_pool: bool, prompt_lens,
                n_new=32, pool_blocks=256):
    """qwen3, a creditor crash, once and counted: the server first serves
    the prompts unfailed (the reference stream), then the same prompts
    again; once the longest has emitted 4 tokens, ``kill_instance`` of a
    creditor hosting its span. Detection, token replay (re-prefill of
    ``prompt + output[:-1]``, the paged kernels over the re-striped
    prefix), every request finishing, no leak, no pool reallocated."""
    from repro_torch.kernels import ops
    from repro_torch.serving import LLMServer, SamplingParams
    t_phase = time.perf_counter()
    if device.type == "cuda":
        reset_peak_memory()
    # 256 blocks an instance: once one creditor is dead, the other must
    # hold the longest request's whole overflow (188 blocks) on replay.
    server = LLMServer(params, cfg, fault_config(global_pool,
                                                 pool_blocks=pool_blocks),
                       device=device)
    cl = server.cluster
    ptrs = pool_ptrs(cl)
    prompts = make_prompts(cfg, prompt_lens, 7)
    sp = SamplingParams(max_new_tokens=n_new)
    clean = [server.submit(p, sp) for p in prompts]
    server.drain(max_steps=20_000)
    all_finished(clean)
    hs = [server.submit(p, sp) for p in prompts]
    req = hs[0]._req
    for _ in range(2_000):
        server.step()
        if len(req.output) >= 4:
            break
    owner = next(i for i, e in cl.engines.items() if req in e.running)
    hosts = [i for i, e in cl.engines.items()
             if i != owner and e.rmanager.is_hosting(req.req_id)]
    if not hosts:
        raise AssertionError("the spanning request has no creditor span")
    victim = hosts[0]
    kill_step, tokens_at_kill = cl._step_count, len(req.output)
    with ReplaySpy() as spy:
        sync(device)
        ops.reset_counts()
        steps0 = decode_steps(server)
        cl.kill_instance(victim)
        for _ in range(50):
            server.step()
            if spy.detected:
                break
        else:
            raise AssertionError("the dead creditor was never detected")
        detect = spy.detected[0]
        if cl.engines[victim].rmanager.pool.alloc.used_count:
            raise AssertionError("the dead instance still holds blocks")
        for _ in range(2_000):
            if req.token_times[-1] > detect["t"]:
                break
            server.step()
        sync(device)
        window = ops.counts()
        window_steps = decode_steps(server) - steps0
        server.drain(max_steps=20_000)
        sync(device)
        counts = ops.counts()
    all_finished(hs)
    if req.replays != 1 or not spy.replays:
        raise AssertionError(f"the spanning request replayed {req.replays} "
                             f"times")
    check_allocators_clean(cl)
    if pool_ptrs(cl) != ptrs or sum(e.stats.pool_copy_steps
                                    for e in cl.engines.values()):
        raise AssertionError("a pool tensor was reallocated")
    check_path_kernels(counts, global_pool, device)
    names = (("paged_micro_attention_ranks", "paged_prefill_attention_ranks")
             if global_pool else
             ("paged_micro_attention", "paged_prefill_attention"))
    for name in names:
        if served(window, name, device) <= 0:
            raise AssertionError(f"{name} did not run during the replay")
    report = {
        "global_pool": global_pool, "prompt_lens": list(prompt_lens),
        "n_new": n_new, "victim": victim, "owner": owner,
        "tokens_at_kill": tokens_at_kill,
        "steps_to_detection": detect["step"] - kill_step,
        "replay_tokens_prefilled": spy.replays[0]["tokens"],
        "replay_host_s": spy.replays[0]["host_s"],
        "replay_token_delay_s": next(t for t in req.token_times
                                     if t > detect["t"]) - detect["t"],
        "replayed_tokens": req.replayed_tokens,
        "shared_with_unfailed": [shared_tokens(h._req.output, c._req.output)
                                 for h, c in zip(hs, clean)],
        "window_launches": {k: served(window, k, device) for k in names},
        "window_decode_steps": window_steps,
        "metrics": {k: server.metrics[k] for k in FAULT_METRICS},
        "counts": counts}
    if global_pool:
        per_step = report["window_launches"][names[0]] / window_steps
        report["decode_launches_per_step"] = per_step
        if per_step != cfg.num_layers:
            raise AssertionError(f"{per_step} decode rank launches per "
                                 f"engine step during the replay, not "
                                 f"{cfg.num_layers}")
    if device.type == "cuda":
        report["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    report["phase_s"] = time.perf_counter() - t_phase
    return report


FAULT_METRICS = ("dead_instances", "fault_recoveries",
                 "fault_failed_recoveries", "replayed_tokens",
                 "move_leg_failures", "transfer_retries",
                 "transfer_failures", "host_frame_corruptions")


def fault_plan_phase(params, cfg, device, global_pool: bool, *,
                     prefix_len=PREFIX_LEN, suffix_len=SUFFIX_LEN,
                     mover_len=1500, worker_len=600, crash_at=40, n_new=32):
    """qwen3 under a FaultPlan with one event of each kind, with the
    prefix cache, a host tier and preemption on. A cold request caches a
    shared prefix + suffix, whose frames are then all evicted to the host
    tier. The plan arms a host fetch error, a stager timeout and a
    move-leg failure at the next step and a host frame corruption at the
    one after, then crashes instance 1 and silences instance 2 past the
    heartbeat timeout ``crash_at`` steps later. On instance 0: a warm
    request (its first host hit meets the fetch error, retried; its
    prefetches of the prefix overflow the stager's ring, whose drain
    meets the timeout, retried), a ``mover_len``-token request, striped
    over a creditor at admission, whose reactive move during decode
    meets the leg failure and re-plans, and, one step later, the cold
    prompt again (its suffix's host hit meets the corruption: that
    block is recomputed). All three finish before the crash. Instances
    1 and 2 each serve a ``worker_len``-token request still decoding at
    the crash: both replay on the survivor."""
    from repro_torch.serving import (FaultEvent, FaultPlan, LLMServer,
                                     OverloadPolicy, Request, SamplingParams)
    from repro_torch.serving.faults import FAULT_KINDS
    t_phase = time.perf_counter()
    config = fault_config(global_pool, prefix_cache=True,
                          host_tier_blocks=96,
                          overload=OverloadPolicy(enabled=True))
    server = LLMServer(params, cfg, config, device=device)
    cl = server.cluster
    cache, tier = cl.prefix_cache, cl.host_tier
    ptrs = pool_ptrs(cl)
    rng = np.random.default_rng(47)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len).tolist()

    def suffix(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()
    ids = iter(range(3_000_000, 4_000_000))

    def submit(prompt, inst, n):
        r = Request(prompt=prompt, sampling=SamplingParams(max_new_tokens=n),
                    req_id=next(ids))
        cl.submit_to(r, inst)
        return r
    cold_prompt = prefix + suffix(suffix_len)
    cold = submit(cold_prompt, 0, n_new)
    for _ in range(2_000):
        if cold.done:
            break
        server.step()
    for i in cl.engines:
        cache.evict_device(i, config.pool_blocks)
    tier.drain(block=True)
    on_host = tier.used_blocks
    s0 = cl._step_count
    steps = config.faults.heartbeat_timeout_steps
    plan = FaultPlan(events=(
        FaultEvent(step=s0 + 1, kind="stager_timeout"),
        FaultEvent(step=s0 + 1, kind="host_fetch"),
        FaultEvent(step=s0 + 1, kind="move_leg"),
        FaultEvent(step=s0 + 2, kind="host_corrupt"),
        FaultEvent(step=s0 + crash_at, kind="crash", target=1),
        FaultEvent(step=s0 + crash_at, kind="silence", target=2,
                   duration=steps + 3)))
    if sorted({e.kind for e in plan.events}) != sorted(FAULT_KINDS):
        raise AssertionError("the plan misses a fault kind")
    injector = cl.install_faults(plan)
    with ReplaySpy() as spy:
        reqs = [submit(prefix + suffix(suffix_len), 0, n_new),
                submit(suffix(mover_len), 0, n_new)]
        reqs += [submit(suffix(worker_len), i, crash_at + 24)
                 for i in (1, 2)]
        server.step()
        reqs.append(submit(cold_prompt, 0, n_new))
        for _ in range(20_000):
            if all(r.done for r in reqs):
                break
            server.step()
        sync(device)
    check_done_or_replay_failed([cold] + reqs,
                                config.faults.max_replays_per_request)
    m = server.metrics
    want = {"dead_instances": 2.0, "move_leg_failures": 1.0,
            "host_frame_corruptions": 1.0, "transfer_failures": 0.0,
            "fault_failed_recoveries": 0.0}
    bad = {k: m[k] for k, v in want.items() if m[k] != v}
    if m["transfer_retries"] < 2 or m["fault_recoveries"] < 2 \
            or m["replayed_tokens"] <= 0:
        bad.update({k: m[k] for k in ("transfer_retries", "fault_recoveries",
                                      "replayed_tokens")})
    if bad or len(injector.fired) != len(plan.events):
        raise AssertionError(f"fault counters off: {bad}; fired "
                             f"{[e.kind for e in injector.fired]}")
    if pool_ptrs(cl) != ptrs:
        raise AssertionError("a pool tensor was reallocated")
    report = {"global_pool": global_pool, "host_frames_before": on_host,
              "plan": [dataclasses.astuple(e) for e in plan.events],
              "fired": [e.kind for e in injector.fired],
              "steps_to_detection": [
                  {"steps": d["step"] - (s0 + crash_at - 1), "dead": d["dead"]}
                  for d in spy.detected],
              "replays": spy.replays,
              "states": [r.state.name for r in [cold] + reqs],
              "move_leg_replans": cl.fault_stats.move_leg_replans,
              "stager_retries": dict(cl.stager.retries),
              "host_fetch_retries": tier.stats.fetch_retries,
              "metrics": {k: m[k] for k in FAULT_METRICS}}
    cache.clear()
    tier.drain(block=True)
    cl.preemptor.tier.drain(block=True)
    if tier.used_blocks or cl.preemptor.tier.used_blocks:
        raise AssertionError("a host tier did not end empty")
    check_allocators_clean(cl)
    report["phase_s"] = time.perf_counter() - t_phase
    return report


def trace_phase(params, cfg, device, config, prompt_lens, n_new, late_len,
                top=12, then=None):
    """A short traced window of a warm server: once the workload is
    admitted and decoding, one more prompt of ``late_len`` tokens arrives
    and the next ``TRACE_STEPS`` server steps (its admission and that
    many decode steps) run under ``torch.profiler``. Reports the device's busy
    time as a share of the window's wall time, the kernels that took most
    device time, and each kernel's launches in the window; then, if given,
    ``then(server, handles)`` on the still-decoding server (its report
    under "then")."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serving import LLMServer, SamplingParams
    server = LLMServer(params, cfg, config, device=device)
    sp = SamplingParams(max_new_tokens=n_new)
    handles = [server.submit(p, sp)
               for p in make_prompts(cfg, prompt_lens, 7)]
    for _ in range(50):             # admission, then two decode steps
        if all(h.metrics["n_tokens"] >= 3 for h in handles):
            break
        server.step()
    else:
        raise AssertionError("the traced window's workload never decoded")
    extra = make_prompts(cfg, [late_len], 13)[0]
    torch.cuda.synchronize()
    ops.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        late = server.submit(extra, sp)
        for _ in range(TRACE_STEPS):
            server.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: c["launches"] for k, c in ops.counts().items()}
    # Device-side events only (kernels, copies): the operators that launch
    # them report the same device time again.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    port_ms = {sym: sum(e.self_device_time_total for e in events
                        if sym in e.key) / 1e3
               for sym in PORT_KERNEL_SYMBOLS}
    report = {"steps": TRACE_STEPS, "late_prompt_len": len(extra),
              "late_tokens": int(late.metrics["n_tokens"]),
              "launches": launches, "wall_s": wall,
              "device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / 1e3 / wall,
              "port_kernel_ms": port_ms,
              "top_kernels": [{"name": e.key[:90],
                               "ms": e.self_device_time_total / 1e3,
                               "calls": e.count} for e in events[:top]]}
    if then is not None:
        report["then"] = then(server, handles + [late])
    return report


def hybrid_serving_config():
    """Two non-pooled instances of four slots on one card; the quota
    covers the longest prompt."""
    from repro_torch.serving import ServingConfig
    return ServingConfig.h100(
        n_instances=2, max_batch=4, max_local_len=8192, pool_blocks=1024,
        block_size=16)


class DenseAdmissionSpy:
    """Records the prompt length of every non-pooled (dense prefill)
    admission."""

    def __enter__(self):
        import repro_torch.serving.engine as engine_mod
        self.cls = engine_mod.InstanceEngine
        self.orig = self.cls._admit_dense
        self.lens = []
        spy = self

        def admit(eng, req, slot, tokens, n_local):
            spy.lens.append(len(tokens))
            return spy.orig(eng, req, slot, tokens, n_local)
        self.cls._admit_dense = admit
        return self

    def __exit__(self, *exc):
        self.cls._admit_dense = self.orig


def hybrid_serving_phase(params, cfg, device, prompt_lens, n_new):
    """The hybrid main path, once and counted: every attention layer of
    every admission prefill on the flash-prefill kernel."""
    from repro_torch.kernels import ops
    prompts = make_prompts(cfg, prompt_lens, 17)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    t0 = time.perf_counter()
    reset_peak_memory()
    with DenseAdmissionSpy() as spy:
        ops.reset_counts()
        handles, server, wall = serve(params, cfg, hybrid_serving_config(),
                                      prompts, n_new, device)
        counts = ops.counts()
    all_finished(handles)
    check_counts(counts, ("flash_prefill",), device)
    if sorted(spy.lens) != sorted(prompt_lens):
        raise AssertionError(f"admissions {spy.lens} != prompts "
                             f"{list(prompt_lens)}")
    want = n_attn * len(spy.lens)
    if counts["flash_prefill"]["launches"] != want:
        raise AssertionError(f"flash_prefill launched "
                             f"{counts['flash_prefill']['launches']} times, "
                             f"not {n_attn} x {len(spy.lens)} admissions")
    return {"prompt_lens": list(prompt_lens), "n_new": n_new,
            "admissions": len(spy.lens), "attn_layers": n_attn,
            **e2e_numbers(server, handles, wall),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "phase_s": time.perf_counter() - t0, "counts": counts}


def oracle_logits(params, cfg, prompt, forced, device):
    """Dense oracle: prefill (plain "xla" core) + decode_step,
    teacher-forced on ``forced``."""
    from repro_torch.models.model import decode_step
    from repro_torch.models.prefill import prefill
    tokens = torch.tensor([prompt], device=device)
    lg, state = prefill(params, cfg, tokens,
                        max_len=len(prompt) + len(forced) + 2,
                        backend="xla")
    out = [lg[0].float()]
    for tok in forced[:-1]:
        lg, state = decode_step(params, cfg, state,
                                torch.tensor([tok], device=device))
        out.append(lg[0].float())
    return out


class LogitSpy:
    """Every pooled step's logits for slot 0 (one request served at a
    time), keyed by the output index they predict: a prefill chunk's last
    row predicts ``output[t0 + n - len(prompt)]``, a decode step at
    position p predicts ``output[p + 1 - len(prompt)]``. A replay's
    re-prefill predicts an index a decode step already did: both are
    kept and both held to the oracle. ``start(len(prompt))`` begins each
    request's records."""

    def __init__(self, global_pool: bool):
        self.names = (("decode_step_global", "prefill_chunk_global")
                      if global_pool else
                      ("decode_step_paged", "prefill_chunk_paged"))
        self.start(0)

    def start(self, prompt_len: int) -> None:
        self.prompt_len, self.records = prompt_len, []

    def __enter__(self):
        import repro_torch.serving.engine as engine_mod
        self.mod = engine_mod
        self.orig = [getattr(engine_mod, n) for n in self.names]
        orig_decode, orig_chunk = self.orig
        spy = self

        def spy_decode(params, cfg, tokens, lens, *a, **k):
            out = orig_decode(params, cfg, tokens, lens, *a, **k)
            spy.records.append((int(lens[0]) + 1 - spy.prompt_len,
                                out[0][0].float().clone()))
            return out

        def spy_chunk(params, cfg, toks, t0, n, *a, **k):
            out = orig_chunk(params, cfg, toks, t0, n, *a, **k)
            if t0 + n >= spy.prompt_len:
                spy.records.append((t0 + n - spy.prompt_len,
                                    out[0][0].float().clone()))
            return out
        setattr(engine_mod, self.names[0], spy_decode)
        setattr(engine_mod, self.names[1], spy_chunk)
        return self

    def __exit__(self, *exc):
        for name, fn in zip(self.names, self.orig):
            setattr(self.mod, name, fn)


def parity_phase(params, cfg, device, prompt_len, n_new, *,
                 global_pool=False, pool_blocks=96, seed=11, **over):
    """float32: served greedy stream == oracle, per-step logits close, in
    either pool mode (``pool_blocks`` small enough that the prompt spans
    creditors; ``over``: other fields of the serving config)."""
    prompt = make_prompts(cfg, [prompt_len], seed)[0]
    config = serving_config().replace(**{
        "pool_blocks": pool_blocks, "max_local_len": 512,
        "global_pool": global_pool, **over})
    with LogitSpy(global_pool) as logits, AdmissionSpy() as spy:
        logits.start(prompt_len)
        handles, server, _ = serve(params, cfg, config, [prompt], n_new,
                                   device)
    out = handles[0].result()
    if max(spy.stripes) < 1:
        raise AssertionError("the parity request did not span a creditor")
    return {"prompt_len": prompt_len, "n_new": n_new,
            "global_pool": global_pool, "layers": cfg.num_layers,
            "block_size": config.block_size,
            **check_parity(params, cfg, device, prompt, out, logits.records),
            "creditors_at_admission": max(spy.stripes),
            "moves_during_decode": moves_executed(server)}


def hierarchy_parity_phase(params, cfg, device, *, global_pool, n_new=12):
    """float32, the memory hierarchy's paths against the dense oracle: a
    warm partial-prefix hit (16 cached blocks), a full-prompt COW hit, a
    hit prefetched from the host tier (every cached replica evicted
    first), and a creditor-spanning request paused after 4 tokens and
    resumed with its recorded layout (``prefer=``). Each request is
    served alone; its stream must equal the oracle's greedy stream and
    its logits the oracle's teacher-forced logits."""
    from repro_torch.serving import (LLMServer, OverloadPolicy,
                                     SamplingParams)
    config = serving_config().replace(
        pool_blocks=96, max_local_len=512, global_pool=global_pool,
        prefix_cache=True, host_tier_blocks=64,
        overload=OverloadPolicy(enabled=True))
    server = LLMServer(params, cfg, config, device=device)
    cl = server.cluster
    cache, pre = cl.prefix_cache, cl.preemptor
    rng = np.random.default_rng(43)
    base = rng.integers(0, cfg.vocab_size, 400).tolist()       # 25 blocks
    partial = base[:256] + rng.integers(0, cfg.vocab_size, 136).tolist()
    spanning = make_prompts(cfg, [1500], 11)[0]

    def metric(name):
        return server.metrics[name]

    def serve_one(logits, prompt, pause_after=None):
        logits.start(len(prompt))
        h = server.submit(prompt, SamplingParams(max_new_tokens=n_new))
        for _ in range(2_000):
            if h.done:
                break
            server.step()
            if pause_after and len(h._req.output) == pause_after and \
                    not h._req.preemptions:
                if not pre.pause(h._req):
                    raise AssertionError("the spanning request did not "
                                         "pause")
        return h.result(), list(logits.records)

    cases = {}
    with LogitSpy(global_pool) as logits:
        serve_one(logits, base)                            # cold
        for name, prompt, want in (("warm", partial, "cache_hit_tokens"),
                                   ("cow", base, "cache_hit_tokens")):
            got0 = metric(want)
            out, served = serve_one(logits, prompt)
            cases[name] = {"hit_tokens": metric(want) - got0,
                           **check_parity(params, cfg, device, prompt, out,
                                          served)}
        for i in cl.engines:
            cache.evict_device(i, config.pool_blocks)
        cl.host_tier.drain(block=True)
        got0 = metric("host_prefetch_bytes")
        out, served = serve_one(logits, partial)
        cases["host"] = {"prefetch_bytes": metric("host_prefetch_bytes")
                         - got0, **check_parity(params, cfg, device, partial,
                                                out, served)}
        out, served = serve_one(logits, spanning, pause_after=4)
        cases["paused_spanning"] = {
            "preemptions": pre.stats.preemptions,
            "resumes": pre.stats.resumes,
            **check_parity(params, cfg, device, spanning, out, served)}
    if cases["warm"]["hit_tokens"] < 256 or cases["cow"]["hit_tokens"] < 399:
        raise AssertionError(f"cache hits too short: {cases}")
    if cache.stats.cow_copies < 1 or cases["host"]["prefetch_bytes"] <= 0:
        raise AssertionError(f"no COW copy or no host prefetch: {cases}")
    if pre.stats.preemptions != 1 or pre.stats.resumes != 1:
        raise AssertionError(f"pause/resume did not happen once: {cases}")
    return {"global_pool": global_pool, "n_new": n_new,
            "layers": cfg.num_layers, "cases": cases}


def check_parity(params, cfg, device, prompt, out, records):
    """``check_parity_at`` against the dense oracle's teacher-forced
    logits for ``prompt`` and the served stream ``out``."""
    return check_parity_at(oracle_logits(params, cfg, prompt, out, device),
                           out, records)


def hybrid_parity_phase(params, cfg, device, prompt_len, n_new):
    """float32, the non-pooled path (hybrid past the window, or ssm):
    served greedy stream == oracle, per-step logits close."""
    import repro_torch.serving.engine as engine_mod
    prompt = make_prompts(cfg, [prompt_len], 23)[0]
    config = hybrid_serving_config().replace(max_local_len=4096,
                                             pool_blocks=512)
    served = []
    orig_decode = engine_mod.decode_step
    orig_prefill = engine_mod.prefill

    def spy_decode(*a, **k):
        out = orig_decode(*a, **k)
        served.append(out[0][0].float().clone())   # slot 0: one request
        return out

    def spy_prefill(*a, **k):
        out = orig_prefill(*a, **k)
        served[:] = [out[0][0].float().clone()]
        return out
    engine_mod.decode_step = spy_decode
    engine_mod.prefill = spy_prefill
    try:
        handles, server, _ = serve(params, cfg, config, [prompt], n_new,
                                   device)
    finally:
        engine_mod.decode_step = orig_decode
        engine_mod.prefill = orig_prefill
    out = handles[0].result()
    return {"prompt_len": prompt_len, "n_new": n_new,
            "layers": cfg.num_layers, "window": cfg.local_window,
            **check_parity(params, cfg, device, prompt, out,
                           list(enumerate(served)))}


# --------------------------------------------------------------------- #
# Serving, xlstm-350m (the ssm family)
# --------------------------------------------------------------------- #
def ssm_serving_config():
    """Two non-pooled instances of four slots on one card; the quota
    covers the longest prompt and its replay."""
    from repro_torch.serving import ServingConfig
    return ServingConfig.h100(n_instances=2, max_batch=4, max_local_len=2048,
                              pool_blocks=512, block_size=16)


def check_no_kernel(counts, path: str = "the xLSTM path") -> None:
    """No kernel of the port (nor its plain version) ran: xLSTM has no
    attention and no Pallas kernel in the reference, and training uses
    the plain attention core, as JAX does."""
    ran = {k: c for k, c in counts.items()
           if c["launches"] or c["plain_calls"]}
    if ran:
        raise AssertionError(f"kernels ran on {path}: {ran}")


def ssm_serving_phase(params, cfg, device, prompt_lens, n_new):
    """xLSTM, once and counted: every request finishes and no kernel of
    the port runs. Reports the end-to-end numbers, the peak memory and
    the mLSTM state a slot holds."""
    from repro_torch.kernels import ops
    prompts = make_prompts(cfg, prompt_lens, 19)
    t0 = time.perf_counter()
    if device.type == "cuda":
        reset_peak_memory()
    with DenseAdmissionSpy() as spy:
        ops.reset_counts()
        handles, server, wall = serve(params, cfg, ssm_serving_config(),
                                      prompts, n_new, device)
        counts = ops.counts()
    all_finished(handles)
    check_no_kernel(counts)
    if sorted(spy.lens) != sorted(prompt_lens):
        raise AssertionError(f"admissions {spy.lens} != prompts "
                             f"{list(prompt_lens)}")
    eng = server.cluster.engines[0]
    mlstm = eng.state.rec["mlstm"]
    report = {"prompt_lens": list(prompt_lens), "n_new": n_new,
              "layers": cfg.num_layers, **e2e_numbers(server, handles, wall),
              "mlstm_state_bytes_per_slot":
                  sum(t.numel() * t.element_size() for t in mlstm)
                  // eng.max_batch,
              "phase_s": time.perf_counter() - t0, "counts": counts}
    if device.type == "cuda":
        report["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return report


def ssm_owner_crash(server, handles) -> dict:
    """A FaultPlan crash of the instance serving the most requests, mid
    decode: they replay on the survivor and every request finishes."""
    from repro_torch.serving import FaultEvent, FaultPlan
    cl = server.cluster
    victim = max(cl.engines, key=lambda i: cl.engines[i].batch_size)
    owned = [h._req for h in handles if h._req in cl.engines[victim].running]
    last_beat = cl._step_count
    with ReplaySpy() as spy:
        cl.install_faults(FaultPlan(events=(FaultEvent(
            step=last_beat + 1, kind="crash", target=victim),)))
        server.drain(max_steps=20_000)
        sync(server.cluster.device)
    all_finished(handles)
    if not owned or any(r.replays != 1 for r in owned) \
            or victim not in cl._dead:
        raise AssertionError(f"owner crash: {[r.replays for r in owned]} "
                             f"replays, dead {sorted(cl._dead)}")
    return {"victim": victim, "replayed_requests": len(owned),
            "replays": spy.replays,
            "steps_to_detection": [d["step"] - last_beat
                                   for d in spy.detected],
            "metrics": {k: server.metrics[k] for k in FAULT_METRICS}}


# --------------------------------------------------------------------- #
# Parity under faults (float32)
# --------------------------------------------------------------------- #
def fault_parity_phase(params, cfg, device, *, global_pool, prompt_len=1500,
                       n_new=16, max_local_len=512, pool_blocks=96):
    """float32, token replay against the dense oracle, each case on a
    fresh server: a creditor crash of a creditor-spanning request
    (``kill_instance``), an owner crash (a FaultPlan event), and a
    spanning request paused after 4 tokens whose first preempt-tier frame
    a ``host_corrupt`` event corrupts, so that its resume falls back to
    replay. Each stream must equal the oracle's and every logit, the
    re-prefill's included, match its teacher-forced logit."""
    from repro_torch.serving import (FaultEvent, FaultPlan, LLMServer,
                                     OverloadPolicy, SamplingParams)
    prompt = make_prompts(cfg, [prompt_len], 11)[0]
    config = fault_config(global_pool, pool_blocks=pool_blocks,
                          max_local_len=max_local_len,
                          overload=OverloadPolicy(enabled=True))
    oracle = {}
    cases = {}
    for case in ("creditor_crash", "owner_crash", "corrupt_preempt_frame"):
        server = LLMServer(params, cfg, config, device=device)
        cl = server.cluster
        with LogitSpy(global_pool) as spy:
            spy.start(prompt_len)
            h = server.submit(prompt, SamplingParams(max_new_tokens=n_new))
            req = h._req
            for _ in range(2_000):
                if len(req.output) >= 4:
                    break
                server.step()
            owner = next(i for i, e in cl.engines.items()
                         if req in e.running)
            if case == "creditor_crash":
                cl.kill_instance(next(
                    i for i, e in cl.engines.items()
                    if i != owner and e.rmanager.is_hosting(req.req_id)))
            elif case == "owner_crash":
                cl.install_faults(FaultPlan(events=(FaultEvent(
                    step=cl._step_count + 1, kind="crash", target=owner),)))
            else:
                if not cl.preemptor.pause(req):
                    raise AssertionError("the spanning request did not "
                                         "pause")
                cl.install_faults(FaultPlan(events=(FaultEvent(
                    step=cl._step_count + 1, kind="host_corrupt"),)))
            out = h.result()
        if req.replays != 1:
            raise AssertionError(f"{case}: {req.replays} replays")
        key = tuple(out)
        if key not in oracle:
            oracle[key] = oracle_logits(params, cfg, prompt, out, device)
        cases[case] = {"replays": req.replays,
                       "replayed_tokens": req.replayed_tokens,
                       "metrics": {k: server.metrics[k]
                                   for k in FAULT_METRICS},
                       **check_parity_at(oracle[key], out, spy.records)}
        del server
    return {"global_pool": global_pool, "prompt_len": prompt_len,
            "n_new": n_new, "layers": cfg.num_layers, "cases": cases}


def check_parity_at(ref, out, records):
    """The served greedy stream ``out`` == the oracle's (``ref``: its
    teacher-forced logits, ``ref[i]`` predicting ``out[i]``), every index
    has a served logit, and every served logit ``(i, logits)`` is within
    PARITY_RTOL of ``ref[i]``."""
    greedy = [int(lg.argmax()) for lg in ref]
    if greedy != out:
        raise AssertionError(f"served greedy stream differs from the dense "
                             f"oracle: {out} vs {greedy}")
    seen = {i for i, _ in records if i < len(ref)}
    if seen != set(range(len(ref))):
        raise AssertionError(f"no served logits for output indices "
                             f"{sorted(set(range(len(ref))) - seen)}")
    worst = 0.0
    for i, s in records:
        if i < len(ref):
            r = ref[i]
            worst = max(worst, ((s - r).abs().max() / r.abs().max()).item())
    if worst > PARITY_RTOL:
        raise AssertionError(f"served logits differ from the oracle by "
                             f"{worst:.3g} (relative) > {PARITY_RTOL}")
    return {"tokens_equal": True, "max_rel_logit_err": worst,
            "rtol": PARITY_RTOL, "logits_checked": len(records)}


# --------------------------------------------------------------------- #
# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #
def tree_to(tree, device):
    """A nested parameter dict with every tensor copied to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def traced_step(report: dict):
    """An ``around_step`` hook for ``launch.train.run``: runs the step
    under ``torch.profiler`` with a CUDA event at the end of each of its
    phases, and fills ``report`` with the step's wall time, the device's
    busy share of it, the device time of forward, backward (remat's
    recompute included) and optimizer, and the kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    def around(step, run_step):
        marks = []

        def on_phase(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            out = run_step(on_phase=on_phase)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        split, prev = {}, start
        for name, ev in marks:
            split[name] = split.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        events.sort(key=lambda e: -e.self_device_time_total)
        report.update({"step": step, "wall_s": wall,
                       "device_busy_ms": busy_ms,
                       "device_busy_share": busy_ms / 1e3 / wall,
                       "phase_device_ms": split,
                       "top_kernels": [
                           {"name": e.key[:90],
                            "ms": e.self_device_time_total / 1e3,
                            "calls": e.count} for e in events[:12]]})
        return out
    return around


def train_phase(arch, device, *, steps, seq, batch, layers=None,
                ep_groups=0):
    """``arch`` trained through the port's trainer (``launch.train.run``:
    seeded random weights, bf16, remat, AdamW) for ``steps`` steps of
    ``batch`` x ``seq`` tokens, the last one traced. Every loss and
    gradient norm must be finite and no kernel of the port may run.
    Reports the median time of the steps after the first
    ``TRAIN_UNTIMED`` (the traced one excluded), tokens/s, MFU (useful
    FLOPs over the step time and the bf16 peak), the least time the card
    could take, the peak memory, and each step's loss and gradient
    norm."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.roofline import (ideal_step_s, mfu,
                                             model_useful_flops)
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = ShapeConfig(f"train_{seq}", "train", seq, batch)
    trace = {}
    hook = traced_step(trace)
    t0 = time.perf_counter()
    reset_peak_memory()
    ops.reset_counts()
    recs = train.run(arch, steps=steps, seq=seq, batch=batch, layers=layers,
                     ep_groups=ep_groups, device=device, log=None,
                     around_step=lambda step, run_step: (
                         hook(step, run_step) if step == steps - 1
                         else run_step()))
    counts = ops.counts()
    check_no_kernel(counts, f"{arch}'s training path")
    peak = torch.cuda.max_memory_allocated()
    timed = [r["seconds"] for r in recs[TRAIN_UNTIMED:steps - 1]]
    step_s = float(np.median(timed))
    return {"arch": arch, "layers": cfg.num_layers,
            "params": cfg.param_count(), "seq": seq, "batch": batch,
            "ep_groups": ep_groups, "steps": len(recs),
            "step_s_median": step_s, "step_s_timed": timed,
            "step_s_untimed": [r["seconds"] for r in recs[:TRAIN_UNTIMED]],
            "tokens_per_s": batch * seq / step_s,
            "useful_flops": model_useful_flops(cfg, shape),
            "mfu": mfu(cfg, shape, step_s),
            "bound_s": ideal_step_s(cfg, shape),
            "peak_mem_bytes": peak,
            "loss": [r["loss"] for r in recs],
            "grad_norm": [r["grad_norm"] for r in recs],
            "lr": [r["lr"] for r in recs], "trace": trace,
            "phase_s": time.perf_counter() - t0}


def rel_diff(got, want) -> float:
    """max |got - want| / max |want|, in float32 on ``want``'s device."""
    got, want = got.detach().float().to(want.device), want.detach().float()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def train_parity_phase(device, arch, layers, tkw, *, seq, batch):
    """One float32 ``train_step`` of ``arch`` at full width and ``layers``
    layers, on the card and on the CPU from the same weights (drawn on the
    card, where drawing is fast, and copied to the CPU before either
    step: a step updates its weights in place): loss and gradient norm
    within ``TRAIN_STEP_RTOL`` relative, and each leaf's gradient within
    ``TRAIN_GRAD_RTOL`` of its largest magnitude — or, where the model
    is worse conditioned, within ``TRAIN_ULPS`` times its own
    sensitivity, measured in the same run: a third step on the card from
    the weights each raised by one ulp. The gradients are read from the
    first moments: a step from zero moments stores (1 - b1) times the
    clipped gradient."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (TrainConfig,
                                                 init_train_state,
                                                 train_step)
    from repro_torch.training.tree import tree_leaves, tree_map
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              num_layers=layers)
    card = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                       device)
    runs = [(torch.device("cpu"), tree_to(card, "cpu")), (device, card),
            (device, tree_map(lambda p: p * (1 + 2 ** -23), card))]
    del card
    setup_s = time.perf_counter() - t0
    toks, mask = batch_for_step(DataConfig(cfg.vocab_size, seq, batch), 0)
    acfg, tcfg = AdamWConfig(), TrainConfig(**tkw)
    res, init_s, cpu_ops = [], [], None
    ops.reset_counts()
    while runs:
        dev, params = runs.pop(0)
        t1 = time.perf_counter()
        state = init_train_state(params, acfg, tcfg, dev)
        del params
        init_s.append(time.perf_counter() - t1)
        # The CPU step under the profiler: its operators by own time
        # (not xLSTM's: its scan's ~1e5 small operators made the
        # profile itself cost about a minute).
        profiled = dev.type == "cpu" and cfg.family != "ssm"
        prof = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
            if profiled else contextlib.nullcontext())
        t1 = time.perf_counter()
        with prof:
            state, out = train_step(state, torch.from_numpy(toks).to(dev),
                                    torch.from_numpy(mask).to(dev), cfg=cfg,
                                    tcfg=tcfg, adam_cfg=acfg)
        res.append((out, tree_leaves(state.opt.m),
                    time.perf_counter() - t1))
        if profiled:
            top = sorted(prof.key_averages(),
                         key=lambda e: -e.self_cpu_time_total)
            cpu_ops = [{"op": e.key, "calls": e.count,
                        "self_s": e.self_cpu_time_total / 1e6}
                       for e in top[:6]]
        del state
    check_no_kernel(ops.counts(), f"{arch}'s training path")

    def diffs(a, b):
        (out_a, m_a, _), (out_b, m_b, _) = a, b
        return {"loss": rel_diff(out_a["loss"], out_b["loss"]),
                "grad_norm": rel_diff(out_a["grad_norm"], out_b["grad_norm"]),
                "grad_max": max(rel_diff(x, y) for x, y in zip(m_a, m_b))}
    cpu, card, ulp = res
    got, sens = diffs(card, cpu), diffs(ulp, card)
    bound = {k: max(floor, TRAIN_ULPS * sens[k]) for k, floor in
             (("loss", TRAIN_STEP_RTOL), ("grad_norm", TRAIN_STEP_RTOL),
              ("grad_max", TRAIN_GRAD_RTOL))}
    report = {"arch": arch, "layers": layers, "seq": seq, "batch": batch,
              **tkw, "cpu_s": cpu[2], "card_s": card[2], "setup_s": setup_s,
              "init_state_s": init_s, "cpu_top_ops": cpu_ops,
              "loss": float(card[0]["loss"]), "rel_diff": got,
              "one_ulp_sensitivity": sens, "bound": bound,
              "leaves": len(cpu[1]), "phase_s": time.perf_counter() - t0}
    if any(got[k] > bound[k] for k in got):
        raise AssertionError(f"train parity: {report}")
    return report


def train_restart_phase(device, *, layers=2, seq=512, batch=2, steps=6,
                        save_at=2):
    """qwen3-0.6b at full width and ``layers`` layers, bf16: ``steps``
    train steps with a checkpoint after step ``save_at``; the checkpoint
    restores into a fresh state (other weights) bit for bit, and the
    restored state's remaining steps give the uninterrupted run's losses
    and gradient norms within ``RESTART_RTOL`` (on the card the backward
    of a gather adds in no fixed order, so bitwise continuation is
    promised only on the CPU, where the tests hold it)."""
    import shutil
    from repro_torch.checkpoint import (Checkpointer, restore_train_state,
                                        save_train_state)
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.training.data import DataConfig, batch_for_step
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (TrainConfig,
                                                 init_train_state,
                                                 train_step)
    from repro_torch.training.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), num_layers=layers)
    acfg = AdamWConfig(warmup_steps=2, total_steps=steps)
    tcfg = TrainConfig(remat=True)
    dc = DataConfig(cfg.vocab_size, seq, batch)

    def fresh(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_train_state(init_params(cfg, gen, device), acfg, tcfg,
                                device)

    def leaves(state):
        return [state.opt.step] + tree_leaves(state.params) + \
            tree_leaves(state.opt.m) + tree_leaves(state.opt.v)

    def run(state, first, last):
        outs = []
        for step in range(first, last):
            toks, mask = batch_for_step(dc, step)
            state, out = train_step(state, torch.from_numpy(toks).to(device),
                                    torch.from_numpy(mask).to(device),
                                    cfg=cfg, tcfg=tcfg, adam_cfg=acfg)
            outs.append((float(out["loss"]), float(out["grad_norm"])))
        return state, outs

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        ckpt = Checkpointer(str(ckdir), keep=1)
        state, first = run(fresh(0), 0, save_at + 1)
        t1 = time.perf_counter()
        save_train_state(ckpt, save_at, state)
        save_s = time.perf_counter() - t1
        saved = [t.cpu().clone() for t in leaves(state)]
        state, rest = run(state, save_at + 1, steps)
        del state
        t1 = time.perf_counter()
        restored = restore_train_state(ckpt, ckpt.latest(), fresh(1))
        restore_s = time.perf_counter() - t1
        got = leaves(restored)
        if len(got) != len(saved) or not all(
                a.dtype == b.dtype and torch.equal(a.cpu(), b)
                for a, b in zip(got, saved)):
            raise AssertionError("the restored state differs from the "
                                 "saved one")
        del got, saved
        restored, again = run(restored, save_at + 1, steps)
        del restored
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    diff = max(abs(a - b) / abs(b) for x, y in zip(again, rest)
               for a, b in zip(x, y))
    report = {"layers": layers, "seq": seq, "batch": batch, "steps": steps,
              "save_at": save_at, "save_s": save_s, "restore_s": restore_s,
              "uninterrupted": first + rest, "continued": again,
              "continuation_max_rel_diff": diff,
              "continuation_bitwise": again == rest,
              "phase_s": time.perf_counter() - t0}
    if diff > RESTART_RTOL:
        raise AssertionError(f"train restart: {report}")
    return report


# --------------------------------------------------------------------- #
# The global pool sharded over processes (qwen3-0.6b)
# --------------------------------------------------------------------- #
# W -> (mesh shape, pool axes): global_check.py's two layouts. W = 2
# holds two of the four ranks a process (the local merge runs before the
# collective), W = 4 one.
MESH_LAYOUTS = {2: ((2, 1), ("data",)), 4: ((2, 2), ("data", "model"))}
MESH_TIMEOUT_S = 600
MESH_SERVE_LAYERS = 14   # the mesh groups' qwen3 depth (of 28)
# Depths of the phases that rerun the main path's machinery at full
# width (qwen3's memory hierarchy, overload and faults; the hybrid and
# ssm servers): cut so that the script stays inside its time on a slow
# host (one call took 1,201 s at full depth).
QWEN3_EXT_LAYERS = 14    # of 28
HYBRID_SERVE_LAYERS = 20  # of 38: six (rglru, rglru, attn) groups + 2
SSM_SERVE_LAYERS = 8     # of 24: one group of 7 mLSTM + 1 sLSTM


def first_layers(params, cfg, n: int):
    """A dense model's first ``n`` layers: the stacked leaves' leading
    slices (views, no copy) and the config of that depth."""
    return ({**params, "layers": layer_slice(params["layers"], n)},
            dataclasses.replace(cfg, num_layers=n))


def layer_slice(tree, n: int):
    """Every leaf of ``tree`` cut to its first ``n`` along dim 0."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, n) for k, v in tree.items()}
    return tree[:n]
GRAD_SEED = 1000


def mesh_config(**over):
    """The serving phase's config on four instances (the rank axis
    divides over 2 and 4 processes), global pool."""
    return serving_config().replace(n_instances=4, global_pool=True, **over)


def mesh_model(job, dtype=None, layers=None):
    """The job's model config: full width; ``job["smoke"]`` (a CPU
    rehearsal) shrinks it, ``layers`` cuts the depth."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config(job["arch"]) if job.get("smoke")
           else get_config(job["arch"]))
    over = {}
    if dtype:
        over["dtype"] = dtype
    if layers:
        over["num_layers"] = layers
    return dataclasses.replace(cfg, **over)


class CollectiveSpy:
    """Calls and host seconds of every all-reduce and broadcast (the
    port calls them as ``torch.distributed`` attributes). With gloo a
    CUDA tensor is staged through the host, so a call's host time
    includes waiting for the kernels queued before it."""

    NAMES = ("all_reduce", "broadcast")

    def __enter__(self):
        import torch.distributed as dist
        self.dist = dist
        self.orig = {n: getattr(dist, n) for n in self.NAMES}
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        for name, fn in self.orig.items():
            setattr(dist, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return call

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)


def mesh_serve(params, cfg, device, mesh, layout, prompts, n_new, config):
    """One process's share of the mesh main path, counted: LLMServer over
    the mesh serves ``prompts`` greedily."""
    from repro_torch.kernels import ops
    from repro_torch.serving import LLMServer, SamplingParams
    if device.type == "cuda":
        reset_peak_memory()
    with AdmissionSpy() as spy, CollectiveSpy() as coll:
        ops.reset_counts()
        server = LLMServer(params, cfg, config, device=device, mesh=mesh,
                           layout=layout)
        handles = [server.submit(p, SamplingParams(max_new_tokens=n_new))
                   for p in prompts]
        t0 = time.perf_counter()
        server.drain(max_steps=20_000)
        sync(device)
        wall = time.perf_counter() - t0
        counts = ops.counts()
    all_finished(handles)
    cl = server.cluster
    out = {"streams": [h.result() for h in handles],
           "stripes": spy.stripes, "moves": moves_executed(server),
           "decode_steps": decode_steps(server),
           "cluster_steps": cl._step_count, "counts": counts,
           "traffic": dataclasses.asdict(cl.gpool.traffic),
           "slab_ranks": cl.gpool.k.shape[0],
           "slab_bytes": 2 * cl.gpool.k.numel() * cl.gpool.k.element_size(),
           "pool_copy_steps": sum(e.stats.pool_copy_steps
                                  for e in cl.engines.values()),
           "collective_calls": coll.calls,
           "collective_s": coll.seconds,
           **e2e_numbers(server, handles, wall)}
    if device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def seeded_grads(params, seed, device):
    """Float32 tensors of the parameter tree's shapes, seeded: one pod's
    stand-in gradients (values like a bf16 model's, 1e-3 scale)."""
    from repro_torch.training.tree import tree_map
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                          device=device) * 1e-3, params)


def bit_checksums(tree) -> list:
    """Two integer sums of each leaf's float32 bits (plain and position
    weighted): equal leaves give equal sums, and any flipped bit moves
    them."""
    out = []
    for t in tree_leaves(tree):
        bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append((int(bits.sum()), int((bits * w).sum())))
    return out


def mesh_grad_sync(params, device, pod):
    """``make_grad_sync`` over a 1-D ("pod",) mesh of the processes,
    each with its own pod's gradients."""
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.training.grad_sync import make_grad_sync, wire_bytes
    pods = make_mesh((2,), ("pod",), device=device)
    grads = seeded_grads(params, GRAD_SEED + pod, device)
    sync(device)
    t0 = time.perf_counter()
    avg = make_grad_sync(pods, "pod")(grads)
    sync(device)
    return {"sync_s": time.perf_counter() - t0, "wire": wire_bytes(grads),
            "checksums": bit_checksums(avg)}


def mesh_worker(rank, world, store, job, queue):
    """One process of a mesh group: gloo over a FileStore, the card it
    shares with every other process of the group."""
    import traceback
    import torch.distributed as dist
    try:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.distributed.mesh import make_mesh
        from repro_torch.models.model import init_params
        from repro_torch.serving import ServeLayout
        device = torch.device(job["device"])
        if device.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        shape, axes = MESH_LAYOUTS[world]
        mesh = make_mesh(shape, device=device)
        layout = ServeLayout(batch_axes=("data",), pool_axes=axes)
        cfg = mesh_model(job, layers=job.get("layers"))
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
        job_s = {}

        def timed(key, fn, *args):
            """``out[key] = fn(*args)``, its seconds in ``job_s``."""
            t0 = time.perf_counter()
            out[key] = fn(*args)
            job_s[key] = time.perf_counter() - t0

        out = {"job_s": job_s}
        timed("serve", mesh_serve, params, cfg, device, mesh, layout,
              job["prompts"], job["n_new"], mesh_config())
        if job.get("ext"):
            timed("ext", ext_job, params, cfg, device, job, EXT_SMOKE
                  if job.get("smoke") else EXT, mesh, layout)
        if job.get("grad_sync"):
            # Over the full-depth tree's shapes, whatever depth served.
            from repro_torch.distributed.placement import param_shapes
            timed("grad_sync", mesh_grad_sync,
                  param_shapes(mesh_model(job)), device, rank)
        del params
        par = job.get("parity")
        if par:
            cfg32 = mesh_model(job, "float32", par["layers"])
            params32 = init_params(cfg32, torch.Generator(device=device)
                                   .manual_seed(0), device)
            timed("parity", mesh_serve, params32, cfg32, device, mesh,
                  layout, par["prompts"], par["n_new"],
                  mesh_config(**par["config"]))
            if job.get("ext"):
                timed("ext32", ext_job, params32, cfg32, device, job,
                      EXT_SMOKE if job.get("smoke") else EXT_F32, mesh,
                      layout)
            del params32
        if job.get("serve_layout"):
            timed("serve_layout", lambda: {
                arch: sl_mesh_case(arch, mode, job, device, mesh)
                for arch, mode in SERVE_LAYOUT_MESH})
        if job.get("placement"):
            release_memory()
            timed("placement", placement_job, world, job, device)
        if job.get("state"):
            release_memory()
            timed("state", state_job, world, job, device)
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def collect(queue, procs, timeout_s):
    """{rank: report} from every process; fails as soon as one died
    without reporting, or at ``timeout_s``."""
    import queue as queue_mod
    res, deadline = {}, time.monotonic() + timeout_s
    while len(res) < len(procs):
        try:
            rank, out = queue.get(timeout=5)
            res[rank] = out
        except queue_mod.Empty:
            dead = [i for i, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and i not in res]
            if dead or time.monotonic() > deadline:
                raise AssertionError(f"mesh processes {dead or 'all'} gave "
                                     f"no report") from None
    return res


def run_mesh_group(world, job):
    """Spawn ``world`` processes of ``mesh_worker`` (never fork: CUDA is
    initialized here), wait for each one's report, reap them all."""
    import shutil
    import torch.multiprocessing as mp
    tmp = ROOT / "build" / f"mesh-store-{os.getpid()}-{world}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=mesh_worker,
                         args=(r, world, str(tmp / "store"), job, queue))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        res = collect(queue, procs, MESH_TIMEOUT_S)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [v for v in res.values() if isinstance(v, str)]
    if bad:
        raise AssertionError(f"a mesh process failed:\n{bad[0]}")
    return [res[r] for r in range(world)], time.perf_counter() - t0


def check_mesh_serve(runs, world, layers, device, *, gate_remote):
    """The gates of one layout's served run, over every process."""
    first = runs[0]
    for r, run in enumerate(runs):
        if run["streams"] != first["streams"]:
            raise AssertionError(f"process {r}'s streams differ from "
                                 f"process 0's")
        if run["slab_ranks"] != 4 // world:
            raise AssertionError(f"process {r} holds {run['slab_ranks']} "
                                 f"ranks, not {4 // world}")
        if run["pool_copy_steps"]:
            raise AssertionError(f"process {r}: a step reallocated the slab")
        check_counts(run["counts"], ("paged_micro_attention_ranks",
                                     "paged_prefill_attention_ranks"),
                     device)
        for name in ("paged_micro_attention", "paged_prefill_attention"):
            if served(run["counts"], name, device):
                raise AssertionError(f"process {r}: {name} ran on the mesh "
                                     f"path")
        per_step = served(run["counts"], "paged_micro_attention_ranks",
                          device) / run["decode_steps"]
        if per_step != layers:
            raise AssertionError(f"process {r}: {per_step} decode launches "
                                 f"per engine step, not {layers}")
        if gate_remote and run["traffic"]["remote_copies"] < 1:
            raise AssertionError(f"process {r}: no move leg crossed "
                                 f"processes")


def mesh_phase(params, cfg, device, prompt_lens, n_new, *, smoke=False,
               layers=None, parity_layers=4):
    """The global pool sharded over processes, on one card: W = 2 and
    W = 4 processes serve the main path's prompts (``LLMServer(...,
    mesh=, layout=)``, gloo); W = 2 also serves the float32 parity
    prompts and averages a gradient tree with ``make_grad_sync``. This
    process holds the references: the float32 single-process global
    path, the dense oracle, the one-process gradient average."""
    arch = "qwen3-0.6b"
    t_phase = time.perf_counter()
    prompts = make_prompts(cfg, prompt_lens, 7)
    par = {"layers": parity_layers, "n_new": 24,
           "prompts": make_prompts(cfg, (1500, 600), 11),
           "config": {"pool_blocks": 96, "max_local_len": 512}}
    job = {"device": str(device), "arch": arch, "smoke": smoke,
           "layers": layers, "prompts": prompts, "n_new": n_new,
           "serve_layout": True, "placement": True, "state": True}
    n_layers = layers or cfg.num_layers
    report = {"prompt_lens": list(prompt_lens), "n_new": n_new,
              "layers": n_layers, "instances": 4, "backend": "gloo",
              "layouts": {}}
    sl_single = {}
    t0 = time.perf_counter()
    st_single = state_single(job, device)
    report["state_single_s"] = time.perf_counter() - t0
    for world in sorted(MESH_LAYOUTS):
        wjob = dict(job, parity=par, grad_sync=True, ext=True) \
            if world == 2 else job
        runs, wall = run_mesh_group(world, wjob)
        serve = [run["serve"] for run in runs]
        check_mesh_serve(serve, world, n_layers, device, gate_remote=True)
        if max(serve[0]["stripes"]) < 2:
            raise AssertionError(f"W={world}: no prompt striped over >= 2 "
                                 f"creditors ({serve[0]['stripes']})")
        s0 = serve[0]
        steps = s0["cluster_steps"]
        legs = s0["traffic"]["remote_copies"]
        report["layouts"][str(world)] = {
            "mesh": list(MESH_LAYOUTS[world][0]),
            "pool_axes": list(MESH_LAYOUTS[world][1]),
            "group_wall_s": wall,
            # Each job's seconds, the slowest process's.
            "job_s": {k: max(run["job_s"][k] for run in runs)
                      for k in runs[0]["job_s"]},
            "creditors_per_admission": s0["stripes"],
            "moves_during_decode": s0["moves"],
            "decode_steps": s0["decode_steps"], "cluster_steps": steps,
            "decode_launches_per_step": served(
                s0["counts"], "paged_micro_attention_ranks", device)
            / s0["decode_steps"],
            "traffic": s0["traffic"],
            "broadcast_bytes_per_remote_leg":
                s0["traffic"]["broadcast_bytes"] / legs,
            "slab_ranks": s0["slab_ranks"], "slab_bytes": s0["slab_bytes"],
            "per_process": [{
                k: run[k] for k in ("wall_s", "tokens", "throughput_tok_s",
                                    "ttft_p50_s", "tbt_p50_s", "tbt_p99_s",
                                    "collective_calls", "collective_s",
                                    "peak_mem_bytes") if k in run}
                | {"collective_s_per_cluster_step":
                   sum(run["collective_s"].values()) / steps,
                   "launches": {n: run["counts"][n]["launches"] for n in
                                ("paged_micro_attention_ranks",
                                 "paged_prefill_attention_ranks")}}
                for run in serve]}
        report["layouts"][str(world)]["serve_layout"] = sl_mesh_check(
            runs, world, job, device, sl_single)
        report["layouts"][str(world)]["placement"] = placement_check(
            runs, world, job, device, sl_single)
        report["layouts"][str(world)]["state"] = state_check(
            runs, world, st_single)
        if world == 2:
            report["parity"] = mesh_parity(runs, cfg, device, par)
            report["grad_sync"] = mesh_grad_sync_check(runs, params, device)
            report["ext"] = ext_check(runs, "ext", device, n_layers)
            report["ext32"] = ext_mesh_parity(runs, cfg, device, par, job)
    report["phase_s"] = time.perf_counter() - t_phase
    return report


def mesh_parity(runs, cfg, device, par):
    """float32: the mesh streams equal the single-process global path's
    and the dense oracle's greedy argmax, with a move."""
    from repro_torch.models.model import init_params
    served_runs = [run["parity"] for run in runs]
    check_mesh_serve(served_runs, 2, par["layers"], device,
                     gate_remote=False)
    got = served_runs[0]["streams"]
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=par["layers"])
    params32 = init_params(cfg32, torch.Generator(device=device)
                           .manual_seed(0), device)
    handles, _, _ = serve(params32, cfg32, mesh_config(**par["config"]),
                          par["prompts"], par["n_new"], device)
    single = [h.result() for h in handles]
    if got != single:
        raise AssertionError(f"mesh streams {got} != single-process {single}")
    flips = 0
    for prompt, out in zip(par["prompts"], got):
        oracle = oracle_logits(params32, cfg32, prompt, out, device)
        flips += sum(int(torch.argmax(lg)) != tok
                     for lg, tok in zip(oracle, out))
    if flips:
        raise AssertionError(f"{flips} mesh tokens differ from the dense "
                             f"oracle's greedy argmax")
    if served_runs[0]["moves"] < 1:
        raise AssertionError("no KV move during the parity decode")
    return {"layers": par["layers"], "prompt_lens": [len(p) for p in
                                                     par["prompts"]],
            "n_new": par["n_new"], "greedy_equal": True,
            "moves_during_decode": served_runs[0]["moves"],
            "remote_legs": served_runs[0]["traffic"]["remote_copies"]}


def ext_mesh_parity(runs, cfg, device, par, job):
    """float32 at the parity depth: every extension scenario in this one
    process (four global-pool instances, no mesh), whose summaries the
    mesh's must equal, and every stream held to the dense oracle."""
    from repro_torch.models.model import init_params
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=par["layers"])
    params32 = init_params(cfg32, torch.Generator(device=device)
                           .manual_seed(0), device)
    single, _ = ext_job(params32, cfg32, device, job, EXT_SMOKE
                        if job.get("smoke") else EXT_F32)
    rep = ext_check(runs, "ext32", device, par["layers"], single=single,
                    params32=params32, cfg32=cfg32)
    del params32
    release_memory()
    return rep


def mesh_grad_sync_check(runs, params, device):
    """Every process's averaged tree equals, bit for bit, the same int8
    quantize/all-gather/mean done in this process."""
    from repro_torch.training.compression import quantize_int8
    from repro_torch.training.grad_sync import wire_bytes
    from repro_torch.training.tree import tree_map
    pods = [seeded_grads(params, GRAD_SEED + p, device) for p in range(2)]

    def mean(*gs):
        deq = [q.float() * s for q, s in (quantize_int8(g) for g in gs)]
        return torch.mean(torch.stack(deq), dim=0)
    want = bit_checksums(tree_map(mean, *pods))
    for r, run in enumerate(runs):
        if run["grad_sync"]["checksums"] != want:
            raise AssertionError(f"process {r}'s averaged gradients differ "
                                 f"from the one-process average")
    wire = wire_bytes(pods[0])
    return {"leaves": len(want), "bit_equal": True, "wire_bytes": wire,
            "wire_ratio_vs_fp32": wire["int8"] / wire["float32"],
            "sync_s": [run["grad_sync"]["sync_s"] for run in runs]}


# --------------------------------------------------------------------- #
# The ServeLayout steps (qwen3-0.6b): pooled prefill, both decode
# schedules, a 524,288-token context, parity, the dense-span decode
# --------------------------------------------------------------------- #
# The launch cells' pool: NP shards on the card, 128-token blocks
# (BLOCK_SIZE of the JAX package's launch inputs). "smoke" is a CPU
# rehearsal at smoke width.
SERVE_LAYOUT = {
    "full": {"bs": 128, "NP": 4, "n_data": 2, "B": 2, "S": 32768,
             "S_ragged": 32704, "steps": 32, "long_S": 524288,
             "long_steps": 16, "parity_layers": 4, "parity_S": 1500,
             "parity_steps": 12, "dist_ring": 1024},
    "smoke": {"bs": 8, "NP": 4, "n_data": 2, "B": 2, "S": 64,
              "S_ragged": 60, "steps": 3, "long_S": 512,
              "long_steps": 3, "parity_layers": 2, "parity_S": 60,
              "parity_steps": 3, "dist_ring": 32}}
# The mesh job: sharded_check.py's three layouts at 4 layers, float32.
SERVE_LAYOUT_MESH = (("olmo-1b", "tp_head"), ("qwen3-0.6b", "seq_model"),
                     ("qwen2-moe-a2.7b", "tp_head"))
SL_MESH = {"layers": 4, "B": 2, "S": 320, "bs": 128, "NP": 4, "n_data": 2,
           "steps": 6}
SL_MESH_SMOKE = dict(SL_MESH, S=60, bs=8, steps=3)


def layout_tables(wblk, NB_loc, S, bs, MB):
    """The tables of the pool ``serve_prefill_step`` wrote (``wblk`` [NP,
    B, S] from ``prefill_layout``): tables [NP, B, MB] in sequence order,
    tails [NP, B], and each request's last block (shard, local block),
    where the next tokens go while it has room."""
    NP, B, _ = wblk.shape
    tables = -np.ones((NP, B, MB), np.int32)
    tails = np.full((NP, B), bs, np.int32)
    for p in range(NP):
        for b in range(B):
            t = np.nonzero(wblk[p, b] < NB_loc)[0]
            if len(t):
                first = t[t % bs == 0]
                tables[p, b, :len(first)] = wblk[p, b, first]
                tails[p, b] = t[-1] % bs + 1
    owner = np.argmax(wblk[:, :, S - 1] < NB_loc, axis=0)
    last = wblk[owner, np.arange(B), S - 1]
    return tables, tails, owner, last


def decode_run(params, cfg, layout, pools, tabs, S, bs, tokens, steps, *,
               opt, device, mesh=None, logits=False):
    """Greedy decode of ``steps`` tokens from the pool of a ``S``-token
    context with ``serve_decode_step`` (``opt``: ``serve_decode_step_opt``)
    over ``tabs`` = (tables, tails, owner shard, last block) of that
    context. Returns the token stream [steps, R] (every request's, also
    under a mesh), each step's host seconds (ended by reading the
    tokens), each step's kernel counts and the first step's logits of
    this process's rows."""
    from repro_torch.kernels import ops
    from repro_torch.serving import sharded_step as ss
    tables, tails0, owner, last = tabs
    NP, R = tables.shape[:2]
    NB = pools[0].shape[2]
    if S % bs + steps > bs:
        raise ValueError("the decode would leave the context's last block")
    nblk = (tables >= 0).sum(-1).astype(np.int32)
    step = ss.serve_decode_step_opt if opt else ss.serve_decode_step
    rows = np.arange(R)
    tok = np.asarray(tokens)
    out, secs, counts, first = [], [], [], None
    for s in range(steps):
        tails = tails0.copy()
        tails[owner, rows] += s + (0 if opt else 1)
        wb = np.full((NP, R), NB, np.int32)
        wb[owner, rows] = last
        wo = np.full((NP, R), (S + s) % bs, np.int32)
        lens = np.full(R, S + s, np.int32)
        sync(device)
        ops.reset_counts()
        t0 = time.perf_counter()
        lg, pk, pv = step(params, cfg, layout, pools[0], pools[1], tables,
                          nblk, tails, wb, wo, tok, lens, mesh=mesh,
                          return_logits=True)
        nxt = ss.gather_batch(torch.argmax(lg, -1), mesh, layout, R)
        tok = nxt.cpu().numpy()
        secs.append(time.perf_counter() - t0)
        counts.append(ops.counts())
        if first is None and logits:
            first = lg.float()
        out.append(tok)
    return np.stack(out), secs, counts, first


def check_decode_counts(counts, layers, device):
    """Each decode step launched the decode rank kernel once a layer and
    nothing else: no plain version, no single-rank kernel, no prefill."""
    for i, c in enumerate(counts):
        if served(c, "paged_micro_attention_ranks", device) != layers:
            raise AssertionError(f"decode step {i}: {c} (want {layers} "
                                 f"rank launches)")
        for name, v in c.items():
            if device.type == "cuda" and v["plain_calls"]:
                raise AssertionError(f"decode step {i}: {name} ran its "
                                     f"plain version")
            if name != "paged_micro_attention_ranks" and \
                    served(c, name, device):
                raise AssertionError(f"decode step {i}: {name} ran")


def tbt_numbers(secs, R) -> dict:
    """TBT p50 and max, tokens/s of a decode run of ``R`` requests."""
    return {"tbt_p50_s": float(np.median(secs)),
            "tbt_max_s": float(max(secs)),
            "tokens_per_s": R * len(secs) / sum(secs)}


def sl_prefill(params, cfg, layout, toks, sh, device, mesh=None):
    """``serve_prefill_step`` once, counted: (first tokens, pools, host
    seconds, counts)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import sharded_step as ss
    sync(device)
    ops.reset_counts()
    t0 = time.perf_counter()
    first, pk, pv = ss.serve_prefill_step(
        params, cfg, layout, toks, block_size=sh["bs"], NP=sh["NP"],
        n_data=sh["n_data"], mesh=mesh)
    sync(device)
    return first, (pk, pv), time.perf_counter() - t0, ops.counts()


def check_prefill_counts(c, layers, device):
    """A prefill ran the flash kernel once a layer and nothing else."""
    for name, v in c.items():
        want = layers if name == "flash_prefill" else 0
        if served(c, name, device) != want or \
                (device.type == "cuda" and v["plain_calls"]):
            raise AssertionError(f"prefill: {name} {v} (want {want} "
                                 f"launches, no plain call)")


def long_context_pool(cfg, sh, device, seed=500):
    """The long_500k pool: ``long_S / bs`` blocks over NP shards (block j
    on shard j % NP), seeded, filled in the model's dtype one layer slice
    at a time (no float32 copy of the pool), R = 1; the context is
    ``long_S - long_steps`` tokens so that every step has a slot."""
    bs, NP, L = sh["bs"], sh["NP"], cfg.num_layers
    blocks = sh["long_S"] // bs
    NB = blocks // NP
    shape = (L, NP, NB, bs, cfg.num_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    pools = (torch.empty(shape, dtype=dt, device=device),
             torch.empty(shape, dtype=dt, device=device))
    for pool in pools:
        for layer in pool:
            layer.normal_(generator=gen)
    S = sh["long_S"] - sh["long_steps"]
    tables = -np.ones((NP, 1, NB + 1), np.int32)
    tables[:, 0, :NB] = np.arange(NB)
    tails = np.full((NP, 1), bs, np.int32)
    last = (S - 1) // bs                  # the context's last block
    owner = np.array([last % NP])
    tails[owner, 0] = (S - 1) % bs + 1
    return pools, (tables, tails, owner, np.array([last // NP])), S


def sl_prefill_phase(params, cfg, device, sh, layout, rep):
    """(a): the prefill at S (every block full) and at S_ragged (a
    partial last block); returns the S_ragged run's first tokens and
    pools."""
    from repro_torch.serving import sharded_step as ss
    cuda = device.type == "cuda"
    L, bs, NP, B = cfg.num_layers, sh["bs"], sh["NP"], sh["B"]
    toks = np.random.default_rng(32).integers(0, cfg.vocab_size,
                                              (B, sh["S"]))
    pre = {}
    for name, S in (("full", sh["S"]), ("ragged", sh["S_ragged"])):
        if cuda:
            reset_peak_memory()
        first, pools, secs, c = sl_prefill(params, cfg, layout, toks[:, :S],
                                           sh, device)
        check_prefill_counts(c, L, device)
        pre[name] = (first, pools)
        rep[f"prefill_{name}"] = {
            "S": S, "seconds": secs, "first_tokens": first.tolist(),
            "pool_bytes": 2 * pools[0].numel() * pools[0].element_size(),
            "pool_shape": list(pools[0].shape),
            "flash_launches": served(c, "flash_prefill", device),
            "prefill_tokens_per_s": B * S / secs}
        if cuda:
            rep[f"prefill_{name}"]["peak_mem_bytes"] = \
                torch.cuda.max_memory_allocated()
    # The two pools hold the same tokens [0, S_ragged) on the same
    # shards: layer 0's rows agree within a few roundings of the model's
    # dtype (GEMMs of other shapes may sum in another order; the later
    # layers' differences grow through the model and are reported).
    n = sh["S_ragged"]
    wb, wo, NBl = ss.prefill_layout(B, n, bs, NP, n_data=sh["n_data"])
    wa, _, _ = ss.prefill_layout(B, sh["S"], bs, NP, n_data=sh["n_data"])
    p_, b_, t_ = np.nonzero(wb < NBl)
    at = [torch.from_numpy(a).to(device) for a in
          (p_, wb[p_, b_, t_], wa[p_, b_, t_], wo[b_, t_])]
    diffs = []
    for layer in range(L):
        x = pre["ragged"][1][0][layer][at[0], at[1], at[3]].float()
        y = pre["full"][1][0][layer][at[0], at[2], at[3]].float()
        if not torch.isfinite(x).all():
            raise AssertionError("prefill pool holds a non-finite value")
        d = (x - y).abs()
        diffs.append(float(d.max()))
        if layer == 0 and bool((d > 2 ** -5 * y.abs() + 1e-3).any()):
            raise AssertionError(f"layer 0 K rows of the two prefills "
                                 f"differ by {diffs[0]}")
    rep["prefill_common_rows_max_abs_diff"] = {"layer0": diffs[0],
                                               "all_layers": max(diffs)}
    return pre["ragged"], (wb, NBl)


def sl_decode_phase(params, cfg, device, sh, layout, rep, first, pools,
                    placed):
    """(b): each schedule decodes ``steps`` tokens from the S_ragged
    pool; the first tokens must agree."""
    L, bs, NP, B = cfg.num_layers, sh["bs"], sh["NP"], sh["B"]
    S = sh["S_ragged"]
    MB = -(-S // bs) // (NP // sh["n_data"]) + 2
    tabs = layout_tables(*placed, S, bs, MB)
    streams = {}
    for opt in (False, True):
        out, secs, counts, _ = decode_run(params, cfg, layout, pools, tabs,
                                          S, bs, first.cpu().numpy(),
                                          sh["steps"], opt=opt,
                                          device=device)
        check_decode_counts(counts, L, device)
        streams[opt] = out
        rep["decode_opt" if opt else "decode_write"] = dict(
            tbt_numbers(secs, B), steps=sh["steps"], context=S, MB=MB,
            rank_launches=sum(served(c, "paged_micro_attention_ranks",
                                     device) for c in counts))
    if not np.array_equal(streams[False][0], streams[True][0]):
        raise AssertionError(f"the schedules' first tokens differ: "
                             f"{streams[False][0]} {streams[True][0]}")
    rep["decode_first_tokens"] = streams[False][0].tolist()
    rep["decode_streams_equal"] = bool(np.array_equal(streams[False],
                                                      streams[True]))


def sl_long_phase(params, cfg, device, sh, layout):
    """(c): long_500k, R = 1 over the whole seeded pool, each schedule;
    one layer's launch against its plain version."""
    from repro_torch.kernels.micro_attn_decode import (
        paged_micro_attention_ranks_plain)
    from repro_torch.kernels.ops import paged_micro_attention_ranks
    cuda = device.type == "cuda"
    L, bs = cfg.num_layers, sh["bs"]
    long = {}
    if cuda:
        reset_peak_memory()
        long["allocated_before_bytes"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pools, tabs, S = long_context_pool(cfg, sh, device)
    sync(device)
    pool_bytes = 2 * pools[0].numel() * pools[0].element_size()
    long.update({"context": S, "last_step_context": S + sh["long_steps"],
                 "pool_bytes": pool_bytes,
                 "fill_s": time.perf_counter() - t0,
                 "bound_ms_per_step": pool_bytes / HBM_BYTES_PER_S * 1e3,
                 "bound_ms_per_launch":
                     pool_bytes / L / HBM_BYTES_PER_S * 1e3})
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, 1)
    firsts = []
    for opt in (False, True):
        out, secs, counts, _ = decode_run(params, cfg, layout, pools, tabs,
                                          S, bs, tok, sh["long_steps"],
                                          opt=opt, device=device)
        check_decode_counts(counts, L, device)
        firsts.append(int(out[0, 0]))
        long["opt" if opt else "write"] = dict(
            tbt_numbers(secs, 1), steps=sh["long_steps"],
            rank_launches=sum(served(c, "paged_micro_attention_ranks",
                                     device) for c in counts),
            tbt_p50_over_bound=float(np.median(secs)) * 1e3
            / long["bound_ms_per_step"])
    if firsts[0] != firsts[1]:
        raise AssertionError(f"long context: first tokens differ {firsts}")
    tables, tails, owner, _ = tabs
    tl = tails.copy()
    tl[owner, 0] += sh["long_steps"]
    tb_d = torch.from_numpy(tables).to(device)
    tl_d = torch.from_numpy(tl).to(device)
    q = torch.randn((1, cfg.num_heads, cfg.head_dim),
                    generator=torch.Generator(device=device).manual_seed(9),
                    device=device).to(pools[0].dtype)
    pk, pv = pools[0][L // 2], pools[1][L // 2]
    got = paged_micro_attention_ranks(q, pk, pv, tb_d, tl_d)
    sync(device)
    want = paged_micro_attention_ranks_plain(q, pk, pv, tb_d, tl_d,
                                             scale=cfg.head_dim ** -0.5)
    long["layer_launch_max_abs_err"] = compare(got, want, TOL)
    if cuda:
        long["layer_launch_ms"] = time_ms(
            lambda: paged_micro_attention_ranks(q, pk, pv, tb_d, tl_d),
            iters=10)
        long["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        if long["peak_mem_bytes"] >= 80e9:
            raise AssertionError(f"peak memory {long['peak_mem_bytes']}")
    return long


def sl_parity_phase(device, cfg, sh, layout):
    """(d): float32 at ``parity_layers`` layers: both schedules greedy-
    equal to the dense oracle (``prefill`` + ``decode_step``) from the
    pool of a context that ends in a partial block, and one
    ``decode_step_dist`` step (a ring of the last ``dist_ring`` tokens +
    the remote span) against ``decode_step``."""
    import dataclasses as dc
    from repro_torch.models.model import decode_step, init_params
    from repro_torch.models.prefill import decode_step_dist, prefill
    from repro_torch.serving import sharded_step as ss
    bs, NP, B = sh["bs"], sh["NP"], sh["B"]
    cfg32 = dc.replace(cfg, dtype="float32", num_layers=sh["parity_layers"])
    p32 = init_params(cfg32, torch.Generator(device=device).manual_seed(0),
                      device)
    S, n_new = sh["parity_S"], sh["parity_steps"]
    ptoks = np.random.default_rng(15).integers(0, cfg.vocab_size, (B, S))
    first, pools, _, c = sl_prefill(p32, cfg32, layout, ptoks, sh, device)
    check_prefill_counts(c, cfg32.num_layers, device)
    wb, _, NBl = ss.prefill_layout(B, S, bs, NP, n_data=sh["n_data"])
    MB = -(-S // bs) // (NP // sh["n_data"]) + 2
    tabs = layout_tables(wb, NBl, S, bs, MB)
    t_ = torch.from_numpy(ptoks).to(device)
    lg, st = prefill(p32, cfg32, t_, max_len=S + n_new + 1)
    oracle = [torch.argmax(lg, -1)]
    for _ in range(n_new):
        lg, st = decode_step(p32, cfg32, st, oracle[-1])
        oracle.append(torch.argmax(lg, -1))
    oracle = torch.stack(oracle).cpu().numpy()
    if not np.array_equal(first.cpu().numpy(), oracle[0]):
        raise AssertionError("parity: prefill first tokens differ")
    par = {"layers": cfg32.num_layers, "B": B, "S": S, "steps": n_new,
           "partial_block": S % bs != 0}
    for opt in (False, True):
        run = tuple(p.clone() for p in pools)
        out, _, counts, _ = decode_run(p32, cfg32, layout, run, tabs, S, bs,
                                       oracle[0], n_new, opt=opt,
                                       device=device)
        check_decode_counts(counts, cfg32.num_layers, device)
        if not np.array_equal(out, oracle[1:]):
            raise AssertionError(f"parity ({'opt' if opt else 'write'}): "
                                 f"{out.T.tolist()} != {oracle[1:].T}")
        par["opt_greedy_equal" if opt else "write_greedy_equal"] = True
    ring = sh["dist_ring"]
    _, full = prefill(p32, cfg32, t_, max_len=S + 2)
    _, rst = prefill(p32, cfg32, t_, max_len=ring)
    start = torch.full((B,), S + 1 - ring, dtype=torch.int64, device=device)
    nxt = torch.from_numpy(oracle[0]).to(device).long()
    want, _ = decode_step(p32, cfg32, full, nxt)
    got, _ = decode_step_dist(p32, cfg32, rst, nxt, start,
                              full.kv_k[:, :, :S + 1 - ring],
                              full.kv_v[:, :, :S + 1 - ring], start)
    rel = float((got - want).abs().max() / want.abs().max())
    if rel > PARITY_RTOL or not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError(f"decode_step_dist: {rel} relative")
    par.update(decode_step_dist_rel_err=rel, dist_ring=ring)
    return par


def serve_layout_phase(params, cfg, device, *, smoke=False):
    """The ServeLayout steps (module docstring, phase 2): (a) prefill,
    (b) decode, (c) long_500k, (d) parity."""
    from repro_torch.serving import sharded_step as ss
    sh = SERVE_LAYOUT["smoke" if smoke else "full"]
    t_phase = time.perf_counter()
    layout = ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    rep = {"layers": cfg.num_layers, "bs": sh["bs"], "NP": sh["NP"],
           "B": sh["B"]}
    (first, pools), placed = sl_prefill_phase(params, cfg, device, sh,
                                              layout, rep)
    sl_decode_phase(params, cfg, device, sh, layout, rep, first, pools,
                    placed)
    del first, pools
    rep["long_500k"] = sl_long_phase(params, cfg, device, sh, layout)
    if device.type == "cuda":
        release_memory()
    rep["parity"] = sl_parity_phase(device, cfg, sh, layout)
    rep["phase_s"] = time.perf_counter() - t_phase
    return rep


def launcher_phase(device):
    """``python -m repro_torch.launch.serve`` as a function, on a smoke
    config on the card: every request finishes."""
    from repro_torch.launch import serve as launch_serve
    t0 = time.perf_counter()
    args = ["--arch", "qwen3-0.6b", "--instances", "3", "--requests", "8"]
    if device.type != "cuda":
        args += ["--device", "cpu"]
    stats = launch_serve.main(args)
    if stats["finished"] != 8:
        raise AssertionError(f"launcher: {stats['finished']} of 8 finished")
    return {"args": args, "wall_s": time.perf_counter() - t0,
            **{k: stats[k] for k in ("finished", "tokens", "ttft_p50",
                                     "tbt_p99")}}


def sl_mesh_layout(cfg, mesh, mode):
    """``mode``'s ServeLayout on ``mesh`` (one process: every shard here):
    the batch axes, and in tp_head mode the pool axes, as
    ``distributed.sharding`` picks them. seq_model is forced: the kv
    heads of these configs divide the TP axis of a mesh of 2 or 4
    processes, so ``serve_pool_axes`` picks tp_head (sharded_check.py
    reaches seq_model on a TP axis wider than the kv heads)."""
    from repro_torch.distributed.sharding import batch_axes, serve_pool_axes
    from repro_torch.serving import sharded_step as ss
    if mesh is None:
        return ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    axes = batch_axes(mesh)
    pool = serve_pool_axes(cfg, mesh)
    if pool != axes:
        raise AssertionError(f"{cfg.name}: serve_pool_axes {pool} on "
                             f"{axes}")
    if mode == "seq_model":
        pool = axes + ("model",)
    return ss.ServeLayout(batch_axes=axes, pool_axes=pool)


def sl_mesh_case(arch, mode, job, device, mesh=None):
    """One of sharded_check.py's layouts through the ServeLayout steps at
    float32: the prefill, then each decode schedule from its pool; with
    ``mesh``, as one process of it."""
    from repro_torch.models.model import init_params
    from repro_torch.serving import sharded_step as ss
    sh = SL_MESH_SMOKE if job.get("smoke") else SL_MESH
    cfg = mesh_model(dict(job, arch=arch), "float32", sh["layers"])
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    layout = sl_mesh_layout(cfg, mesh, mode)
    B, S, bs = sh["B"], sh["S"], sh["bs"]
    toks = np.random.default_rng(40).integers(0, cfg.vocab_size, (B, S))
    first, pools, _, c = sl_prefill(params, cfg, layout, toks, sh, device,
                                    mesh)
    check_prefill_counts(c, cfg.num_layers, device)
    first = ss.gather_batch(first, mesh, layout, B).cpu().numpy()
    wb, _, NBl = ss.prefill_layout(B, S, bs, sh["NP"], n_data=sh["n_data"])
    tabs = layout_tables(wb, NBl, S, bs, -(-S // bs) + 1)
    out = {"first": first.tolist(), "pool_axes": list(layout.pool_axes),
           "slab_shape": list(pools[0].shape),
           "slab_bytes": 2 * pools[0].numel() * pools[0].element_size()}
    for opt in (False, True):
        run = tuple(p.clone() for p in pools)
        stream, secs, counts, _ = decode_run(params, cfg, layout, run, tabs,
                                             S, bs, first, sh["steps"],
                                             opt=opt, device=device,
                                             mesh=mesh)
        check_decode_counts(counts, cfg.num_layers, device)
        out["opt" if opt else "write"] = {"stream": stream.tolist(),
                                          **tbt_numbers(secs, B)}
    return out


def sl_mesh_check(runs, world, job, device, single):
    """Every process of a group holds 1/shards of the pool and the
    single-process streams (computed here once, kept in ``single``)."""
    sh = SL_MESH_SMOKE if job.get("smoke") else SL_MESH
    shape, _ = MESH_LAYOUTS[world]
    rep = {}
    for arch, mode in SERVE_LAYOUT_MESH:
        if arch not in single:
            single[arch] = sl_mesh_case(arch, mode, job, device)
        want = single[arch]
        K = mesh_model(dict(job, arch=arch)).num_kv_heads
        shards = world if mode == "seq_model" else shape[0]
        k_loc = K if mode == "seq_model" else K // shape[1]
        for r, run in enumerate(runs):
            got = run["serve_layout"][arch]
            if got["slab_shape"][1] != sh["NP"] // shards or \
                    got["slab_shape"][4] != k_loc:
                raise AssertionError(f"{arch} W={world} process {r}: slab "
                                     f"{got['slab_shape']}")
            for key in ("first", "write", "opt"):
                g = got[key] if key == "first" else got[key]["stream"]
                w = want[key] if key == "first" else want[key]["stream"]
                if g != w:
                    raise AssertionError(f"{arch} W={world} process {r}: "
                                         f"{key} {g} != single-process {w}")
        rep[arch] = {"mode": mode,
                     "pool_axes": runs[0]["serve_layout"][arch]["pool_axes"],
                     "slab_shape": runs[0]["serve_layout"][arch]["slab_shape"],
                     "slab_bytes": [run["serve_layout"][arch]["slab_bytes"]
                                    for run in runs],
                     "single_slab_bytes": want["slab_bytes"],
                     "streams_equal": True,
                     "tbt_p50_s": {k: [run["serve_layout"][arch][k]
                                       ["tbt_p50_s"] for run in runs]
                                   for k in ("write", "opt")}}
        if device.type == "cuda":
            release_memory()
    return rep


# --------------------------------------------------------------------- #
# Parameter placements over the mesh (in the mesh phase's groups)
# --------------------------------------------------------------------- #
# qwen3-0.6b at full depth and width, bf16: a prefill of B = 2 x S =
# 4,096 (the S = 32,768 prefill stays in the one-process phase: every TP
# all-reduce of its activations is staged through the host over gloo),
# then ``steps`` decode steps of each schedule, placed and replicated
# interleaved; qwen2-moe-a2.7b placed only (W = 2), a shorter run.
# 8 decode steps a schedule: room for the state and extension jobs that
# the same groups run.
PLACEMENT = {"B": 2, "S": 4096, "bs": 128, "NP": 4, "steps": 8,
             "moe_S": 512, "moe_steps": 4, "parity_layers": 4,
             "parity_S": 320, "parity_steps": 4, "seed": 21}
PLACEMENT_RTOL = 1e-5   # placed vs whole-tree logits, float32, relative
PLACEMENT_SMOKE = dict(PLACEMENT, S=64, bs=8, steps=3, moe_S=32,
                       moe_steps=2, parity_layers=2, parity_S=60,
                       parity_steps=3)
# world -> the meshes of the bf16 runs ((axis names, shape)) and of the
# float32 parity runs ((axis names, shape, fsdp)).
PLACEMENT_MESHES = {2: ((("data", "model"), (1, 2)),),
                    4: ((("data", "model"), (1, 4)),
                        (("data", "model"), (2, 2)))}
PLACEMENT_PARITY = {2: ((("data", "model"), (1, 2), False),),
                    4: ((("data", "model"), (1, 4), False),
                        (("data", "model"), (2, 2), False),
                        (("data", "model"), (2, 2), True),
                        (("pod", "data", "model"), (2, 1, 2), False))}


def gloo_bf16_probe(device) -> dict:
    """Whether gloo takes a bf16 tensor on ``device`` for an all-reduce
    and an all-gather (the placed steps reduce in float32 either way)."""
    import torch.distributed as dist
    out = {}
    x = torch.ones(4, dtype=torch.bfloat16, device=device)
    for name in ("all_reduce", "all_gather"):
        try:
            if name == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = float(y[0]) == dist.get_world_size()
            else:
                parts = [torch.empty_like(x)
                         for _ in range(dist.get_world_size())]
                dist.all_gather(parts, x)
                ok = all(bool((p == 1).all()) for p in parts)
            out[name] = "ok" if ok else "wrong values"
        except Exception as exc:                # the answer is the point
            out[name] = f"refused: {type(exc).__name__}: {exc}"[:200]
    return out


def placement_model(job, arch, dtype=None, layers=None):
    return mesh_model(dict(job, arch=arch), dtype, layers)


def placed_tree(cfg, mesh, fsdp, seed, device):
    """(placed params, specs, bytes predicted from the spec tree, draw
    seconds): ``seeded_params`` keeps only this process's shards."""
    from repro_torch.distributed.placement import (param_shapes,
                                                   seeded_params, spec_bytes)
    from repro_torch.distributed.sharding import (param_specs,
                                                  validate_divisibility)
    shapes = param_shapes(cfg)
    specs = validate_divisibility(param_specs(cfg, shapes, fsdp=fsdp),
                                  shapes, mesh)
    sync(device)
    t0 = time.perf_counter()
    placed = seeded_params(cfg, seed, mesh=mesh, specs=specs, device=device)
    sync(device)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return placed, specs, spec_bytes(shapes, specs, sizes), \
        time.perf_counter() - t0


def placement_layout(cfg, mesh):
    """The mesh's ServeLayout as ``distributed.sharding`` decides it, and
    the prefill's ``n_data`` (the batch axes' size)."""
    from repro_torch.distributed.sharding import batch_axes, serve_pool_axes
    from repro_torch.serving import sharded_step as ss
    axes = batch_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return (ss.ServeLayout(axes, serve_pool_axes(cfg, mesh)),
            int(np.prod([sizes[a] for a in axes])))


def placed_serve_run(arch, mesh, job, device, ph, *, S, steps,
                     replicated):
    """One model on placed weights over ``mesh``: the weight bytes this
    process holds (against the spec tree's prediction), a prefill of B x
    S, then ``steps`` decode steps of each schedule; with ``replicated``
    the same steps on the whole tree in between (replicated, placed,
    placed, replicated), for TBT side by side."""
    from repro_torch.distributed.placement import local_bytes, seeded_params
    from repro_torch.serving import sharded_step as ss
    cfg = placement_model(job, arch)
    L = cfg.num_layers
    placed, specs, predicted, draw_s = placed_tree(cfg, mesh, False,
                                                   ph["seed"], device)
    held = local_bytes(placed)
    if held != predicted:
        raise AssertionError(f"{arch}: {held} B held, the spec tree gives "
                             f"{predicted}")
    layout, n_data = placement_layout(cfg, mesh)
    sh = {"bs": ph["bs"], "NP": ph["NP"], "n_data": n_data}
    B, bs = ph["B"], ph["bs"]
    toks = np.random.default_rng(ph["seed"]).integers(0, cfg.vocab_size,
                                                      (B, S))
    if device.type == "cuda":
        reset_peak_memory()
    first, pools, prefill_s, c = sl_prefill(placed, cfg, layout, toks, sh,
                                            device, mesh)
    check_prefill_counts(c, L, device)
    first = ss.gather_batch(first, mesh, layout, B).cpu().numpy()
    wb, _, NBl = ss.prefill_layout(B, S, bs, ph["NP"], n_data=n_data)
    tabs = layout_tables(wb, NBl, S, bs, -(-S // bs) + 1)
    out = {"arch": arch, "mesh": list(mesh.shape),
           "pool_axes": list(layout.pool_axes), "weight_bytes": held,
           "weight_bytes_predicted": predicted, "draw_s": draw_s,
           "prefill_s": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
           "slab_shape": list(pools[0].shape), "runs": {}}
    whole = seeded_params(cfg, ph["seed"], device=device) if replicated \
        else None
    order = ((("replicated", False), ("placed", False), ("placed", True),
              ("replicated", True)) if replicated else
             (("placed", False), ("placed", True)))
    for who, opt in order:
        run = tuple(p.clone() for p in pools)
        stream, secs, counts, _ = decode_run(
            placed if who == "placed" else whole, cfg, layout, run, tabs, S,
            bs, first, steps, opt=opt, device=device, mesh=mesh)
        check_decode_counts(counts, L, device)
        out["runs"][f"{who}_{'opt' if opt else 'write'}"] = {
            "stream": stream.tolist(), **tbt_numbers(secs, B)}
        del run
    if device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["first"] = first.tolist()
    del placed, whole, pools
    release_memory()
    return out


def placed_parity_run(mesh, fsdp, job, device, ph):
    """float32 at ``parity_layers``: the steps on placed weights against
    the same steps on the whole tree, in this process: the first tokens,
    each schedule's first-step logits (this process's rows) and streams."""
    from repro_torch.distributed.placement import seeded_params
    from repro_torch.serving import sharded_step as ss
    cfg = placement_model(job, "qwen3-0.6b", "float32", ph["parity_layers"])
    placed, _, _, _ = placed_tree(cfg, mesh, fsdp, ph["seed"], device)
    whole = seeded_params(cfg, ph["seed"], device=device)
    layout, n_data = placement_layout(cfg, mesh)
    sh = {"bs": ph["bs"], "NP": ph["NP"], "n_data": n_data}
    B, S, bs = ph["B"], ph["parity_S"], ph["bs"]
    toks = np.random.default_rng(ph["seed"] + 1).integers(
        0, cfg.vocab_size, (B, S))
    res = {"mesh": list(mesh.shape), "names": list(mesh.mesh_dim_names),
           "fsdp": fsdp, "pool_axes": list(layout.pool_axes),
           "n_data": n_data}
    firsts, streams = {}, {}
    for who, params in (("placed", placed), ("replicated", whole)):
        first, pools, _, _ = sl_prefill(params, cfg, layout, toks, sh,
                                        device, mesh)
        firsts[who] = ss.gather_batch(first, mesh, layout, B).cpu().numpy()
        wb, _, NBl = ss.prefill_layout(B, S, bs, ph["NP"], n_data=n_data)
        tabs = layout_tables(wb, NBl, S, bs, -(-S // bs) + 1)
        for opt in (False, True):
            run = tuple(p.clone() for p in pools)
            stream, _, _, lg = decode_run(
                params, cfg, layout, run, tabs, S, bs, firsts[who],
                ph["parity_steps"], opt=opt, device=device, mesh=mesh,
                logits=True)
            streams[who, opt] = (stream, lg)
    res["first"] = firsts["placed"].tolist()
    res["first_equal"] = bool((firsts["placed"] ==
                               firsts["replicated"]).all())
    for opt in (False, True):
        (sp, lp), (sr, lr) = streams["placed", opt], streams["replicated",
                                                            opt]
        key = "opt" if opt else "write"
        res[key] = {"stream": sp.tolist(),
                    "streams_equal": bool((sp == sr).all()),
                    "logit_rel_err": rel_diff(lp, lr)}
    del placed, whole
    return res


def placement_job(world, job, device):
    """This process's share of the placement runs of a group of
    ``world`` processes (``PLACEMENT_MESHES``, ``PLACEMENT_PARITY``)."""
    from repro_torch.distributed.mesh import make_mesh
    ph = PLACEMENT_SMOKE if job.get("smoke") else PLACEMENT
    out = {"gloo_bf16": gloo_bf16_probe(device), "runs": {}, "parity": []}
    meshes = {}
    for names, shape in PLACEMENT_MESHES[world]:
        mesh = meshes[names, shape] = make_mesh(shape, names, device=device)
        out["runs"][str(shape)] = placed_serve_run(
            "qwen3-0.6b", mesh, job, device, ph, S=ph["S"],
            steps=ph["steps"], replicated=True)
    if world == 2:
        out["moe"] = placed_serve_run(
            "qwen2-moe-a2.7b", meshes[("data", "model"), (1, 2)], job,
            device, ph, S=ph["moe_S"], steps=ph["moe_steps"],
            replicated=False)
    for names, shape, fsdp in PLACEMENT_PARITY[world]:
        mesh = meshes.get((names, shape)) or make_mesh(shape, names,
                                                       device=device)
        meshes[names, shape] = mesh
        out["parity"].append(placed_parity_run(mesh, fsdp, job, device, ph))
    return out


def placement_check(runs, world, job, device, single):
    """The gates of a group's placement runs over every process: the
    bytes each holds, equal streams in every process (and, at float32,
    equal to the whole tree's and to the single-process step's, logits
    within 1e-5 relative)."""
    ph = PLACEMENT_SMOKE if job.get("smoke") else PLACEMENT
    jobs = [run["placement"] for run in runs]
    rep = {"gloo_bf16": jobs[0]["gloo_bf16"], "runs": {}, "parity": []}
    for key in jobs[0]["runs"]:
        for j, p in enumerate(jobs):
            for name in ("first",):
                if p["runs"][key][name] != jobs[0]["runs"][key][name]:
                    raise AssertionError(f"placement {key}: process {j}'s "
                                         f"{name} differs")
            for name, r in p["runs"][key]["runs"].items():
                if r["stream"] != jobs[0]["runs"][key]["runs"][name][
                        "stream"]:
                    raise AssertionError(f"placement {key} {name}: process "
                                         f"{j}'s stream differs")
        r0 = jobs[0]["runs"][key]
        rep["runs"][key] = {
            **{k: r0[k] for k in ("arch", "mesh", "pool_axes",
                                  "weight_bytes_predicted", "slab_shape")},
            "weight_bytes": [p["runs"][key]["weight_bytes"] for p in jobs],
            "draw_s": [p["runs"][key]["draw_s"] for p in jobs],
            "prefill_s": [p["runs"][key]["prefill_s"] for p in jobs],
            "peak_mem_bytes": [p["runs"][key].get("peak_mem_bytes")
                               for p in jobs],
            "tbt_p50_s": {n: [p["runs"][key]["runs"][n]["tbt_p50_s"]
                              for p in jobs] for n in r0["runs"]},
            "placed_equals_replicated_tokens": {
                sched: float(np.mean(np.array(r0["runs"][f"placed_{sched}"]
                                              ["stream"]) ==
                                     np.array(r0["runs"][
                                         f"replicated_{sched}"]["stream"])))
                for sched in ("write", "opt")}}
    if "moe" in jobs[0]:
        m0 = jobs[0]["moe"]
        for j, p in enumerate(jobs):
            if p["moe"]["runs"] and any(
                    p["moe"]["runs"][n]["stream"] != m0["runs"][n]["stream"]
                    for n in m0["runs"]):
                raise AssertionError(f"placement moe: process {j}'s stream "
                                     f"differs")
        rep["moe"] = {**{k: m0[k] for k in ("arch", "mesh", "pool_axes",
                                            "weight_bytes_predicted",
                                            "slab_shape")},
                      "weight_bytes": [p["moe"]["weight_bytes"]
                                       for p in jobs],
                      "draw_s": [p["moe"]["draw_s"] for p in jobs],
                      "prefill_s": [p["moe"]["prefill_s"] for p in jobs],
                      "peak_mem_bytes": [p["moe"].get("peak_mem_bytes")
                                         for p in jobs],
                      "tbt_p50_s": {n: [p["moe"]["runs"][n]["tbt_p50_s"]
                                        for p in jobs] for n in m0["runs"]}}
    for i, p0 in enumerate(jobs[0]["parity"]):
        want = single_placement_streams(job, device, ph, single,
                                        p0["n_data"])
        for j, p in enumerate(jobs):
            par = p["parity"][i]
            err = max(par[k]["logit_rel_err"] for k in ("write", "opt"))
            if err > PLACEMENT_RTOL or not par["first_equal"] or not all(
                    par[k]["streams_equal"] for k in ("write", "opt")):
                raise AssertionError(f"placement parity {par['mesh']} "
                                     f"fsdp={par['fsdp']} process {j}: "
                                     f"logits {err} relative, {par}")
            got = (par["first"], par["write"]["stream"], par["opt"]["stream"])
            if got != want:
                raise AssertionError(f"placement parity {par['mesh']} "
                                     f"process {j}: streams {got} != the "
                                     f"single-process step's {want}")
        rep["parity"].append({
            k: p0[k] for k in ("mesh", "names", "fsdp", "pool_axes")} | {
            "logit_rel_err": max(p["parity"][i][k]["logit_rel_err"]
                                 for p in jobs for k in ("write", "opt")),
            "streams_equal_single_process": True})
    if device.type == "cuda":
        release_memory()
    return rep


def single_placement_streams(job, device, ph, single, n_data):
    """The float32 parity case's streams from the one-process steps
    (every shard here, the whole tree, the prefill laid out for
    ``n_data`` batch ranks as on the mesh), computed once."""
    key = ("placement_parity", n_data)
    if key in single:
        return single[key]
    from repro_torch.distributed.placement import seeded_params
    from repro_torch.serving import sharded_step as ss
    cfg = placement_model(job, "qwen3-0.6b", "float32", ph["parity_layers"])
    params = seeded_params(cfg, ph["seed"], device=device)
    layout = ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    B, S, bs = ph["B"], ph["parity_S"], ph["bs"]
    sh = {"bs": bs, "NP": ph["NP"], "n_data": n_data}
    toks = np.random.default_rng(ph["seed"] + 1).integers(
        0, cfg.vocab_size, (B, S))
    first, pools, _, _ = sl_prefill(params, cfg, layout, toks, sh, device)
    first = first.cpu().numpy()
    wb, _, NBl = ss.prefill_layout(B, S, bs, ph["NP"], n_data=n_data)
    tabs = layout_tables(wb, NBl, S, bs, -(-S // bs) + 1)
    out = [first.tolist()]
    for opt in (False, True):
        run = tuple(p.clone() for p in pools)
        stream, _, _, _ = decode_run(params, cfg, layout, run, tabs, S, bs,
                                     first, ph["parity_steps"], opt=opt,
                                     device=device)
        out.append(stream.tolist())
    single[key] = tuple(out)
    return single[key]


# --------------------------------------------------------------------- #
# The state steps on placed weights (recurrentgemma-9b, xlstm-350m)
# --------------------------------------------------------------------- #
STATE_ARCHS = ("recurrentgemma-9b", "xlstm-350m")
# bf16 at full width: B x S prompts (the hybrid's past its 2,048-token
# window, so the ring wraps), then ``steps`` decode steps; the hybrid at
# 11 of 38 layers, three groups and two leftover layers (its placed
# prefill's all-reduces go through the host: the full depth does not fit
# the script's time), xLSTM at all 24 (its prompt at 256 tokens: the
# scan is sequential);
# float32 parity past one group, where the stacked groups are indexed
# (hybrid 8 layers: two (rglru, rglru, attn) groups and two unstacked
# leftover layers; xLSTM 16: two groups) with ``parity_steps`` steps.
STATE = {"B": 2, "S": {"recurrentgemma-9b": 4096, "xlstm-350m": 256},
         "steps": 8, "seed": 23,
         "layers": {"recurrentgemma-9b": 11,
                    "xlstm-350m": None},
         "parity_layers": {"recurrentgemma-9b": 8, "xlstm-350m": 16},
         "parity_S": {"recurrentgemma-9b": 2304, "xlstm-350m": 256},
         "parity_steps": 4}
STATE_SMOKE = dict(STATE, S={"recurrentgemma-9b": 40, "xlstm-350m": 12},
                   layers={"recurrentgemma-9b": None, "xlstm-350m": None},
                   steps=3, parity_S={"recurrentgemma-9b": 40,
                                      "xlstm-350m": 12}, parity_steps=2)
# placed vs whole-tree logits and gathered states, and the whole tree's
# logits vs its full-sequence forward, float32, relative to the largest
# value (xLSTM's whole model as its CPU tests hold it) — or, where the
# model is worse conditioned (xLSTM past one group), within STATE_ULPS
# times the steps' own sensitivity, measured in the same run: the whole
# tree's steps again from the weights each raised by one ulp.
STATE_RTOL = {"recurrentgemma-9b": 1e-5, "xlstm-350m": 1e-4}
STATE_ULPS = 4
STATE_MESHES = {2: ((1, 2),), 4: ((1, 4),)}
STATE_PARITY = {2: (((1, 2), False),), 4: (((2, 2), True),)}


class FlashCheck:
    """The first flash-prefill kernel launch of a run held against the
    kernel's plain version on the same inputs, as the kernel phase holds
    it (its query and kv heads recorded); the plain call is no launch."""

    def __enter__(self):
        from repro_torch.kernels import flash_prefill as fp, ops
        self.ops, self.plain, self.orig = (ops, fp.flash_prefill_plain,
                                           ops.flash_prefill_cuda)
        self.heads = self.err = None

        def spy(q, k, v, *, scale, window=0):
            out = self.orig(q, k, v, scale=scale, window=window)
            if self.err is None:
                want = self.plain(q, k, v, scale=scale, window=window)
                diff = (out.float() - want.float()).abs()
                bad = diff > TOL + FLASH_RTOL[q.dtype] * want.float().abs()
                if bad.any():
                    raise AssertionError(f"flash on the placed prefill: "
                                         f"{int(bad.sum())} elements off")
                self.heads = [q.shape[2], k.shape[2]]
                self.err = diff.max().item()
                del want, diff, bad
            return out
        ops.flash_prefill_cuda = spy
        return self

    def __exit__(self, *exc):
        self.ops.flash_prefill_cuda = self.orig


def state_leaves(state) -> list:
    """A DecodeState's tensors, in field order."""
    out = [state.lens]
    if state.kv_k is not None:
        out += [state.kv_k, state.kv_v]
    rec = state.rec
    return out + (list(rec) if isinstance(rec, tuple) else
                  list(rec["mlstm"]) + list(rec["slstm"]))


def state_run(params, cfg, layout, toks, steps, device, mesh=None,
              parity=False):
    """``serve_prefill_step_state`` then ``steps`` greedy
    ``serve_decode_step_state`` steps: the first tokens and the stream
    (every row's), the prefill's host seconds and kernel counts, each
    step's seconds; with ``parity`` every step's logits (this process's
    rows) and the gathered state after the prefill and at the end."""
    from repro_torch.kernels import ops
    from repro_torch.serving import sharded_step as ss
    B = toks.shape[0]
    sync(device)
    ops.reset_counts()
    t0 = time.perf_counter()
    lg, st = ss.serve_prefill_step_state(params, cfg, layout, toks,
                                         max_len=toks.shape[1], mesh=mesh,
                                         return_logits=True)
    tok = ss.gather_batch(lg.argmax(-1), mesh, layout, B)
    sync(device)
    out = {"prefill_s": time.perf_counter() - t0, "counts": ops.counts(),
           "first": tok.cpu().tolist(), "stream": [], "secs": [],
           "local_state_bytes": sum(t.numel() * t.element_size()
                                    for t in state_leaves(st))}
    logits, states = [lg.float()], []
    if parity:
        states.append([t.float().clone() for t in state_leaves(
            ss.gather_state(st, cfg, mesh, layout, B))])
    for _ in range(steps):
        t0 = time.perf_counter()
        lg, st = ss.serve_decode_step_state(params, cfg, layout, st, tok,
                                            mesh=mesh, return_logits=True)
        tok = ss.gather_batch(lg.argmax(-1), mesh, layout, B)
        out["stream"].append(tok.cpu().tolist())
        out["secs"].append(time.perf_counter() - t0)
        logits.append(lg.float())
    if parity:
        states.append([t.float() for t in state_leaves(
            ss.gather_state(st, cfg, mesh, layout, B))])
        out["logits"], out["states"] = logits, states
    return out


def state_layout(mesh):
    """The state steps' layout: the batch over the batch axes (as the
    JAX package's cells place the states)."""
    from repro_torch.distributed.sharding import batch_axes
    from repro_torch.serving import sharded_step as ss
    if mesh is None:
        return ss.ServeLayout(("data",), ("data",))
    axes = batch_axes(mesh)
    return ss.ServeLayout(axes, axes)


def state_tokens(cfg, ph, arch, S):
    return np.random.default_rng(ph["seed"]).integers(
        0, cfg.vocab_size, (ph["B"], S))


def check_state_counts(counts, cfg, device) -> None:
    """The prefill launched the flash kernel once per local-attention
    layer (none for xLSTM) and ran nothing else."""
    want = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers)) \
        if cfg.family == "hybrid" else 0
    if served(counts, "flash_prefill", device) != want:
        raise AssertionError(f"{cfg.name}: {counts} (want {want} flash "
                             f"launches)")
    for name, v in counts.items():
        if name != "flash_prefill" and served(counts, name, device):
            raise AssertionError(f"{cfg.name}: {name} ran on the state path")
        if device.type == "cuda" and v["plain_calls"]:
            raise AssertionError(f"{cfg.name}: {name} ran its plain version")


def state_serve_run(arch, mesh, job, device, ph):
    """bf16 at full size on placed weights: the bytes this process holds
    (against the spec tree's prediction), a B x S prefill (its first
    flash launch held to the plain version), ``steps`` decode steps."""
    from repro_torch.distributed.placement import local_bytes
    t0 = time.perf_counter()
    cfg = placement_model(job, arch, layers=ph["layers"][arch])
    placed, _, predicted, draw_s = placed_tree(cfg, mesh, False, ph["seed"],
                                               device)
    held = local_bytes(placed)
    if held != predicted:
        raise AssertionError(f"{arch}: {held} B held, the spec tree gives "
                             f"{predicted}")
    if device.type == "cuda":
        reset_peak_memory()
    toks = state_tokens(cfg, ph, arch, ph["S"][arch])
    with FlashCheck() as fc:
        run = state_run(placed, cfg, state_layout(mesh), toks, ph["steps"],
                        device, mesh)
    check_state_counts(run["counts"], cfg, device)
    out = {"arch": arch, "mesh": list(mesh.shape), "layers": cfg.num_layers,
           "S": ph["S"][arch], "weight_bytes": held, "draw_s": draw_s,
           "flash_heads": fc.heads, "flash_max_abs_err": fc.err,
           "flash_launches": run["counts"]["flash_prefill"]["launches"],
           **{k: run[k] for k in ("prefill_s", "first", "stream",
                                  "local_state_bytes")},
           **tbt_numbers(run["secs"], ph["B"])}
    if device.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del placed
    release_memory()
    out["seconds"] = time.perf_counter() - t0
    return out


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|, at least 1: the scale
    the CPU tests hold states and logits to (``rel_diff`` has no
    floor)."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1.0)).item()


def to_cpu(x):
    """Tensors of nested lists and dicts copied to the host."""
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_cpu(v) for v in x]
    return x.cpu() if torch.is_tensor(x) else x


def forward_check(whole, cfg, toks, ref, device, bound) -> dict:
    """The whole tree's state-step logits held to its full-sequence
    ``forward`` (a layer loop of its own: the groups unstacked, no
    state) over the prompt and the streamed tokens, at the prompt's last
    position and each streamed one; greedy tokens equal."""
    from repro_torch.models.model import forward
    S = toks.shape[1]
    fed = np.concatenate([toks, np.array([ref["first"]] + ref["stream"][:-1],
                                         dtype=np.int64).T], 1)
    with torch.no_grad():
        lg, _ = forward(whole, cfg, torch.from_numpy(fed).to(device))
        lg = lg[:, S - 1:].float()
    err = max(rel_err(got.to(device), lg[:, j])
              for j, got in enumerate(ref["logits"]))
    tokens = lg.argmax(-1).T.cpu().tolist()
    res = {"forward_logit_rel_err": err,
           "forward_tokens_equal": tokens == [ref["first"]] + ref["stream"]}
    del lg
    if err > bound or not res["forward_tokens_equal"]:
        raise AssertionError(f"{cfg.name}: state steps vs forward {res}")
    return res


def state_parity_run(arch, mesh, fsdp, job, device, ph):
    """float32 past one group: the placed steps against the whole tree's
    without a mesh (the single-process step; run once, in the group's
    first process, while the others wait, so that one whole float32 tree
    is on the card at a time, and broadcast), which are held to the
    whole tree's ``forward`` there: first tokens and streams equal,
    every step's logits and the gathered states within ``STATE_RTOL``
    relative or ``STATE_ULPS`` one-ulp sensitivities."""
    import torch.distributed as dist
    from repro_torch.distributed.placement import seeded_params
    from repro_torch.serving.sharded_step import batch_rows
    t0 = time.perf_counter()
    cfg = placement_model(job, arch, "float32", ph["parity_layers"][arch])
    placed, _, _, _ = placed_tree(cfg, mesh, fsdp, ph["seed"], device)
    toks = state_tokens(cfg, ph, arch, ph["parity_S"][arch])
    got = to_cpu(state_run(placed, cfg, state_layout(mesh), toks,
                           ph["parity_steps"], device, mesh, parity=True))
    del placed
    release_memory()
    want = [None]
    if dist.get_rank() == 0:
        whole = seeded_params(cfg, ph["seed"], device=device)
        ref = to_cpu(state_run(whole, cfg, state_layout(None), toks,
                               ph["parity_steps"], device, parity=True))
        with torch.no_grad():
            for leaf in tree_leaves(whole):
                leaf.mul_(1 + 2 ** -23)
        ulp = to_cpu(state_run(whole, cfg, state_layout(None), toks,
                               ph["parity_steps"], device, parity=True))
        sens = max([rel_err(g, w) for g, w in zip(ulp["logits"],
                                                  ref["logits"])]
                   + [rel_err(g, w) for gs, ws in zip(ulp["states"],
                                                      ref["states"])
                      for g, w in zip(gs, ws)])
        ref["sensitivity"] = sens
        ref["bound"] = max(STATE_RTOL[arch], STATE_ULPS * sens)
        with torch.no_grad():
            for leaf in tree_leaves(whole):
                leaf.div_(1 + 2 ** -23)
        ref["forward"] = forward_check(whole, cfg, toks, ref, device,
                                       ref["bound"])
        want[0] = ref
        del whole, ulp
        release_memory()
    dist.broadcast_object_list(want, src=0)
    want = want[0]
    rows = batch_rows(mesh, state_layout(mesh), ph["B"])
    lerr = max(rel_err(g, w[rows]) for g, w in zip(got["logits"],
                                                   want["logits"]))
    serr = max(rel_err(g, w) for gs, ws in zip(got["states"],
                                               want["states"])
               for g, w in zip(gs, ws))
    res = {"arch": arch, "mesh": list(mesh.shape), "fsdp": fsdp,
           "layers": cfg.num_layers, "S": ph["parity_S"][arch],
           "logit_rel_err": lerr, "state_rel_err": serr,
           "tokens_equal": got["first"] == want["first"]
           and got["stream"] == want["stream"],
           "stream": got["stream"], **want["forward"],
           "one_ulp_sensitivity": want["sensitivity"], "bound": want["bound"],
           "seconds": time.perf_counter() - t0}
    if not res["tokens_equal"] or max(lerr, serr) > want["bound"]:
        raise AssertionError(f"state parity {arch} {mesh.shape} fsdp="
                             f"{fsdp}: {res}")
    return res


def state_job(world, job, device):
    """This process's share of the state-step runs of a group of
    ``world`` processes (``STATE_MESHES``, ``STATE_PARITY``)."""
    from repro_torch.distributed.mesh import make_mesh
    ph = STATE_SMOKE if job.get("smoke") else STATE
    out = {"runs": [], "parity": []}
    meshes = {}
    for shape in STATE_MESHES[world]:
        mesh = meshes[shape] = make_mesh(shape, device=device)
        for arch in STATE_ARCHS:
            out["runs"].append(state_serve_run(arch, mesh, job, device, ph))
    for shape, fsdp in STATE_PARITY[world]:
        mesh = meshes.get(shape) or make_mesh(shape, device=device)
        meshes[shape] = mesh
        for arch in STATE_ARCHS:
            out["parity"].append(state_parity_run(arch, mesh, fsdp, job,
                                                  device, ph))
    release_memory()
    return out


def state_single(job, device):
    """The bf16 runs' reference in this one process: the same seeded
    weights whole, the same steps without a mesh (greedy streams)."""
    from repro_torch.distributed.placement import seeded_params
    ph = STATE_SMOKE if job.get("smoke") else STATE
    out = {}
    for arch in STATE_ARCHS:
        cfg = placement_model(job, arch, layers=ph["layers"][arch])
        whole = seeded_params(cfg, ph["seed"], device=device)
        run = state_run(whole, cfg, state_layout(None),
                        state_tokens(cfg, ph, arch, ph["S"][arch]),
                        ph["steps"], device)
        out[arch] = {"first": run["first"], "stream": run["stream"],
                     "prefill_s": run["prefill_s"],
                     **tbt_numbers(run["secs"], ph["B"])}
        del whole
        release_memory()
    return out


def state_check(runs, world, single):
    """The gates of a group's state runs over every process: equal first
    tokens and streams in every process; the share of bf16 tokens equal
    to the whole tree's (reduction order); the parity runs' errors."""
    jobs = [run["state"] for run in runs]
    rep = {"runs": [], "parity": []}
    for i, r0 in enumerate(jobs[0]["runs"]):
        for j, p in enumerate(jobs):
            r = p["runs"][i]
            if (r["first"], r["stream"]) != (r0["first"], r0["stream"]):
                raise AssertionError(f"state {r0['arch']} {r0['mesh']}: "
                                     f"process {j}'s stream differs")
        ref = single[r0["arch"]]
        placed = np.array([r0["first"]] + r0["stream"])
        whole = np.array([ref["first"]] + ref["stream"])
        rep["runs"].append({
            **{k: r0[k] for k in ("arch", "mesh", "layers", "S",
                                  "flash_heads", "flash_launches")},
            **{k: [p["runs"][i].get(k) for p in jobs] for k in (
                "weight_bytes", "local_state_bytes", "draw_s", "prefill_s",
                "tbt_p50_s", "flash_max_abs_err", "peak_mem_bytes",
                "seconds")},
            "replicated_prefill_s": ref["prefill_s"],
            "replicated_tbt_p50_s": ref["tbt_p50_s"],
            "placed_equals_replicated_tokens": float(np.mean(placed ==
                                                             whole))})
    for i, p0 in enumerate(jobs[0]["parity"]):
        for j, p in enumerate(jobs):
            if p["parity"][i]["stream"] != p0["stream"]:
                raise AssertionError(f"state parity {p0['arch']}: process "
                                     f"{j}'s stream differs")
        rep["parity"].append({
            **{k: p0[k] for k in ("arch", "mesh", "fsdp", "layers", "S",
                                  "forward_logit_rel_err",
                                  "one_ulp_sensitivity", "bound")},
            **{k: max(p["parity"][i][k] for p in jobs)
               for k in ("logit_rel_err", "state_rel_err", "seconds")},
            "tokens_equal_whole_tree": True,
            "tokens_equal_forward": True})
    return rep


# --------------------------------------------------------------------- #
# The serving extensions under a mesh (qwen3-0.6b, global pool, W = 2)
# --------------------------------------------------------------------- #
# bf16 at MESH_SERVE_LAYERS; float32 at 4 layers, where every stream is
# also held to the dense oracle and every counter to the same scenario
# in one process.
EXT = {"n_new": 12, "prefix": PREFIX_LEN, "suffix": SUFFIX_LEN,
       "span": (4000, 600, 300), "bg": 600, "urgent": 300, "plan": 1500,
       "plan_seed": 5}
EXT_F32 = dict(EXT, n_new=8, span=(1500, 600, 300), plan=1000)
EXT_SMOKE = dict(EXT, n_new=6, prefix=24, suffix=8, span=(48, 20, 9),
                 bg=12, urgent=6, plan=40)
HOST_COUNTS = ("spills", "fetches", "evictions", "rejected",
               "fetch_retries", "fetch_failures", "corruptions",
               "spilled_bytes", "fetched_bytes")


def ext_config(job, **over):
    """Four global-pool instances (two ranks a process at W = 2); the
    smoke rehearsal's tiny pools."""
    from repro_torch.serving import FaultPolicy, ServingConfig
    faults = FaultPolicy(max_transfer_retries=2, verify_host_frames=True)
    if job.get("smoke"):
        return ServingConfig.smoke(n_instances=4, global_pool=True,
                                   faults=faults, **over)
    return mesh_config(faults=faults, **over)


def ext_tier_counts(tier):
    return None if tier is None else {k: getattr(tier.stats, k)
                                      for k in HOST_COUNTS}


def ext_summary(cl, reqs) -> dict:
    """What every process (and the single process) must agree on; the
    allocators' check once any cache is cleared."""
    pre = cl.preemptor
    out = {"outs": [list(r.output) for r in reqs],
           "prompts": [list(r.prompt) for r in reqs],
           "states": [r.state.name for r in reqs],
           "replays": [r.replays for r in reqs],
           "preemptions": [r.preemptions for r in reqs],
           "fault_stats": dataclasses.asdict(cl.fault_stats),
           "preempt": None if pre is None else dataclasses.asdict(pre.stats),
           "host": ext_tier_counts(cl.host_tier),
           "preempt_tier": ext_tier_counts(pre and pre.tier),
           "stager": [dict(cl.stager.retries), dict(cl.stager.failures)],
           "copies": sum(e.stats.pool_copy_steps
                         for e in cl.engines.values()),
           "dead": sorted(cl._dead)}
    if cl.prefix_cache is not None:
        cl.prefix_cache.clear()
    check_allocators_clean(cl)
    for tier in (cl.host_tier, pre and pre.tier):
        if tier is not None and tier.used_blocks:
            raise AssertionError(f"{tier.used_blocks} host frames left")
    return out


def ext_serve(server, reqs, insts=None):
    """Submit ``reqs`` (to ``insts`` when given) and step to the end."""
    cl = server.cluster
    for i, r in enumerate(reqs):
        if insts is None:
            cl.submit(r)
        else:
            cl.submit_to(r, insts[i])
    for _ in range(20_000):
        if all(r.done for r in reqs):
            return
        server.step()
    raise AssertionError("requests did not finish")


def ext_host_tier(params, cfg, device, job, ph, mesh, layout):
    """A cold request caches a shared prefix; every cached replica is
    spilled to the host tier (pressure on every instance); the same
    prompt then hits the host (H2D fetch), and once more the device."""
    from repro_torch.serving import LLMServer, Request, SamplingParams
    server = LLMServer(params, cfg, ext_config(
        job, prefix_cache=True, host_tier_blocks=96), device=device,
        mesh=mesh, layout=layout)
    cl = server.cluster
    prompt = make_prompts(cfg, [ph["prefix"] + ph["suffix"]], 29)[0]
    sp = SamplingParams(max_new_tokens=ph["n_new"])
    reqs = [Request(prompt=list(prompt), sampling=sp) for _ in range(3)]
    ttft, t0 = [], time.perf_counter()
    for i, r in enumerate(reqs):
        if i == 1:
            for j in cl.engines:
                cl.prefix_cache.evict_device(j, 10 ** 6)
            held = cl.host_tier.held_bytes
        ext_serve(server, [r], [0])
        ttft.append(r.token_times[0] - r.arrival_time)
    meas = {"host_bytes_held": held, "ttft_cold_host_warm_s": ttft,
            "d2h_device_ms": cl.host_tier.stats.d2h_ms,
            "wall_s": time.perf_counter() - t0}
    return ext_summary(cl, reqs), meas


def ext_overload(params, cfg, device, job, ph, mesh, layout):
    """One best-effort request in every slot (one a slot, four
    instances), then an urgent arrival: a victim pauses (its chain
    spilled to the preempt tier) and resumes."""
    from repro_torch.serving import (LLMServer, OverloadPolicy, Request,
                                     SamplingParams)
    server = LLMServer(params, cfg, ext_config(
        job, max_batch=1, overload=OverloadPolicy(enabled=True)),
        device=device, mesh=mesh, layout=layout)
    cl = server.cluster
    sp = SamplingParams(max_new_tokens=ph["n_new"])
    best = [Request(prompt=p, sampling=sp)
            for p in make_prompts(cfg, (ph["bg"],) * 4, 37)]
    with PauseSpy() as spy:
        for i, r in enumerate(best):
            cl.submit_to(r, i)
        for _ in range(200):
            if all(r.output for r in best):
                break
            server.step()
        urgent = server.submit(make_prompts(cfg, [ph["urgent"]], 41)[0],
                               sp, priority=1)
        reqs = best + [urgent._req]
        for _ in range(20_000):
            if all(r.done for r in reqs):
                break
            server.step()
    if cl.preemptor.stats.preemptions < 1:
        raise AssertionError("the urgent arrival paused no victim")
    meas = {"pause_s": spy.pause_s, "resume_s": spy.resume_s,
            "urgent_ttft_s": urgent.metrics["ttft"],
            "preempt_spilled_bytes": cl.preemptor.tier.stats.spilled_bytes}
    return ext_summary(cl, reqs), meas


def ext_kill(params, cfg, device, job, ph, mesh, layout):
    """A creditor of the spanning request dies once it has 4 tokens (a
    logical crash: its rank's slab stays); the request replays."""
    from repro_torch.serving import LLMServer, Request, SamplingParams
    server = LLMServer(params, cfg, ext_config(job, pool_blocks=256)
                       if not job.get("smoke") else ext_config(job),
                       device=device, mesh=mesh, layout=layout)
    cl = server.cluster
    sp = SamplingParams(max_new_tokens=ph["n_new"])
    reqs = [Request(prompt=p, sampling=sp)
            for p in make_prompts(cfg, ph["span"], 7)]
    for r in reqs:
        cl.submit(r)
    for _ in range(2000):
        if len(reqs[0].output) >= 4:
            break
        server.step()
    owner = next(e for e in cl.engines.values() if reqs[0] in e.running)
    victim = owner.remote_insts[reqs[0].req_id][0]
    with ReplaySpy() as spy:
        t_kill, n_kill = time.monotonic(), len(reqs[0].output)
        cl.kill_instance(victim)
        step0 = cl._step_count
        for _ in range(20_000):
            if all(r.done for r in reqs):
                break
            server.step()
    tt = reqs[0].token_times
    meas = {"victim": victim, "detect_steps":
            spy.detected[0]["step"] - step0 if spy.detected else None,
            "replay_host_s": [r["host_s"] for r in spy.replays],
            "replay_tokens": [r["tokens"] for r in spy.replays],
            "next_token_after_kill_s": tt[n_kill] - t_kill
            if len(tt) > n_kill else None}
    return ext_summary(cl, reqs), meas


def ext_fault_plan(params, cfg, device, job, ph, mesh, layout):
    """A seeded ``FaultPlan`` (``FaultPlan.from_seed``: six events over
    the first 30 steps, at most one crash) with the prefix cache, a host
    tier and preemption on; after the first round every cached replica
    is spilled and one prompt is served again from the host."""
    from repro_torch.serving import (FaultPlan, LLMServer, OverloadPolicy,
                                     Request, SamplingParams)
    server = LLMServer(params, cfg, ext_config(
        job, prefix_cache=True, host_tier_blocks=96,
        overload=OverloadPolicy(enabled=True)), device=device, mesh=mesh,
        layout=layout)
    cl = server.cluster
    inj = cl.install_faults(FaultPlan.from_seed(
        ph["plan_seed"], n_steps=30, n_instances=4, n_events=6))
    sp = SamplingParams(max_new_tokens=ph["n_new"])
    prompts = make_prompts(cfg, (ph["plan"],) + tuple(ph["span"][1:]), 43)
    reqs = [Request(prompt=p, sampling=sp) for p in prompts]
    ext_serve(server, reqs)
    for i in cl.engines:
        if i not in cl._dead:
            cl.prefix_cache.evict_device(i, 10 ** 6)
    again = Request(prompt=list(prompts[1]), sampling=sp)
    ext_serve(server, [again])
    max_replays = cl.config.faults.max_replays_per_request
    check_done_or_replay_failed(reqs + [again], max_replays)
    fired = [ev.kind for ev in inj.fired]
    out = dict(ext_summary(cl, reqs + [again]), fired=fired)
    return out, {"planned": [(ev.step, ev.kind, ev.target)
                             for ev in inj.plan.events]}


EXT_CASES = {"host_tier": ext_host_tier, "overload": ext_overload,
             "kill": ext_kill, "fault_plan": ext_fault_plan}


def ext_job(params, cfg, device, job, ph, mesh=None, layout=None):
    """Every extension scenario once, counted: (summaries, measures)."""
    from repro_torch.kernels import ops
    summ, meas = {}, {}
    for name, fn in EXT_CASES.items():
        if device.type == "cuda":
            reset_peak_memory()
        with CollectiveSpy() as coll:
            ops.reset_counts()
            t0 = time.perf_counter()
            summ[name], meas[name] = fn(params, cfg, device, job, ph, mesh,
                                        layout)
            sync(device)
            meas[name]["phase_s"] = time.perf_counter() - t0
            meas[name]["counts"] = ops.counts()
        meas[name]["collective_calls"] = coll.calls
        meas[name]["collective_s"] = coll.seconds
        if device.type == "cuda":
            meas[name]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        release_memory()
    return summ, meas


def ext_check(runs, key, device, layers, single=None, params32=None,
              cfg32=None):
    """The gates of the extension runs over every process: equal
    summaries in every process (streams, states, counters), every
    request finished (or failed past its replay budget, as in one
    process), no slab reallocated, the mesh path's rank kernels and no
    single-rank one; at float32, the summaries equal the single-process
    scenario's and every stream the dense oracle's greedy argmax."""
    jobs = [run[key] for run in runs]
    s0, m0 = jobs[0]
    for j, (s, _) in enumerate(jobs):
        if s != s0:
            bad = [c for c in s0 if s[c] != s0[c]]
            raise AssertionError(f"{key}: process {j} differs in {bad}")
    rep = {}
    for name, summ in s0.items():
        if summ["copies"]:
            raise AssertionError(f"{key} {name}: a slab was reallocated")
        if single is not None and summ != single[name]:
            bad = [k for k in summ if summ[k] != single[name][k]]
            raise AssertionError(f"{key} {name}: the mesh differs from one "
                                 f"process in {bad}")
        counts = [m[name]["counts"] for _, m in jobs]
        for c in counts:
            check_counts(c, ("paged_micro_attention_ranks",
                             "paged_prefill_attention_ranks"), device)
            for n in ("paged_micro_attention", "paged_prefill_attention"):
                if served(c, n, device):
                    raise AssertionError(f"{key} {name}: {n} ran")
        flips = 0
        if params32 is not None:
            for prompt, out, st in zip(summ["prompts"], summ["outs"],
                                       summ["states"]):
                if st != "FINISHED":
                    continue
                oracle = oracle_logits(params32, cfg32, prompt, out, device)
                flips += sum(int(torch.argmax(lg)) != t
                             for lg, t in zip(oracle, out))
            if flips:
                raise AssertionError(f"{key} {name}: {flips} tokens differ "
                                     f"from the dense oracle")
        steps = [max(1, served(m[name]["counts"],
                              "paged_micro_attention_ranks", device)
                     / layers) for _, m in jobs]
        rep[name] = {
            **{k: summ[k] for k in ("states", "replays", "preemptions",
                                    "fault_stats", "preempt", "host",
                                    "preempt_tier", "stager", "dead")},
            "fired": summ.get("fired"),
            "oracle_checked": params32 is not None,
            "per_process": [{k: v for k, v in m[name].items()
                             if k != "counts"} |
                            {"launches": {n: m[name]["counts"][n]["launches"]
                                          for n in m[name]["counts"]},
                             "collectives_per_decode_step":
                             sum(m[name]["collective_calls"].values()) / st}
                            for (_, m), st in zip(jobs, steps)]}
    return rep


def flash_long_case(name, B, S, H, K, D, dtype, device):
    """The flash-prefill kernel at the ServeLayout prefill's causal shape,
    against its plain version applied to one (batch, query head) slice
    at a time (the whole plain score matrix would take B * H * S * S *
    4 bytes), timed, with ``sdpa`` as the yardstick."""
    from repro_torch.kernels.flash_prefill import flash_prefill_plain
    from repro_torch.kernels.ops import flash_prefill
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(
        name.encode()))
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    scale = D ** -0.5
    G = H // K
    cut = [(slice(b, b + 1), slice(h, h + 1), slice(h // G, h // G + 1))
           for b in range(B) for h in range(H)]

    def plain_slice(b, h, kv):
        return flash_prefill_plain(q[b, :, h].contiguous(),
                                   k[b, :, kv].contiguous(),
                                   v[b, :, kv].contiguous(), scale=scale)

    def plain():
        out = torch.empty_like(q)
        for b, h, kv in cut:
            out[b, :, h] = plain_slice(b, h, kv)
        return out
    got = flash_prefill(q, k, v)
    sync(device)
    err, bad = 0.0, 0
    for b, h, kv in cut:
        w = plain_slice(b, h, kv).float()
        d = (got[b, :, h].float() - w).abs()
        err = max(err, float(d.max()))
        bad += int((d > TOL + FLASH_RTOL[dtype] * w.abs()).sum())
    if bad or torch.isnan(got).any():
        raise AssertionError(f"{name}: kernel disagrees at {bad} elements "
                             f"(max |diff| {err:.3g})")
    row = {"case": name, "dtype": str(dtype), "B": B, "S": S, "H": H,
           "K": K, "D": D, "window": 0, "max_abs_err": err,
           "tol": f"{TOL} + {FLASH_RTOL[dtype]:.3g}*|plain|"}
    if device.type != "cuda":
        return row
    itemsize = q.element_size()
    pairs = B * live_pairs(S, 0)
    flops = 4 * H * D * pairs
    nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    row["live_pairs"] = pairs
    row["ms"] = time_ms(lambda: flash_prefill(q, k, v), iters=5, warmup=1)
    row["graph_ms"] = device_ms(lambda: flash_prefill(q, k, v), iters=3,
                                replays=2)
    row["plain_ms"] = time_ms(plain, iters=1, warmup=0)
    row["plain_note"] = "the plain version over B * H (batch, head) slices"
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qq, kk, vv, is_causal=True, enable_gqa=True)
    row["library_ms"] = time_ms(library, iters=5, warmup=1)
    row["library_graph_ms"] = device_ms(library, iters=3, replays=2)
    row["library_kernels"] = cuda_kernel_names(library)[:3]
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "elapsed_s": {}}

    def mark(phase):
        """Seconds since the start, at the end of ``phase``."""
        report["elapsed_s"][phase] = time.perf_counter() - t_start

    t0 = time.perf_counter()
    libs = build.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(libs)} kernels in {report['build_s']:.1f} s "
          f"({build.build_dir()})", flush=True)
    for name in libs:
        log = (build.build_dir() / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("Compiling entry", "registers",
                                           "spill")):
                    print(f"  ptxas {name}: {line.strip()}")

    cfg = get_config("qwen3-0.6b")
    config = serving_config()
    report["plans"] = kernel_plans(config.prefill_chunk)
    for name, plan in report["plans"].items():
        print(f"plan {name}: {json.dumps(plan)}", flush=True)
    rows, main = kernel_phase(device, config.prefill_chunk)
    report["kernel_cases"] = rows
    for r in rows:
        extra = "".join(f" {k}={r[k]:.4g}" for k in
                        ("ms", "graph_ms", "nr_launch_ms",
                         "nr_launch_graph_ms", "plain_ms", "library_ms",
                         "library_graph_ms", "bound_ms")
                        if k in r)
        if "library_kernels" in r:
            extra += f" library_kernels={r['library_kernels'][:3]}"
        print(f"kernel {r['case']}: max_abs_err={r['max_abs_err']:.3g} "
              f"tol={r['tol']}{extra}", flush=True)
    mark("kernels")

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    torch.cuda.synchronize()
    serving = serving_phase(params, cfg, device, (4000, 600, 300), 32)
    report["serving"] = serving
    print("serving: " + json.dumps({k: v for k, v in serving.items()
                                    if k != "counts"}), flush=True)
    report["trace"] = trace_phase(params, cfg, device, config,
                                  (4000, 600, 300), 32,
                                  config.prefill_chunk)
    print("trace: " + json.dumps(report["trace"]), flush=True)
    mark("qwen3")
    gserving = global_serving_phase(params, cfg, device, (4000, 600, 300),
                                    32)
    report["global_serving"] = gserving
    print("global serving: " + json.dumps(
        {k: v for k, v in gserving.items() if k != "counts"}), flush=True)
    mark("qwen3_global")
    for gp in (False, True):
        key = "bs128_global" if gp else "bs128"
        report[key] = bs128_phase(params, cfg, device, (4000, 600, 300), 32,
                                  global_pool=gp)
        print(f"{key.replace('_', ' ')}: " + json.dumps(
            {k: v for k, v in report[key].items() if k != "counts"}),
            flush=True)
    mark("qwen3_bs128")
    # The extensions' phases at QWEN3_EXT_LAYERS (views of the weights).
    ext, ecfg = first_layers(params, cfg, QWEN3_EXT_LAYERS)
    for gp in (False, True):
        key = "hierarchy_global" if gp else "hierarchy"
        report[key] = hierarchy_phase(ext, ecfg, device, gp)
        print(f"{key.replace('_', ' ')}: " + json.dumps(
            {k: v for k, v in report[key].items() if k != "counts"}),
            flush=True)
    mark("qwen3_hierarchy")
    for gp in (False, True):
        key = "overload_global" if gp else "overload"
        report[key] = overload_phase(ext, ecfg, device, gp)
        print(f"{key.replace('_', ' ')}: " + json.dumps(
            {k: v for k, v in report[key].items() if k != "counts"}),
            flush=True)
    mark("qwen3_overload")
    for gp in (False, True):
        key = "faults_global" if gp else "faults"
        report[key] = fault_phase(ext, ecfg, device, gp, (4000, 600, 300))
        print(f"{key.replace('_', ' ')}: " + json.dumps(
            {k: v for k, v in report[key].items() if k != "counts"}),
            flush=True)
        key = "fault_plan_global" if gp else "fault_plan"
        report[key] = fault_plan_phase(ext, ecfg, device, gp)
        print(f"{key.replace('_', ' ')}: " + json.dumps(report[key]),
              flush=True)
    mark("qwen3_faults")
    del ext
    # The mesh groups serve qwen3 at half depth (14 layers): their gloo
    # steps are host-bound, and the placement job shares their time.
    report["mesh"] = mesh_phase(params, cfg, device, (4000, 600, 300), 32,
                                layers=MESH_SERVE_LAYERS)
    print("mesh: " + json.dumps(report["mesh"]), flush=True)
    mark("qwen3_mesh")
    check_released(report, "qwen3-0.6b servers", limit=(512 << 20)
                   + sum(t.numel() * t.element_size()
                         for t in tree_leaves(params)))
    report["serve_layout"] = serve_layout_phase(params, cfg, device)
    print("serve layout: " + json.dumps(report["serve_layout"]), flush=True)
    report["launcher"] = launcher_phase(device)
    print("launcher: " + json.dumps(report["launcher"]), flush=True)
    mark("qwen3_serve_layout")
    del params
    check_released(report, "qwen3-0.6b")

    hcfg = get_config("recurrentgemma-9b")
    hcfg_s = dataclasses.replace(hcfg, num_layers=HYBRID_SERVE_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    hparams = init_params(hcfg_s, gen, device)
    torch.cuda.synchronize()
    report["hybrid_init_s"] = time.perf_counter() - t0
    hybrid = hybrid_serving_phase(hparams, hcfg_s, device,
                                  (6000, 3000, 1000, 400), 32)
    report["hybrid_serving"] = hybrid
    print("hybrid serving: " + json.dumps(
        {k: v for k, v in hybrid.items() if k != "counts"}), flush=True)
    report["hybrid_trace"] = trace_phase(hparams, hcfg_s, device,
                                         hybrid_serving_config(),
                                         (3000, 1000, 400), 32, 6000)
    print("hybrid trace: " + json.dumps(report["hybrid_trace"]), flush=True)
    mark("hybrid")
    del hparams
    check_released(report, "recurrentgemma-9b")

    mcfg = get_config("qwen2-moe-a2.7b")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    mparams = init_params(mcfg, gen, device)
    torch.cuda.synchronize()
    report["moe_init_s"] = time.perf_counter() - t0
    moe = global_serving_phase(mparams, mcfg, device, (4000, 600, 300), 32)
    report["moe_serving"] = moe
    print("moe serving: " + json.dumps(
        {k: v for k, v in moe.items() if k != "counts"}), flush=True)
    report["moe_trace"] = trace_phase(
        mparams, mcfg, device, serving_config().replace(global_pool=True),
        (4000, 600, 300), 32, config.prefill_chunk)
    print("moe trace: " + json.dumps(report["moe_trace"]), flush=True)
    mark("moe")
    del mparams
    check_released(report, "qwen2-moe-a2.7b")

    xcfg = get_config("xlstm-350m")
    xcfg_s = dataclasses.replace(xcfg, num_layers=SSM_SERVE_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    xparams = init_params(xcfg_s, gen, device)
    torch.cuda.synchronize()
    report["ssm_init_s"] = time.perf_counter() - t0
    report["ssm_param_bytes"] = sum(
        t.numel() * t.element_size() for t in tree_leaves(xparams))
    ssm = ssm_serving_phase(xparams, xcfg_s, device, (1024, 512, 256, 64),
                            32)
    report["ssm_serving"] = ssm
    print("ssm serving: " + json.dumps(
        {k: v for k, v in ssm.items() if k != "counts"}), flush=True)
    report["ssm_trace"] = trace_phase(xparams, xcfg_s, device,
                                      ssm_serving_config(), (512, 256, 64),
                                      32, 64, then=ssm_owner_crash)
    print("ssm trace: " + json.dumps(report["ssm_trace"]), flush=True)
    mark("ssm")
    del xparams
    check_released(report, "xlstm-350m")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    params32 = init_params(cfg32, gen, device)
    parity = parity_phase(params32, cfg32, device, 1500, 24)
    report["parity"] = parity
    print("parity: " + json.dumps(parity), flush=True)
    gparity = parity_phase(params32, cfg32, device, 1500, 24,
                           global_pool=True)
    report["global_parity"] = gparity
    print("global parity: " + json.dumps(gparity), flush=True)
    for gp in (False, True):
        key = "hierarchy_parity_global" if gp else "hierarchy_parity"
        report[key] = hierarchy_parity_phase(params32, cfg32, device,
                                             global_pool=gp)
        print(f"{key.replace('_', ' ')}: " + json.dumps(report[key]),
              flush=True)
    for gp in (False, True):
        key = "fault_parity_global" if gp else "fault_parity"
        report[key] = fault_parity_phase(params32, cfg32, device,
                                         global_pool=gp)
        print(f"{key.replace('_', ' ')}: " + json.dumps(report[key]),
              flush=True)
    mark("qwen3_parity")
    del params32
    check_released(report, "qwen3-0.6b float32")

    # MoE at full width, depth cut to 4 layers; a pool of 48 blocks a
    # rank makes the prompt stripe over both creditors.
    mcfg32 = dataclasses.replace(mcfg, dtype="float32", num_layers=4)
    gen = torch.Generator(device=device).manual_seed(0)
    mparams32 = init_params(mcfg32, gen, device)
    mparity = parity_phase(mparams32, mcfg32, device, 1500, 24,
                           global_pool=True, pool_blocks=48)
    report["moe_parity"] = mparity
    print("moe parity: " + json.dumps(mparity), flush=True)
    mark("moe_parity")
    del mparams32
    check_released(report, "qwen2-moe-a2.7b float32")

    # 128-token blocks, float32 at 4 layers: the creditor-spanning
    # prompt of the serving phase (4,000 tokens, seed 7) over pools of 20
    # blocks, in both pool modes, greedy-equal to the dense oracle.
    cfg4 = dataclasses.replace(cfg32, num_layers=4)
    gen = torch.Generator(device=device).manual_seed(0)
    params4 = init_params(cfg4, gen, device)
    for gp in (False, True):
        key = "bs128_parity_global" if gp else "bs128_parity"
        report[key] = parity_phase(params4, cfg4, device, 4000, 24,
                                   global_pool=gp, pool_blocks=20, seed=7,
                                   block_size=128, max_local_len=1024)
        print(f"{key.replace('_', ' ')}: " + json.dumps(report[key]),
              flush=True)
    mark("bs128_parity")
    del params4
    check_released(report, "qwen3-0.6b float32 4 layers")

    hcfg32 = dataclasses.replace(hcfg, dtype="float32", num_layers=5)
    gen = torch.Generator(device=device).manual_seed(0)
    hparams32 = init_params(hcfg32, gen, device)
    hparity = hybrid_parity_phase(hparams32, hcfg32, device, 3000, 24)
    report["hybrid_parity"] = hparity
    print("hybrid parity: " + json.dumps(hparity), flush=True)
    mark("hybrid_parity")
    del hparams32
    check_released(report, "recurrentgemma-9b float32")

    xcfg32 = dataclasses.replace(xcfg, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    xparams32 = init_params(xcfg32, gen, device)
    xparity = hybrid_parity_phase(xparams32, xcfg32, device, 1024, 16)
    report["ssm_parity"] = xparity
    print("ssm parity: " + json.dumps(xparity), flush=True)
    mark("ssm_parity")
    del xparams32
    check_released(report, "xlstm-350m float32")

    for key, arch, kw in (
            ("train_dense", "qwen3-0.6b", TRAIN_DENSE),
            ("train_moe", "qwen2-moe-a2.7b", TRAIN_MOE)):
        report[key] = train_phase(arch, device, **kw)
        print(f"{key.replace('_', ' ')}: " + json.dumps(report[key]),
              flush=True)
        mark(key)
        check_released(report, f"{arch} training")
    report["train_parity"] = []
    for arch, layers, tkw, (batch, seq) in TRAIN_PARITY:
        report["train_parity"].append(
            train_parity_phase(device, arch, layers, tkw, seq=seq,
                               batch=batch))
        print("train parity: " + json.dumps(report["train_parity"][-1]),
              flush=True)
        check_released(report, f"{arch} float32 training")
    mark("train_parity")
    report["train_restart"] = train_restart_phase(device)
    print("train restart: " + json.dumps(report["train_restart"]),
          flush=True)
    mark("train_restart")
    check_released(report, "qwen3-0.6b restart")

    # Launches: each kernel's count from the run of ITS main path: the
    # single-rank paged kernels from qwen3's per-instance phase, the rank
    # forms from qwen2-moe's global phase, flash from the hybrid phase.
    launches = {name: serving["counts"][name]["launches"]
                for name in ("paged_micro_attention",
                             "paged_prefill_attention")}
    # The rank forms also run in every process of the mesh phase (its
    # served main path, both layouts): each process's own count, apart.
    mesh_launches = {}
    for name in ("paged_micro_attention_ranks",
                 "paged_prefill_attention_ranks"):
        launches[name] = moe["counts"][name]["launches"]
        mesh_launches[name] = [
            pp["launches"][name] for lay in report["mesh"]["layouts"].values()
            for pp in lay["per_process"]]
    launches["flash_prefill"] = hybrid["counts"]["flash_prefill"]["launches"]
    # The serving extensions under a mesh (W = 2, bf16): each process's
    # rank-form launches per scenario; the placed state steps' flash
    # launches per placed recurrentgemma prefill.
    ext_launches = {name: {case: [pp["launches"][name]
                                  for pp in rep["per_process"]]
                           for case, rep in report["mesh"]["ext"].items()}
                    for name in ("paged_micro_attention_ranks",
                                 "paged_prefill_attention_ranks")}
    state_flash = [{"mesh": r["mesh"], "layers": r["layers"],
                    "heads": r["flash_heads"],
                    "launches": r["flash_launches"]}
                   for lay in report["mesh"]["layouts"].values()
                   for r in lay["state"]["runs"]
                   if r["arch"] == "recurrentgemma-9b"]
    # The ServeLayout path's launches (phase 2) and its shapes' rows.
    sl = report["serve_layout"]

    def sl_rows(*keys):
        return {main[k]["case"]: {f: main[k][f] for f in (
            "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms") if f in main[k]} for k in keys}
    sl_extra = {
        "paged_micro_attention_ranks": {
            "serve_layout_launches": {
                f"{part}_{sched}": sl_part[sched]["rank_launches"]
                for part, sl_part in (("decode_32k", sl),
                                      ("long_500k", sl["long_500k"]))
                for sched in (("decode_write", "decode_opt")
                              if part == "decode_32k" else
                              ("write", "opt"))},
            "serve_layout_rows": sl_rows("decode_ranks_long500k",
                                         "decode_ranks_R2")},
        "flash_prefill": {
            "serve_layout_launches": {
                f"prefill_32k_{n}": sl[f"prefill_{n}"]["flash_launches"]
                for n in ("full", "ragged")},
            "serve_layout_rows": sl_rows("flash_serve_prefill")}}
    # 128-token blocks: the prefill kernels' rows (sub-block views) and
    # their launches in the bs-128 served runs, each pool mode's own.
    bs128_extra = {
        "paged_prefill_attention": {
            "bs128_launches": report["bs128"]["counts"][
                "paged_prefill_attention"]["launches"],
            "bs128_rows": sl_rows("prefill_bs128")},
        "paged_prefill_attention_ranks": {
            "bs128_launches": report["bs128_global"]["counts"][
                "paged_prefill_attention_ranks"]["launches"],
            "bs128_rows": sl_rows("prefill_ranks_bs128")}}
    sources = {"decode": ("paged_micro_attention",
                          "src/repro_torch/csrc/micro_attn_decode.cu",
                          "src/repro/kernels/micro_attn_decode.py:86"),
               "prefill": ("paged_prefill_attention",
                           "src/repro_torch/csrc/micro_attn_prefill.cu",
                           "src/repro/kernels/micro_attn_prefill.py:89"),
               "decode_ranks": ("paged_micro_attention_ranks",
                                "src/repro_torch/csrc/micro_attn_decode.cu",
                                "src/repro/kernels/ops.py:182"),
               "prefill_ranks": ("paged_prefill_attention_ranks",
                                 "src/repro_torch/csrc/micro_attn_prefill.cu",
                                 "src/repro/kernels/ops.py:198"),
               "flash": ("flash_prefill",
                         "src/repro_torch/csrc/flash_prefill.cu",
                         "src/repro/kernels/flash_prefill.py:77")}
    kernels = []
    for key, (name, src, replaces) in sources.items():
        r = main[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        kernels[-1].update({k: r[k] for k in ("graph_ms", "library_graph_ms",
                                              "nr_launch_ms",
                                              "nr_launch_graph_ms")
                            if k in r})
        if name in mesh_launches:
            kernels[-1]["mesh_launches"] = mesh_launches[name]
            kernels[-1]["mesh_ext_launches"] = ext_launches[name]
        if name == "flash_prefill":
            kernels[-1]["placed_state_launches"] = state_flash
        if name in sl_extra:
            kernels[-1].update(sl_extra[name])
        if name in bs128_extra:
            kernels[-1].update(bs128_extra[name])
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_start
    print(f"script: {report['script_s']:.1f} s (elapsed at the end of "
          f"each phase: {json.dumps(report['elapsed_s'])})", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
