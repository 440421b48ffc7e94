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
   that serve the yardstick call (which ``sdpa`` backend).
2. Serving, qwen3-0.6b. ``LLMServer`` serves it at full width (28
   layers, bf16, seeded random weights) with three instances on the
   card; the longest prompt stripes its prefix across two creditors at
   admission and moves KV reactively during decode. Every request must
   finish, both paged kernels' launch counters must be > 0 and no step
   may run a plain version. Reports tokens/s, TTFT, TBT, KV moved and
   peak memory, for this first (cold) run and for warm repeats of the
   same workload. A short traced window of a warm server (one more
   prompt's admission chunk and a few decode steps, ``torch.profiler``)
   then reports the device's busy share of that window and the kernels
   with the most device time.
3. Serving, recurrentgemma-9b. ``LLMServer`` serves the hybrid model at
   full width (38 layers: 26 RG-LRU, 12 local-attention; bf16, seeded
   random weights) with two non-pooled instances: prompts of 6,000,
   3,000, 1,000 and 400 tokens, two of them longer than the 2,048-token
   window. Every request must finish, the flash-prefill kernel must
   launch exactly once per attention layer per admission, and no plain
   version may run. A traced window of a warm hybrid server (a late
   6,000-token admission and a few decode steps) reports the device's
   busy share and the kernels with the most device time. Each traced
   window also reports the device time of the port's own kernels.
4. Parity, float32. qwen3-0.6b: a creditor-spanning request served
   through ``LLMServer``; recurrentgemma-9b at full width and 5 layers
   (one (rglru, rglru, attn) group plus two leftover RG-LRU layers): a
   3,000-token prompt, past the window. Each must give the dense
   oracle's (``prefill`` with the plain "xla" core + ``decode_step``)
   greedy stream, and its per-step logits must match the oracle's
   teacher-forced logits within the stated tolerance.

Prints the card's name and power limit, then per-phase lines, then one
JSON line with every kernel's numbers, then the card's name and power
limit again exactly as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without
CUDA, and when run outside the repository (it needs ``src/repro_torch``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
WARM_REPEATS = 3    # untraced repeats of the serving workload
TRACE_STEPS = 6     # server steps in the traced window
# Names of the port's CUDA kernels (csrc/), as a traced window lists them.
PORT_KERNEL_SYMBOLS = ("paged_decode_kernel", "paged_prefill",
                       "flash_prefill")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
                 pad=3, timed=False):
    """The prefill-chunk wrapper the model calls (``ops``, default
    scale) on CUDA tensors against the kernel's plain version."""
    from repro_torch.core.distattn import gather_local_kv
    from repro_torch.kernels.micro_attn_prefill import (
        paged_prefill_attention_plain)
    from repro_torch.kernels.ops import paged_prefill_attention
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    gen = torch.Generator(device=device).manual_seed(2)
    NB = ctx_blocks + 4
    pk, pv = make_pool(gen, NB, bs, K, D, dtype, device)
    table, tail = make_tables(rng, 1, ctx_blocks + pad, [ctx_blocks], NB, bs)
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


def check_counts(counts, path_kernels, device):
    """Every kernel of the path ran on it (launches on the card, plain
    twins on the CPU); on the card no plain version ran at all."""
    for name in path_kernels:
        c = counts[name]
        served_by = c["launches"] if device.type == "cuda" \
            else c["plain_calls"]
        if served_by <= 0:
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
        torch.cuda.reset_peak_memory_stats()
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
    report = {
        "prompt_lens": list(prompt_lens), "n_new": n_new,
        "creditors_per_admission": stripes, "moves_during_decode": moves,
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


def trace_phase(params, cfg, device, config, prompt_lens, n_new, late_len,
                top=12):
    """A short traced window of a warm server: once the workload is
    admitted and decoding, one more prompt of ``late_len`` tokens arrives
    and the next ``TRACE_STEPS`` server steps (its admission and that
    many decode steps) run under ``torch.profiler``. Reports the device's busy
    time as a share of the window's wall time, the kernels that took most
    device time, and each kernel's launches in the window."""
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
    return {"steps": TRACE_STEPS, "late_prompt_len": len(extra),
            "late_tokens": int(late.metrics["n_tokens"]),
            "launches": launches, "wall_s": wall,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / wall,
            "port_kernel_ms": port_ms,
            "top_kernels": [{"name": e.key[:90],
                             "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in events[:top]]}


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
    torch.cuda.reset_peak_memory_stats()
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


def parity_phase(params, cfg, device, prompt_len, n_new):
    """float32: served greedy stream == oracle, per-step logits close."""
    import repro_torch.serving.engine as engine_mod
    prompt = make_prompts(cfg, [prompt_len], 11)[0]
    config = serving_config().replace(pool_blocks=96, max_local_len=512)
    served = []
    orig_decode = engine_mod.decode_step_paged
    orig_chunk = engine_mod.prefill_chunk_paged

    def spy_decode(*a, **k):
        out = orig_decode(*a, **k)
        served.append(out[0][0].float().clone())   # slot 0: one request
        return out

    def spy_chunk(*a, **k):
        out = orig_chunk(*a, **k)
        served[:] = [out[0][0].float().clone()]    # keep the last chunk's
        return out
    engine_mod.decode_step_paged = spy_decode
    engine_mod.prefill_chunk_paged = spy_chunk
    try:
        with AdmissionSpy() as spy:
            handles, server, _ = serve(params, cfg, config, [prompt], n_new,
                                       device)
    finally:
        engine_mod.decode_step_paged = orig_decode
        engine_mod.prefill_chunk_paged = orig_chunk
    out = handles[0].result()
    if max(spy.stripes) < 1:
        raise AssertionError("the parity request did not span a creditor")
    return {"prompt_len": prompt_len, "n_new": n_new,
            **check_parity(params, cfg, device, prompt, out, served),
            "creditors_at_admission": max(spy.stripes),
            "moves_during_decode": moves_executed(server)}


def check_parity(params, cfg, device, prompt, out, served):
    """The served greedy stream ``out`` == the dense oracle's, and the
    served per-step logits ``served`` within PARITY_RTOL of its
    teacher-forced logits."""
    ref = oracle_logits(params, cfg, prompt, out, device)
    greedy = [int(lg.argmax()) for lg in ref]
    if greedy != out:
        raise AssertionError(f"served greedy stream differs from the dense "
                             f"oracle: {out} vs {greedy}")
    if len(served) != len(ref):
        raise AssertionError(f"{len(served)} served logits vs {len(ref)}")
    worst = 0.0
    for s, r in zip(served, ref):
        worst = max(worst, ((s - r).abs().max() / r.abs().max()).item())
    if worst > PARITY_RTOL:
        raise AssertionError(f"served logits differ from the oracle by "
                             f"{worst:.3g} (relative) > {PARITY_RTOL}")
    return {"tokens_equal": True, "max_rel_logit_err": worst,
            "rtol": PARITY_RTOL}


def hybrid_parity_phase(params, cfg, device, prompt_len, n_new):
    """float32 hybrid: served greedy stream == oracle past the window,
    per-step logits close."""
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
            **check_parity(params, cfg, device, prompt, out, served)}


# --------------------------------------------------------------------- #
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
              "cuda": torch.version.cuda}

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
                        ("ms", "graph_ms", "plain_ms", "library_ms",
                         "library_graph_ms", "bound_ms")
                        if k in r)
        if "library_kernels" in r:
            extra += f" library_kernels={r['library_kernels'][:3]}"
        print(f"kernel {r['case']}: max_abs_err={r['max_abs_err']:.3g} "
              f"tol={r['tol']}{extra}", flush=True)

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
    del params
    torch.cuda.empty_cache()

    hcfg = get_config("recurrentgemma-9b")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    hparams = init_params(hcfg, gen, device)
    torch.cuda.synchronize()
    report["hybrid_init_s"] = time.perf_counter() - t0
    hybrid = hybrid_serving_phase(hparams, hcfg, device,
                                  (6000, 3000, 1000, 400), 32)
    report["hybrid_serving"] = hybrid
    print("hybrid serving: " + json.dumps(
        {k: v for k, v in hybrid.items() if k != "counts"}), flush=True)
    report["hybrid_trace"] = trace_phase(hparams, hcfg, device,
                                         hybrid_serving_config(),
                                         (3000, 1000, 400), 32, 6000)
    print("hybrid trace: " + json.dumps(report["hybrid_trace"]), flush=True)
    del hparams
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    params32 = init_params(cfg32, gen, device)
    parity = parity_phase(params32, cfg32, device, 1500, 24)
    report["parity"] = parity
    print("parity: " + json.dumps(parity), flush=True)
    del params32
    torch.cuda.empty_cache()

    hcfg32 = dataclasses.replace(hcfg, dtype="float32", num_layers=5)
    gen = torch.Generator(device=device).manual_seed(0)
    hparams32 = init_params(hcfg32, gen, device)
    hparity = hybrid_parity_phase(hparams32, hcfg32, device, 3000, 24)
    report["hybrid_parity"] = hparity
    print("hybrid parity: " + json.dumps(hparity), flush=True)
    del hparams32
    torch.cuda.empty_cache()

    # Launches: each kernel's count from the run of ITS main path.
    launches = {name: c["launches"]
                for name, c in serving["counts"].items()
                if name != "flash_prefill"}
    launches["flash_prefill"] = hybrid["counts"]["flash_prefill"]["launches"]
    sources = {"decode": ("paged_micro_attention",
                          "src/repro_torch/csrc/micro_attn_decode.cu",
                          "src/repro/kernels/micro_attn_decode.py:86"),
               "prefill": ("paged_prefill_attention",
                           "src/repro_torch/csrc/micro_attn_prefill.cu",
                           "src/repro/kernels/micro_attn_prefill.py:89"),
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
        kernels[-1].update({k: r[k] for k in ("graph_ms", "library_graph_ms")
                            if k in r})
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_start
    print(f"script: {report['script_s']:.1f} s", flush=True)
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
