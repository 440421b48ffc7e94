#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out report.json]

Phases, each of which fails the run (non-zero exit) if anything is off:

1. Kernels. Build the hand-written CUDA kernels from ``src/repro_torch/
   csrc`` (one ``nvcc`` per source, in parallel), then hold each against
   its plain PyTorch version on the card — in bf16 and fp32, at the
   serving path's shapes (H=16, K=8, D=128, bs=16; decode R=8 over ~4k
   tokens each; a prefill chunk over a ~3k-token prefix) and on edge
   cases (empty table, partial tails, -1 padding, MHA, MQA, the largest
   head dim and block size). Times the kernel, the plain version and
   ``scaled_dot_product_attention`` over the same KV gathered contiguous
   (a yardstick the port never calls), next to the least time the card
   could take for the same bytes and FLOPs (data-sheet peaks).
2. Serving. ``LLMServer`` serves qwen3-0.6b at full width (28 layers,
   bf16, seeded random weights) with three instances on the card; the
   longest prompt stripes its prefix across two creditors at admission
   and moves KV reactively during decode. Every request must finish, both
   kernels' launch counters must be > 0 and no step may run a plain
   version. Reports tokens/s, TTFT, TBT, KV moved and peak memory, for
   this first (cold) run and for warm repeats of the same workload.
   A short traced window of a warm server (one more prompt's admission
   chunk and a few decode steps, ``torch.profiler``) then reports the
   device's busy share of that window and the kernels with the most
   device time.
3. Parity. The same model in float32: a creditor-spanning request served
   through ``LLMServer`` must give the dense oracle's (``prefill`` +
   ``decode_step``) greedy stream, and its per-step logits must match the
   oracle's teacher-forced logits within the stated tolerance.

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
TOL = 1e-4      # kernel vs plain: both float32 math on the same inputs
PARITY_RTOL = 1e-3  # served vs oracle logits, float32, |diff| / max|logit|
WARM_REPEATS = 3    # untraced repeats of the serving workload
TRACE_STEPS = 6     # server steps in the traced window


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls,
    measured with CUDA events after ``warmup`` calls."""
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
                empty_rows=0, pad=3, timed=False):
    """The decode wrapper the model calls (``ops``, default scale) on
    CUDA tensors against the kernel's plain version."""
    from repro_torch.core.distattn import gather_local_kv
    from repro_torch.kernels.micro_attn_decode import (
        paged_micro_attention_plain)
    from repro_torch.kernels.ops import paged_micro_attention
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    gen = torch.Generator(device=device).manual_seed(1)
    nblks = [0 if r < empty_rows else ctx_blocks for r in range(R)]
    NB = sum(nblks) + 4
    pk, pv = make_pool(gen, NB, bs, K, D, dtype, device)
    table, tail = make_tables(rng, R, ctx_blocks + pad, nblks, NB, bs)
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
        row["plain_ms"] = time_ms(lambda: paged_micro_attention_plain(
            q, pk, pv, tb, tl, scale=scale), iters=5)
        k, v = gather_local_kv(pk, pv, tb)            # [R, S_pad, K, D]
        kk = k.transpose(1, 2).contiguous()
        vv = v.transpose(1, 2).contiguous()
        qq = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qq, kk, vv,
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
        row["plain_ms"] = time_ms(lambda: paged_prefill_attention_plain(
            q, pk, pv, tb, tl, scale=scale), iters=5)
        k, v = gather_local_kv(pk, pv, tb[None])
        kk = k.transpose(1, 2).contiguous()            # [1, K, S_pad, D]
        vv = v.transpose(1, 2).contiguous()
        qq = q.transpose(0, 1)[None].contiguous()      # [1, H, C, D]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qq, kk, vv,
                                                 enable_gqa=True))
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


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
        rows.append(prefill_case(f"prefill-empty-{dt}", 37, 16, 8, 128, 16,
                                 0, dt, device))
        rows.append(prefill_case(f"prefill-mha-{dt}", 40, 16, 16, 128, 16,
                                 9, dt, device))
        rows.append(prefill_case(f"prefill-mqa-{dt}", 13, 16, 1, 128, 16, 9,
                                 dt, device))
        rows.append(prefill_case(f"prefill-d256-bs64-{dt}", 33, 8, 2, 256,
                                 64, 5, dt, device))
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
    for name, c in counts.items():
        served_by = c["launches"] if device.type == "cuda" \
            else c["plain_calls"]
        if served_by <= 0:
            raise AssertionError(f"{name}: never ran on the serving path")
        if device.type == "cuda" and c["plain_calls"]:
            raise AssertionError(f"{name}: {c['plain_calls']} plain-version "
                                 f"calls on the serving path")
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


def trace_phase(params, cfg, device, prompt_lens, n_new, top=12):
    """A short traced window of a warm server: once the workload is
    admitted and decoding, one more prompt of one prefill chunk arrives
    and the next ``TRACE_STEPS`` server steps (its admission and that
    many decode steps) run under ``torch.profiler``. Reports the device's busy
    time as a share of the window's wall time, the kernels that took most
    device time, and each kernel's launches in the window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.serving import LLMServer, SamplingParams
    config = serving_config()
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
    extra = make_prompts(cfg, [config.prefill_chunk], 13)[0]
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
    return {"steps": TRACE_STEPS, "late_prompt_len": len(extra),
            "late_tokens": int(late.metrics["n_tokens"]),
            "launches": launches, "wall_s": wall,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / 1e3 / wall,
            "top_kernels": [{"name": e.key[:90],
                             "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in events[:top]]}


def oracle_logits(params, cfg, prompt, forced, device):
    """Dense oracle: prefill + decode_step, teacher-forced on ``forced``."""
    from repro_torch.models.model import decode_step
    from repro_torch.models.prefill import prefill
    tokens = torch.tensor([prompt], device=device)
    lg, state = prefill(params, cfg, tokens,
                        max_len=len(prompt) + len(forced) + 2)
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
    return {"prompt_len": prompt_len, "n_new": n_new, "tokens_equal": True,
            "max_rel_logit_err": worst, "rtol": PARITY_RTOL,
            "creditors_at_admission": max(spy.stripes),
            "moves_during_decode": moves_executed(server)}


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
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    cfg = get_config("qwen3-0.6b")
    config = serving_config()
    rows, main = kernel_phase(device, config.prefill_chunk)
    report["kernel_cases"] = rows
    for r in rows:
        extra = "".join(f" {k}={r[k]:.4g}" for k in
                        ("ms", "plain_ms", "library_ms", "bound_ms")
                        if k in r)
        print(f"kernel {r['case']}: max_abs_err={r['max_abs_err']:.3g} "
              f"tol={r['tol']}{extra}", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    torch.cuda.synchronize()
    serving = serving_phase(params, cfg, device, (4000, 600, 300), 32)
    report["serving"] = serving
    print("serving: " + json.dumps({k: v for k, v in serving.items()
                                    if k != "counts"}), flush=True)
    report["trace"] = trace_phase(params, cfg, device, (4000, 600, 300), 32)
    print("trace: " + json.dumps(report["trace"]), flush=True)
    del params
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    params32 = init_params(cfg32, gen, device)
    parity = parity_phase(params32, cfg32, device, 1500, 24)
    report["parity"] = parity
    print("parity: " + json.dumps(parity), flush=True)

    counts = serving["counts"]
    sources = {"decode": ("paged_micro_attention",
                          "src/repro_torch/csrc/micro_attn_decode.cu",
                          "src/repro/kernels/micro_attn_decode.py:86"),
               "prefill": ("paged_prefill_attention",
                           "src/repro_torch/csrc/micro_attn_prefill.cu",
                           "src/repro/kernels/micro_attn_prefill.py:89")}
    kernels = []
    for key, (name, src, replaces) in sources.items():
        r = main[key]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": counts[name]["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    report["kernels"] = kernels
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
