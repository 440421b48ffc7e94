#!/usr/bin/env python3
"""Per-instance against global-pool serving of the port on one card.

    python3 scripts/pool_mode_ab.py [--arch qwen3-0.6b] [--repeats 3]
                                    [--out report.json]

Serves ``chip_smoke.py``'s serving workload (prompts of 4,000, 600 and
300 tokens, 32 new tokens, ``chip_smoke.serving_config()``: three
instances, the longest prompt striped over two creditors) with seeded
random full-width weights, alternating the two pool modes (P G G P P G
...) so that both see the same card and neighbours, and reports each
run's TBT, TTFT and tokens/s. Then it traces five decode-only server
steps in each mode with ``torch.profiler`` (CPU and CUDA): wall time,
the device's busy time, the host's time inside PyTorch operators, the
operator count, and the operators with the most host time. Prints the
card's name and power limit first; needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def trace_decode(params, cfg, device, config, prompts, n_new, steps=5,
                 top=15):
    """Admit the workload, decode two steps, then trace ``steps``
    decode-only server steps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import LLMServer, SamplingParams
    server = LLMServer(params, cfg, config, device=device)
    handles = [server.submit(p, SamplingParams(max_new_tokens=n_new))
               for p in prompts]
    while not all(h.metrics["n_tokens"] >= 3 for h in handles):
        server.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            server.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    cpu.sort(key=lambda e: -e.self_cpu_time_total)
    return {"steps": steps, "wall_s": wall,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in cuda) / 1e3,
            "host_aten_self_ms": sum(e.self_cpu_time_total
                                     for e in cpu) / 1e3,
            "aten_calls": sum(e.count for e in cpu),
            "top_host_ops": [{"name": e.key, "self_ms":
                              e.self_cpu_time_total / 1e3,
                              "calls": e.count} for e in cpu[:top]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_mode_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    device = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cfg = get_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    prompts = cs.make_prompts(cfg, (4000, 600, 300), 7)
    modes = {"per_instance": cs.serving_config(),
             "global": cs.serving_config().replace(global_pool=True)}
    order = []
    for i in range(args.repeats):
        pair = ["per_instance", "global"]
        order += pair if i % 2 == 0 else pair[::-1]
    cs.serve(params, cfg, modes["global"], prompts, 32, device)   # warm-up
    runs = []
    for mode in order:
        handles, server, wall = cs.serve(params, cfg, modes[mode], prompts,
                                         32, device)
        cs.all_finished(handles)
        run = {"mode": mode, **cs.e2e_numbers(server, handles, wall),
               "decode_steps": cs.decode_steps(server),
               "host_gather_s": sum(e.stats.host_gather_s for e in
                                    server.cluster.engines.values())}
        runs.append(run)
        print("run: " + json.dumps(run), flush=True)
    traces = {}
    for mode, config in modes.items():
        traces[mode] = trace_decode(params, cfg, device, config, prompts, 32)
        print(f"trace {mode}: " + json.dumps(traces[mode]), flush=True)
    report = {"card": card, "arch": args.arch, "runs": runs,
              "traces": traces}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
