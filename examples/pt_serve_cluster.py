"""End-to-end run on the port: a 3-instance cluster behind the
LLMServer frontend — mixed short/long traffic with priorities and a
deadline, DistAttention spanning, a cancellation, and elastic scale-out
— followed by an overload-survival demo (bursty arrivals force the
preemptor to pause a best-effort request for a deadline-urgent one).

    PYTHONPATH=src python examples/pt_serve_cluster.py          # the card
    PYTHONPATH=src python examples/pt_serve_cluster.py --device cpu

``--chaos`` runs the fault-tolerance demo instead: an instance is
killed mid-decode and the cluster detects it, quarantines the rank,
and replays the affected request to an identical token stream.

    PYTHONPATH=src python examples/pt_serve_cluster.py --chaos --device cpu

``examples/serve_cluster.py`` step by step, on ``repro_torch``: the same
smoke config (olmo-1b), settings, traffic and prints; seeded random
weights from a ``torch.Generator``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.model import init_params, resolve_device
from repro_torch.serving import (LLMServer, RequestState, SamplingParams,
                                 ServingConfig)
from repro_torch.serving.config import FaultPolicy, OverloadPolicy


def _model(device):
    cfg = get_smoke_config("olmo-1b")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    return params, cfg


def cluster_demo(params, cfg, device):
    server = LLMServer(params, cfg, ServingConfig.smoke(n_instances=3),
                       device=device)

    # Mixed load: mostly short chats + one long-context request that
    # overflows its instance and spans creditors via DistAttention. The
    # long request carries a deadline, so the planner treats it as the
    # most urgent debtor when offloading prefix blocks.
    rng = np.random.default_rng(7)
    handles = []
    for i, n in enumerate((6, 9, 60, 12, 7, 15)):
        handles.append(server.submit(
            rng.integers(0, cfg.vocab_size, size=n).tolist(),
            SamplingParams(max_new_tokens=10),
            priority=1 if n > 30 else 0,
            deadline_s=30.0 if n > 30 else None))
    victim = handles[1]                   # running by the time we cancel

    step = 0
    while not all(h.done for h in handles) and step < 200:
        made = server.step()
        step += 1
        if step % 5 == 0:
            views = {i: (e.batch_size,
                         f"{e.rmanager.pool.memory_utilization:.0%}")
                     for i, e in server.cluster.engines.items()
                     if i not in server.cluster._dead}
            print(f"step {step:03d}: +{made} tok  "
                  f"(inst -> batch, mem_util) {views}")
        if step == 8:
            print(f">>> cancelling req {victim.req_id} mid-flight")
            victim.cancel()
        if step == 12:
            print(">>> elastic scale-out: adding instance")
            server.cluster.add_instance(params)

    stats = server.cluster.throughput_stats
    print(f"\nKV moved: {stats['kv_moved_bytes'] / 1024:.1f} KiB; "
          f"query/merge traffic: "
          f"{stats['query_shipped_bytes'] / 1024:.1f} KiB")
    for h in handles:
        m = h.metrics
        print(f"  [{h.status.value:9s}] req {h.req_id} "
              f"out={int(m['n_tokens'])} ttft={m['ttft'] * 1e3:.0f}ms")
    assert victim.status == RequestState.CANCELLED
    assert all(h.status == RequestState.FINISHED
               for h in handles if h is not victim)
    print("all surviving requests served; cancellation released its KV.")
    return [h.result() for h in handles if h is not victim]


def overload_demo(params, cfg, device):
    """Overload survival: a one-slot instance is hogged by a best-effort
    long decode when a burst of deadline-urgent shorts arrives. With
    ``OverloadPolicy(enabled=True)`` the server pauses the victim at a
    step boundary (KV chain spilled byte-for-byte to the pinned host
    tier), serves the urgent burst, then resumes the victim with tokens
    identical to an undisturbed run — all visible in ``server.metrics``.
    """
    print("\n--- overload survival demo (preemptive pause/resume) ---")
    server = LLMServer(params, cfg, ServingConfig.smoke(
        n_instances=1, max_batch=1, max_local_len=128,
        overload=OverloadPolicy(enabled=True, victim_min_slack_s=0.0)),
        device=device)
    rng = np.random.default_rng(13)

    bg = server.submit(rng.integers(0, cfg.vocab_size, 12).tolist(),
                       SamplingParams(max_new_tokens=48))
    for _ in range(4):                    # let the hog get established
        server.step()

    # A bursty spike of latency-critical arrivals: none can be admitted
    # (the slot is taken), so the SLO-aware preemptor pauses the
    # best-effort victim — its slack is infinite, theirs is not.
    urgent = [server.submit(rng.integers(0, cfg.vocab_size, 8).tolist(),
                            SamplingParams(max_new_tokens=4),
                            priority=1, deadline_s=30.0)
              for _ in range(2)]
    while not all(h.done for h in urgent):
        server.step()
        m = server.metrics
        if m["paused_now"]:
            print(f"  victim req {bg.req_id} PAUSED "
                  f"(preempt tier holds "
                  f"{m['preempt_tier_blocks_used']:.0f} KV frames)")

    out = bg.result()                     # drives the resume path
    m = server.metrics
    print(f"  urgent burst served on time: "
          f"{[h.status.value for h in urgent]}")
    print(f"  victim resumed and finished: {len(out)} tokens, "
          f"preemptions={m['preemptions']:.0f} "
          f"resumes={m['preempt_resumes']:.0f} "
          f"est arrival rate={m['arrival_rate_hz']:.2f}/s")
    assert bg.status == RequestState.FINISHED
    assert m["preemptions"] >= 1 and m["paused_now"] == 0
    print("overload survived: victim paused, spilled, resumed intact.")
    return out


def chaos_demo(params, cfg, device):
    """Fault tolerance: kill an instance mid-decode and watch detection,
    quarantine, and deterministic token-replay recovery.

    An oracle server (no fault) first records the greedy stream for the
    same prompt; then a second server loses the instance serving the
    request and must reproduce that stream exactly — the replay
    re-prefills the already-emitted tokens, so nothing is resampled.
    Returns (prompt, oracle stream, replayed stream).
    """
    print("--- chaos demo (crash detection + token-replay recovery) ---")
    serving = dict(n_instances=3, max_batch=2, heartbeat_timeout=0.0,
                   faults=FaultPolicy(max_transfer_retries=2))
    rng = np.random.default_rng(42)
    prompt = rng.integers(0, cfg.vocab_size, 12).tolist()
    sp = SamplingParams(max_new_tokens=12)

    oracle = LLMServer(params, cfg, ServingConfig.smoke(**serving),
                       device=device)
    ref = oracle.submit(prompt, sp).result()

    server = LLMServer(params, cfg, ServingConfig.smoke(**serving),
                       device=device)
    h = server.submit(prompt, sp)
    while len(h._req.output) < 4:         # mid-decode
        server.step()
    cl = server.cluster
    victim = next(i for i, e in cl.engines.items()
                  if h.req_id in e.rmanager.pool.requests)
    print(f">>> killing instance {victim} (serves req {h.req_id}, "
          f"{len(h._req.output)} tokens emitted)")
    cl.kill_instance(victim)
    out = h.result()

    m = server.metrics
    print(f"  dead instances: {m['dead_instances']:.0f}  "
          f"recoveries: {m['fault_recoveries']:.0f}  "
          f"replayed tokens: {m['replayed_tokens']:.0f}")
    print(f"  oracle: {ref}\n  replay: {out}")
    assert h.status == RequestState.FINISHED
    assert out == ref and m["fault_recoveries"] == 1
    print("crash survived: rank quarantined, request replayed, "
          "stream byte-identical.")
    return prompt, ref, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without it) or cpu")
    ap.add_argument("--chaos", action="store_true",
                    help="run the fault-tolerance demo instead")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params, cfg = _model(dev)
    if args.chaos:
        return chaos_demo(params, cfg, dev)
    streams = cluster_demo(params, cfg, dev)
    return streams, overload_demo(params, cfg, dev)


if __name__ == "__main__":
    main()
