"""Quickstart on the port: build a tiny model and serve requests through
the request-lifecycle frontend — submit, stream tokens, read metrics.

    PYTHONPATH=src python examples/pt_quickstart.py            # the card
    PYTHONPATH=src python examples/pt_quickstart.py --device cpu

``examples/quickstart.py`` step by step, on ``repro_torch``: the same
smoke config, serving settings, prompts and prints; seeded random
weights from a ``torch.Generator`` (not JAX's numbers), and sampled
streams from the port's own random stream.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.model import init_params, resolve_device
from repro_torch.serving import LLMServer, SamplingParams, ServingConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without it) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("qwen3-0.6b")
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.2f}M params, "
          f"family={cfg.family})")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)

    server = LLMServer(params, cfg,
                       ServingConfig.smoke(n_instances=1, max_batch=4,
                                           max_local_len=64,
                                           pool_blocks=64), device=dev)
    rng = np.random.default_rng(0)
    handles = [server.submit(
        rng.integers(0, cfg.vocab_size, size=n).tolist(),
        SamplingParams(max_new_tokens=12, temperature=0.8, top_k=20,
                       seed=i))
        for i, n in enumerate((6, 11, 17))]

    # Stream the first request token-by-token; the iterator drives the
    # server, so the other handles make progress concurrently.
    print(f"req {handles[0].req_id} streaming:", end=" ", flush=True)
    for tok in handles[0].tokens():
        print(tok, end=" ", flush=True)
    print()

    for h in handles:
        out = h.result()
        m = h.metrics
        print(f"req {h.req_id}: {h.status.value}, {len(out)} tokens, "
              f"ttft={m['ttft'] * 1e3:.1f}ms "
              f"tbt_mean={m['tbt_mean'] * 1e3:.1f}ms")

    return prefix_caching_demo(params, cfg, dev)


def prefix_caching_demo(params, cfg, device):
    """Cross-request prefix caching + the host-DRAM KV tier: finished
    requests' KV blocks are kept (device first, spilling to host under
    pressure) in a radix cache keyed by token content, so a request
    sharing a prompt prefix — a system prompt, a few-shot template,
    multi-turn history — skips prefill for the cached part entirely.
    Tokens are bit-identical to a cold run; only TTFT changes. Returns
    the (greedy) cold and warm streams."""
    server = LLMServer(params, cfg,
                       ServingConfig.smoke(n_instances=1, max_batch=4,
                                           max_local_len=64,
                                           pool_blocks=64,
                                           prefix_cache=True,
                                           host_tier_blocks=256),
                       device=device)
    rng = np.random.default_rng(1)
    system_prompt = rng.integers(0, cfg.vocab_size, size=24).tolist()
    sp = SamplingParams(max_new_tokens=8)

    cold = server.submit(system_prompt, sp)
    cold_out = cold.result()
    warm = server.submit(system_prompt, sp)     # full-prompt cache hit
    warm_out = warm.result()
    m = server.metrics
    print(f"prefix cache: cold ttft={cold.metrics['ttft'] * 1e3:.1f}ms, "
          f"warm ttft={warm.metrics['ttft'] * 1e3:.1f}ms, "
          f"hit_tokens={m['cache_hit_tokens']}, "
          f"cached_blocks={m['cache_device_blocks']}")
    return {"prompt": system_prompt, "cold": cold_out, "warm": warm_out}


if __name__ == "__main__":
    main()
