"""Serving launcher: drive an Infinite-LLM ``LLMServer`` open-loop on
synthetic traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --instances 3 --requests 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b

The JAX package's ``python -m repro.launch.serve`` with the same flags
and printed lines: the smoke config of ``--arch`` with seeded random
weights, ``ServingConfig.smoke(n_instances=...)``, ``--requests``
arrivals spread over about a second (a ``--long-frac`` share of them
longer than one instance's quota, so their KV spans creditors), served
by ``LLMServer.run``. It runs on the card unless ``--device cpu`` is
given, and raises without CUDA otherwise. Its ``--aot`` and ``--shape``
(compile the production-mesh serve step ahead of time with XLA) have no
PyTorch counterpart.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the launcher; returns the server's frontend metrics."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--long-frac", type=float, default=0.2,
                    help="fraction of requests that exceed one instance")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params, resolve_device
    from repro_torch.serving import (Arrival, LLMServer, SamplingParams,
                                     ServingConfig)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    server = LLMServer(params, cfg,
                       ServingConfig.smoke(n_instances=args.instances),
                       device=dev)
    # Open-loop synthetic traffic: Poisson-ish arrivals over ~1s.
    rng = np.random.default_rng(0)
    arrivals = []
    for _ in range(args.requests):
        n = int(rng.integers(40, 70)) if rng.random() < args.long_frac \
            else int(rng.integers(4, 20))
        arrivals.append(Arrival(
            at=float(rng.uniform(0.0, 1.0)),
            prompt=rng.integers(0, cfg.vocab_size, size=n).tolist(),
            sampling=SamplingParams(max_new_tokens=args.max_new)))
    t0 = time.time()
    stats = server.run(arrivals)
    dt = time.time() - t0
    st = server.cluster.throughput_stats
    print(f"{stats['finished']:.0f}/{len(arrivals)} finished, "
          f"{stats['tokens']:.0f} tokens ({dt:.1f}s wall on {dev.type}); "
          f"ttft_p50={stats['ttft_p50'] * 1e3:.0f}ms "
          f"ttft_p99={stats['ttft_p99'] * 1e3:.0f}ms "
          f"tbt_p99={stats['tbt_p99'] * 1e3:.0f}ms")
    print(f"KV moved {st['kv_moved_bytes'] / 1024:.1f} KiB; "
          f"query/merge traffic {st['query_shipped_bytes'] / 1024:.1f} KiB")
    return stats


if __name__ == "__main__":
    main()
