"""Long-context serving on the port: a prompt far beyond any single
instance's memory is served by pooling KV across the whole cluster (the
paper's headline 2000K-on-32-GPUs scenario, at smoke scale).

Verifies the DistAttention output is IDENTICAL to a single big cache.

    PYTHONPATH=src python examples/pt_long_context.py          # the card
    PYTHONPATH=src python examples/pt_long_context.py --device cpu

``examples/long_context.py`` step by step, on ``repro_torch``: the same
smoke config (mistral-nemo-12b), cluster, prompt and prints; seeded
random weights from a ``torch.Generator``; the reference is the port's
dense ``prefill`` + ``decode_step``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.model import decode_step, init_params, resolve_device
from repro_torch.models.prefill import prefill
from repro_torch.serving import (LLMServer, RequestState, SamplingParams,
                                 ServingConfig)


def reference(params, cfg, prompt, n_new):
    dev = params["embed"].device
    tokens = torch.tensor([prompt], dtype=torch.int32, device=dev)
    logits, state = prefill(params, cfg, tokens,
                            max_len=len(prompt) + n_new + 2)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = decode_step(params, cfg, state, torch.tensor(
            [out[-1]], dtype=torch.int32, device=dev))
        out.append(int(torch.argmax(lg[0])))
    return out


def serve_long(params, cfg, device):
    """Serve the 100-token prompt over six 24-token instances; returns
    (served stream, reference stream)."""
    rng = np.random.default_rng(1)

    # Each instance holds <=24 local tokens; the prompt is 100.
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, size=100)]
    n_new = 12
    print(f"prompt len {len(prompt)}; per-instance local window 24 "
          f"-> needs cluster pooling")

    server = LLMServer(params, cfg,
                       ServingConfig.smoke(n_instances=6, max_batch=2,
                                           max_local_len=24,
                                           pool_blocks=32), device=device)
    handle = server.submit(prompt, SamplingParams(max_new_tokens=n_new))
    out = handle.result(max_steps=300)
    assert handle.status == RequestState.FINISHED, handle.status

    ref = reference(params, cfg, prompt, n_new)
    match = out == ref
    print(f"spanned output: {out}")
    print(f"reference:      {ref}")
    print(f"exact match: {match}")
    spans = {i: e.rmanager.pool.alloc.used_count
             for i, e in server.cluster.engines.items()}
    print(f"blocks held per instance at finish: {spans}")
    assert match
    print("long-context DistAttention == single-cache reference.")
    return out, ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without it) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("mistral-nemo-12b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    return serve_long(params, cfg, dev)


if __name__ == "__main__":
    main()
