#!/usr/bin/env python3
"""Time the rank forms of the paged kernels of one checkout, on one card.

    python3 scripts/rank_kernels_ab.py [--src DIR] [--label NAME]
                                       [--dtype bfloat16|float32]
                                       [--out report.json]

Builds the ``repro_torch`` package under ``DIR/src`` (default: this
checkout; point ``--src`` at an unpacked older commit to compare) and
times, in ``--dtype`` (default bf16), at ``chip_smoke.py``'s rank shapes
(the qwen2-moe global path's decode and prefill chunk, MHA 16 x 128 over
three ranks; the ServeLayout path's 128-token blocks: long_500k, a batch
of two, a chunk over three ranks; the mesh path's decode batches and
chunks over a slab of two ranks and of one, qwen3 heads on a 28-layer
pool; the COW path's one-query chunk over three ranks; decode batches
of two at G 1 and at starcoder2's G 12; the 77-query chunks at G 1 and
G 2), each with its seeded tables:

* ``stacked``: ``ops.paged_*_attention_ranks`` (one partial a rank);
* ``stacked_merge``: the same followed by ``merge_partials(axis=0)``,
  what the global pool's steps ran before the merged entries;
* ``merged``: ``ops.paged_*_attention_ranks_merged``, where the tree
  has it.

Each as eager calls between CUDA events (``ms``) and as CUDA-graph
replays (``graph_ms``), after a check against the plain twins within
``chip_smoke.TOL``; every row also times one
``scaled_dot_product_attention`` call over every rank's gathered rows
(``library_ms``, ``library_graph_ms``) and gives ``chip_smoke``'s
``bound_ms`` (of the merged form: bytes for decode, operations for the
prefill chunk). Run trees in turns within one call (A B B A) to
compare them on the same card. Prints the card's name and power limit
first and one JSON line a row; needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# name: (kind, NR, H, K, rows, MB, L, bs, NB, nblks, tail_rows)
SHAPES = {
    "decode-ranks-main": ("decode", 3, 16, 16, 4, 256, 24, 16, 160,
                          [[63, 38, 0, 0], [160, 0, 0, 0], [27, 0, 0, 0]],
                          None),
    "prefill-ranks-main": ("prefill", 3, 16, 16, 512, 256, 24, 16, 160,
                           [32, 160, 27], None),
    "decode-ranks-bs128-long500k": ("decode", 4, 16, 8, 1, 1025, 1, 128,
                                    1024, [[1024]] * 4, None),
    "decode-ranks-bs128-R2": ("decode", 4, 16, 8, 2, 130, 1, 128, 128,
                              [[128, 0], [128, 0], [0, 128], [0, 128]],
                              None),
    "decode-ranks-mesh-nr2-mb256": ("decode", 2, 16, 8, 4, 256, 28, 16,
                                    160, [[64, 20, 38, 0], [150, 0, 0, 0]],
                                    None),
    "decode-ranks-mesh-nr1-mb256": ("decode", 1, 16, 8, 4, 256, 28, 16,
                                    160, [[90, 0, 12, 0]], None),
    "decode-ranks-nr1-g1": ("decode", 1, 16, 16, 2, 128, 2, 16, 160,
                            [[40, 3]], None),
    "decode-ranks-nr4-g12": ("decode", 4, 48, 4, 2, 128, 2, 16, 160,
                             [[0, 0], [100, 2], [0, 0], [7, 60]], None),
    "prefill-ranks-bs128-nr3": ("prefill", 3, 16, 8, 512, 32, 2, 128, 24,
                                [4, 20, 0], 65),
    "prefill-ranks-mesh-nr2-160": ("prefill", 2, 16, 8, 512, 256, 28, 16,
                                   160, [64, 160], None),
    "prefill-ranks-mesh-nr1-96": ("prefill", 1, 16, 8, 512, 256, 28, 16,
                                  160, [96], None),
    "prefill-ranks-cow-c1": ("prefill", 3, 16, 8, 1, 256, 2, 16, 160,
                             [120, 0, 68], 15),
    "prefill-ranks-nr1-g1": ("prefill", 1, 16, 16, 77, 128, 2, 16, 160,
                             [3], None),
    "prefill-ranks-nr4-g2": ("prefill", 4, 16, 8, 77, 128, 2, 16, 160,
                             [0, 2, 0, 60], None),
}


def case_inputs(name, spec, device, dtype=torch.bfloat16):
    """``chip_smoke.rank_case``'s inputs for one shape (same seeds)."""
    import chip_smoke as cs
    kind, NR, H, K, rows, MB, L, bs, NB, nblks, tail_rows = spec
    D = 128
    rng = np.random.default_rng(zlib.crc32(f"{name}-{dtype}".encode()))
    gen = torch.Generator(device=device).manual_seed(3)
    gk, gv = (torch.randn((NR, L, NB, bs, K, D), generator=gen,
                          device=device).to(dtype) for _ in range(2))
    pk, pv = gk[:, L // 2], gv[:, L // 2]
    decode = kind == "decode"
    R = rows if decode else 1
    tabs = [cs.make_tables(rng, R, MB, nb if decode else [nb], NB, bs)
            for nb in nblks]
    table = np.stack([t for t, _ in tabs])
    tail = np.stack([t for _, t in tabs])
    if tail_rows is not None:
        tail[table[..., 0] >= 0] = tail_rows
    if not decode:
        table, tail = table[:, 0], tail[:, 0]
    q = torch.randn((rows, H, D), generator=gen, device=device).to(dtype)
    return (q, pk, pv, torch.from_numpy(table).to(device),
            torch.from_numpy(tail).to(device)), decode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--out", default=None, help="also write rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rank_kernels_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.online_softmax import merge_partials
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import micro_attn_decode as dec
    from repro_torch.kernels import micro_attn_prefill as pre
    from repro_torch.core.distattn import gather_local_kv
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    build.build()
    device = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    rows = []
    for name, spec in SHAPES.items():
        (q, pk, pv, tb, tl), decode = case_inputs(name, spec, device,
                                                  dtype)
        stacked = (ops.paged_micro_attention_ranks if decode
                   else ops.paged_prefill_attention_ranks)
        plain = (dec.paged_micro_attention_ranks_plain if decode
                 else pre.paged_prefill_attention_ranks_plain)
        scale = q.shape[-1] ** -0.5
        want = merge_partials(*plain(q, pk, pv, tb, tl, scale=scale), axis=0)

        def stacked_merge():
            return merge_partials(*stacked(q, pk, pv, tb, tl), axis=0)
        fns = {"stacked": lambda: stacked(q, pk, pv, tb, tl),
               "stacked_merge": stacked_merge}
        merged = getattr(ops, ("paged_micro_attention_ranks_merged"
                               if decode else
                               "paged_prefill_attention_ranks_merged"), None)
        if merged is not None:
            fns["merged"] = lambda: merged(q, pk, pv, tb, tl)
        row = {"tree": args.label, "case": name, "dtype": args.dtype}
        for key, fn in fns.items():
            if key != "stacked":
                row[f"{key}_max_abs_err"] = cs.compare(fn(), want, cs.TOL)
            row[f"{key}_ms"] = cs.time_ms(fn)
            row[f"{key}_graph_ms"] = cs.device_ms(fn)
        # chip_smoke.rank_case's yardstick (the ranks, and a decode's
        # requests, as batch rows) and the merged form's bound.
        NR, K, D = pk.shape[0], pk.shape[3], q.shape[-1]
        tb2, tl2 = (tb, tl) if decode else (tb[:, None], tl[:, None])
        kk, vv = (torch.cat(t) for t in zip(*(
            gather_local_kv(pk[i], pv[i], tb2[i]) for i in range(NR))))
        kk = kk.transpose(1, 2).contiguous()
        vv = vv.transpose(1, 2).contiguous()
        qq = (q[:, :, None, :].repeat(NR, 1, 1, 1) if decode else
              q.transpose(0, 1)[None].repeat(NR, 1, 1, 1).contiguous())
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = cs.time_ms(lambda: sdpa(qq, kk, vv,
                                                    enable_gqa=True))
        row["library_graph_ms"] = cs.device_ms(lambda: sdpa(
            qq, kk, vv, enable_gqa=True))
        S = sum(cs.valid_tokens(tb2[i].cpu().numpy(), tl2[i].cpu().numpy(),
                                pk.shape[2]) for i in range(NR))
        flops = 4 * S * q.shape[1] * D * (1 if decode else q.shape[0])
        nbytes = (2 * S * K * D * pk.element_size()
                  + q.numel() * q.element_size() + tb.numel() * 4
                  + tl.numel() * 4 + q.shape[0] * q.shape[1] * (D + 2) * 4)
        t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
        if decode:
            t_ops = flops / cs.PEAK_FLOPS[dtype] * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        else:
            cs.tensor_core_bound(row, dtype, t_bytes, flops)
        row["tokens"] = S
        del kk, vv, qq
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, pk, pv, want
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
