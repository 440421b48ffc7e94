#!/usr/bin/env python3
"""Time the bf16 flash-prefill kernel of one checkout, on one card.

    python3 scripts/flash_ab.py [--src DIR] [--label NAME] [--out report.json]

Builds the ``repro_torch`` package under ``DIR/src`` (default: this
checkout; point ``--src`` at an unpacked older commit to compare) and
times ``ops.flash_prefill`` in bf16 at the shapes where the main paths
launch it, with ``chip_smoke.py``'s seeds:

* ``flash-main``: the recurrentgemma-9b admission (S 6,000, MQA 16 x 256,
  window 2,048);
* ``flash-qwen3``: qwen3-0.6b's dense prefill (S 4,000, GQA 16/8 x 128);
* ``flash-serve-prefill-S32768``: the ServeLayout prefill (B 2, S 32,768,
  GQA 16/8 x 128, causal);
* ``flash-cell-chameleon-S24576`` and ``flash-cell-musicgen-S32768``: the
  prefill_32k cells (B 1, S 24,576, GQA 64/8 x 128; B 2, S 32,768, MHA
  24 x 64);

and, because the flash kernel shares ``csrc/paged_attn.cuh`` with the
paged prefill-chunk kernel, that kernel at its main shape and at
chameleon's heads (``prefill-main``, ``prefill-chameleon``; through
``chip_smoke.prefill_case``, which also checks it).

Each flash row is first checked against the plain twin, one (batch row,
query head) slice at a time, within ``chip_smoke.TOL`` + one bf16 ulp;
then timed as eager calls between CUDA events (``ms``) and as CUDA-graph
replays (``graph_ms``). Run trees in turns within one call (A B B A) to
compare them on the same card. Prints the card's name and power limit
first and one JSON line a row; needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import sys
import zlib
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# name: (B, S, H, K, D, window)
FLASH_SHAPES = {
    "flash-main": (1, 6000, 16, 1, 256, 2048),
    "flash-qwen3": (1, 4000, 16, 8, 128, 0),
    "flash-serve-prefill-S32768": (2, 32768, 16, 8, 128, 0),
    "flash-cell-chameleon-S24576": (1, 24576, 64, 8, 128, 0),
    "flash-cell-musicgen-S32768": (2, 32768, 24, 24, 64, 0),
}
# name: (C, H, K, D, bs, ctx_blocks), as chip_smoke's kernel phase runs them
PREFILL_SHAPES = {
    "prefill-main": (512, 16, 8, 128, 16, 188),
    "prefill-chameleon": (512, 64, 8, 128, 16, 150),
}


def flash_row(name, shape, device, cs):
    """Check, then time, ``ops.flash_prefill`` at one shape."""
    from repro_torch.kernels.flash_prefill import flash_prefill_plain
    from repro_torch.kernels.ops import flash_prefill
    B, S, H, K, D, window = shape
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(
        name.encode()))
    q, k, v = (torch.randn(s, generator=gen, device=device).to(
        torch.bfloat16) for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    scale = D ** -0.5
    got = flash_prefill(q, k, v, window=window)
    torch.cuda.synchronize()
    err, bad = 0.0, 0
    for b in range(B):
        for h in range(H):
            kv = h // (H // K)
            want = flash_prefill_plain(
                q[b, :, h].contiguous()[None, :, None],
                k[b, :, kv].contiguous()[None, :, None],
                v[b, :, kv].contiguous()[None, :, None], scale=scale,
                window=window)[0, :, 0].float()
            d = (got[b, :, h].float() - want).abs()
            err = max(err, float(d.max()))
            bad += int((d > cs.TOL + cs.FLASH_RTOL[torch.bfloat16]
                        * want.abs()).sum())
    if bad or torch.isnan(got).any():
        raise AssertionError(f"{name}: kernel disagrees at {bad} elements "
                             f"(max |diff| {err:.3g})")
    iters = 5 if S > 10000 else 20

    def fn():
        return flash_prefill(q, k, v, window=window)
    return {"case": name, "max_abs_err": err,
            "ms": cs.time_ms(fn, iters=iters, warmup=2),
            "graph_ms": cs.device_ms(fn, iters=min(iters, 5), replays=3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None, help="also write rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    build.build()
    device = torch.device("cuda")
    rows = []
    for name, shape in FLASH_SHAPES.items():
        row = {"tree": args.label, **flash_row(name, shape, device, cs)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    for name, (C, H, K, D, bs, ctx) in PREFILL_SHAPES.items():
        r = cs.prefill_case(f"{name}-{torch.bfloat16}", C, H, K, D, bs, ctx,
                            torch.bfloat16, device, timed=True)
        row = {"tree": args.label, "case": name,
               **{k: r[k] for k in ("max_abs_err", "ms", "graph_ms")}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
