#!/usr/bin/env python3
"""Time the single-rank paged kernels of one checkout, on one card.

    python3 scripts/paged_ab.py [--src DIR] [--label NAME]
                                [--f32-blocks {plan,groups,sms}]
                                [--out report.json]

Builds the ``repro_torch`` package under ``DIR/src`` (default: this
checkout; point ``--src`` at an unpacked older commit to compare) and
times the decode and prefill-chunk wrappers (``ops.paged_micro_attention``
and ``ops.paged_prefill_attention``) in bf16 and float32 at the shapes of
``chip_smoke.py``'s kernel phase, with its seeds and its checks against
the plain twins (``chip_smoke.decode_case`` / ``prefill_case``):

* ``decode-main``: row 1, R 8 over 4,096-token tables, GQA 16/8 x 128;
* ``decode-{starcoder2,musicgen,chameleon}``: rows 1'', R 4 over 64-slot
  tables at the configs' heads (G 12; MHA 24 x 64; G 8);
* ``prefill-main``: row 2, a 512-query chunk over a ~3,000-token prefix,
  GQA 16/8 x 128;
* ``prefill-{starcoder2,musicgen,chameleon}``: rows 2'', the same chunk
  over a ~2,400-token prefix at the configs' heads;
* ``prefill-bs128``: row 2', 128-token blocks, 3,009 tokens;
* ``prefill-cow-c1``: one query over a 3,007-token prefix (a COW hit).

Each row: eager calls between CUDA events (``ms``), CUDA-graph replays
(``graph_ms``), the plain twin (``plain_ms``), one
``scaled_dot_product_attention`` call over the gathered rows
(``library_ms``, ``library_graph_ms``) and the bound (the float32
prefill chunk's on the tf32 tensor cores in 3xTF32, its CUDA-core
bound beside it as ``bound_cuda_cores_ms``). Run trees in
turns within one call (A B B A) to compare them on the same card.
``--f32-blocks groups`` or ``sms`` times only the float32 prefill chunk,
its persistent blocks forced to the merge-group-aligned count or to one
an SM (the two counts ``prefill_unit_plan`` chooses between).
Prints the card's name and power limit first and one JSON line a row;
needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# name: (R or C, H, K, D, bs, ctx_blocks, tail), as chip_smoke's kernel
# phase runs them
DECODE_SHAPES = {
    "decode-main": (8, 16, 8, 128, 16, 256, None),
    "decode-starcoder2": (4, 48, 4, 128, 16, 61, None),
    "decode-musicgen": (4, 24, 24, 64, 16, 61, None),
    "decode-chameleon": (4, 64, 8, 128, 16, 61, None),
}
PREFILL_SHAPES = {
    "prefill-main": (512, 16, 8, 128, 16, 188, None),
    "prefill-starcoder2": (512, 48, 4, 128, 16, 150, None),
    "prefill-musicgen": (512, 24, 24, 64, 16, 150, None),
    "prefill-chameleon": (512, 64, 8, 128, 16, 150, None),
    "prefill-bs128": (512, 16, 8, 128, 128, 24, 65),
    "prefill-cow-c1": (1, 16, 8, 128, 16, 188, 15),
}
FIELDS = ("max_abs_err", "tokens", "ms", "graph_ms", "plain_ms",
          "library_ms", "library_graph_ms", "bound_ms", "bound_by",
          "bound_cuda_cores_ms")


def force_f32_blocks(mode: str) -> None:
    """Replace the float32 prefill-chunk plan's persistent block count by
    the merge-group-aligned count (``groups``) or one an SM (``sms``);
    bf16 plans stay as they are."""
    import repro_torch.kernels.micro_attn_prefill as mp
    from repro_torch.kernels.micro_attn_decode import (group_blocks,
                                                       rank_blocks)
    plan_of = mp.prefill_unit_plan

    def forced(C, H, K, D, MB, bs, sm_count, dtype):
        plan = plan_of(C, H, K, D, MB, bs, sm_count, dtype)
        if dtype != torch.float32:
            return plan
        hg = plan["groups"]
        n = group_blocks(hg, sm_count) if mode == "groups" else sm_count
        n = rank_blocks(1, n, hg * -(-MB * bs // plan["kv_tile"]))
        return dict(plan, blocks=n, ws_slots=n + hg)
    mp.prefill_unit_plan = forced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--f32-blocks", choices=("plan", "groups", "sms"),
                    default="plan", help="float32 prefill chunk only, its "
                    "blocks forced (default: every row, as planned)")
    ap.add_argument("--out", default=None, help="also write rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_ab: CUDA is not available", file=sys.stderr)
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
    forced = args.f32_blocks != "plan"
    if forced:
        force_f32_blocks(args.f32_blocks)

    def emit(name, r, **extra):
        row = {"tree": args.label, "case": name, **extra,
               **{k: r[k] for k in FIELDS if k in r}}
        if forced:
            row["f32_blocks"] = args.f32_blocks
        print(json.dumps(row), flush=True)
        rows.append(row)

    for dt in (torch.float32,) if forced else (torch.bfloat16,
                                               torch.float32):
        for name, (R, H, K, D, bs, ctx, _) in ({} if forced else
                                               DECODE_SHAPES).items():
            emit(name, cs.decode_case(f"{name}-{dt}", R, H, K, D, bs, ctx,
                                      dt, device, timed=True),
                 dtype=str(dt))
        for name, (C, H, K, D, bs, ctx, tail) in PREFILL_SHAPES.items():
            emit(name, cs.prefill_case(f"{name}-{dt}", C, H, K, D, bs, ctx,
                                       dt, device, tail=tail, timed=True),
                 dtype=str(dt))
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
