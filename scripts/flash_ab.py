#!/usr/bin/env python3
"""Time the flash-prefill kernel of one checkout, on one card.

    python3 scripts/flash_ab.py [--src DIR] [--label NAME]
                                [--dtype bfloat16|float32] [--out FILE]

Builds the ``repro_torch`` package under ``DIR/src`` (default: this
checkout; point ``--src`` at an unpacked older commit to compare) and
times ``ops.flash_prefill`` in ``--dtype`` (default bf16) at the shapes
where the main paths launch it, with ``chip_smoke.py``'s seeds:

* ``flash-main``: the recurrentgemma-9b admission (S 6,000, MQA 16 x 256,
  window 2,048);
* ``flash-qwen3``: qwen3-0.6b's dense prefill (S 4,000, GQA 16/8 x 128);
* ``flash-serve-prefill-S32768``: the ServeLayout prefill (B 2, S 32,768,
  GQA 16/8 x 128, causal);
* ``flash-cell-chameleon-S24576`` and ``flash-cell-musicgen-S32768``: the
  prefill_32k cells (B 1, S 24,576, GQA 64/8 x 128; B 2, S 32,768, MHA
  24 x 64);

and, because the flash kernel shares ``csrc/paged_attn.cuh`` and
``csrc/hopper.cuh`` with the paged prefill-chunk kernel, that kernel at
its main shape and at chameleon's heads (``prefill-main``,
``prefill-chameleon``; through ``chip_smoke.prefill_case``, which also
checks it and gives its ``sdpa`` time and bounds).

Each flash row is first checked against the plain twin, one (batch row,
query head) slice at a time, within ``chip_smoke.TOL`` + the dtype's
``FLASH_RTOL`` (one bf16 ulp; 0 in float32); then timed as eager calls
between CUDA events (``ms``) and as CUDA-graph replays (``graph_ms``),
with its bounds: ``bound_ms`` on the tensor cores (float32: 3xTF32,
three tf32 products a float32 product) and, in float32,
``bound_cuda_cores_ms`` (the CUDA cores' float32 peak). In float32 each flash row also
times one ``scaled_dot_product_attention`` call on the same inputs
(causal, K/V expanded to the query heads: ``library_ms``, as
``chip_smoke.flash_long_case`` runs it; with a window, a boolean mask)
and names its kernels. Run trees in turns within one call (A B B A) to
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


def flash_row(name, shape, device, cs, dtype):
    """Check, then time, ``ops.flash_prefill`` at one shape."""
    from repro_torch.kernels.flash_prefill import flash_prefill_plain
    from repro_torch.kernels.ops import flash_prefill
    B, S, H, K, D, window = shape
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(
        name.encode()))
    q, k, v = (torch.randn(s, generator=gen, device=device).to(dtype)
               for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
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
            bad += int((d > cs.TOL + cs.FLASH_RTOL[dtype]
                        * want.abs()).sum())
    if bad or torch.isnan(got).any():
        raise AssertionError(f"{name}: kernel disagrees at {bad} elements "
                             f"(max |diff| {err:.3g})")
    del got
    iters = 5 if S > 10000 else 20
    if dtype == torch.float32 and S > 10000:
        iters = 2

    def fn():
        return flash_prefill(q, k, v, window=window)
    flops = 4 * H * D * B * cs.live_pairs(S, window)
    t_bytes = ((2 * B * S * H * D + 2 * B * S * K * D) * q.element_size()
               / cs.HBM_BYTES_PER_S * 1e3)
    row = {"case": name, "dtype": str(dtype), "max_abs_err": err,
           "ms": cs.time_ms(fn, iters=iters, warmup=1),
           "graph_ms": cs.device_ms(fn, iters=min(iters, 5), replays=2)}
    cs.tensor_core_bound(row, dtype, t_bytes, flops)
    if dtype == torch.float32:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        G = H // K
        qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (
            q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
        if window and window < S:
            pos = torch.arange(S, device=device)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)

            def library():
                return sdpa(qq, kk, vv, attn_mask=mask)
        else:
            def library():
                return sdpa(qq, kk, vv, is_causal=True)
        row["library_ms"] = cs.time_ms(library, iters=iters, warmup=1)
        row["library_kernels"] = cs.cuda_kernel_names(library)[:2]
    return row


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
    dtype = getattr(torch, args.dtype)
    rows = []
    for name, shape in FLASH_SHAPES.items():
        row = {"tree": args.label,
               **flash_row(name, shape, device, cs, dtype)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    for name, (C, H, K, D, bs, ctx) in PREFILL_SHAPES.items():
        r = cs.prefill_case(f"{name}-{dtype}", C, H, K, D, bs, ctx, dtype,
                            device, timed=True)
        row = {"tree": args.label, "case": name, "dtype": str(dtype),
               **{k: r[k] for k in ("max_abs_err", "ms", "graph_ms",
                                    "library_ms", "bound_ms",
                                    "bound_cuda_cores_ms") if k in r}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
