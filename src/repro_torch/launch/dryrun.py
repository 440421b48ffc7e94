"""Dry run: plan every (arch x shape x mesh) cell without running it.

For each cell (``launch.inputs.build_cell`` on a production mesh shape
of ``launch.mesh``) it reports what one process would hold — the
parameters by their specs (``distributed.placement.spec_bytes``), the
gradients and AdamW moments of a train cell, the KV pool or decode
state, the inputs, the prefill's output pool — whether that fits the
card, and the ideal step time on the mesh's cards from the useful FLOPs
and mandatory bytes (``launch.roofline``, H100 data-sheet constants).
A cell that fails to plan is a bug in the placement rules.

The JAX package's ``repro.launch.dryrun`` lowers and compiles each cell
with XLA over 512 fake host devices and reads the compiler's memory and
cost analyses and the HLO's collectives. The port has no compiler to
ask: the plan is arithmetic over meta tensors, it counts no
temporaries (activations, attention buffers), and its report has no
HLO FLOPs, HLO bytes or collective breakdown. Nothing touches a device.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out r.jsonl]
  python -m repro_torch.launch.dryrun --all --both-meshes --seq-parallel

``--seq-parallel`` plans the prefill cells with ``seq_parallel=True``
(JAX's ``REPRO_SP=1``): the same bytes a process (the plan counts no
activations), the cell's ``meta["seq_parallel"]`` printed beside them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from typing import List, Optional, Sequence

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed.hardware import H100, HardwareSpec
from repro_torch.distributed.placement import spec_bytes
from repro_torch.launch.inputs import (BLOCK_SIZE, build_cell,
                                       decode_state_specs, mesh_axis_sizes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (REPORT_HEADER, RooflineReport,
                                         model_mandatory_bytes,
                                         model_useful_flops, report_row)
from repro_torch.models.model import init_decode_state
from repro_torch.serving.sharded_step import prefill_pool_blocks


def tree_bytes(tree, specs, sizes) -> int:
    """Bytes one process holds of a tree (dicts, tuples, NamedTuples of
    meta tensors; None: nothing) placed by ``specs``."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return spec_bytes({"x": tree}, {"x": specs}, sizes)
    if isinstance(tree, dict):
        return sum(tree_bytes(v, specs[k], sizes) for k, v in tree.items())
    return sum(tree_bytes(t, s, sizes) for t, s in zip(tree, specs))


def _as_float32(tree):
    if isinstance(tree, dict):
        return {k: _as_float32(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=torch.float32, device="meta")


def _grad_bytes(params, specs, sizes, microbatches: int) -> int:
    """The gradient tree (the parameters' dtype), plus float32
    accumulators when the step accumulates microbatches."""
    g = spec_bytes(params, specs, sizes)
    if microbatches > 1:
        g += spec_bytes(_as_float32(params), specs, sizes)
    return g


def memory_breakdown(cell, cfg, shape, mesh) -> dict:
    """Bytes one process holds for ``cell``, by kind."""
    sizes = mesh_axis_sizes(mesh)
    kw, sh = cell.kwargs, cell.in_shardings
    kind = cell.meta["kind"]
    out = {}
    if kind == "train":
        st, ss = kw["state"], sh["state"]
        out["params"] = spec_bytes(st.params, ss.params, sizes)
        out["gradients"] = _grad_bytes(st.params, ss.params, sizes,
                                       cell.fn.keywords["tcfg"].microbatches)
        out["optimizer"] = tree_bytes(st.opt, ss.opt, sizes) + \
            tree_bytes(st.ef, ss.ef, sizes)
    else:
        out["params"] = spec_bytes(kw["params"], sh["params"], sizes)
    if kind == "decode":
        out["pool"] = tree_bytes((kw["pool_k"], kw["pool_v"]),
                                 (sh["pool_k"], sh["pool_v"]), sizes)
    if kind == "decode_state":
        out["state"] = tree_bytes(kw["state"], sh["state"], sizes)
    skip = {"params", "state", "pool_k", "pool_v"}
    out["inputs"] = sum(tree_bytes(v, sh[k], sizes) for k, v in kw.items()
                        if k not in skip)
    B, S = shape.global_batch, shape.seq_len
    if kind == "prefill":
        k = cell.fn.keywords
        nb = prefill_pool_blocks(B, S, BLOCK_SIZE, k["NP"], k["n_data"])
        pool = torch.empty((cfg.num_layers, k["NP"], nb, BLOCK_SIZE,
                            cfg.num_kv_heads, cfg.head_dim),
                           dtype=kw["params"]["embed"].dtype, device="meta")
        spec = cell.out_shardings[1]
        out["outputs"] = 2 * tree_bytes(pool, spec, sizes)
    if kind == "prefill_state":
        state = init_decode_state(cfg, B, cell.fn.keywords["max_len"],
                                  device="meta")
        bspec = sh["tokens"]
        specs = decode_state_specs(cfg, state, B, bspec[0] if bspec
                                   else None)
        out["outputs"] = tree_bytes(state, specs, sizes)
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, hw: HardwareSpec = H100,
             **cell_kw) -> RooflineReport:
    """Plan one cell on the production mesh; returns its report."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    cell = build_cell(arch, shape_name, mesh, hw=hw, **cell_kw)
    mem = memory_breakdown(cell, cfg, shape, mesh)
    rep = RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh.name, chips=mesh.size(),
        model_flops=model_useful_flops(cfg, shape),
        model_bytes=model_mandatory_bytes(cfg, shape),
        peak_memory_per_device=float(sum(mem.values())),
        memory_breakdown=mem).finalize(hw)
    if verbose:
        sp = (f", seq_parallel={cell.meta['seq_parallel']}"
              if "seq_parallel" in cell.meta else "")
        print(f"[dryrun] {arch} x {shape_name} x {mesh.name}: "
              f"{cell.meta['kind']}, fsdp={cell.meta.get('fsdp', True)}{sp}")
        print(f"  bytes a process: {json.dumps(mem)} = "
              f"{rep.peak_memory_per_device / 1e9:.2f} GB "
              f"({'fits' if rep.fits else 'does NOT fit'} "
              f"{hw.hbm_bytes / 1e9:.0f} GB)")
        print(f"  roofline ({hw.name}): compute={rep.t_compute:.3e}s "
              f"memory={rep.t_memory:.3e}s -> {rep.bottleneck}-bound, "
              f"ideal step {rep.ideal_step_s:.3e}s")
    return rep


def main(argv: Optional[Sequence[str]] = None) -> List[RooflineReport]:
    """Plan the cells the flags name; exits 1 if any fails to plan."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL reports here")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"],
                    help="decode-step implementation")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-parallel prefill cells")
    ap.add_argument("--quiet", action="store_true",
                    help="print only the table")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    print(REPORT_HEADER)
    reports, failures = [], []
    for multi_pod in meshes:
        for a, s in cells:
            try:
                kind = SHAPES[s].kind
                kw = ({"variant": args.variant} if kind == "decode" else
                      {"seq_parallel": True}
                      if kind == "prefill" and args.seq_parallel else {})
                rep = run_cell(a, s, multi_pod=multi_pod,
                               verbose=not args.quiet, **kw)
            except Exception as e:          # a placement bug: report all
                failures.append((a, s, multi_pod, repr(e)))
                traceback.print_exc()
                continue
            reports.append(rep)
            print(report_row(rep))
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(dataclasses.asdict(rep)) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    n_fit = sum(r.fits for r in reports)
    print(f"\nall {len(reports)} cells planned OK; {n_fit} fit in "
          f"{H100.hbm_bytes / 1e9:.0f} GB a device")
    return reports


if __name__ == "__main__":
    main()
