"""Print the dry-run table (markdown) from ``launch.dryrun``'s JSONL
records, against the H100's data-sheet constants.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out r.jsonl
  PYTHONPATH=src python -m repro_torch.launch.report r.jsonl

The JAX package's ``repro.launch.report`` with the same rows. Its
compute term is the larger of the HLO's FLOPs and the analytic model's;
here it is the analytic one alone (useful FLOPs at the bf16 peak), the
memory term is the mandatory bytes at the HBM rate, and the collective
column reads "n/a": no compiled program gives collective bytes.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.hardware import H100, HardwareSpec


def load(path: str) -> List[dict]:
    """The records of a dry-run JSONL, the last one per cell."""
    recs = []
    with open(path) as f:
        for line in f:
            recs.append(json.loads(line))
    # Keep the LAST record per (arch, shape, mesh) — reruns override.
    uniq: Dict[tuple, dict] = {}
    for r in recs:
        uniq[(r["arch"], r["shape"], r["mesh"])] = r
    return list(uniq.values())


def effective_terms(r: dict, hw: HardwareSpec = H100):
    """(compute s, memory s, bottleneck) of a record: the ideal terms on
    its ``chips`` cards."""
    t_c = r["model_flops"] / (r["chips"] * hw.peak_flops_bf16)
    t_m = r["model_bytes"] / (r["chips"] * hw.hbm_bw)
    return t_c, t_m, ("compute" if t_c >= t_m else "memory")


def fix_note(r: dict, bottleneck: str) -> str:
    """What would move a cell toward its bound."""
    kind = SHAPES[r["shape"]].kind
    if not r.get("fits", True):
        cfg = get_config(r["arch"])
        if kind == "train" and cfg.is_moe:
            return ("does not fit: more microbatches or bf16 moments; "
                    "wide-EP token all-to-all")
        return "does not fit: FSDP over more axes, or a smaller pool"
    if bottleneck == "memory":
        if kind == "decode":
            return ("read pool blocks in place (the paged decode kernel) "
                    "at the HBM rate")
        return "larger attention tiles; fuse norm+matmul reads"
    return "tensor-core tiles toward the bf16 peak (wgmma)"


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Print (and return) the table of the JSONL the argument names."""
    args = list(sys.argv[1:] if argv is None else argv)
    path = args[0] if args else "results/dryrun_single.jsonl"
    recs = sorted(load(path), key=lambda r: (r["arch"], r["mesh"],
                                             list(SHAPES).index(r["shape"])))
    lines = ["| arch | shape | mesh | chips | t_compute | t_memory | "
             "t_collective | bound | ideal step | mem/chip | fits | note |",
             "|" + "---|" * 12]
    for r in recs:
        t_c, t_m, b = effective_terms(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} "
            f"| {t_c:.2e}s | {t_m:.2e}s | n/a | **{b}** "
            f"| {max(t_c, t_m):.2e}s "
            f"| {r['peak_memory_per_device'] / 1e9:.1f}GB "
            f"| {'yes' if r['fits'] else 'no'} | {fix_note(r, b)} |")
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
