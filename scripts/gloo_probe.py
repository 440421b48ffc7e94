"""Does gloo run a collective directly on CUDA tensors? One pair of processes.

The port runs its reduce-scatter (``TPAxis.sum_scatter``) on CUDA tensors
over gloo directly, and stages the Ring baseline's point-to-point sends
through host memory (``repro_torch.distributed.mesh.host_staged``); this
probe tries each op directly, which may abort its process rather than
raise, so each op runs in a pair of processes of its own:

  python scripts/gloo_probe.py                       # every op, a pair each
  python scripts/gloo_probe.py --op reduce_scatter

Prints one JSON object {op: {"direct": "ok" | "wrong values" | "refused:
..." | "aborted (exit N): ...", "port": "ok" | ...}}: "port" is the port's
own path (``TPAxis.sum_scatter`` or ``ring_shift``) on the same inputs.
``probe(ops, workdir)`` returns the same dict. Needs a card (``--device
cpu`` rehearses it on host tensors, where gloo takes both); imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OPS = ("reduce_scatter", "send")
TIMEOUT_S = 120


def _direct(op, x, rank, world):
    """The op called on ``x`` directly (no host copy)."""
    import torch
    import torch.distributed as dist
    if op == "reduce_scatter":
        out = torch.empty(x.shape[0] // world, device=x.device)
        dist.reduce_scatter(out, [c.contiguous() for c in x.chunk(world)])
        return out
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
           dist.P2POp(dist.irecv, out, (rank - 1) % world)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _port(op, x, rank, world):
    """The port's path for the op."""
    import torch.distributed as dist
    from repro_torch.core.baselines import ring_shift
    from repro_torch.distributed.mesh import PoolShards
    from repro_torch.distributed.placement import TPAxis
    if op == "reduce_scatter":
        tp = TPAxis(PoolShards(dist.group.WORLD, rank, world,
                               tuple(range(world))))
        return tp.sum_scatter(x, 0)
    return ring_shift([x], dist.group.WORLD)[0]


def _want(op, rank, world, n):
    import torch
    xs = [torch.arange(n, dtype=torch.float32) + r for r in range(world)]
    if op == "reduce_scatter":
        return sum(xs).chunk(world)[rank]
    return xs[(rank - 1) % world]


def _process(op, rank, world, store, path, device):
    """One process of a pair: the port's path first, then the direct
    call (which may abort the process); a JSON line after each."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    n = 8 * world
    x = torch.arange(n, dtype=torch.float32, device=device) + rank
    want = _want(op, rank, world, n)
    for name, fn in (("port", _port), ("direct", _direct)):
        try:
            got = fn(op, x, rank, world).cpu()
            res = "ok" if torch.equal(got, want) else "wrong values"
        except (RuntimeError, ValueError) as exc:
            res = f"refused: {type(exc).__name__}: {exc}"[:200]
        with open(path, "a") as f:
            f.write(json.dumps({name: res}) + "\n")
    dist.destroy_process_group()


def probe(ops=OPS, workdir=None, world: int = 2,
          device: str = "cuda") -> dict:
    """Each op's outcomes, from a pair of processes of its own (all pairs
    at once); a process that dies is reported with its exit code and the
    end of its error output."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        runs = {}
        for op in ops:
            store = os.path.join(tmp, f"{op}-store")
            paths = [os.path.join(tmp, f"{op}-{r}.jsonl")
                     for r in range(world)]
            runs[op] = [(subprocess.Popen(
                [sys.executable, __file__, "--op", op, "--rank", str(r),
                 "--world", str(world), "--store", store, "--out", path,
                 "--device", device],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True), path) for r, path in enumerate(paths)]
        out = {}
        for op, procs in runs.items():
            res = {}
            for proc, path in procs:
                try:
                    _, err = proc.communicate(timeout=TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    _, err = proc.communicate()
                lines = open(path).read().splitlines() \
                    if os.path.exists(path) else []
                for line in lines:
                    for k, v in json.loads(line).items():
                        if res.get(k, "ok") == "ok":
                            res[k] = v
                if proc.returncode:
                    tail = (err or "").strip().splitlines()[-1:] or [""]
                    res.setdefault("direct", f"aborted (exit "
                                   f"{proc.returncode}): {tail[0][:160]}")
                    res.setdefault("port", "not reached")
            out[op] = res
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", choices=OPS, action="append")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--store")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.rank is not None:
        _process(args.op[0], args.rank, args.world, args.store, args.out,
                 args.device)
        return 0
    print(json.dumps(probe(args.op or OPS, world=args.world,
                           device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
