"""The port's launch cells and dry-run planning against the JAX package.

* ``launch.inputs.build_cell`` equals JAX's ``build_cell`` for every
  arch x shape on both production meshes, (16, 16) and (2, 16, 16),
  given v5e's constants (JAX decides serve-time FSDP against v5e's 16
  GB): ``meta``, every kwarg's shape and dtype, the spec of every leaf
  of ``in_shardings``, the output specs and the donated names. JAX needs
  devices for its ``NamedSharding``s, so its side is computed once per
  module in one subprocess with 512 fake host devices, without lowering,
  and printed as JSON (``python tests/test_torch_launch.py``).
* ``launch.dryrun.run_cell``'s parameter bytes equal
  ``placement.spec_bytes`` of the cell's tree and specs;
  ``dryrun.main(["--all"])`` plans every cell; ``launch.report`` prints
  the table from its JSONL; the launchers' ``--aot`` plan their cells.
* ``launch.mesh``'s shapes are JAX's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed.hardware import HardwareSpec
from repro_torch.distributed.placement import param_shapes, spec_bytes
from repro_torch.launch import dryrun, report
from repro_torch.launch.inputs import build_cell, mesh_axis_sizes
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

CELLS = [(a, s, mp) for mp in (False, True) for a in ARCH_IDS
         for s in SHAPES]
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
           torch.int32: "int32"}


def _jax_cells() -> dict:
    """Every JAX cell as JSON-able data (run in a process whose XLA has
    512 host devices)."""
    import jax
    from jax.sharding import NamedSharding
    from repro.launch.inputs import build_cell as jax_build_cell
    from repro.launch.mesh import make_production_mesh as jax_mesh

    def name(k):
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                return str(getattr(k, a))
        return str(k)

    def flat(tree, is_leaf=None):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree,
                                                         is_leaf=is_leaf)
        return {"/".join(name(k) for k in p): v for p, v in leaves}

    def ns(x):
        return isinstance(x, NamedSharding)
    out = {}
    for mp in (False, True):
        mesh = jax_mesh(multi_pod=mp)
        for a in ARCH_IDS:
            for s in SHAPES:
                c = jax_build_cell(a, s, mesh)
                out[f"{a}|{s}|{int(mp)}"] = {
                    "meta": c.meta,
                    "kwargs": {k: [list(v.shape), str(v.dtype)]
                               for k, v in flat(c.kwargs).items()},
                    "specs": {k: _norm(v.spec)
                              for k, v in flat(c.in_shardings, ns).items()},
                    "out": None if c.out_shardings is None else
                    [_norm(x.spec) for x in c.out_shardings],
                    "donate": list(c.donate)}
    return out


def _norm(spec) -> list:
    """A spec as JSON, each entry canonical as ``PartitionSpec`` keeps
    it: a tuple of one axis is that axis' name; no trailing None."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return json.loads(json.dumps(out))


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=512")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    res = subprocess.run([sys.executable, __file__], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


def _v5e() -> HardwareSpec:
    from repro.distributed.hardware import V5E
    fields = {f.name for f in dataclasses.fields(HardwareSpec)}
    return HardwareSpec(**{k: v for k, v in dataclasses.asdict(V5E).items()
                           if k in fields})


def _flat(tree, specs, path=""):
    """{path: ((shape, dtype), spec)} of every tensor of a kwargs tree
    (dicts, NamedTuples, tuples; None skipped, as JAX skips it)."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {path: ([list(tree.shape), _DTYPES[tree.dtype]], specs)}
    if isinstance(tree, dict):
        items = [(k, v, specs[k]) for k, v in tree.items()]
    elif hasattr(tree, "_fields"):
        items = [(k, v, getattr(specs, k)) for k, v in
                 zip(tree._fields, tree)]
    else:
        items = [(i, v, specs[i]) for i, v in enumerate(tree)]
    out = {}
    for k, v, sp in items:
        out.update(_flat(v, sp, f"{path}/{k}" if path else str(k)))
    return out


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_build_cell_equals_jax(jax_cells, arch, shape, multi_pod):
    want = jax_cells[f"{arch}|{shape}|{int(multi_pod)}"]
    cell = build_cell(arch, shape, make_production_mesh(multi_pod=multi_pod),
                      hw=_v5e())
    assert json.loads(json.dumps(cell.meta)) == want["meta"]
    flat = _flat(cell.kwargs, cell.in_shardings)
    assert {k: v[0] for k, v in flat.items()} == want["kwargs"]
    assert {k: _norm(v[1]) for k, v in flat.items()} == want["specs"]
    out = cell.out_shardings
    assert (None if out is None else [_norm(x) for x in out]) == \
        want["out"]
    assert list(cell.donate) == want["donate"]


@pytest.mark.parametrize("arch,shape", [
    ("chameleon-34b", "prefill_32k"), ("kimi-k2-1t-a32b", "train_4k"),
    ("starcoder2-15b", "decode_32k"), ("xlstm-350m", "long_500k")])
def test_run_cell_parameter_bytes_equal_spec_bytes(arch, shape):
    rep = dryrun.run_cell(arch, shape, verbose=False)
    mesh = make_production_mesh()
    cell = build_cell(arch, shape, mesh)
    specs = (cell.in_shardings["state"].params
             if SHAPES[shape].kind == "train" else
             cell.in_shardings["params"])
    assert rep.memory_breakdown["params"] == spec_bytes(
        param_shapes(get_config(arch)), specs, mesh_axis_sizes(mesh))
    assert rep.peak_memory_per_device == sum(rep.memory_breakdown.values())
    assert rep.fits == (rep.peak_memory_per_device <= 80e9)
    assert rep.ideal_step_s == max(rep.t_compute, rep.t_memory) > 0


def test_dryrun_main_plans_every_cell_and_report_prints_them(tmp_path,
                                                             capsys):
    out = tmp_path / "r.jsonl"
    reps = dryrun.main(["--all", "--quiet", "--out", str(out)])
    assert len(reps) == len(ARCH_IDS) * len(SHAPES)
    assert all(r.mesh == "16x16" and r.chips == 256 for r in reps)
    capsys.readouterr()
    lines = report.main([str(out)])
    assert len(lines) == 2 + len(reps)
    assert all("| n/a |" in line for line in lines[2:])
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "olmo-1b"])           # --shape missing


def test_launchers_aot_plan_their_cells(capsys):
    from repro_torch.launch import serve, train
    rep = serve.main(["--arch", "starcoder2-15b", "--aot", "--shape",
                      "decode_32k"])
    assert (rep.arch, rep.shape, rep.mesh) == ("starcoder2-15b",
                                               "decode_32k", "16x16")
    assert "pool" in rep.memory_breakdown
    rep = train.main(["--arch", "olmo-1b", "--aot"])
    assert rep.shape == "train_4k"
    assert {"params", "gradients", "optimizer"} <= set(rep.memory_breakdown)
    assert "[dryrun]" in capsys.readouterr().out


def test_input_specs_are_the_cells_meta_inputs(capsys):
    """``input_specs`` gives the cell's kwargs: meta tensors, the frame
    embeddings in place of tokens for the audio arch. The sequence-
    parallel prefill (JAX's ``REPRO_SP``) builds with ``seq_parallel`` in
    its step's keywords and in its meta (off for the state families, as
    in JAX), and ``dryrun --seq-parallel`` plans every prefill_32k
    cell with it."""
    from repro_torch.launch.inputs import build_prefill_cell, input_specs
    mesh = make_production_mesh()
    specs = input_specs("musicgen-medium", "prefill_32k", mesh)
    assert specs["tokens"] is None
    assert tuple(specs["embeds"].shape) == (32, 32768, 1536)
    assert specs["embeds"].device.type == "meta"
    assert specs["embeds"].dtype == torch.bfloat16
    cell = build_prefill_cell(get_config("olmo-1b"), SHAPES["prefill_32k"],
                              mesh, seq_parallel=True)
    assert cell.fn.keywords["seq_parallel"] is True
    assert cell.meta["seq_parallel"] is True
    plain = build_cell("olmo-1b", "prefill_32k", mesh)
    assert plain.fn.keywords["seq_parallel"] is False
    assert "seq_parallel" not in plain.meta           # JAX's meta
    state = build_cell("xlstm-350m", "prefill_32k", mesh, seq_parallel=True)
    assert state.meta["seq_parallel"] is False
    capsys.readouterr()
    reps = dryrun.main(["--all", "--both-meshes", "--seq-parallel"])
    assert len(reps) == 2 * len(ARCH_IDS) * len(SHAPES)
    planned = [line for line in capsys.readouterr().out.splitlines()
               if "x prefill_32k x" in line]
    assert len(planned) == 2 * len(ARCH_IDS)
    assert all("seq_parallel=" in line for line in planned)


def test_mesh_shapes_are_jax_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.mesh_dim_names, one.shape, one.size()) == \
        (("data", "model"), (16, 16), 256)
    assert (two.mesh_dim_names, two.shape, two.size()) == \
        (("pod", "data", "model"), (2, 16, 16), 512)
    assert [two.size(i) for i in range(3)] == [2, 16, 16]
    t = make_test_mesh()
    assert (t.mesh_dim_names, t.shape) == (("data", "model"), (2, 4))
    with pytest.raises(ValueError):
        make_test_mesh((2, 4), ("data",))


if __name__ == "__main__":
    print(json.dumps(_jax_cells()))
