"""The hybrid and ssm state steps on placed weights over a mesh, against
the replicated port step and the JAX package (float32, smoke width).

Four processes are spawned once for the module (gloo, ``FileStore``
rendezvous): W = 4 runs the meshes (1, 4) and (2, 2), the latter once
more with forced FSDP; then processes 0 and 1 re-initialize as W = 2 on
(1, 2). The cases: recurrentgemma with one ``block_pattern`` group and
16 query heads over one kv head (the full config's MQA: ``wq``/``wo``
split over "model", ``wk``/``wv`` whole; JAX's multi-group hybrid
prefill orders RG-LRU states wrongly, ROADMAP Queue 3), and xlstm with
one group of 7 mLSTM layers and an sLSTM; past one group, xlstm with two
groups and recurrentgemma at 8 layers (two groups and two unstacked
leftover layers), the latter's logits held to JAX's full-sequence
``forward`` fed the same tokens. Each process places the same
bridged tree by ``param_specs``, runs ``serve_prefill_step_state`` (a
40-token prompt past the 32-token window) and three
``serve_decode_step_state`` steps, and reports its rows' logits, the
gathered tokens (``gather_batch``) and the gathered state
(``gather_state``). Checked in every process: tokens equal to the
replicated port step's and to JAX's ``serve_*_step_state`` (run here
under a (1, 1) mesh with Auto axes), logits and states within 1e-5 of
the largest value (1e-4 for xLSTM's whole model, as
``tests/test_torch_xlstm.py`` holds it; 2e-4 at two groups, ``TOL``);
each process holds only its
RG-LRU columns and its mLSTM heads; ``seeded_params`` of both families
gives the same values on a mesh as without one.

The spawned processes import this module; JAX is imported only where
the references are computed.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.serving import sharded_step as pss
from test_torch_collectives import Spawned

# Relative to the largest value. xLSTM's whole model as
# ``tests/test_torch_xlstm.py`` holds it at one group; at two, its sLSTM
# cell state (an unbounded accumulator) reaches 1.4e-4 against JAX in
# float32, whichever way the weights are placed.
TOL = {"hybrid": 1e-5, "xlstm": 1e-4, "hybrid8": 1e-5, "xlstm2": 2e-4}
ARCHS = {"hybrid": "recurrentgemma-9b", "xlstm": "xlstm-350m",
         "hybrid8": "recurrentgemma-9b", "xlstm2": "xlstm-350m"}
LAYERS = {"hybrid8": 8, "xlstm2": 16}   # default: one group
# world -> (mesh shape over ("data", "model"), forced FSDP)
MESHES = {4: (((1, 4), False), ((2, 2), False), ((2, 2), True)),
          2: (((1, 2), False),)}
B, T, MAX_LEN, STEPS = 2, 40, 40, 3


def _cfg(name, get=get_smoke_config):
    cfg = dataclasses.replace(get(ARCHS[name], layers=LAYERS.get(name)),
                              dtype="float32")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_heads=16, head_dim=8)
    return cfg


def _leaves(state):
    """A DecodeState's tensors as float32 numpy copies, in field order
    (the decode step updates a state in place)."""
    out = [state.lens]
    if state.kv_k is not None:
        out += [state.kv_k, state.kv_v]
    rec = state.rec
    out += list(rec) if isinstance(rec, tuple) else \
        list(rec["mlstm"]) + list(rec["slstm"])
    return [np.array(x.numpy() if torch.is_tensor(x) else x, np.float32)
            for x in out]


def _layout(mesh):
    from repro_torch.distributed.sharding import batch_axes
    axes = batch_axes(mesh)
    return pss.ServeLayout(batch_axes=axes, pool_axes=axes)


def _run(params, cfg, layout, toks, mesh=None):
    """Prefill, then STEPS greedy decode steps: (every step's logits of
    this process's rows, every step's tokens of all rows, the state
    after the prefill and at the end, gathered; the local state's
    shapes)."""
    lg, st = pss.serve_prefill_step_state(params, cfg, layout, toks,
                                          max_len=MAX_LEN, mesh=mesh,
                                          return_logits=True)
    logits, tokens = [lg.numpy()], []
    states = [_leaves(pss.gather_state(st, cfg, mesh, layout, B))]
    for _ in range(STEPS):
        tok = pss.gather_batch(lg.argmax(-1), mesh, layout, B)
        tokens.append(tok.numpy())
        lg, st = pss.serve_decode_step_state(params, cfg, layout, st, tok,
                                             mesh=mesh, return_logits=True)
        logits.append(lg.numpy())
    tokens.append(pss.gather_batch(lg.argmax(-1), mesh, layout, B).numpy())
    states.append(_leaves(pss.gather_state(st, cfg, mesh, layout, B)))
    return {"logits": logits, "tokens": tokens, "states": states,
            "local": [tuple(x.shape) for x in _leaves(st)]}


def _placed_case(name, mesh, fsdp, payload):
    from repro_torch.distributed.placement import param_shapes, place_params
    from repro_torch.distributed.sharding import (param_specs,
                                                  validate_divisibility)
    cfg = _cfg(name)
    tree, toks = payload[name]
    shapes = param_shapes(cfg)
    specs = validate_divisibility(param_specs(cfg, shapes, fsdp=fsdp),
                                  shapes, mesh)
    placed = place_params(tree, specs, mesh, device="cpu")
    return _run(placed, cfg, _layout(mesh), toks, mesh)


def _seeded_case(mesh):
    """Whether ``seeded_params`` placed over ``mesh`` (forced FSDP) and
    gathered equals the tree drawn without a mesh, bit for bit."""
    from repro_torch.distributed.placement import (gather_params,
                                                   param_shapes,
                                                   seeded_params)
    from repro_torch.distributed.sharding import (param_specs,
                                                  validate_divisibility)
    out = {}
    for name in ARCHS:
        cfg = _cfg(name)
        shapes = param_shapes(cfg)
        specs = validate_divisibility(param_specs(cfg, shapes, fsdp=True),
                                      shapes, mesh)
        whole = seeded_params(cfg, 7, device="cpu")
        back = gather_params(seeded_params(cfg, 7, mesh=mesh, specs=specs,
                                           device="cpu"))
        out[name] = all(torch.equal(a, b) for a, b in zip(
            _tree_leaves(back), _tree_leaves(whole)))
    return out


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _tree_leaves(tree[k])]
    return [tree]


def _worker(rank, store, payload, queue):
    import traceback
    torch.set_num_threads(1)
    try:
        from repro_torch.distributed.mesh import make_mesh
        out = {}
        for world in (4, 2):
            if rank >= world:
                break
            dist.init_process_group("gloo", init_method=f"file://{store}"
                                    f"-{world}", rank=rank, world_size=world)
            meshes = {}
            for shape, fsdp in MESHES[world]:
                mesh = meshes.get(shape) or make_mesh(shape, device="cpu")
                meshes[shape] = mesh
                for name in ARCHS:
                    out[world, shape, fsdp, name] = _placed_case(
                        name, mesh, fsdp, payload)
            if world == 4:
                out["seeded"] = _seeded_case(meshes[2, 2])
            dist.barrier()
            dist.destroy_process_group()
        queue.put((rank, out))
    except Exception:
        queue.put((rank, traceback.format_exc()))


# ------------------------------------------------------------------ #
# References (this process)
# ------------------------------------------------------------------ #
def _jax_run(name, tree, toks, steps):
    """JAX's state steps under a (1, 1) Auto mesh, fed the given tokens:
    (every step's logits, the states after the prefill and at the end).
    For the multi-group hybrid, whose JAX prefill misorders the states:
    the logits of its full-sequence ``forward`` over the prompt and the
    fed tokens, at the prompt's last position and each fed one (no
    states)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.model import decode_step, forward
    from repro.models.prefill import prefill
    from repro.serving import sharded_step as jss
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jcfg = _cfg(name, jax_smoke)
    jp = jax.tree.map(jnp.asarray, tree)
    if name == "hybrid8":
        seq = np.concatenate([toks] + [t[:, None] for t in steps], 1)
        lg, _ = jax.jit(lambda p, t: forward(p, jcfg, t))(
            jp, seq.astype(np.int32))
        lg = np.asarray(lg)[:, T - 1:]
        return {"first": lg[:, 0].argmax(-1),
                "logits": [lg[:, j] for j in range(lg.shape[1])],
                "states": None}
    layout = jss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    with mesh:
        lg, st = jax.jit(lambda p, t: prefill(p, jcfg, t, max_len=MAX_LEN))(
            jp, toks.astype(np.int32))
        first, _ = jax.jit(lambda p, t: jss.serve_prefill_step_state(
            p, jcfg, layout, t, max_len=MAX_LEN))(jp, toks.astype(np.int32))
        logits, states = [np.asarray(lg)], [_leaves(st)]
        dec = jax.jit(lambda p, s, t: decode_step(p, jcfg, s, t))
        for tok in steps:
            lg, st = dec(jp, st, jnp.asarray(tok, jnp.int32))
            logits.append(np.asarray(lg))
    states.append(_leaves(st))
    return {"first": np.asarray(first), "logits": logits, "states": states}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.models.model import init_params
    payload = {}
    for name in ARCHS:
        tp = init_params(_cfg(name), torch.Generator().manual_seed(0),
                         device="cpu")
        toks = np.random.default_rng(5).integers(0, _cfg(name).vocab_size,
                                                 (B, T))
        payload[name] = (bridge.to_numpy_tree(tp), toks)
    group = Spawned(_worker, 4, str(tmp_path_factory.mktemp("state")),
                    payload)
    refs = {}
    for name, (tree, toks) in payload.items():
        cfg = _cfg(name)
        tp = bridge.from_numpy_tree(tree, device="cpu")
        rep = _run(tp, cfg, _layout(SimpleNamespace(mesh_dim_names=("data",
                                                                    "model"),
                                                    size=lambda i: 1)),
                   toks)
        refs[name] = {"replicated": rep,
                      "jax": _jax_run(name, tree, toks, rep["tokens"][:-1])}
    return refs, group.results()


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _rows(world, shape, rank):
    """The batch rows process ``rank`` of a (data, model) mesh keeps."""
    n_data = shape[0]
    if n_data == 1 or B % n_data:
        return slice(0, B)
    d = rank // shape[1]
    return slice(d * B // n_data, (d + 1) * B // n_data)


@pytest.mark.parametrize("world,shape,fsdp,name", [
    (w, s, f, n) for w in (4, 2) for s, f in MESHES[w] for n in ARCHS],
    ids=[f"{w}-{s[0]}x{s[1]}{'-fsdp' if f else ''}-{n}"
         for w in (4, 2) for s, f in MESHES[w] for n in ARCHS])
def test_placed_state_steps_match_replicated_and_jax(runs, world, shape,
                                                     fsdp, name):
    refs, res = runs
    rep, jref = refs[name]["replicated"], refs[name]["jax"]
    tol = TOL[name]
    cfg = _cfg(name)
    # The replicated port step against JAX (the same tokens fed).
    np.testing.assert_array_equal(rep["tokens"][0], jref["first"])
    for got, want in zip(rep["logits"], jref["logits"]):
        _close(got, want, tol)
    for got, want in zip(rep["states"], jref["states"] or ()):
        for g, w in zip(got, want):
            _close(g, w, tol)
    tp = shape[1]
    for rank in range(world):
        got = res[rank][world, shape, fsdp, name]
        rows = _rows(world, shape, rank)
        for g, w in zip(got["tokens"], rep["tokens"]):
            np.testing.assert_array_equal(g, w)
        for g, w, j in zip(got["logits"], rep["logits"], jref["logits"]):
            _close(g, w[rows], tol)
            _close(g, j[rows], tol)
        for i, (gs, ws) in enumerate(zip(got["states"], rep["states"])):
            for k, (g, w) in enumerate(zip(gs, ws)):
                _close(g, w, tol)
                if jref["states"] is not None:
                    _close(g, jref["states"][i][k], tol)
        # Each process holds its rows and its share of the recurrent
        # width (hybrid) or of the mLSTM heads (ssm).
        local, whole = got["local"], [x.shape for x in rep["states"][-1]]
        n_rows = rows.stop - rows.start
        assert local[0] == (n_rows,)
        if cfg.family == "hybrid":
            w = cfg.lru_width
            assert local[-1] == (whole[-1][0], n_rows, w // tp)
            assert local[-2][-1] == w // tp
            assert local[1][3] == cfg.num_kv_heads      # one kv head, whole
        else:
            assert local[3][3] == cfg.num_heads // tp   # mLSTM m [.., nh]
            assert local[-1] == (whole[-1][0], n_rows, cfg.d_model)


def test_seeded_params_of_every_family_do_not_depend_on_the_mesh(runs):
    _, res = runs
    for rank in range(4):
        assert res[rank]["seeded"] == {name: True for name in ARCHS}
