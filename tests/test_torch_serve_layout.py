"""The ServeLayout serving steps and the dense-span decode, against JAX.

The JAX references run in this process under a (1, 1) mesh whose axes
are Auto (JAX 0.9's ``jax.make_mesh`` default is Explicit, under which
the reference's sharding constraints do not trace), each computed once
for the module. Float32 smoke configs; JAX's weights are bridged with
``repro_torch.bridge``; inputs come from a numpy seed. Checked, within
1e-5 of the largest value:

* ``serve_decode_step`` (write-then-attend) and ``serve_decode_step_opt``
  (read-only pool, against BOTH of JAX's branches: the owner-masked
  whole pool, and the gathered partial that ``REPRO_FORCE_GATHER``
  forces) for olmo-1b, qwen3-0.6b and qwen2-moe-a2.7b with
  ``capacity_factor`` 1.25 and -1: logits and every pool row, on
  ``sharded_check.py``'s adversarial placement (request r's block j on
  shard (r + j) % NP, partial tails);
* ``prefill_layout`` exactly, in both layouts; ``serve_prefill_step``'s
  first tokens and pools, in the data-local layout with full blocks
  (where JAX lays the pool by a reshape) and in the fallback (a
  scatter), each the drop-scatter of the dense prefill's rows;
* the state steps (hybrid with one group, ssm), ``decode_step_dist``,
  ``serve_pool_axes``/``batch_axes`` on several mesh shapes;
* the nblk/table check, and the families and inputs the steps refuse;
* the mesh half: four processes spawned once (gloo), first as W = 4 on
  a (2, 2) mesh, then processes 0 and 1 as W = 2 on (2, 1), serve
  ``sharded_check.py``'s three layouts (olmo-1b tp_head, qwen3 seq_model,
  qwen2-moe tp_head): each process holds its shards and kv heads, and
  its rows of the prefill, both decode schedules and their pools equal
  the single-process steps';
* placed weights (``distributed.placement``) in the same processes, on
  (2, 2) and (1, 2) meshes: tp_head and the forced seq_model, dense and
  MoE (experts over "model"), q split over "model" or not (16-head
  variants of the smoke configs, ``test_torch_placement.H16``), one
  forced-FSDP case: ``place_params`` then ``gather_params`` gives the
  tree back bit for bit; each process's logits and pools of both decode
  schedules and of the prefill equal the same JAX references the
  replicated path is held to; the streams are equal in every process
  and to the single-process step's. And a ("pod", "data", "model") =
  (2, 1, 2) mesh whose pool is over ("pod", "data").

The spawned processes import this module; JAX is imported only where
references are computed.
"""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.serving import sharded_step as pss
from test_torch_collectives import Spawned
from test_torch_placement import H16, h16_config

TOL = 1e-5
ARCHS = ("olmo-1b", "qwen3-0.6b", "qwen2-moe-a2.7b")
# (arch, mode, fsdp) run on placed weights; the 16-head variants split q.
PLACED_CASES = (("olmo-1b", "tp_head", False),
                ("qwen2-moe-a2.7b", "tp_head", False),
                ("qwen3-0.6b", "seq_model", False),
                ("olmo-h16", "tp_head", False),
                ("qwen3-h16", "seq_model", False),
                ("qwen3-h16", "tp_head", True))
PLACED_MESHES = {4: ((("data", "model"), (2, 2)),
                     (("pod", "data", "model"), (2, 1, 2))),
                 2: ((("data", "model"), (1, 2)),)}
THREE_AXIS_CASE = ("qwen3-h16", "tp_head", False)
R, T_HIST, BS, NP = 4, 21, 8, 4          # sharded_check.py's decode shapes
SCHEDULES = ("write", "opt-fullpool", "opt-gather")
# (arch, mode): sharded_check.py's three layouts.
MESH_CASES = (("olmo-1b", "tp_head"), ("qwen3-0.6b", "seq_model"),
              ("qwen2-moe-a2.7b", "tp_head"))
MESH_SHAPES = {4: (2, 2), 2: (2, 1)}
PREFILLS = ((2, 32, 2), (3, 20, 2))      # (B, S, n_data): aligned, fallback


def _cfg(arch):
    cfg = h16_config(arch) if arch in H16 else get_smoke_config(arch)
    return dataclasses.replace(cfg, dtype="float32")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _weights(arch, J):
    """The port's seeded float32 weights and the same values as a JAX
    tree (the bridge is key for key)."""
    from repro_torch.models.model import init_params
    tp = init_params(_cfg(arch), torch.Generator().manual_seed(0),
                     device="cpu")
    return tp, J.jax.tree.map(J.jnp.asarray, bridge.to_numpy_tree(tp))


def _jax():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.distributed import sharding
    from repro.models import model, prefill
    from repro.serving import sharded_step
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return SimpleNamespace(
        jax=jax, jnp=jnp, mesh=mesh, ss=sharded_step, sharding=sharding,
        model=model, prefill=prefill,
        cfg=lambda arch: dataclasses.replace(
            h16_config(arch, jax_smoke) if arch in H16 else jax_smoke(arch),
            dtype="float32"))


def adversarial_pool(kv_k, kv_v, T, bs, n_shards):
    """``sharded_check.py``'s placement of a dense cache [L, R, >= T, K,
    hd]: request r's block j on shard (r + j) % n_shards. Returns the
    pools [L, NP, NB, bs, K, hd], tables [NP, R, MB], nblk, tails
    without and with the new token, and its write target wblk/woff."""
    L, nreq = kv_k.shape[:2]
    K, hd = kv_k.shape[3:]
    nblocks = -(-T // bs)
    NB, MB = nreq * nblocks, nblocks + 1
    pk = np.zeros((L, n_shards, NB, bs, K, hd), np.float32)
    pv = np.zeros_like(pk)
    tables = -np.ones((n_shards, nreq, MB), np.int32)
    tails = np.full((n_shards, nreq), bs, np.int32)
    nxt = np.zeros(n_shards, np.int64)
    last = {}
    for r in range(nreq):
        used = {}
        for j in range(nblocks):
            p = (r + j) % n_shards
            blk = int(nxt[p])
            nxt[p] += 1
            c = used.get(p, 0)
            used[p] = c + 1
            tables[p, r, c] = blk
            lo, hi = j * bs, min((j + 1) * bs, T)
            pk[:, p, blk, :hi - lo] = kv_k[:, r, lo:hi]
            pv[:, p, blk, :hi - lo] = kv_v[:, r, lo:hi]
            if hi == T:
                tails[p, r] = hi - lo
                last[r] = (p, blk)
    wblk = np.full((n_shards, nreq), NB, np.int32)
    woff = np.zeros((n_shards, nreq), np.int32)
    tails_new = tails.copy()
    for r, (p, blk) in last.items():
        wblk[p, r], woff[p, r] = blk, T % bs
        tails_new[p, r] += 1
    nblk = (tables >= 0).sum(-1).astype(np.int32)
    return {"pool_k": pk, "pool_v": pv, "tables": tables, "nblk": nblk,
            "tails": tails, "tails_new": tails_new, "wblk": wblk,
            "woff": woff}


def _decode_inputs(arch, tparams):
    """The adversarial pool of a T_HIST-token history (the port's dense
    prefill of it) and the new tokens."""
    from repro_torch.models.prefill import prefill
    cfg = _cfg(arch)
    rng = np.random.default_rng(20)
    hist = rng.integers(0, cfg.vocab_size, (R, T_HIST))
    _, st = prefill(tparams, cfg, torch.from_numpy(hist),
                    max_len=T_HIST + 4)
    inp = adversarial_pool(st.kv_k.numpy(), st.kv_v.numpy(), T_HIST, BS, NP)
    inp["tokens"] = rng.integers(0, cfg.vocab_size, R).astype(np.int32)
    inp["lens"] = np.full(R, T_HIST, np.int32)
    return inp


def _port_decode(tp, cfg, layout, inp, opt, cf, mesh=None, sl=None):
    """One decode step of the port; ``sl`` (pool shards, kv heads) cuts
    the process's slab out of the global pool."""
    pk, pv = inp["pool_k"], inp["pool_v"]
    if sl is not None:
        pk, pv = pk[:, sl[0], ..., sl[1], :], pv[:, sl[0], ..., sl[1], :]
    step = pss.serve_decode_step_opt if opt else pss.serve_decode_step
    logits, pk, pv = step(
        tp, cfg, layout, torch.from_numpy(pk.copy()),
        torch.from_numpy(pv.copy()), inp["tables"], inp["nblk"],
        inp["tails"] if opt else inp["tails_new"], inp["wblk"], inp["woff"],
        inp["tokens"], inp["lens"], capacity_factor=cf, return_logits=True,
        mesh=mesh)
    return logits.numpy(), pk.numpy(), pv.numpy()


# --------------------------------------------------------------------- #
# Single process against JAX
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def decode_refs(mesh_group):
    """JAX's logits and pools for every (arch, capacity factor, schedule),
    with the bridged weights and inputs. (Asks for ``mesh_group`` only so
    that the spawned processes run while the references compute.)"""
    J = _jax()
    out = {}
    for arch in ARCHS + tuple(H16):
        jcfg = J.cfg(arch)
        tp, jp = _weights(arch, J)
        inp = _decode_inputs(arch, tp)
        layout = J.ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
        for cf in (-1.0, 1.25):
            for sched in SCHEDULES[:2] if arch in H16 else SCHEDULES:
                if cf > 0 and not jcfg.is_moe:
                    # JAX's dense layers never read capacity_factor.
                    out[arch, cf, sched] = out[arch, -1.0, sched]
                    continue
                opt = sched != "write"
                fn = J.ss.serve_decode_step_opt if opt else \
                    J.ss.serve_decode_step
                step = J.jax.jit(lambda *a, fn=fn, cf=cf: fn(
                    a[0], jcfg, layout, *a[1:], capacity_factor=cf,
                    return_logits=True))
                os.environ.pop("REPRO_FORCE_GATHER", None)
                if sched == "opt-gather":
                    os.environ["REPRO_FORCE_GATHER"] = "1"
                try:
                    with J.mesh:
                        lg, pk, pv = step(
                            jp, inp["pool_k"], inp["pool_v"], inp["tables"],
                            inp["nblk"],
                            inp["tails"] if opt else inp["tails_new"],
                            inp["wblk"], inp["woff"], inp["tokens"],
                            inp["lens"])
                finally:
                    os.environ.pop("REPRO_FORCE_GATHER", None)
                out[arch, cf, sched] = tuple(np.asarray(x)
                                             for x in (lg, pk, pv))
        out[arch] = (tp, inp)
    return out


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("cf", [1.25, -1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_steps_match_jax(decode_refs, arch, cf, sched):
    tp, inp = decode_refs[arch]
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    got = _port_decode(tp, _cfg(arch), layout, inp, sched != "write", cf)
    want = decode_refs[arch, cf, sched]
    for g, w in zip(got, want):
        _close(g, w)
    # The new token's K landed in its tail slot on its shard only.
    changed = np.abs(got[1] - inp["pool_k"]).max(axis=(0, 3, 4, 5))
    p, r = np.nonzero(inp["wblk"] < inp["pool_k"].shape[2])
    assert changed[p, inp["wblk"][p, r]].all() and \
        np.count_nonzero(changed) == len(p)


@pytest.mark.parametrize("sched", SCHEDULES[:2])
@pytest.mark.parametrize("arch", tuple(H16))
def test_16_head_variants_decode_match_jax(decode_refs, arch, sched):
    tp, inp = decode_refs[arch]
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    got = _port_decode(tp, _cfg(arch), layout, inp, sched != "write", -1.0)
    for g, w in zip(got, decode_refs[arch, -1.0, sched]):
        _close(g, w)


def test_decode_rejects_inconsistent_tables(decode_refs):
    tp, inp = decode_refs["olmo-1b"]
    cfg = _cfg("olmo-1b")
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    bad = dict(inp, nblk=inp["nblk"] + 1)
    with pytest.raises(ValueError, match="nblk"):
        _port_decode(tp, cfg, layout, bad, False, -1.0)
    tables = inp["tables"].copy()
    p, r = np.argwhere(inp["nblk"] == 1)[0]
    tables[p, r, :2] = -1, tables[p, r, 0]   # a hole before a valid slot
    bad = dict(inp, tables=tables, nblk=(tables >= 0).sum(-1))
    for opt in (False, True):
        with pytest.raises(ValueError, match="prefix"):
            _port_decode(tp, cfg, layout, bad, opt, -1.0)


def test_steps_refuse_unpooled_families_and_embeds():
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    for arch in ("recurrentgemma-9b", "xlstm-350m"):
        cfg = _cfg(arch)
        for step in (pss.serve_decode_step, pss.serve_decode_step_opt):
            with pytest.raises(ValueError, match="attention archs"):
                step({}, cfg, layout, torch.zeros(1, 1, 1, 1, 1, 1),
                     torch.zeros(1, 1, 1, 1, 1, 1), None, None, None, None,
                     None, None, None)
        with pytest.raises(ValueError, match="attention archs"):
            pss.serve_prefill_step({"embed": torch.zeros(1)}, cfg, layout,
                                   np.zeros((1, 8), np.int64), block_size=8,
                                   NP=2)
    with pytest.raises(ValueError, match="state steps"):
        pss.serve_prefill_step_state({}, _cfg("olmo-1b"), layout, None,
                                     max_len=8)
    with pytest.raises(ValueError, match="state steps"):
        pss.serve_decode_step_state({}, _cfg("olmo-1b"), layout, None, None)


@pytest.mark.parametrize("B,S,bs,NP_,n_data", [
    (2, 32, 8, 4, 2), (4, 64, 8, 4, 1), (2, 32, 8, 4, 1),    # data-local
    (3, 20, 8, 4, 2), (2, 30, 8, 4, None), (1, 40, 16, 4, 2),  # fallback
    (2, 30, 8, 4, 2)])                             # data-local, not aligned
def test_prefill_layout_equals_jax(B, S, bs, NP_, n_data):
    J = _jax()
    want = J.ss.prefill_layout(B, S, bs, NP_, n_data=n_data)
    got = pss.prefill_layout(B, S, bs, NP_, n_data=n_data)
    for g, w in zip(got[:2], want[:2]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[2] == int(want[2])


@pytest.fixture(scope="module")
def prefill_refs(decode_refs):
    J = _jax()
    out = {}
    layout = J.ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    for arch in ARCHS + tuple(H16):
        jp = J.jax.tree.map(J.jnp.asarray, bridge.to_numpy_tree(
            decode_refs[arch][0]))
        jcfg = J.cfg(arch)
        for B, S, n_data in PREFILLS:
            toks = np.random.default_rng(S).integers(0, jcfg.vocab_size,
                                                     (B, S)).astype(np.int32)
            with J.mesh:
                first, pk, pv = J.jax.jit(lambda p, t: J.ss.serve_prefill_step(
                    p, jcfg, layout, t, block_size=BS, NP=NP, n_data=n_data))(
                        jp, toks)
            out[arch, S] = (toks, np.asarray(first), np.asarray(pk),
                            np.asarray(pv))
    return out


@pytest.mark.parametrize("B,S,n_data", PREFILLS, ids=["aligned", "scatter"])
@pytest.mark.parametrize("arch", ARCHS + tuple(H16))
def test_serve_prefill_step_matches_jax(decode_refs, prefill_refs, arch, B,
                                        S, n_data):
    from repro_torch.models.prefill import prefill
    tp = decode_refs[arch][0]
    cfg = _cfg(arch)
    toks, first, pk, pv = prefill_refs[arch, S]
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    got = pss.serve_prefill_step(tp, cfg, layout, toks, block_size=BS, NP=NP,
                                 n_data=n_data)
    np.testing.assert_array_equal(got[0].numpy(), first)
    _close(got[1].numpy(), pk)
    _close(got[2].numpy(), pv)
    # The pool is the drop-scatter of the dense prefill's rows at
    # prefill_layout's slots.
    wblk, woff, NB_loc = pss.prefill_layout(B, S, BS, NP, n_data=n_data)
    _, st = prefill(tp, cfg, torch.from_numpy(toks.astype(np.int64)),
                    max_len=S, capacity_factor=1.25)
    want = np.zeros_like(got[1].numpy())
    for p in range(NP):
        b, t = np.nonzero(wblk[p] < NB_loc)
        want[:, p, wblk[p, b, t], woff[b, t]] = st.kv_k.numpy()[:, b, t]
    _close(got[1].numpy(), want)


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, dict):
        return [a for k in sorted(x) for a in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _leaves(v)]
    return [np.asarray(x.numpy() if torch.is_tensor(x) else x, np.float32)]


@pytest.mark.parametrize("arch,tol", [("recurrentgemma-9b", TOL),
                                      ("xlstm-350m", 1e-4)])
def test_state_steps_match_jax(arch, tol):
    """One block_pattern group for the hybrid family (JAX's hybrid
    prefill orders RG-LRU states wrongly past one group). xLSTM is held
    at 1e-4, the whole-model tolerance of ``test_torch_xlstm.py``: its
    float32 recurrences move by ~2e-5 for a one-ulp change of the
    weights."""
    J = _jax()
    jcfg = J.cfg(arch)
    tp, jp = _weights(arch, J)
    cfg = _cfg(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12))
    jl = J.ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    pl = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    with J.mesh:
        jt, jst = J.jax.jit(lambda p, t: J.ss.serve_prefill_step_state(
            p, jcfg, jl, t, max_len=40))(jp, toks.astype(np.int32))
    tt, tst = pss.serve_prefill_step_state(tp, cfg, pl, torch.from_numpy(toks),
                                           max_len=40)
    jdec = J.jax.jit(lambda p, s, t: J.ss.serve_decode_step_state(
        p, jcfg, jl, s, t))
    for step in range(3):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for g, w in zip(_leaves(tst), _leaves(jst)):
            _close(g, w, tol)
        if step == 2:
            break
        with J.mesh:
            jt, jst = jdec(jp, jst, jt)
        tt, tst = pss.serve_decode_step_state(tp, cfg, pl, tst,
                                              tt.to(torch.int64))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_dist_matches_jax(decode_refs, arch):
    """A 16-slot ring of the last tokens plus the remote span [0, start)
    over three steps, as the JAX package's own test sets it up."""
    from repro_torch.models.prefill import decode_step_dist, prefill
    J = _jax()
    tp = decode_refs[arch][0]
    jp = J.jax.tree.map(J.jnp.asarray, bridge.to_numpy_tree(tp))
    jcfg, cfg = J.cfg(arch), _cfg(arch)
    B, T, maxlen = 2, 24, 16
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, T + 3))
    _, jfull = J.prefill.prefill(jp, jcfg, toks[:, :T].astype(np.int32),
                                 max_len=T + 8)
    _, jring = J.prefill.prefill(jp, jcfg, toks[:, :T].astype(np.int32),
                                 max_len=maxlen)
    _, ring = prefill(tp, cfg, torch.from_numpy(toks[:, :T]), max_len=maxlen)
    rk = np.array(jfull.kv_k)[:, :, :T - maxlen + 3]
    rv = np.array(jfull.kv_v)[:, :, :T - maxlen + 3]
    jstep = J.jax.jit(J.prefill.decode_step_dist, static_argnums=1)
    for i, t in enumerate(range(T, T + 3)):
        start = np.full(B, T + i + 1 - maxlen, np.int32)
        jl, jring = jstep(jp, jcfg, jring, toks[:, t].astype(np.int32),
                          start, rk, rv, start)
        tl, ring = decode_step_dist(
            tp, cfg, ring, torch.from_numpy(toks[:, t]),
            torch.from_numpy(start).long(), torch.from_numpy(rk),
            torch.from_numpy(rv), torch.from_numpy(start).long())
        _close(tl.numpy(), jl)
        _close(ring.kv_k.numpy(), jring.kv_k)
        np.testing.assert_array_equal(ring.lens.numpy(), jring.lens)


@pytest.mark.parametrize("names,shape", [
    (("data", "model"), (2, 4)), (("data", "model"), (2, 2)),
    (("data", "model"), (1, 1)), (("data", "model"), (4, 1)),
    (("data", "model"), (1, 8)), (("pod", "data", "model"), (2, 2, 4))])
def test_layout_decisions_match_jax(names, shape):
    from repro_torch.distributed.sharding import batch_axes, serve_pool_axes
    J = _jax()
    jmesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    # What the port reads of a DeviceMesh: its axis names and sizes.
    mesh = SimpleNamespace(mesh_dim_names=names, size=lambda i: shape[i])
    assert batch_axes(mesh) == J.sharding.batch_axes(jmesh)
    for arch in ARCHS + ("kimi-k2-1t-a32b",):
        for cfg in (get_smoke_config(arch), _full_cfg(arch)):
            axes = serve_pool_axes(cfg, mesh)
            assert axes == J.sharding.serve_pool_axes(cfg, jmesh)
            # The pool's placement: JAX's PartitionSpec, dim by dim.
            want = J.ss.ServeLayout(batch_axes(mesh), axes).pool_spec()
            got = pss.ServeLayout(batch_axes(mesh), axes).pool_spec()
            assert got == tuple(want)


def _full_cfg(arch):
    from repro_torch.configs import get_config
    return get_config(arch)


# --------------------------------------------------------------------- #
# The mesh half: W = 4 on (2, 2), then W = 2 on (2, 1)
# --------------------------------------------------------------------- #
def serve_layout(cfg, mesh, mode):
    """``mode``'s ServeLayout on ``mesh``: the batch axes, and in tp_head
    mode the pool axes, as ``distributed.sharding`` picks them. seq_model
    is forced: the smoke configs' kv heads divide this TP axis, so
    ``serve_pool_axes`` picks tp_head (sharded_check.py reaches seq_model
    on a TP axis of 4)."""
    from repro_torch.distributed.sharding import batch_axes, serve_pool_axes
    axes = batch_axes(mesh)
    pool = serve_pool_axes(cfg, mesh)
    assert pool == axes
    if mode == "seq_model":
        pool = axes + ("model",)
    return pss.ServeLayout(batch_axes=axes, pool_axes=pool)


def slab_of(world, rank, mode, K):
    """(pool shards, kv heads, batch data rank, data ranks) process
    ``rank`` of a ``MESH_SHAPES[world]`` mesh holds, from its mesh
    coordinates (process r at row-major position r)."""
    n_data, n_model = MESH_SHAPES[world]
    d, m = divmod(rank, n_model)
    if mode == "seq_model":
        n = NP // world
        return slice(rank * n, (rank + 1) * n), slice(0, K), d, n_data
    n = NP // n_data                              # tp_head
    kl = K // n_model
    return slice(d * n, (d + 1) * n), slice(m * kl, (m + 1) * kl), d, n_data


def _rows(nreq, d, n_data):
    if nreq % n_data:
        return slice(0, nreq)
    n = nreq // n_data
    return slice(d * n, (d + 1) * n)


def _mesh_run(rank, world, payload):
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh(MESH_SHAPES[world], device="cpu")
    out = {}
    for arch, mode in MESH_CASES:
        cfg = _cfg(arch)
        tp, inp = payload[arch]
        tp = bridge.from_numpy_tree(tp, device="cpu")
        layout = serve_layout(cfg, mesh, mode)
        shards, heads, _, _ = slab_of(world, rank, mode,
                                      cfg.num_kv_heads)
        res = {"rows": pss.batch_rows(mesh, layout, R)}
        for opt in (False, True):
            res[opt] = _port_decode(tp, cfg, layout, inp, opt, 1.25, mesh,
                                    (shards, heads))
        for B, S, n_data in PREFILLS:
            toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                                     (B, S))
            first, pk, pv = pss.serve_prefill_step(
                tp, cfg, layout, toks, block_size=BS, NP=NP, n_data=n_data,
                mesh=mesh)
            res[S] = (first.numpy(), pk.numpy(), pv.numpy())
        out[arch] = res
    return out


def _slab(names, shape, rank, mode, K):
    """(pool shards, kv heads, batch rows) process ``rank`` of a mesh of
    ``shape`` over ``names`` holds: the pool over the batch axes (and
    "model" in seq_model mode), kv heads over "model" in tp_head mode."""
    coord = dict(zip(names, np.unravel_index(rank, shape)))
    size = dict(zip(names, shape))
    bnames = [a for a in names if a != "model"]
    n_b = int(np.prod([size[a] for a in bnames]))
    b = int(np.ravel_multi_index([coord[a] for a in bnames],
                                 [size[a] for a in bnames]))
    m, tp = int(coord["model"]), size["model"]
    if mode == "seq_model":
        n = NP // (n_b * tp)
        i = b * tp + m
        return slice(i * n, (i + 1) * n), slice(0, K), _rows(R, b, n_b)
    n, kl = NP // n_b, K // tp
    return (slice(b * n, (b + 1) * n), slice(m * kl, (m + 1) * kl),
            _rows(R, b, n_b))


def _placed_run(rank, mesh, names, shape, cases, payload):
    """Each case on placed weights: whether gathering the placed tree
    gives it back bit for bit, each decode schedule's logits, pools and
    (gathered) greedy tokens, and each prefill's first tokens and
    pools."""
    from repro_torch.distributed.placement import gather_params, place_params
    from repro_torch.distributed.sharding import (param_specs,
                                                  validate_divisibility)
    out = {}
    for arch, mode, fsdp in cases:
        cfg = _cfg(arch)
        tree, inp = payload["placed"][arch]
        full = bridge.from_numpy_tree(tree, device="cpu")
        specs = validate_divisibility(param_specs(cfg, full, fsdp=fsdp),
                                      full, mesh)
        placed = place_params(tree, specs, mesh, device="cpu")
        back = gather_params(placed)
        res = {"identity": all(torch.equal(a, b) for a, b in zip(
            _leaves_t(back), _leaves_t(full)))}
        del full, back
        layout = serve_layout(cfg, mesh, mode)
        shards, heads, _ = _slab(names, shape, rank, mode, cfg.num_kv_heads)
        for opt in (False, True):
            lg, pk, pv = _port_decode(placed, cfg, layout, inp, opt, 1.25,
                                      mesh, (shards, heads))
            stream = pss.gather_batch(torch.from_numpy(lg).argmax(-1), mesh,
                                      layout, R)
            res[opt] = (lg, pk, pv, stream.numpy())
        for B, S, n_data in PREFILLS:
            toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                                     (B, S))
            first, pk, pv = pss.serve_prefill_step(
                placed, cfg, layout, toks, block_size=BS, NP=NP,
                n_data=n_data, mesh=mesh)
            res[S] = (pss.gather_batch(first, mesh, layout, B).numpy(),
                      pk.numpy(), pv.numpy())
        out[arch, mode, fsdp] = res
    return out


def _leaves_t(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves_t(tree[k])]
    return [tree]


def _mesh_worker(rank, store, payload, queue):
    import traceback
    torch.set_num_threads(1)
    try:
        out = {}
        for world in (4, 2):
            if rank >= world:
                break
            dist.init_process_group("gloo", init_method=f"file://{store}"
                                    f"-{world}", rank=rank, world_size=world)
            out[world] = _mesh_run(rank, world, payload)
            from repro_torch.distributed.mesh import make_mesh
            for names, shape in PLACED_MESHES[world]:
                mesh = make_mesh(shape, names, device="cpu")
                cases = (_placed_cases(world) if len(shape) == 2
                         else (THREE_AXIS_CASE,))
                out[world, shape] = _placed_run(rank, mesh, names, shape,
                                                cases, payload)
            dist.barrier()
            dist.destroy_process_group()
        queue.put((rank, out))
    except Exception:
        queue.put((rank, traceback.format_exc()))


@pytest.fixture(scope="module")
def mesh_group(tmp_path_factory):
    """The spawned processes, started once, and what they were given."""
    from repro_torch.models.model import init_params
    payload = {"placed": {}}
    for arch, _ in MESH_CASES:
        tp = init_params(_cfg(arch), torch.Generator().manual_seed(3),
                         device="cpu")
        payload[arch] = (bridge.to_numpy_tree(tp), _decode_inputs(arch, tp))
    for arch in {a for a, _, _ in PLACED_CASES}:
        # decode_refs' weights and inputs (seed 0), held to its references.
        tp = init_params(_cfg(arch), torch.Generator().manual_seed(0),
                         device="cpu")
        payload["placed"][arch] = (bridge.to_numpy_tree(tp),
                                   _decode_inputs(arch, tp))
    return payload, Spawned(_mesh_worker, 4,
                            str(tmp_path_factory.mktemp("sl")), payload)


@pytest.fixture(scope="module")
def mesh_runs(mesh_group):
    """Every process's results, and the single-process steps' here."""
    payload, spawned = mesh_group
    single = {}
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    for arch, _ in MESH_CASES:
        cfg = _cfg(arch)
        tp = bridge.from_numpy_tree(payload[arch][0], device="cpu")
        res = {opt: _port_decode(tp, cfg, layout, payload[arch][1], opt,
                                 1.25) for opt in (False, True)}
        for B, S, n_data in PREFILLS:
            toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                                     (B, S))
            res[S] = tuple(t.numpy() for t in pss.serve_prefill_step(
                tp, cfg, layout, toks, block_size=BS, NP=NP, n_data=n_data))
        single[arch] = res
    return spawned.results(), single


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("arch,mode", MESH_CASES,
                         ids=[a for a, _ in MESH_CASES])
def test_mesh_steps_give_each_process_its_shards(mesh_runs, world, arch,
                                                 mode):
    res, single = mesh_runs
    K = _cfg(arch).num_kv_heads
    for rank in range(world):
        got = res[rank][world][arch]
        want = single[arch]
        shards, heads, d, n_data = slab_of(world, rank, mode, K)
        assert got["rows"] == _rows(R, d, n_data)
        for opt in (False, True):
            lg, pk, pv = got[opt]
            assert pk.shape[1] == NP // (world if mode == "seq_model"
                                         else n_data)
            assert pk.shape[4] == heads.stop - heads.start
            _close(lg, want[opt][0][got["rows"]])
            _close(pk, want[opt][1][:, shards, ..., heads, :])
            _close(pv, want[opt][2][:, shards, ..., heads, :])
        for B, S, _ in PREFILLS:
            first, pk, pv = got[S]
            np.testing.assert_array_equal(first, want[S][0][_rows(B, d,
                                                                  n_data)])
            _close(pk, want[S][1][:, shards, ..., heads, :])
            _close(pv, want[S][2][:, shards, ..., heads, :])


def _single_placed_streams(payload):
    """The single-process (replicated) port's greedy tokens of each
    placed case's decode schedules and prefills."""
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    out = {}
    for arch in payload["placed"]:
        cfg = _cfg(arch)
        tree, inp = payload["placed"][arch]
        tp = bridge.from_numpy_tree(tree, device="cpu")
        res = {opt: _port_decode(tp, cfg, layout, inp, opt, 1.25)[0].argmax(-1)
               for opt in (False, True)}
        for B, S, n_data in PREFILLS:
            toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                                     (B, S))
            res[S] = pss.serve_prefill_step(tp, cfg, layout, toks,
                                            block_size=BS, NP=NP,
                                            n_data=n_data)[0].numpy()
        out[arch] = res
    return out


@pytest.fixture(scope="module")
def placed_runs(mesh_group, mesh_runs):
    payload, _ = mesh_group
    return mesh_runs[0], _single_placed_streams(payload)


def _check_placed(res, world, names, shape, case, decode_refs, prefill_refs,
                  single):
    arch, mode, _ = case
    K = _cfg(arch).num_kv_heads
    for rank in range(world):
        got = res[rank][world, shape][case]
        assert got["identity"], f"process {rank}: gather(place) differs"
        shards, heads, rows = _slab(names, shape, rank, mode, K)
        for opt in (False, True):
            lg, pk, pv, stream = got[opt]
            want = decode_refs[arch, 1.25, "opt-fullpool" if opt else "write"]
            assert pk.shape[1] == shards.stop - shards.start
            assert pk.shape[4] == heads.stop - heads.start
            _close(lg, want[0][rows])
            _close(pk, want[1][:, shards, ..., heads, :])
            _close(pv, want[2][:, shards, ..., heads, :])
            np.testing.assert_array_equal(stream, single[arch][opt])
        for B, S, _ in PREFILLS:
            first, pk, pv = got[S]
            _, jfirst, jpk, jpv = prefill_refs[arch, S]
            np.testing.assert_array_equal(first, jfirst)
            np.testing.assert_array_equal(first, single[arch][S])
            _close(pk, jpk[:, shards, ..., heads, :])
            _close(pv, jpv[:, shards, ..., heads, :])


def _placed_cases(world):
    """The placed cases a group runs: FSDP only where "data" has 2."""
    return tuple(c for c in PLACED_CASES if world == 4 or not c[2])


@pytest.mark.parametrize("world,case", [
    (w, c) for w in (4, 2) for c in _placed_cases(w)],
    ids=[f"{w}-{a}-{m}{'-fsdp' if f else ''}"
         for w in (4, 2) for a, m, f in _placed_cases(w)])
def test_placed_steps_match_jax_in_every_process(placed_runs, decode_refs,
                                                 prefill_refs, world, case):
    res, single = placed_runs
    names, shape = PLACED_MESHES[world][0]
    _check_placed(res, world, names, shape, case, decode_refs, prefill_refs,
                  single)


def test_pool_over_two_of_three_mesh_axes(placed_runs, decode_refs,
                                          prefill_refs):
    """("pod", "data", "model") = (2, 1, 2): the pool over ("pod",
    "data"), kv heads over "model" (tp_head), placed weights."""
    from repro_torch.distributed.sharding import serve_pool_axes
    res, single = placed_runs
    names, shape = PLACED_MESHES[4][1]
    mesh = SimpleNamespace(mesh_dim_names=names, size=lambda i: shape[i])
    assert serve_pool_axes(_cfg(THREE_AXIS_CASE[0]), mesh) == ("pod", "data")
    _check_placed(res, 4, names, shape, THREE_AXIS_CASE, decode_refs,
                  prefill_refs, single)


def test_steps_refuse_a_placed_tree_off_its_mesh():
    from repro_torch.distributed.placement import PlacedParams
    cfg = _cfg("olmo-1b")
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    placed = PlacedParams({"embed": torch.zeros(1)}, {"embed": (None,)},
                          mesh=SimpleNamespace(shape=(1, 2)))
    with pytest.raises(ValueError, match="mesh="):
        pss.serve_prefill_step(placed, cfg, layout, np.zeros((1, 8)),
                               block_size=8, NP=2)
    with pytest.raises(ValueError, match="another mesh"):
        pss.serve_prefill_step(placed, cfg, layout, np.zeros((1, 8)),
                               block_size=8, NP=2,
                               mesh=SimpleNamespace(shape=(2, 1)))
    for arch in ("recurrentgemma-9b", "xlstm-350m"):
        with pytest.raises(ValueError, match="mesh="):
            pss.serve_prefill_step_state(placed, _cfg(arch), layout,
                                         np.zeros((1, 8)), max_len=16)
        with pytest.raises(ValueError, match="another mesh"):
            pss.serve_decode_step_state(placed, _cfg(arch), layout, None,
                                        np.zeros(1),
                                        mesh=SimpleNamespace(shape=(2, 1)))


# --------------------------------------------------------------------- #
# embeds= (a modality frontend's output in place of the token embeddings)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("step", ["prefill", "serve_prefill_step",
                                  "serve_prefill_step_state"])
def test_prefill_entry_points_take_embeds_like_jax(step):
    """The same float32 embeddings through each prefill entry point of
    the port and of JAX: first tokens (or logits) and the KV or state
    within 1e-5; and equal to the token path when the embeddings are
    the embedding table's rows."""
    from repro_torch.models.prefill import prefill
    J = _jax()
    arch = {"prefill": "qwen3-0.6b", "serve_prefill_step": "olmo-1b",
            "serve_prefill_step_state": "recurrentgemma-9b"}[step]
    tp, jp = _weights(arch, J)
    cfg, jcfg = _cfg(arch), J.cfg(arch)
    rng = np.random.default_rng(17)
    B, S = 2, 40
    emb = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    table = tp["embed"].numpy()[toks]             # the token path's rows
    layout = pss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    jl = J.ss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    if step == "prefill":
        with J.mesh:
            jlg, jst = J.jax.jit(lambda p, e: J.prefill.prefill(
                p, jcfg, None, e, max_len=S + 4))(jp, emb)
        lg, st = prefill(tp, cfg, embeds=torch.from_numpy(emb),
                         max_len=S + 4)
        _close(lg.numpy(), jlg)
        _close(st.kv_k.numpy(), jst.kv_k)
        lg2, _ = prefill(tp, cfg, embeds=torch.from_numpy(table),
                         max_len=S + 4)
        _close(lg2.numpy(), prefill(tp, cfg, torch.from_numpy(toks),
                                    max_len=S + 4)[0].numpy())
    elif step == "serve_prefill_step":
        with J.mesh:
            jf, jk, jv = J.jax.jit(lambda p, e: J.ss.serve_prefill_step(
                p, jcfg, jl, None, block_size=BS, NP=NP, n_data=2,
                embeds=e))(jp, emb)
        f, pk, pv = pss.serve_prefill_step(tp, cfg, layout, None,
                                           block_size=BS, NP=NP, n_data=2,
                                           embeds=torch.from_numpy(emb))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        _close(pk.numpy(), jk)
        _close(pv.numpy(), jv)
        f2, pk2, _ = pss.serve_prefill_step(
            tp, cfg, layout, None, block_size=BS, NP=NP, n_data=2,
            embeds=torch.from_numpy(table))
        f3, pk3, _ = pss.serve_prefill_step(tp, cfg, layout, toks,
                                            block_size=BS, NP=NP, n_data=2)
        np.testing.assert_array_equal(f2.numpy(), f3.numpy())
        _close(pk2.numpy(), pk3.numpy())
    else:
        with J.mesh:
            jf, jst = J.jax.jit(lambda p, e: J.ss.serve_prefill_step_state(
                p, jcfg, jl, None, max_len=S, embeds=e))(jp, emb)
        f, st = pss.serve_prefill_step_state(tp, cfg, layout, None,
                                             max_len=S,
                                             embeds=torch.from_numpy(emb))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        for g, w in zip(_leaves(st), _leaves(jst)):
            _close(g, w)
        f2, _ = pss.serve_prefill_step_state(tp, cfg, layout, None,
                                             max_len=S,
                                             embeds=torch.from_numpy(table))
        np.testing.assert_array_equal(
            f2.numpy(), pss.serve_prefill_step_state(
                tp, cfg, layout, toks, max_len=S)[0].numpy())
