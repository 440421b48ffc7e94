"""The port's collectives against the JAX package, over real processes.

Four CPU processes are spawned once for the module (gloo, a ``FileStore``
rendezvous in the test's temporary directory); every check runs in them
with W = 2 (a group of processes 0 and 1) and W = 4 (all four), on
inputs made from a numpy seed here and split between the processes:

* ``merge_partials_collective`` and ``merge_over_axes`` (one all-reduce
  MAX, two SUMs) against JAX's ``merge_partials``/``finalize`` on the
  stacked partials — an empty shard ``(0, -inf, 0)`` among them, and a
  row that is empty on every shard;
* ``distattn_decode_paged(group=)``: each process holds one rank's
  paged pool; against JAX's per-rank MicroAttention over the gathered
  blocks, merged;
* ``grad_sync_compressed`` (int8 all-gather of values and scales, mean
  after dequantization) against JAX's ``quantize_int8``-then-mean on the
  same per-process gradients, and bit for bit against the same
  computation in one process; ``make_grad_sync`` over a ("pod", "data")
  mesh averages over pods only;
* the paper-§7.4 baselines (``ring_attention_prefill``,
  ``tp_head_attention_decode``, ``ship_kv_decode``, ``distattn_decode``)
  against full attention from the port's ``core/attention.py`` and
  JAX's ``micro_attention_*``/``finalize`` on the gathered inputs;
* the ring's shift staged through host memory (as CUDA tensors go over
  gloo) against the direct shift, bit for bit, its copies counted; and
  the staging decision (``host_staged``) as a function of the backend
  and the device.

Tolerance: float32; 1e-6 on the merges, 1e-5 on attention outputs,
1e-7 relative on the gradient sync against JAX.

The spawned processes import this module to find their worker, so JAX
is imported only where the references are computed (``_jax``): each
worker would otherwise spend seconds importing it.
"""
import os
import queue
import time
import traceback
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.attention import (full_attention_decode,
                                        full_attention_prefill)
from repro_torch.training.compression import quantize_int8

WORLD = 4
SIZES = (2, 4)


def _jax():
    """JAX and the reference functions (this process only)."""
    import jax.numpy as jnp
    from repro.core import distattn, online_softmax
    from repro.training.compression import quantize_int8 as quantize
    return SimpleNamespace(
        jnp=jnp, gather=distattn.gather_local_kv,
        mask=distattn.local_mask_from_table,
        finalize=online_softmax.finalize,
        merge=online_softmax.merge_partials,
        attn_decode=online_softmax.micro_attention_decode,
        attn_prefill=online_softmax.micro_attention_prefill,
        quantize=quantize)
B, H, K, D = 3, 8, 4, 8
NB, BS, MB = 6, 4, 3
TIMEOUT_S = 120


def _partials(rng, W):
    """Stacked per-shard partials [W, B, H(, D)]: shard 1 empty, and the
    last row empty on every shard."""
    o = rng.standard_normal((W, B, H, D)).astype(np.float32)
    m = rng.standard_normal((W, B, H)).astype(np.float32)
    l = rng.uniform(0.5, 3.0, (W, B, H)).astype(np.float32)
    for sl in ((1,), (slice(None), B - 1)):
        o[sl], m[sl], l[sl] = 0.0, -np.inf, 0.0
    return o, m, l


def _paged(rng, W):
    """One paged pool a rank, tables [W, B, MB] and tails [W, B]; rank 0
    holds nothing of request 1."""
    pk = rng.standard_normal((W, NB, BS, K, D)).astype(np.float32)
    pv = rng.standard_normal((W, NB, BS, K, D)).astype(np.float32)
    tables = -np.ones((W, B, MB), np.int32)
    tails = np.full((W, B), BS, np.int32)
    for p in range(W):
        perm = rng.permutation(NB)
        for r in range(B):
            n = 0 if (p, r) == (0, 1) else int(rng.integers(1, 3))
            tables[p, r, :n] = perm[2 * r:2 * r + n]
            if n:
                tails[p, r] = rng.integers(1, BS + 1)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, pk, pv, tables, tails


def _grads(rng, W):
    """A gradient tree per process (a zero leaf among them)."""
    return [{"a": rng.standard_normal((5, 7)).astype(np.float32),
             "b": {"c": (rng.standard_normal(11) * 1e-3).astype(np.float32),
                   "z": np.zeros((2, 3), np.float32)}}
            for _ in range(W)]


def _attention_inputs(rng, W):
    """Sequence S = 3 W, split into W blocks of 3; q for decode, q
    blocks for the ring prefill; the decode mask drops two slots."""
    S = 3 * W
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    qp = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[0, 1] = mask[2, S - 1] = False
    return {"q": q, "qp": qp, "k": k, "v": v, "mask": mask}


def _inputs():
    rng = np.random.default_rng(19)
    return {W: {"partials": _partials(rng, W), "paged": _paged(rng, W),
                "grads": _grads(rng, W), "attn": _attention_inputs(rng, W)}
            for W in SIZES}


def _run_checks(rank, W, group, inp):
    """Every collective of the module, as process ``rank`` of ``group``."""
    from repro_torch.core import baselines
    from repro_torch.core.baselines import (distattn_decode,
                                            ring_attention_prefill,
                                            ring_shift, ship_kv_decode,
                                            tp_head_attention_decode)
    from repro_torch.distributed.mesh import HostStaging
    from repro_torch.core.distattn import (distattn_decode_paged,
                                           merge_over_axes)
    from repro_torch.core.online_softmax import merge_partials_collective
    from repro_torch.training.grad_sync import grad_sync_compressed
    from repro_torch.training.tree import tree_map
    T = torch.from_numpy
    out = {}
    o, m, l = (T(x[rank]) for x in inp["partials"])
    o_in = o.clone()
    got = merge_partials_collective(o, m, l, group)
    assert torch.equal(o, o_in)                    # inputs untouched
    out["merge"] = [x.numpy() for x in got]
    out["merge_over_axes"] = merge_over_axes(o, m, l, group).numpy()
    q, pk, pv, tables, tails = inp["paged"]
    out["distattn_paged"] = distattn_decode_paged(
        T(q), [(T(pk[rank]), T(pv[rank]))], T(tables[rank:rank + 1]),
        T(tails[rank:rank + 1]), group=group).numpy()
    out["distattn_paged_none"] = distattn_decode_paged(
        T(q), [], T(tables[:0]), T(tails[:0]), group=group).numpy()
    grads = tree_map(T, inp["grads"][rank])
    out["grad_sync"] = tree_map(lambda t: t.numpy(),
                                grad_sync_compressed(grads, group))
    a = inp["attn"]
    S = a["k"].shape[1]
    s = S // W
    sl = slice(rank * s, (rank + 1) * s)
    pos = np.broadcast_to(np.arange(S, dtype=np.int64), (B, S))
    out["ring"] = ring_attention_prefill(
        T(a["qp"][:, sl]), T(a["k"][:, sl]), T(a["v"][:, sl]),
        T(np.ascontiguousarray(pos[:, sl])),
        T(np.ascontiguousarray(pos[:, sl])),
        torch.ones((B, s), dtype=torch.bool), group).numpy()
    blocks = (T(a["k"][:, sl]), T(np.ascontiguousarray(pos[:, sl])))
    staging = HostStaging()
    out["shift"] = [[t.numpy() for t in ring_shift(blocks, group,
                                                   staging=staging)]]
    # The staged transport (gloo's, for CUDA tensors) on host tensors.
    decide = baselines.host_staged
    baselines.host_staged = lambda backend, device: True
    try:
        out["shift"].append([t.numpy() for t in ring_shift(
            blocks, group, staging=staging)])
    finally:
        baselines.host_staged = decide
    out["shift_staging"] = (staging.copies, staging.bytes)
    hs, ks = slice(rank * H // W, (rank + 1) * H // W), \
        slice(rank * K // W, (rank + 1) * K // W)
    out["tp_head"] = tp_head_attention_decode(
        T(a["q"][:, hs]), T(a["k"][:, :, ks]), T(a["v"][:, :, ks]),
        T(a["mask"])).numpy()
    out["ship_kv"] = ship_kv_decode(
        T(a["q"]), T(a["k"][:, sl]), T(a["v"][:, sl]), T(a["mask"][:, sl]),
        group).numpy()
    out["distattn_decode"] = distattn_decode(
        T(a["q"]), T(a["k"][:, sl]), T(a["v"][:, sl]), T(a["mask"][:, sl]),
        group).numpy()
    return out


def _mesh_grad_sync(rank, grads):
    """make_grad_sync over a (2, 2) ("pod", "data") mesh: pod p's two
    processes hold pod p's gradients."""
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.training.grad_sync import make_grad_sync
    from repro_torch.training.tree import tree_map
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    pod = mesh.get_coordinate()[0]
    sync = make_grad_sync(mesh, "pod")
    return tree_map(lambda t: t.numpy(),
                    sync(tree_map(torch.from_numpy, grads[pod])))


def _worker(rank, store, inputs, queue):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=WORLD)
        pair = dist.new_group([0, 1])      # every process must create it
        out = {}
        for W, group in ((2, pair), (4, dist.group.WORLD)):
            if rank < W:
                out[W] = _run_checks(rank, W, group, inputs[W])
        out["mesh_grad_sync"] = _mesh_grad_sync(rank, inputs[4]["grads"])
        queue.put((rank, out))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        queue.put((rank, traceback.format_exc()))


class Spawned:
    """``worker(rank, store, *args, queue)`` running in ``world`` spawned
    processes; ``results()`` waits for {rank: result} (a worker's
    traceback fails) and reaps the processes."""

    def __init__(self, worker, world, tmp_dir, *args):
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        store = os.path.join(tmp_dir, "store")
        self.procs = [ctx.Process(target=worker,
                                  args=(r, store, *args, self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self):
        res, deadline = {}, time.monotonic() + TIMEOUT_S
        try:
            while len(res) < len(self.procs):
                try:
                    rank, out = self.queue.get(timeout=2)
                    res[rank] = out
                except queue.Empty:
                    dead = [i for i, p in enumerate(self.procs)
                            if p.exitcode not in (None, 0) and i not in res]
                    assert not dead and time.monotonic() < deadline, \
                        f"processes {dead or 'all'} gave no result"
        finally:
            for p in self.procs:
                p.join(timeout=TIMEOUT_S)
                if p.is_alive():
                    p.terminate()
        bad = {r: v for r, v in res.items() if isinstance(v, str)}
        assert not bad, "\n".join(bad.values())
        return res


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = _inputs()
    res = Spawned(_worker, WORLD, str(tmp_path_factory.mktemp("store")),
                  inputs).results()
    return inputs, res


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("W", SIZES)
def test_merge_partials_collective_matches_jax(run, W):
    inputs, res = run
    J = _jax()
    o, m, l = (J.jnp.asarray(x) for x in inputs[W]["partials"])
    want = J.merge(o, m, l, axis=0)
    for r in range(W):
        got = res[r][W]["merge"]
        for g, w in zip(got, want):
            _close(g, w, 1e-6)
        # Every process holds the same merged partial, bit for bit.
        for g, g0 in zip(got, res[0][W]["merge"]):
            np.testing.assert_array_equal(g, g0)
    assert np.isneginf(res[0][W]["merge"][1][B - 1]).all()


@pytest.mark.parametrize("W", SIZES)
def test_merge_over_axes_matches_jax_finalize(run, W):
    inputs, res = run
    J = _jax()
    o, m, l = (J.jnp.asarray(x) for x in inputs[W]["partials"])
    o_g, _, l_g = J.merge(o, m, l, axis=0)
    want = np.asarray(J.finalize(o_g, l_g))
    assert not want[B - 1].any()                  # all-empty row: zeros
    for r in range(W):
        _close(res[r][W]["merge_over_axes"], want, 1e-6)


@pytest.mark.parametrize("W", SIZES)
def test_distattn_decode_paged_over_a_group_matches_jax(run, W):
    inputs, res = run
    J = _jax()
    q, pk, pv, tables, tails = inputs[W]["paged"]
    parts = []
    for p in range(W):
        t = J.jnp.asarray(tables[p])
        k, v = J.gather(J.jnp.asarray(pk[p]), J.jnp.asarray(pv[p]), t)
        mask = J.mask(t, BS, J.jnp.asarray(tails[p]))
        parts.append(J.attn_decode(J.jnp.asarray(q), k, v, mask))
    o, m, l = (J.jnp.stack(x) for x in zip(*parts))
    o_g, _, l_g = J.merge(o, m, l, axis=0)
    want = np.asarray(J.finalize(o_g, l_g))
    for r in range(W):
        _close(res[r][W]["distattn_paged"], want, 1e-5)
        # A process with no rank contributes the empty partial only.
        assert not res[r][W]["distattn_paged_none"].any()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _port_mean(per_process):
    """The sync's math in one process, on the port's quantizer."""
    out = []
    for leaves in zip(*(_leaves(g) for g in per_process)):
        deq = [q.float() * s for q, s in
               (quantize_int8(torch.from_numpy(x)) for x in leaves)]
        out.append(torch.mean(torch.stack(deq), dim=0).numpy())
    return out


def _jax_mean(per_process):
    J = _jax()
    out = []
    for leaves in zip(*(_leaves(g) for g in per_process)):
        deq = [np.asarray(q, np.float32) * np.float32(s) for q, s in
               (J.quantize(J.jnp.asarray(x)) for x in leaves)]
        out.append(np.mean(np.stack(deq), axis=0))
    return out


@pytest.mark.parametrize("W", SIZES)
def test_grad_sync_compressed_matches_jax_and_one_process(run, W):
    inputs, res = run
    grads = inputs[W]["grads"]
    want_jax, want_port = _jax_mean(grads), _port_mean(grads)
    for r in range(W):
        got = _leaves(res[r][W]["grad_sync"])
        for g, wj, wp in zip(got, want_jax, want_port):
            assert g.dtype == np.float32 and g.shape == wj.shape
            np.testing.assert_array_equal(g, wp)
            scale = max(float(np.abs(wj).max()), 1e-30)
            assert float(np.abs(g - wj).max()) <= 1e-7 * scale
    assert not _leaves(res[0][W]["grad_sync"])[2].any()     # the zero leaf


def test_make_grad_sync_averages_over_the_pod_axis(run):
    inputs, res = run
    grads = inputs[4]["grads"][:2]                 # pod 0's, pod 1's
    want = _port_mean(grads)
    for r in range(WORLD):
        for g, w in zip(_leaves(res[r]["mesh_grad_sync"]), want):
            np.testing.assert_array_equal(g, w)


def _jax_full_decode(a):
    J = _jax()
    o, _, l = J.attn_decode(*(J.jnp.asarray(a[n]) for n in
                              ("q", "k", "v", "mask")))
    return np.asarray(J.finalize(o, l))


@pytest.mark.parametrize("W", SIZES)
@pytest.mark.parametrize("kind", ["ship_kv", "distattn_decode"])
def test_decode_baselines_equal_full_attention(run, W, kind):
    inputs, res = run
    a = inputs[W]["attn"]
    want = full_attention_decode(*(torch.from_numpy(a[n]) for n in
                                   ("q", "k", "v", "mask"))).numpy()
    _close(want, _jax_full_decode(a), 1e-5)
    for r in range(W):
        _close(res[r][W][kind], want, 1e-5)


@pytest.mark.parametrize("W", SIZES)
def test_tp_head_attention_decode_equals_its_head_slice(run, W):
    """No collective: each process attends with its own head group over
    the whole sequence."""
    inputs, res = run
    a = inputs[W]["attn"]
    want = full_attention_decode(*(torch.from_numpy(a[n]) for n in
                                   ("q", "k", "v", "mask"))).numpy()
    _close(want, _jax_full_decode(a), 1e-5)
    h = H // W
    for r in range(W):
        _close(res[r][W]["tp_head"], want[:, r * h:(r + 1) * h], 1e-5)


@pytest.mark.parametrize("W", SIZES)
def test_staged_ring_shift_equals_the_direct_shift(run, W):
    """Each process receives the previous one's block, the same bit for
    bit through host memory, whose copies (two out, two back) carry the
    blocks' bytes twice."""
    inputs, res = run
    k = inputs[W]["attn"]["k"]
    s = k.shape[1] // W
    for r in range(W):
        (dk, dpos), (sk, spos) = res[r][W]["shift"]
        prv = (r - 1) % W
        np.testing.assert_array_equal(dk, k[:, prv * s:(prv + 1) * s])
        np.testing.assert_array_equal(dpos[0], np.arange(prv * s,
                                                         (prv + 1) * s))
        np.testing.assert_array_equal(sk, dk)
        np.testing.assert_array_equal(spos, dpos)
        assert res[r][W]["shift_staging"] == (4, 2 * (dk.nbytes
                                                     + dpos.nbytes))


def test_host_staging_decision():
    """gloo stages CUDA tensors and nothing else; NCCL stages nothing."""
    from repro_torch.distributed.mesh import host_staged
    assert host_staged("gloo", torch.device("cuda", 0))
    assert host_staged(dist.Backend.GLOO, "cuda")
    assert not host_staged("gloo", "cpu")
    assert not host_staged("nccl", torch.device("cuda", 0))


@pytest.mark.parametrize("W", SIZES)
def test_ring_attention_prefill_equals_causal_attention(run, W):
    inputs, res = run
    a = inputs[W]["attn"]
    S = a["k"].shape[1]
    s = S // W
    want = full_attention_prefill(torch.from_numpy(a["qp"]),
                                  torch.from_numpy(a["k"]),
                                  torch.from_numpy(a["v"])).numpy()
    J = _jax()
    pos = J.jnp.broadcast_to(J.jnp.arange(S, dtype=J.jnp.int32), (B, S))
    o, _, l = J.attn_prefill(*(J.jnp.asarray(a[n]) for n in
                               ("qp", "k", "v")), pos, pos,
                             J.jnp.ones((B, S), bool))
    _close(want, np.asarray(J.finalize(o, l)), 1e-5)
    for r in range(W):
        _close(res[r][W]["ring"], want[:, r * s:(r + 1) * s], 1e-5)
