"""The sequence-parallel ServeLayout prefill, against JAX and the port.

``serve_prefill_step(seq_parallel=True)`` on placed weights (Megatron-
style sequence parallelism: the residual split over the TP axis by
position between blocks) runs in four CPU processes spawned once (gloo),
first as W = 4 on (2, 2) and (1, 4) meshes, then processes 0 and 1 as
W = 2 on (1, 2). Float32 smoke widths with 16 query heads (so the
attention's ``wo`` splits over "model" as at production width): qwen3
(GQA 16/8, qk-norm), qwen2-moe (16/16, shared experts, capacity drops)
and musicgen (16/4, ``embeds=`` in place of tokens); qwen3's own 4-head
smoke config on (1, 2), whose ``wo`` stays whole. One forced-FSDP case
and one seq_model case on (2, 2). Checked in every process:

* the first tokens equal JAX's ``serve_prefill_step(seq_parallel=True)``
  (in this process, under a (1, 1) mesh with Auto axes) and the port's
  step without it; the pools (this process's slab) are within 1e-5 of
  the largest value of both, and so are the logits of one
  ``serve_decode_step_opt`` step from each pool;
* a spy on ``TPAxis`` sees, in order: the embedding's reduce-scatter
  (none for ``embeds=``), then each layer's all-gather, reduce-scatter,
  all-gather, reduce-scatter, then the broadcast of the last position
  and the unembedding's collective; no all-reduce before the
  unembedding. Without sequence parallelism: one all-reduce for the
  embedding and two a layer;
* S = 40 (not a multiple of 16): sequence parallelism stays off, as in
  JAX: the same collectives and bit-for-bit the same results as the
  step without it.

The spawned processes import this module; JAX is imported only where
the references are computed.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.serving import sharded_step as pss
from test_torch_collectives import Spawned
from test_torch_serve_layout import _slab, serve_layout

TOL = 1e-5
BS, NP = 32, 4
B, S, S_OFF = 2, 48, 40            # S_OFF: not a multiple of 16
# name -> (smoke config, query heads, kv heads), head_dim 8.
VARIANTS = {"qwen3-h16": ("qwen3-0.6b", 16, 8),
            "qwen2-moe-h16": ("qwen2-moe-a2.7b", 16, 16),
            "musicgen-h16": ("musicgen-medium", 16, 4)}
ARCHS = tuple(VARIANTS) + ("qwen3-0.6b",)
# world -> ((axis names, shape, cases)), a case (arch, mode, fsdp, S).
MESHES = {
    4: ((("data", "model"), (2, 2),
         (("qwen3-h16", "tp_head", False, S),
          ("qwen2-moe-h16", "tp_head", False, S),
          ("musicgen-h16", "tp_head", False, S),
          ("qwen3-h16", "tp_head", True, S),
          ("qwen3-h16", "seq_model", False, S))),
        (("data", "model"), (1, 4),
         (("qwen3-h16", "tp_head", False, S),
          ("qwen2-moe-h16", "tp_head", False, S),
          ("musicgen-h16", "tp_head", False, S)))),
    2: ((("data", "model"), (1, 2),
         (("qwen3-h16", "tp_head", False, S),
          ("qwen2-moe-h16", "tp_head", False, S),
          ("musicgen-h16", "tp_head", False, S),
          ("qwen3-0.6b", "tp_head", False, S),
          ("qwen3-h16", "tp_head", False, S_OFF))),)}
SPIED = ("sum", "sum_scatter", "cat", "from_last")


def _cfg(arch, get=get_smoke_config):
    if arch in VARIANTS:
        base, h, k = VARIANTS[arch]
        cfg = dataclasses.replace(get(base), num_heads=h, num_kv_heads=k,
                                  head_dim=8)
    else:
        cfg = get(arch)
    return dataclasses.replace(cfg, dtype="float32")


def _inputs(arch, S_):
    """(tokens, embeds) of a prefill: musicgen takes embeddings."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(S_)
    if cfg.modality == "audio":
        return None, (rng.standard_normal((B, S_, cfg.d_model))
                      * 0.5).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S_)), None


def _decode_inputs(wblk, NB_loc, S_, first):
    """One ``serve_decode_step_opt`` step's arguments after a prefill
    laid out by ``wblk`` (the tails exclude the new token)."""
    tables = -np.ones((NP, B, -(-S_ // BS) + 1), np.int32)
    tails = np.full((NP, B), BS, np.int32)
    for p in range(NP):
        for b in range(B):
            t = np.nonzero(wblk[p, b] < NB_loc)[0]
            if len(t):
                starts = t[t % BS == 0]
                tables[p, b, :len(starts)] = wblk[p, b, starts]
                tails[p, b] = t[-1] % BS + 1
    owner = np.argmax(wblk[:, :, S_ - 1] < NB_loc, axis=0)
    wb = np.full((NP, B), NB_loc, np.int32)
    wb[owner, np.arange(B)] = wblk[owner, np.arange(B), S_ - 1]
    return (tables, (tables >= 0).sum(-1).astype(np.int32), tails, wb,
            np.full((NP, B), S_ % BS, np.int32), first,
            np.full(B, S_, np.int32))


class _TPSpy:
    """The ``TPAxis`` collectives called inside the block, in order."""

    def __enter__(self):
        from repro_torch.distributed.placement import TPAxis
        self.cls, self.calls = TPAxis, []
        self.orig = {n: getattr(TPAxis, n) for n in SPIED}
        for name, fn in self.orig.items():
            setattr(TPAxis, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(tp, *a, **k):
            self.calls.append(name)
            return fn(tp, *a, **k)
        return call

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)


def _case(rank, mesh, names, shape, case, tree):
    """Both prefills of a case on placed weights, their collectives, and
    one decode step's logits from each pool."""
    from repro_torch.distributed.placement import place_params
    from repro_torch.distributed.sharding import (param_specs,
                                                  validate_divisibility)
    arch, mode, fsdp, S_ = case
    cfg = _cfg(arch)
    full = bridge.from_numpy_tree(tree, device="cpu")
    specs = validate_divisibility(param_specs(cfg, full, fsdp=fsdp), full,
                                  mesh)
    placed = place_params(tree, specs, mesh, device="cpu")
    layout = serve_layout(cfg, mesh, mode)
    n_data = shape[0]
    toks, emb = _inputs(arch, S_)
    emb = None if emb is None else torch.from_numpy(emb)
    wblk, _, NB_loc = pss.prefill_layout(B, S_, BS, NP, n_data=n_data)
    out = {}
    for sp in (False, True):
        with _TPSpy() as spy:
            first, pk, pv = pss.serve_prefill_step(
                placed, cfg, layout, toks, block_size=BS, NP=NP,
                n_data=n_data, embeds=emb, mesh=mesh, seq_parallel=sp)
        first = pss.gather_batch(first, mesh, layout, B).numpy()
        lg, _, _ = pss.serve_decode_step_opt(
            placed, cfg, layout, pk.clone(), pv.clone(),
            *_decode_inputs(wblk, NB_loc, S_, first), mesh=mesh,
            return_logits=True)
        out[sp] = {"first": first, "pk": pk.numpy(), "pv": pv.numpy(),
                   "logits": lg.numpy(), "calls": spy.calls}
    out["slab"] = _slab(names, shape, rank, mode, cfg.num_kv_heads)[:2]
    return out


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
            for names, shape, cases in MESHES[world]:
                mesh = make_mesh(shape, names, device="cpu")
                for case in cases:
                    out[shape, case] = _case(rank, mesh, names, shape, case,
                                             payload[case[0]])
            dist.barrier()
            dist.destroy_process_group()
        queue.put((rank, out))
    except Exception:
        queue.put((rank, traceback.format_exc()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process's results (the processes start first), then JAX's
    sequence-parallel prefill of each case here."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.serving import sharded_step as jss
    from repro_torch.models.model import init_params
    trees = {a: bridge.to_numpy_tree(init_params(
        _cfg(a), torch.Generator().manual_seed(5), device="cpu"))
        for a in ARCHS}
    spawned = Spawned(_worker, 4, str(tmp_path_factory.mktemp("sp")), trees)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    layout = jss.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    refs = {}
    for world in MESHES:
        for _, shape, cases in MESHES[world]:
            for arch, _, _, S_ in cases:
                key = arch, S_, shape[0]
                if S_ != S or key in refs:
                    continue
                toks, emb = _inputs(arch, S_)
                jp = jax.tree.map(jax.numpy.asarray, trees[arch])
                with mesh:
                    refs[key] = [np.asarray(t) for t in jax.jit(
                        lambda p, t, e, c=_cfg(arch, jax_smoke), n=shape[0]:
                        jss.serve_prefill_step(
                            p, c, layout, t, block_size=BS, NP=NP,
                            n_data=n, embeds=e, seq_parallel=True))(
                                jp, toks, emb)]
    return spawned.results(), refs


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _want_calls(arch, sp):
    """The ``TPAxis`` calls of a prefill: the embedding's, two a layer
    (two all-gathers and two reduce-scatters with sequence parallelism;
    one of each fewer where ``wo`` stays whole: fewer than 16 heads),
    the last position's broadcast and the unembedding's (a vocab-split
    table's logits gathered, an untied ``unembed`` split over d
    summed)."""
    cfg = _cfg(arch)
    embed = [] if cfg.modality == "audio" else \
        ["sum_scatter" if sp else "sum"]
    attn = ["sum_scatter"] if cfg.num_heads % 16 == 0 else []
    layer = ["cat"] + attn + ["cat", "sum_scatter"] if sp else \
        ["sum"] * (len(attn) + 1)
    last = ["from_last"] if sp else []
    return (embed + layer * cfg.num_layers + last
            + ["cat" if cfg.tie_embeddings else "sum"])


CASES = [(w, names, shape, case) for w in MESHES
         for names, shape, cases in MESHES[w] for case in cases]


@pytest.mark.parametrize(
    "world,names,shape,case", CASES,
    ids=[f"{'x'.join(map(str, sh))}-{c[0]}-{c[1]}"
         f"{'-fsdp' if c[2] else ''}-S{c[3]}" for _, _, sh, c in CASES])
def test_seq_parallel_prefill_matches_jax_and_the_plain_step(
        runs, world, names, shape, case):
    res, refs = runs
    arch, _, _, S_ = case
    applies = S_ % 16 == 0
    for rank in range(world):
        got = res[rank][shape, case]
        plain, sp = got[False], got[True]
        assert plain["calls"] == _want_calls(arch, False)
        assert sp["calls"] == _want_calls(arch, applies), f"process {rank}"
        if not applies:                         # off, as in JAX
            for k in ("first", "pk", "pv", "logits"):
                np.testing.assert_array_equal(sp[k], plain[k])
            continue
        shards, heads = got["slab"]
        first, jpk, jpv = refs[arch, S_, shape[0]]
        np.testing.assert_array_equal(sp["first"], first)
        np.testing.assert_array_equal(sp["first"], plain["first"])
        for k, jp in (("pk", jpk), ("pv", jpv)):
            _close(sp[k], jp[:, shards, ..., heads, :])
            _close(sp[k], plain[k])
        _close(sp["logits"], plain["logits"])


def test_seq_parallel_needs_s_to_split_over_the_tp_axis():
    """Where the rule applies (S a multiple of 16, a TP axis of several
    processes), an S that the axis does not divide is refused; a plain
    tree or one TP process never applies it."""
    from types import SimpleNamespace
    tp = SimpleNamespace(count=3)
    with pytest.raises(ValueError, match="does not split"):
        pss._seq_parallel(True, 32, tp)
    assert pss._seq_parallel(True, 48, tp)
    assert not pss._seq_parallel(True, 40, tp)
    assert not pss._seq_parallel(True, 32, None)
    assert not pss._seq_parallel(False, 48, tp)
