"""The global pool sharded over processes, on the card.

Two processes share one GPU (NCCL refuses two ranks on one device, so
they talk over gloo, which stages CUDA tensors through the host) on a
(2, 1) mesh with ``pool_axes=("data",)``: two of four pool ranks each.
Checked against the same computation in this process: the collective
merge of CUDA partials, and one ``decode_step_global`` at qwen3-0.6b's
attention shapes (16 x 128 query heads, 8 kv heads, width 1024; two
layers, float32) over a 4-rank pool, whose logits and pool rows equal
the single-process global step's; both processes launch the decode rank
kernel once per layer and run no plain version. A third test serves
through ``LLMServer(mesh=, layout=)`` over NCCL in a group of one process
(NCCL takes one process a card), so that the control collectives (the
agreed clock, the divergence guard) run on NCCL too; its streams equal
the server's without a mesh. These tests need an
NVIDIA GPU: they carry the ``cuda`` marker and skip without one. No JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py
"""
import dataclasses
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_collectives import Spawned

TOL = 1e-4
NR, NB, BS, MB, B = 4, 16, 16, 12, 4
LAYERS = 2


def _cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32",
                               num_layers=LAYERS)


def _inputs():
    """Partials [2, B, H(, D)] (shard 1 empty for request 0) and a decode
    step: pool, tables [NR, B, MB], tails, tokens, write targets."""
    cfg = _cfg()
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(23)
    o = rng.standard_normal((2, B, H, D)).astype(np.float32)
    m = rng.standard_normal((2, B, H)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (2, B, H)).astype(np.float32)
    o[1, 0], m[1, 0], l[1, 0] = 0.0, -np.inf, 0.0
    shape = (NR, LAYERS, NB, BS, K, D)
    gk, gv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    tables = -np.ones((NR, B, MB), np.int32)
    tails = np.full((NR, B), BS, np.int32)
    for p in range(NR):
        perm = rng.permutation(NB)
        for r in range(B):
            n = int(rng.integers(0, 4))
            tables[p, r, :n] = perm[3 * r:3 * r + n]
            if n:
                tails[p, r] = rng.integers(1, BS + 1)
    step = dict(tokens=rng.integers(0, cfg.vocab_size, B).astype(np.int32),
                lens=np.array([40, 7, 33, 2], np.int32), tables=tables,
                tails=tails, wblk=np.array([13, 14, NB, 15], np.int32),
                woff=np.array([3, 0, 0, 9], np.int32))
    return (o, m, l), gk, gv, step


def _step(params, cfg, gk, gv, step, **mesh):
    from repro_torch.serving.sharded_step import decode_step_global
    lg, _, _ = decode_step_global(
        params, cfg, step["tokens"], step["lens"], gk, gv, step["tables"],
        step["tails"], step["wblk"], step["woff"], rank=2, **mesh)
    return lg


def _worker(rank, store, inputs, queue):
    try:
        from repro_torch.core.online_softmax import merge_partials_collective
        from repro_torch.distributed.mesh import make_mesh
        from repro_torch.kernels import ops
        from repro_torch.models.model import init_params
        torch.cuda.set_device(0)
        dev = torch.device("cuda")
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=2)
        mesh = make_mesh((2, 1), device=dev)
        parts, gk, gv, step = inputs
        got = merge_partials_collective(
            *(torch.from_numpy(x[rank]).to(dev) for x in parts),
            dist.group.WORLD)
        cfg = _cfg()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        lo = 2 * rank
        tk = torch.from_numpy(gk[lo:lo + 2].copy()).to(dev)
        tv = torch.from_numpy(gv[lo:lo + 2].copy()).to(dev)
        ops.reset_counts()
        lg = _step(params, cfg, tk, tv, step, mesh=mesh,
                   pool_axes=("data",))
        torch.cuda.synchronize()
        queue.put((rank, {"merge": [x.cpu().numpy() for x in got],
                          "logits": lg.cpu().numpy(),
                          "k": tk.cpu().numpy(), "v": tv.cpu().numpy(),
                          "counts": ops.counts()}))
        dist.destroy_process_group()
    except Exception:
        queue.put((rank, traceback.format_exc()))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels import build
    build.build()              # once, here: the processes load it
    inputs = _inputs()
    res = Spawned(_worker, 2, str(tmp_path_factory.mktemp("store")),
                  inputs).results()
    return inputs, res


@pytest.mark.cuda
def test_collective_merge_of_cuda_partials(run):
    from repro_torch.core.online_softmax import merge_partials
    (o, m, l), _, _, _ = run[0]
    dev = torch.device("cuda")
    want = merge_partials(*(torch.from_numpy(x).to(dev) for x in (o, m, l)),
                          axis=0)
    for r in range(2):
        for got, w in zip(run[1][r]["merge"], want):
            np.testing.assert_allclose(got, w.cpu().numpy(), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.cuda
def test_mesh_decode_step_equals_the_single_process_step(run):
    from repro_torch.models.model import init_params
    _, gk, gv, step = run[0]
    dev = torch.device("cuda")
    cfg = _cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    tk, tv = (torch.from_numpy(x.copy()).to(dev) for x in (gk, gv))
    want = _step(params, cfg, tk, tv, step).cpu().numpy()
    for r in range(2):
        got = run[1][r]
        np.testing.assert_allclose(got["logits"], want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()))
        for key, pool in (("k", tk), ("v", tv)):
            np.testing.assert_allclose(
                got[key], pool[2 * r:2 * r + 2].cpu().numpy(), rtol=TOL,
                atol=TOL)
        c = got["counts"]
        assert c["paged_micro_attention_ranks"]["launches"] == LAYERS
        assert all(v["plain_calls"] == 0 for v in c.values())
        assert c["paged_micro_attention"]["launches"] == 0


def _smoke():
    import repro_torch.serving as psv
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              dtype="float32")
    config = psv.ServingConfig.smoke(n_instances=2, max_batch=2,
                                     pool_blocks=32, global_pool=True)
    prompts = [np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                 n).tolist()
               for n in (40, 9)]
    return cfg, config, prompts


def _serve_smoke(dev, **mesh):
    import repro_torch.serving as psv
    from repro_torch.models.model import init_params
    cfg, config, prompts = _smoke()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    server = psv.LLMServer(params, cfg, config, device=dev, **mesh)
    handles = [server.submit(p, psv.SamplingParams(max_new_tokens=8))
               for p in prompts]
    server.drain(max_steps=400)
    return [h.result() for h in handles]


def _nccl_worker(rank, store, queue):
    try:
        import repro_torch.serving as psv
        from repro_torch.distributed.mesh import make_mesh
        torch.cuda.set_device(0)
        dev = torch.device("cuda")
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=1)
        mesh = make_mesh((1, 1), device=dev)
        layout = psv.ServeLayout(batch_axes=("data",), pool_axes=("data",))
        streams = _serve_smoke(dev, mesh=mesh, layout=layout)
        queue.put((rank, {"backend": str(dist.get_backend()),
                          "streams": streams}))
        dist.destroy_process_group()
    except Exception:
        queue.put((rank, traceback.format_exc()))


@pytest.mark.cuda
def test_mesh_server_runs_its_control_collectives_on_nccl(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels import build
    build.build()
    got = Spawned(_nccl_worker, 1, str(tmp_path)).results()[0]
    assert got["backend"] == "nccl"
    assert got["streams"] == _serve_smoke(torch.device("cuda"))


# --------------------------------------------------------------------- #
# A one-process NCCL mesh: the placed hybrid prefill and the host tier
# --------------------------------------------------------------------- #
HYBRID_S = 3000        # past recurrentgemma's 2,048-token window


class FlashSpy:
    """Each ``ops.flash_prefill`` call's query heads, and its output
    against the plain twin on the same inputs (the comparison's own
    calls are not counted)."""

    def __enter__(self):
        from repro_torch.kernels import flash_prefill as fp, ops
        self.ops, self.plain, self.orig = ops, fp.flash_prefill_plain, \
            ops.flash_prefill
        self.heads, self.err = [], 0.0

        def spy(q, k, v, **kw):
            out = self.orig(q, k, v, **kw)
            want = self.plain(q, k, v, scale=kw.get("scale") or
                              q.shape[-1] ** -0.5,
                              window=kw.get("window", 0))
            self.heads.append((q.shape[2], k.shape[2]))
            self.err = max(self.err, float((out - want).abs().max()))
            return out
        ops.flash_prefill = spy
        return self

    def __exit__(self, *exc):
        self.ops.flash_prefill = self.orig


def _hybrid_case(dev, mesh):
    """The placed recurrentgemma prefill (full width, one group, float32)
    on ``mesh``: its first tokens, the flash calls' heads and error, the
    kernel launches; and the same step on the whole tree, unplaced."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.placement import (param_shapes,
                                                   seeded_params)
    from repro_torch.distributed.sharding import (param_specs,
                                                  validate_divisibility)
    from repro_torch.kernels import ops
    from repro_torch.serving import sharded_step as ss
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3,
                              dtype="float32")
    shapes = param_shapes(cfg)
    specs = validate_divisibility(param_specs(cfg, shapes, fsdp=False),
                                  shapes, mesh)
    placed = seeded_params(cfg, 3, mesh=mesh, specs=specs, device=dev)
    layout = ss.ServeLayout(("data",), ("data",))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (1, HYBRID_S))
    ops.reset_counts()
    with FlashSpy() as spy:
        first, state = ss.serve_prefill_step_state(
            placed, cfg, layout, toks, max_len=HYBRID_S, mesh=mesh)
    counts = ops.counts()
    whole = seeded_params(cfg, 3, device=dev)
    want, _ = ss.serve_prefill_step_state(whole, cfg, layout, toks,
                                          max_len=HYBRID_S)
    return {"first": first.cpu().tolist(), "want": want.cpu().tolist(),
            "heads": spy.heads, "err": spy.err,
            "tp": placed.tp.count if placed.tp else 1,
            "launches": counts["flash_prefill"]["launches"],
            "plain": counts["flash_prefill"]["plain_calls"],
            "ring": tuple(state.kv_k.shape)}


def _host_tier_case(dev, mesh):
    """Every cached replica spilled to the host tier and fetched back:
    the fetched blocks hold exactly the spilled bytes."""
    import repro_torch.serving as psv
    from repro_torch.models.model import init_params
    cfg, config, prompts = _smoke()
    config = config.replace(prefix_cache=True, host_tier_blocks=16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    layout = psv.ServeLayout(batch_axes=("data",), pool_axes=("data",))
    server = psv.LLMServer(params, cfg, config, device=dev, mesh=mesh,
                           layout=layout)
    cl = server.cluster
    base = prompts[0][:24]
    first = server.submit(base, psv.SamplingParams(max_new_tokens=8))
    server.drain(max_steps=400)
    nodes = {nd.hash: cl.engines[i].read_block_rows(b)
             for nd in cl.prefix_cache._nodes.values()
             for i, b in list(nd.replicas.items())[:1]}
    for i in cl.engines:
        cl.prefix_cache.evict_device(i, 10 ** 6)
    spilled = cl.host_tier.stats.spills
    again = server.submit(base, psv.SamplingParams(max_new_tokens=8))
    server.drain(max_steps=400)
    exact = []
    for h, (k, v) in nodes.items():
        nd = cl.prefix_cache._nodes.get(h)
        if nd is None or not nd.replicas:
            continue
        i, b = next(iter(nd.replicas.items()))
        k2, v2 = cl.engines[i].read_block_rows(b)
        exact.append(bool(torch.equal(k, k2) and torch.equal(v, v2)))
    return {"spilled": spilled, "fetched": cl.host_tier.stats.fetches,
            "exact": exact, "streams": [first.result(), again.result()]}


def _nccl_cases_worker(rank, store, queue):
    try:
        from repro_torch.distributed.mesh import make_mesh
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=1)
        mesh = make_mesh((1, 1), device=dev)
        queue.put((rank, {"hybrid": _hybrid_case(dev, mesh),
                          "host_tier": _host_tier_case(dev, mesh)}))
        dist.destroy_process_group()
    except Exception:
        queue.put((rank, traceback.format_exc()))


@pytest.fixture(scope="module")
def nccl_cases(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels import build
    build.build()
    return Spawned(_nccl_cases_worker, 1,
                   str(tmp_path_factory.mktemp("nccl"))).results()[0]


@pytest.mark.cuda
def test_placed_hybrid_prefill_launches_flash_on_its_heads(nccl_cases):
    """recurrentgemma's placed prefill on a one-process mesh: each local
    attention layer launches the flash kernel once, on 16 / tp query
    heads over the one kv head, within 1e-4 of the plain twin; the first
    token equals the unplaced step's."""
    got = nccl_cases["hybrid"]
    assert got["launches"] == 1 and got["plain"] == 0
    assert got["heads"] == [(16 // got["tp"], 1)]
    assert got["err"] <= 1e-4
    assert got["first"] == got["want"]
    assert got["ring"][2:4] == (2048, 1)


@pytest.mark.cuda
def test_host_tier_round_trip_under_a_one_process_mesh(nccl_cases):
    got = nccl_cases["host_tier"]
    assert got["spilled"] >= 3 and got["fetched"] >= 3
    assert got["exact"] and all(got["exact"])
    assert got["streams"][0] == got["streams"][1]
