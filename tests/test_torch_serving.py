"""The port's serving stack against the JAX package, token for token.

JAX float32 olmo-1b smoke weights are bridged into the port, and the
same numpy-made prompts are served by the port and by the JAX package.
Greedy streams must equal the JAX dense oracle (``prefill`` +
``decode_step``) and the JAX serving stack's own streams for:
continuous batching; a request spanning creditors with mid-decode moves;
a prompt whose prefix stripes across two creditors at admission; a
decode-time striped Algorithm-1 move (the executed plans must match the
JAX cluster's step for step, so the port's perf model gets the JAX
package's hardware constants); cancel mid-prefill with the allocators
restored exactly; ``top_k=1`` == greedy, and ``top_k=3`` sampling stays
inside each step's top-3 set (the port's random stream cannot match
JAX's, so sampled paths are checked by support). And a dropped server
frees its weights at once, with the garbage collector off, even with
the prefix cache, host tier and preemption on and a fault injector
installed (no reference cycle holds a cluster).
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro_torch.serving.cluster as pt_cluster_mod
from repro.configs import get_smoke_config
from repro.distributed.hardware import V5E
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro import serving as jsv
from repro_torch import bridge
from repro_torch import serving as psv
from repro_torch.distributed.hardware import HardwareSpec
from repro_torch.models.model import init_params as pt_init_params


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _v5e_perf(cfg, **kw):
    """The port's perf model with the JAX package's hardware constants,
    so both Algorithm-1 planners see the same modeled costs."""
    fields = {f.name for f in dataclasses.fields(HardwareSpec)}
    hw = HardwareSpec(**{k: v for k, v in dataclasses.asdict(V5E).items()
                         if k in fields})
    return psv.InstancePerfModel(cfg, hw=hw, **kw)


def _oracle(jp, cfg, prompt, n_new):
    """JAX dense greedy oracle: prefill + decode_step."""
    logits, state = jax_prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                max_len=len(prompt) + n_new + 2)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = jax_decode_step(jp, cfg, state,
                                    jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def _oracle_logits(jp, cfg, prompt, forced):
    """JAX dense oracle's logits, teacher-forced on ``forced``."""
    logits, state = jax_prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                max_len=len(prompt) + len(forced) + 2)
    out = [np.asarray(logits[0])]
    for tok in forced[:-1]:
        logits, state = jax_decode_step(jp, cfg, state,
                                        jnp.asarray([tok], jnp.int32))
        out.append(np.asarray(logits[0]))
    return out


def _serve(pkg, params, cfg, config, prompts, n_new, **kw):
    """Greedy streams of ``prompts`` through ``pkg``'s LLMServer."""
    server = pkg.LLMServer(params, cfg, config, **kw)
    handles = [server.submit(list(p), pkg.SamplingParams(max_new_tokens=n_new))
               for p in prompts]
    server.drain(max_steps=500)
    assert all(h.status.name == "FINISHED" for h in handles)
    return [h.result() for h in handles], server


def _run_engine(eng, reqs, steps=60):
    for r in reqs:
        eng.submit(r)
    for _ in range(steps):
        if all(r.done for r in reqs):
            break
        eng.step()
    assert all(r.state.name == "FINISHED" for r in reqs)
    return [r.output for r in reqs]


def _alloc_snapshot(cluster):
    out = {}
    for i, e in cluster.engines.items():
        a = e.rmanager.pool.alloc
        out[i] = (a.used_count, a.reserved, sorted(a._free),
                  {r: list(rb.blocks)
                   for r, rb in e.rmanager.pool.requests.items()})
    return out


# ------------------------------------------------------------------ #
def test_continuous_batching_matches_oracle_and_jax_engine(setup):
    cfg, jp, tp = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9, 13)]
    n_new = 6
    kw = dict(max_batch=4, max_local_len=64, pool_blocks=64, block_size=8)
    got = _run_engine(
        psv.InstanceEngine(tp, cfg, device="cpu", **kw),
        [psv.Request(prompt=p, sampling=psv.SamplingParams(
            max_new_tokens=n_new)) for p in prompts])
    jax_got = _run_engine(
        jsv.InstanceEngine(jp, cfg, **kw),
        [jsv.Request(prompt=p, sampling=jsv.SamplingParams(
            max_new_tokens=n_new)) for p in prompts])
    assert got == [_oracle(jp, cfg, p, n_new) for p in prompts]
    assert got == jax_got


def test_spanning_request_with_mid_decode_moves(setup):
    cfg, jp, tp = setup
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 40).tolist()
    n_new = 24
    config = psv.ServingConfig.smoke(n_instances=3, max_batch=2,
                                     pool_blocks=32)
    (got,), server = _serve(psv, tp, cfg, config, [prompt], n_new,
                            device="cpu", perf=_v5e_perf(cfg))
    ptrs = {i: (e.pool_k.data_ptr(), e.pool_v.data_ptr())
            for i, e in server.cluster.engines.items()}
    (jax_got,), _ = _serve(jsv, jp, cfg, jsv.ServingConfig.smoke(
        n_instances=3, max_batch=2, pool_blocks=32), [prompt], n_new)
    assert got == _oracle(jp, cfg, prompt, n_new)
    assert got == jax_got
    cl = server.cluster
    assert cl.throughput_stats["kv_moved_bytes"] > 0
    assert cl.throughput_stats["query_shipped_bytes"] > 0
    assert any(e.stats.tokens_moved_steps for e in cl.engines.values()), \
        "no KV move happened during decode"
    # In place, never reallocated as the request grew and moved.
    for i, e in cl.engines.items():
        assert e.stats.pool_copy_steps == 0
        assert (e.pool_k.data_ptr(), e.pool_v.data_ptr()) == ptrs[i]


def test_prefix_stripes_across_two_creditors_at_admission(setup):
    cfg, jp, tp = setup
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 40).tolist()
    n_new = 8
    kw = dict(n_instances=3, max_batch=2, max_local_len=16, pool_blocks=6,
              block_size=4)
    cl = psv.Cluster(tp, cfg, psv.ServingConfig.smoke(**kw),
                     perf=_v5e_perf(cfg), device="cpu")
    req = psv.Request(prompt=prompt,
                      sampling=psv.SamplingParams(max_new_tokens=n_new))
    cl.submit(req)
    cl.step()
    owner = next(e for e in cl.engines.values()
                 if req.req_id in e.remote_insts)
    assert len(owner.remote_insts[req.req_id]) >= 2, \
        "prefix did not stripe across multiple creditors"
    # Admission stages one chunk's [L, C, K, hd] export, never the prompt.
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    chunk_bytes = 2 * L * 8 * K * hd * 4
    assert 0 < owner.stats.admit_stage_bytes <= chunk_bytes
    cl.run_until_done(max_steps=200)
    assert req.state == psv.RequestState.FINISHED
    (jax_got,), _ = _serve(jsv, jp, cfg, jsv.ServingConfig.smoke(**kw),
                           [prompt], n_new)
    assert req.output == _oracle(jp, cfg, prompt, n_new)
    assert req.output == jax_got


def _striped_run(pkg, params, cfg, perf, prompt, n_new):
    """The decode-time striping scenario of the JAX package's striped
    scheduling test; returns (output, executed plans, planned legs)."""
    cl = pkg.Cluster(params, cfg, pkg.ServingConfig.smoke(
        n_instances=3, max_batch=2, max_local_len=64, pool_blocks=16,
        block_size=4, schedule_every=4, avg_new_req_len=4,
        move_chunk_tokens=16, prefill_chunk=32), perf=perf,
        **({"device": "cpu"} if pkg is psv else {}))
    executed = []
    orig = cl._execute_move

    def spy(mv):
        res = orig(mv)
        executed.append((mv.kind, [(leg.dst_inst, leg.num_blocks)
                                   for leg in mv.legs], res.name))
        return res
    cl._execute_move = spy
    req = pkg.Request(prompt=prompt,
                      sampling=pkg.SamplingParams(max_new_tokens=n_new))
    cl.submit(req)
    cl.step()
    owner_id = next(i for i, e in cl.engines.items() if req in e.running)
    assert not cl.engines[owner_id].remote_insts.get(req.req_id)
    # Ballast leaves each creditor 4 free blocks: less than the movable
    # prefix, so one plan must stripe over both creditors.
    for i, e in cl.engines.items():
        if i != owner_id:
            assert e.rmanager.pool.append_tokens(900 + i, 12 * 4)
    cl.step()
    cl.step()
    planned = [[(leg.dst_inst, leg.num_blocks) for leg in mv.legs]
               for mv in cl.gmanager.plan_moves() if mv.req_id == req.req_id]
    cl.run_until_done(max_steps=300)
    assert req.state.name == "FINISHED"
    assert all(e.rmanager.pool.alloc.reserved == 0
               for e in cl.engines.values())
    return req.output, executed, planned


def test_decode_time_striped_move_matches_jax_step_for_step(setup):
    cfg, jp, tp = setup
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 40).tolist()
    n_new = 16
    got, executed, planned = _striped_run(
        psv, tp, cfg, _v5e_perf(cfg, alpha_hop=0.0), prompt, n_new)
    jax_got, jax_executed, jax_planned = _striped_run(
        jsv, jp, cfg, jsv.InstancePerfModel(cfg, alpha_hop=0.0), prompt,
        n_new)
    assert planned and len(planned[0]) >= 2, planned
    assert any(kind == "offload" and res == "OK" and len(legs) >= 2
               for kind, legs, res in executed), executed
    assert any(kind == "reclaim" and res == "OK"
               for kind, _, res in executed), executed
    assert (planned, executed) == (jax_planned, jax_executed)
    assert got == _oracle(jp, cfg, prompt, n_new)
    assert got == jax_got


def test_cancel_mid_prefill_restores_allocators_exactly(setup, monkeypatch):
    cfg, _, tp = setup
    rng = np.random.default_rng(30)
    server = psv.LLMServer(tp, cfg, psv.ServingConfig.smoke(
        max_batch=2, max_local_len=16, pool_blocks=32, block_size=4),
        device="cpu")
    cl = server.cluster
    before = _alloc_snapshot(cl)
    writes = []
    orig_write = pt_cluster_mod.PrefixSink.write

    def write_then_cancel(self, t0, k, v):
        orig_write(self, t0, k, v)
        writes.append(t0)
        server.cancel(self._req_id)      # lands while prefill is in flight
    monkeypatch.setattr(pt_cluster_mod.PrefixSink, "write", write_then_cancel)
    h = server.submit(rng.integers(0, cfg.vocab_size, 40).tolist(),
                      psv.SamplingParams(max_new_tokens=8))
    server.step()
    assert writes and len(writes) < 4, writes
    assert h.status == psv.RequestState.CANCELLED
    assert _alloc_snapshot(cl) == before
    for e in cl.engines.values():
        a = e.rmanager.pool.alloc
        assert a.free_count == a.num_blocks and a.reserved == 0
    monkeypatch.setattr(pt_cluster_mod.PrefixSink, "write", orig_write)
    h2 = server.submit(rng.integers(0, cfg.vocab_size, 10).tolist(),
                       psv.SamplingParams(max_new_tokens=4))
    assert h2.result() and h2.status == psv.RequestState.FINISHED


def test_top_k_one_is_greedy_and_top_k_stays_in_top_set(setup):
    cfg, jp, tp = setup
    rng = np.random.default_rng(33)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    n_new = 8
    kw = dict(max_batch=2, max_local_len=64, pool_blocks=32, block_size=8,
              prefill_chunk=8, device="cpu")
    (got,) = _run_engine(psv.InstanceEngine(tp, cfg, **kw), [psv.Request(
        prompt=prompt, sampling=psv.SamplingParams(
            max_new_tokens=n_new, temperature=0.9, top_k=1))])
    assert got == _oracle(jp, cfg, prompt, n_new)
    (sampled,) = _run_engine(psv.InstanceEngine(tp, cfg, **kw), [psv.Request(
        prompt=prompt, sampling=psv.SamplingParams(
            max_new_tokens=n_new, temperature=1.5, top_k=3))])
    for i, lg in enumerate(_oracle_logits(jp, cfg, prompt, sampled)):
        top3 = set(np.argsort(lg)[-3:].tolist())
        assert sampled[i] in top3, f"step {i}: {sampled[i]} not in {top3}"


def _served_server(cfg, global_pool):
    """A server with the prefix cache, a host tier, preemption and an
    armed fault injector (a stager timeout, a short silence, a host
    fetch error) that served warm, spanning, spilled and paused
    requests; returns it and weak references to one of its weight
    tensors, its cache, both host tiers (which hold pinned host frames
    on the card) and the injector."""
    params = pt_init_params(cfg, device="cpu")
    weight = weakref.ref(params["embed"])
    server = psv.LLMServer(params, cfg, psv.ServingConfig.smoke(
        n_instances=3, max_batch=2, pool_blocks=24, prefix_cache=True,
        host_tier_blocks=16, overload=psv.OverloadPolicy(enabled=True),
        global_pool=global_pool), device="cpu")
    injector = server.cluster.install_faults(psv.FaultPlan(events=(
        psv.FaultEvent(step=1, kind="stager_timeout"),
        psv.FaultEvent(step=2, kind="silence", target=2, duration=1),
        psv.FaultEvent(step=3, kind="host_fetch"))))
    rng = np.random.default_rng(40)
    sp = psv.SamplingParams(max_new_tokens=6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 16, 24, 9)]
    handles = [server.submit(p, sp) for p in prompts]
    for _ in range(3):
        server.step()
    paused = next(h for h in handles if h.status.name == "RUNNING")
    assert server.cluster.preemptor.pause(paused._req)
    server.drain()
    server.submit(prompts[0], sp).result()          # warm, spanning
    assert all(h.status.name == "FINISHED" for h in handles)
    m = server.metrics
    assert m["preempt_resumes"] == 1 and m["cache_hit_tokens"] > 0
    assert m["transfer_retries"] >= 1 and m["dead_instances"] == 0
    assert len(injector.fired) == 3
    cl = server.cluster
    return server, [weight, weakref.ref(cl.prefix_cache),
                    weakref.ref(cl.host_tier), weakref.ref(cl.preemptor),
                    weakref.ref(cl.preemptor.tier), weakref.ref(injector)]


@pytest.mark.parametrize("global_pool", [False, True],
                         ids=["per-instance", "global-pool"])
def test_dropped_server_frees_its_weights_without_gc(setup, global_pool):
    cfg = setup[0]
    gc.collect()
    gc.disable()
    try:
        server, refs = _served_server(cfg, global_pool)
        assert all(r() is not None for r in refs)
        del server
        assert [r() for r in refs] == [None] * len(refs), \
            "a reference cycle keeps the server (or its tiers) alive"
    finally:
        gc.enable()
