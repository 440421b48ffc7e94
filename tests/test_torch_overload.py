"""The port's overload survival (pause/spill/resume) against JAX's.

``repro_torch.serving.preempt.Preemptor`` and the engine's pause/resume
path, olmo-1b smoke in float32 (where the JAX pause path is a sound
oracle: in bf16 a resumed stream can flip an argmax against the dense
oracle), JAX weights bridged into the port:

* a running request paused to the preempt tier and resumed through the
  paged path emits the dense oracle's greedy stream and the JAX server's,
  in both pool modes; so does a creditor-spanning request paused
  mid-decode (its live local/creditor split recorded and reproduced at
  resume, the resume landing in the same step as the pause's finished
  event);
* a pause releases every device resource exactly once: the allocators
  return to their state before admission (``_alloc_snapshot``), stay
  there while the request is parked, and again after it finishes;
* a pause requested mid-prefill rolls the admission back exactly and
  re-queues the request (WAITING, flag cleared, preemption counted);
* victim ranking equals JAX's on the same state (same perf-model
  constants, same clock);
* an urgent arrival pauses a best-effort victim through the server's
  overload control, and the victim resumes with the oracle's tokens;
* cancel while paused retires the request and frees its tier frames;
* no pause or resume reallocates a pool.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import serving as jsv
from repro.configs import get_smoke_config
from repro.distributed.hardware import V5E
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro_torch import bridge
from repro_torch import serving as psv
from repro_torch.distributed.hardware import HardwareSpec

MODES = pytest.mark.parametrize("global_pool", [False, True],
                                ids=["per-instance", "global-pool"])


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _oracle(jp, cfg, prompt, n_new):
    logits, state = jax_prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                max_len=len(prompt) + n_new + 2)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = jax_decode_step(jp, cfg, state,
                                    jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def _alloc_snapshot(cluster):
    out = {}
    for i, e in cluster.engines.items():
        a = e.rmanager.pool.alloc
        out[i] = (a.used_count, a.reserved, sorted(a._free),
                  {r: list(rb.blocks)
                   for r, rb in e.rmanager.pool.requests.items()})
    return out


def _v5e_perf(cfg):
    """The port's perf model with the JAX package's hardware constants,
    so both preemptors charge the same modeled costs."""
    fields = {f.name for f in dataclasses.fields(HardwareSpec)}
    hw = HardwareSpec(**{k: v for k, v in dataclasses.asdict(V5E).items()
                         if k in fields})
    return psv.InstancePerfModel(cfg, hw=hw)


def _server(pkg, params, cfg, *, global_pool=False, perf=None, **over):
    policy = over.pop("policy", pkg.OverloadPolicy(enabled=True))
    kw = {"device": "cpu"} if pkg is psv else {}
    if perf is not None:
        kw["perf"] = perf
    return pkg.LLMServer(params, cfg, pkg.ServingConfig.smoke(
        overload=policy, global_pool=global_pool, **over), **kw)


def _pool_ptrs(cluster):
    return [e.pool_k.data_ptr() for e in cluster.engines.values()]


def _pause_after(pkg, params, cfg, prompt, n_new, steps, global_pool):
    """Serve ``prompt``, pause it after ``steps`` server steps, let it
    resume and finish. Returns (tokens, preemptor, cluster)."""
    server = _server(pkg, params, cfg, global_pool=global_pool)
    cl = server.cluster
    h = server.submit(prompt, pkg.SamplingParams(max_new_tokens=n_new))
    req = h._req
    for _ in range(steps):
        server.step()
    assert req.state == pkg.RequestState.RUNNING
    pre = cl.preemptor
    assert pre.pause(req)
    assert req.state == pkg.RequestState.PAUSED and req.slot is None
    assert pre.tier.used_blocks > 0
    out = h.result()
    assert req.preemptions == 1 and pre.stats.resumes == 1
    assert not pre.paused and pre.tier.used_blocks == 0
    server.step()
    return out, pre, cl


@MODES
def test_pause_resume_token_identity(setup, global_pool):
    cfg, jp, tp = setup
    prompt = np.random.default_rng(80).integers(0, cfg.vocab_size,
                                                12).tolist()
    out, pre, cl = _pause_after(psv, tp, cfg, prompt, 14, 5, global_pool)
    jout, _, _ = _pause_after(jsv, jp, cfg, prompt, 14, 5, global_pool)
    assert out == _oracle(jp, cfg, prompt, 14) == jout
    assert pre.stats.spilled_blocks == pre.stats.fetched_blocks > 0
    assert not sum(e.stats.pool_copy_steps for e in cl.engines.values())


@MODES
def test_pause_resume_spanning_mid_decode_identity(setup, global_pool):
    cfg, jp, tp = setup
    prompt = np.random.default_rng(99).integers(0, cfg.vocab_size,
                                                40).tolist()  # spans
    outs = []
    for pkg, params in ((psv, tp), (jsv, jp)):
        server = _server(pkg, params, cfg, global_pool=global_pool)
        cl = server.cluster
        ptrs = _pool_ptrs(cl) if pkg is psv else None
        h = server.submit(prompt, pkg.SamplingParams(max_new_tokens=8))
        req = h._req
        for _ in range(3):
            server.step()
        assert req.state == pkg.RequestState.RUNNING
        assert any(e.rmanager.is_hosting(req.req_id)
                   for e in cl.engines.values()), "expected a creditor span"
        assert cl.preemptor.pause(req)
        assert cl.preemptor.paused[req.req_id].remote_layout
        outs.append(h.result())
        assert req.preemptions == 1 and cl.preemptor.stats.resumes == 1
        server.step()
        for e in cl.engines.values():
            a = e.rmanager.pool.alloc
            assert a.reserved == 0 and a.used_count == 0
        assert cl.preemptor.tier.used_blocks == 0
        if ptrs is not None:
            assert _pool_ptrs(cl) == ptrs
    assert outs[0] == outs[1] == _oracle(jp, cfg, prompt, 8)


@MODES
def test_pause_releases_everything_exactly_once(setup, global_pool):
    cfg, jp, tp = setup
    prompt = np.random.default_rng(81).integers(0, cfg.vocab_size,
                                                40).tolist()
    server = _server(psv, tp, cfg, global_pool=global_pool,
                     max_local_len=16, block_size=4, pool_blocks=32,
                     policy=psv.OverloadPolicy(enabled=True,
                                               min_pause_s=600.0))
    cl = server.cluster
    before = _alloc_snapshot(cl)
    h = server.submit(prompt, psv.SamplingParams(max_new_tokens=6))
    req = h._req
    server.step()
    assert req.state == psv.RequestState.RUNNING
    assert any(e.rmanager.is_hosting(req.req_id)
               for e in cl.engines.values())
    assert cl.preemptor.pause(req)
    assert _alloc_snapshot(cl) == before
    server.step()              # min_pause_s keeps it parked
    assert _alloc_snapshot(cl) == before
    assert req.state == psv.RequestState.PAUSED
    cl.preemptor.policy = psv.OverloadPolicy(enabled=True)
    out = h.result()
    assert req.state == psv.RequestState.FINISHED
    assert out == _oracle(jp, cfg, prompt, 6)
    server.step()
    assert _alloc_snapshot(cl) == before


@MODES
def test_midprefill_pause_rolls_back_and_requeues(setup, global_pool):
    cfg, jp, tp = setup
    prompt = np.random.default_rng(82).integers(0, cfg.vocab_size,
                                                24).tolist()
    server = _server(psv, tp, cfg, global_pool=global_pool)
    cl = server.cluster
    before = _alloc_snapshot(cl)
    h = server.submit(prompt, psv.SamplingParams(max_new_tokens=4))
    req = h._req
    req.pause_requested = True       # lands before the first chunk
    server.step()
    assert req.state == psv.RequestState.WAITING
    assert not req.pause_requested and req.preemptions == 1
    assert _alloc_snapshot(cl) == before
    assert h.result() == _oracle(jp, cfg, prompt, 4)


def test_victim_ranking_equals_jax(setup):
    cfg, jp, tp = setup
    rng = np.random.default_rng(83)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist()
               for _ in range(3)]
    ranked = {}
    for pkg, params, perf in ((psv, tp, _v5e_perf(cfg)),
                              (jsv, jp, jsv.InstancePerfModel(cfg))):
        server = _server(pkg, params, cfg, perf=perf, n_instances=1,
                         max_batch=3)
        sp = pkg.SamplingParams(max_new_tokens=20)
        hs = [server.submit(prompts[0], sp, arrival_time=100.0),
              server.submit(prompts[1], sp, deadline_s=0.75,
                            arrival_time=100.0),
              server.submit(prompts[2], sp, deadline_s=5.0,
                            arrival_time=100.0)]
        for t in range(3):
            server.step(now=100.0 + 0.1 * t)
        got = server.cluster.preemptor.rank_victims(100.3)
        ranked[pkg] = [(s, r.req_id - hs[0].req_id) for s, r in got]
    assert [r for _, r in ranked[psv]] == [r for _, r in ranked[jsv]]
    assert ranked[psv][0] == (float("inf"), 0)   # no deadline: max slack
    for (s, _), (js, _) in zip(ranked[psv], ranked[jsv]):
        assert s == pytest.approx(js, rel=1e-9)


@MODES
def test_urgent_arrival_preempts_and_victim_resumes(setup, global_pool):
    cfg, jp, tp = setup
    rng = np.random.default_rng(84)
    bg_prompt = rng.integers(0, cfg.vocab_size, 10).tolist()
    urgent_prompt = rng.integers(0, cfg.vocab_size, 6).tolist()
    server = _server(psv, tp, cfg, global_pool=global_pool, n_instances=1,
                     max_batch=1)
    pre = server.cluster.preemptor
    bg = server.submit(bg_prompt, psv.SamplingParams(max_new_tokens=16))
    for _ in range(4):
        server.step()
    assert bg._req.state == psv.RequestState.RUNNING
    urgent = server.submit(urgent_prompt, psv.SamplingParams(
        max_new_tokens=4), priority=1, deadline_s=60.0)
    server.step()
    assert bg._req.state == psv.RequestState.PAUSED
    assert pre.stats.preemptions == 1
    assert urgent.result() == _oracle(jp, cfg, urgent_prompt, 4)
    assert bg.result() == _oracle(jp, cfg, bg_prompt, 16)
    assert pre.stats.resumes == 1 and bg._req.preemptions == 1
    m = server.metrics
    assert m["preemptions"] == 1.0 and m["preempt_resumes"] == 1.0
    assert m["paused_now"] == 0.0 and m["preempt_tier_blocks_used"] == 0.0
    fm = psv.LLMServer.frontend_metrics([bg, urgent], wall_s=1.0)
    assert fm["preempted"] == 1.0 and fm["deadline_goodput"] == 1.0


def test_cancel_while_paused(setup):
    cfg, _, tp = setup
    server = _server(psv, tp, cfg)
    h = server.submit(np.random.default_rng(85).integers(
        0, cfg.vocab_size, 10).tolist(), psv.SamplingParams(
            max_new_tokens=30))
    for _ in range(3):
        server.step()
    pre = server.cluster.preemptor
    assert pre.pause(h._req)
    assert pre.tier.used_blocks > 0
    assert server.cancel(h.req_id)
    assert h.status == psv.RequestState.CANCELLED and h.done
    assert pre.tier.used_blocks == 0 and not pre.paused
    server.step()                    # no resurrection, no double free
    assert h.status == psv.RequestState.CANCELLED
    for e in server.cluster.engines.values():
        a = e.rmanager.pool.alloc
        assert a.free_count == a.num_blocks and a.reserved == 0
