"""The port's hybrid-family serving against the JAX package.

JAX float32 recurrentgemma-9b smoke weights (3 layers: two RG-LRU and
one local-attention layer, window 32) are bridged into the port. Its
engines are non-pooled: each request's state lives in a batch slot, and
admission is one dense prefill whose attention layer runs the
flash-prefill kernel's plain twin here. Greedy streams must equal the
JAX dense oracle (``prefill`` + ``decode_step``) with the slot quota
``max_local_len`` above, at and below the window, and the JAX
``LLMServer``'s where that server is right (quota == window; above it
the JAX server fails at admission, below it attends to fewer than
``window`` tokens). A prompt over the quota fails as in JAX; cancel
mid-decode releases the slot and every allocator exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro import serving as jsv
from repro_torch import bridge
from repro_torch import serving as psv
from repro_torch.kernels import ops


def _serve(pkg, params, cfg, config, prompts, n_new, **kw):
    """Greedy streams of ``prompts`` through ``pkg``'s LLMServer."""
    server = pkg.LLMServer(params, cfg, config, **kw)
    handles = [server.submit(list(p), pkg.SamplingParams(max_new_tokens=n_new))
               for p in prompts]
    server.drain(max_steps=500)
    assert all(h.status.name == "FINISHED" for h in handles)
    return [h.result() for h in handles], server


@pytest.fixture(scope="module")
def hybrid():
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _hybrid_config(pkg, max_local_len, **kw):
    """Two instances, two slots each (unless ``kw`` says otherwise): a
    third and fourth request wait for a slot to free (continuous
    batching)."""
    base = dict(n_instances=2, max_batch=2, max_local_len=max_local_len)
    base.update(kw)
    return pkg.ServingConfig.smoke(**base)


_jit_prefill = jax.jit(jax_prefill, static_argnums=1,
                       static_argnames="max_len")
_jit_decode = jax.jit(jax_decode_step, static_argnums=1)


def _hybrid_oracle(jp, cfg, prompt, n_new):
    """The JAX dense greedy oracle (``_oracle``), compiled: the hybrid
    decode step is a Python loop over layers, slow op by op."""
    logits, state = _jit_prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                 max_len=len(prompt) + n_new + 2)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = _jit_decode(jp, cfg, state,
                                jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def _n_attn(cfg):
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))


def test_hybrid_batching_past_the_window_matches_jax_server(hybrid):
    """max_local_len == window (32): four requests under continuous
    batching, each generating past the window; streams == the JAX
    LLMServer's and the JAX dense oracle's, one flash-prefill dispatch
    per attention layer per admission, no pool tensors, one set of
    weight tensors shared by both instances."""
    cfg, jp, tp = hybrid
    rng = np.random.default_rng(40)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 9, 13, 5)]
    n_new = 20
    ops.reset_counts()
    got, server = _serve(psv, tp, cfg, _hybrid_config(psv, 32), prompts,
                         n_new, device="cpu")
    assert ops.counts()["flash_prefill"] == {
        "launches": 0, "plain_calls": _n_attn(cfg) * len(prompts),
        "float32_launches": 0}
    for e in server.cluster.engines.values():
        assert e.pool_k is None and e.state.kv_k.shape[2] == cfg.local_window
        assert e.params is tp
        a = e.rmanager.pool.alloc
        assert a.free_count == a.num_blocks and a.reserved == 0
    assert server.cluster.throughput_stats["kv_moved_bytes"] == 0
    jax_got, _ = _serve(jsv, jp, cfg, _hybrid_config(jsv, 32), prompts,
                        n_new)
    assert got == jax_got
    assert got == [_hybrid_oracle(jp, cfg, p, n_new) for p in prompts]


def test_hybrid_quota_above_the_window_matches_oracle(hybrid):
    """max_local_len 64 > window: a 40-token prompt (> window) is served
    as the dense oracle serves it; the JAX server fails at admission."""
    cfg, jp, tp = hybrid
    prompt = np.random.default_rng(41).integers(0, cfg.vocab_size,
                                                40).tolist()
    n_new = 12
    (got,), _ = _serve(psv, tp, cfg, _hybrid_config(psv, 64), [prompt],
                       n_new, device="cpu")
    assert got == _hybrid_oracle(jp, cfg, prompt, n_new)
    jserver = jsv.LLMServer(jp, cfg, _hybrid_config(jsv, 64))
    jserver.submit(prompt, jsv.SamplingParams(max_new_tokens=n_new))
    with pytest.raises(ValueError):
        jserver.drain(max_steps=50)


def test_hybrid_quota_below_the_window_matches_oracle(hybrid):
    """max_local_len 16 < window: generation runs 30 tokens past the
    quota and the window, and still attends to the whole window (the
    slot ring holds ``local_window`` tokens whatever the quota)."""
    cfg, jp, tp = hybrid
    prompt = np.random.default_rng(42).integers(0, cfg.vocab_size,
                                                8).tolist()
    n_new = 30
    (got,), _ = _serve(psv, tp, cfg, _hybrid_config(psv, 16, block_size=4),
                       [prompt], n_new, device="cpu")
    assert got == _hybrid_oracle(jp, cfg, prompt, n_new)


def test_hybrid_prompt_over_the_quota_fails_as_in_jax(hybrid):
    """A non-pooled engine cannot span creditors: a prompt longer than
    max_local_len - block_size FAILS, and the next request is served."""
    cfg, jp, tp = hybrid
    rng = np.random.default_rng(43)
    long, short = (rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (25, 6))
    states = []
    for pkg, params, kw in ((psv, tp, {"device": "cpu"}), (jsv, jp, {})):
        server = pkg.LLMServer(params, cfg, _hybrid_config(pkg, 32), **kw)
        h_long = server.submit(long, pkg.SamplingParams(max_new_tokens=4))
        h_short = server.submit(short, pkg.SamplingParams(max_new_tokens=4))
        server.drain(max_steps=50)
        states.append((h_long.status.name, h_short.status.name,
                       h_short.result()))
    assert states[0][:2] == ("FAILED", "FINISHED")
    assert states[0] == states[1]


def test_hybrid_cancel_mid_decode_frees_the_slot(hybrid):
    """Cancel a decoding request: its slot and blocks are released
    exactly (every allocator back to free == num_blocks, reserved == 0),
    and the next request reuses the slot — its stream equals the oracle's,
    so nothing of the cancelled request's state survived."""
    cfg, jp, tp = hybrid
    rng = np.random.default_rng(44)
    server = psv.LLMServer(tp, cfg, _hybrid_config(psv, 32, max_batch=1,
                                                   n_instances=1),
                           device="cpu")
    h = server.submit(rng.integers(0, cfg.vocab_size, 17).tolist(),
                      psv.SamplingParams(max_new_tokens=20))
    for _ in range(5):
        server.step()
    assert h.status == psv.RequestState.RUNNING and h.metrics["n_tokens"] > 1
    eng = server.cluster.engines[0]
    slot = eng.slots.index(next(r for r in eng.slots if r is not None))
    assert server.cancel(h.req_id)
    assert h.status == psv.RequestState.CANCELLED
    assert eng.slots == [None]
    a = eng.rmanager.pool.alloc
    assert a.free_count == a.num_blocks and a.reserved == 0
    assert not eng.rmanager.pool.requests
    prompt = rng.integers(0, cfg.vocab_size, 11).tolist()
    h2 = server.submit(prompt, psv.SamplingParams(max_new_tokens=24))
    assert h2.result() == _hybrid_oracle(jp, cfg, prompt, 24)
    assert h2.status == psv.RequestState.FINISHED and slot == 0
    assert a.free_count == a.num_blocks and a.reserved == 0
