"""The port's ssm family (xLSTM) against the JAX package.

``repro_torch.models.xlstm`` and the ssm branches of ``models.model``,
``models.prefill`` and the non-pooled serving engine, in float32 on the
xlstm-350m smoke config (d_model 64, 4 heads, one sLSTM per 8 layers),
JAX weights bridged into the port, numpy-seeded inputs, held to JAX at
1e-5 relative to the largest reference value (``_close``) for every cell
and block, and at ``MODEL_RTOL`` = 1e-4 (the tolerance of the other
model tests, ``tests/test_torch_model.py``) for whole models: at 8
layers a one-ulp relative perturbation of the JAX model's own embedding
table moves its logits by 1.9e-5 relative, so 8 and 16 layers of float32
recurrences cannot agree to 1e-5 unless the arithmetic is bit-identical
(measured: 1.4e-5 and 4.9e-5):

* ``mlstm_step``, ``mlstm_scan``, ``_group_norm``, ``slstm_step`` and
  both block applications, prompt and decode modes;
* ``forward``, ``prefill`` and ``decode_step`` at 8 layers (one group)
  and 16 (two groups) — at 16 JAX's own ``prefill`` + ``decode_step``
  is first checked against its ``forward`` (JAX's hybrid ``prefill``
  orders states wrongly with two groups; its ssm ``prefill`` does not);
* the greedy stream served by ``LLMServer`` (two non-pooled instances,
  several prompts in one batch) equals the JAX dense oracle (``prefill``
  + ``decode_step``) — the JAX server cannot serve this family (its
  admission repacks a KV ring the family does not have);
* an owner crash of an xLSTM instance replays its requests on the
  survivor to the same streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import xlstm as jx
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro_torch import bridge
from repro_torch import serving as psv
from repro_torch.models import xlstm as px
from repro_torch.models.model import decode_step, forward, init_params
from repro_torch.models.prefill import prefill
from repro_torch.serving.faults import FaultEvent, FaultPlan

RTOL = 1e-5
MODEL_RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    """|got - want| <= rtol * max|want| (+ a float32 floor)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale + 1e-7, f"max |diff| {err} vs scale {scale}"


def _cfg(layers=8):
    return dataclasses.replace(get_smoke_config("xlstm-350m", layers=layers),
                               dtype="float32")


@pytest.fixture(scope="module")
def smoke():
    cfg = _cfg()
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mlstm_state(rng, B, nh, hd):
    return (_rand(rng, B, nh, hd, hd), _rand(rng, B, nh, hd),
            _rand(rng, B, nh))


# ------------------------------------------------------------------ #
# Cells
# ------------------------------------------------------------------ #
def test_mlstm_step_matches_jax():
    rng = np.random.default_rng(0)
    B, nh, hd = 2, 4, 8
    q, k, v = (_rand(rng, B, nh, hd) for _ in range(3))
    li, lf = _rand(rng, B, nh), -np.abs(_rand(rng, B, nh))
    for st in (_mlstm_state(rng, B, nh, hd),
               (np.zeros((B, nh, hd, hd), np.float32),
                np.zeros((B, nh, hd), np.float32),
                np.full((B, nh), -1e30, np.float32))):   # the first step
        jh, jst = jx.mlstm_step(q, k, v, li, lf, jx.MLstmState(*st))
        ph, pst = px.mlstm_step(_t(q), _t(k), _t(v), _t(li), _t(lf),
                                px.MLstmState(*map(_t, st)))
        assert torch.isfinite(ph).all()
        _close(ph, jh)
        for a, b in zip(pst, jst):
            _close(a, b)


def test_group_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 5, 64) * 3 + 1
    scale = _rand(rng, 64)
    _close(px._group_norm(_t(x), _t(scale), 4),
           jx._group_norm(jnp.asarray(x), jnp.asarray(scale), 4))


def test_slstm_step_matches_jax(smoke):
    cfg, jp, tp = smoke
    rng = np.random.default_rng(2)
    jblk = jax.tree.map(lambda a: a[0], jp["groups"]["slstm"]["blk"])
    pblk = {k: v[0] for k, v in tp["groups"]["slstm"]["blk"].items()}
    d = cfg.d_model
    xt = _rand(rng, 3, d)
    st = (_rand(rng, 3, d), np.abs(_rand(rng, 3, d)) + 0.5,
          _rand(rng, 3, d), _rand(rng, 3, d))
    jh, jst = jx.slstm_step(jblk, jnp.asarray(xt), jx.SLstmState(*st), d)
    ph, pst = px.slstm_step(pblk, _t(xt), px.SLstmState(*map(_t, st)))
    _close(ph, jh)
    for a, b in zip(pst, jst):
        _close(a, b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_application_matches_jax(smoke, kind):
    """Prompt mode (the scan, with a carried state) and decode mode."""
    cfg, jp, tp = smoke
    rng = np.random.default_rng(3)
    sel = (lambda a: a[0, 1]) if kind == "mlstm" else (lambda a: a[0])
    jblk = jax.tree.map(sel, jp["groups"][kind]["blk"])
    pblk = {k: sel(v) for k, v in tp["groups"][kind]["blk"].items()}
    japply = jx.apply_mlstm_block if kind == "mlstm" else \
        jx.apply_slstm_block
    papply = px.apply_mlstm_block if kind == "mlstm" else \
        px.apply_slstm_block
    x = _rand(rng, 2, 9, cfg.d_model)
    jy, jst = japply(jblk, jnp.asarray(x[:, :6]), cfg)
    py, pst = papply(pblk, _t(x[:, :6]), cfg)
    _close(py, jy)
    for t in range(6, 9):                     # decode continues the scan
        jy, jst = japply(jblk, jnp.asarray(x[:, t:t + 1]), cfg, jst,
                         decode=True)
        py, pst = papply(pblk, _t(x[:, t:t + 1]), cfg, pst, decode=True)
        _close(py, jy)
    for a, b in zip(pst, jst):
        _close(a, b)
    jy2, _ = japply(jblk, jnp.asarray(x[:, 6:]), cfg, jst)   # scan resumes
    py2, _ = papply(pblk, _t(x[:, 6:]), cfg, pst)
    _close(py2, jy2)


# ------------------------------------------------------------------ #
# Model: forward, prefill, decode_step
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("layers", [8, 16], ids=["one-group", "two-groups"])
def test_forward_prefill_decode_match_jax(layers):
    cfg = _cfg(layers)
    jp = jax_init_params(jax.random.PRNGKey(layers), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    T0 = 7
    jfull, _ = jax_forward(jp, cfg, jnp.asarray(toks, jnp.int32))
    full, _ = forward(tp, cfg, torch.from_numpy(toks))
    _close(full, jfull, MODEL_RTOL)
    jlg, jst = jax_prefill(jp, cfg, jnp.asarray(toks[:, :T0], jnp.int32),
                           max_len=16)
    lg, st = prefill(tp, cfg, torch.from_numpy(toks[:, :T0]), max_len=16)
    # JAX's own prefill + decode_step against its forward (group order).
    _close(jlg, jfull[:, T0 - 1])
    _close(lg, jlg, MODEL_RTOL)
    for kind in ("mlstm", "slstm"):
        for a, b in zip(st.rec[kind], jst.rec[kind]):
            _close(a, b, MODEL_RTOL)
    assert st.kv_k is None and st.lens.tolist() == [T0, T0]
    for t in range(T0, toks.shape[1]):
        jlg, jst = jax_decode_step(jp, cfg, jst,
                                   jnp.asarray(toks[:, t], jnp.int32))
        lg, st = decode_step(tp, cfg, st, torch.from_numpy(toks[:, t]))
        _close(jlg, jfull[:, t])
        _close(lg, jlg, MODEL_RTOL)
    for kind in ("mlstm", "slstm"):
        for a, b in zip(st.rec[kind], jst.rec[kind]):
            _close(a, b, MODEL_RTOL)


def test_init_params_has_the_jax_tree(smoke):
    """Seeded port weights: JAX's keys, shapes, dtypes and the gate
    biases (0 input, 3 forget)."""
    cfg = dataclasses.replace(smoke[0], dtype="bfloat16")
    tp = init_params(cfg, device="cpu")
    jshapes = jax.eval_shape(
        lambda: jax_init_params(jax.random.PRNGKey(0), cfg))

    def flat(tree, shape, dtype):
        return {jax.tree_util.keystr(k): (tuple(shape(v)), dtype(v))
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(tp, lambda t: t.shape,
                lambda t: str(t.dtype).replace("torch.", "")) == \
        flat(jshapes, lambda a: a.shape, lambda a: a.dtype.name)
    b_if = tp["groups"]["mlstm"]["blk"]["b_if"][0, 0]
    nh = cfg.num_heads
    assert b_if[:nh].eq(0).all() and b_if[nh:].eq(3).all()


# ------------------------------------------------------------------ #
# Serving: non-pooled engines, greedy stream, owner crash
# ------------------------------------------------------------------ #
# The JAX dense oracle, jitted once per shape (eagerly, each JAX
# decode step re-traces its layer scan).
_jax_prefill = jax.jit(jax_prefill, static_argnames=("cfg", "max_len"))
_jax_decode = jax.jit(jax_decode_step, static_argnums=1)


def _oracle(jp, cfg, prompt, n_new):
    """JAX dense greedy oracle: prefill + decode_step."""
    logits, state = _jax_prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                 max_len=len(prompt) + n_new + 2)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = _jax_decode(jp, cfg, state,
                                jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def _xlstm_server(tp, cfg, **over):
    return psv.LLMServer(tp, cfg, psv.ServingConfig.smoke(
        n_instances=2, max_batch=2, max_local_len=64, pool_blocks=32,
        **over), device="cpu")


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def test_served_stream_matches_jax_oracle(smoke):
    cfg, jp, tp = smoke
    n_new = 6
    prompts = _prompts(cfg, (20, 7, 13, 30), 5)
    server = _xlstm_server(tp, cfg)
    hs = [server.submit(p, psv.SamplingParams(max_new_tokens=n_new))
          for p in prompts]
    server.drain()
    for h, p in zip(hs, prompts):
        assert h.status == psv.RequestState.FINISHED
        assert h.result() == _oracle(jp, cfg, p, n_new)
    engines = server.cluster.engines.values()
    assert all(e.pool_k is None and e.state.kv_k is None for e in engines)
    assert sum(e.stats.decode_steps for e in engines) > 0


def test_owner_crash_replays_to_the_same_stream(smoke):
    """A FaultPlan crash of one xLSTM instance mid-decode: its requests
    replay (re-prefill of prompt + output[:-1]) on the survivor and every
    stream equals the oracle's."""
    cfg, jp, tp = smoke
    n_new = 8
    prompts = _prompts(cfg, (12, 9, 15), 6)
    server = _xlstm_server(tp, cfg)
    cl = server.cluster
    hs = [server.submit(p, psv.SamplingParams(max_new_tokens=n_new))
          for p in prompts]
    for _ in range(3):
        server.step()
    victim = next(i for i, e in cl.engines.items() if e.running)
    eng = cl.engines[victim]
    owned = [h for h in hs if h._req in eng.running]
    queued = [h for h in hs if h._req in eng.waiting]
    cl.install_faults(FaultPlan(events=(
        FaultEvent(step=cl._step_count + 1, kind="crash", target=victim),)))
    server.drain()
    assert victim in cl._dead
    for h, p in zip(hs, prompts):
        assert h.result() == _oracle(jp, cfg, p, n_new)
    assert owned and all(h._req.replays == 1 for h in owned)
    assert all(h._req.replays == 0 for h in queued)   # nothing to replay
    assert server.metrics["fault_recoveries"] == float(len(owned + queued))
