"""The port's training path against the JAX package.

The same float32 smoke weights (JAX ``init_params``, bridged) and the
same numpy-made batches go through ``repro.training`` and
``repro_torch.training``:

* ``batch_for_step`` and ``quantize_int8`` bit for bit (exact .5 ties
  round half to even on both sides; a zero tensor has scale 1);
  error-feedback compression over several steps, and its drift bound;
* ``lr_schedule``, ``global_norm`` and one ``adamw_update`` (bf16 and
  float32 leaves) in both moment dtypes;
* ``lm_loss`` and every gradient for each family: olmo-1b, qwen3-0.6b,
  qwen2-moe-a2.7b at capacity 1.25 with ``ep_groups`` 0, 2, 4 and 3
  (32 tokens: not divisible, so the plain path), recurrentgemma-9b at
  5 layers over 40 tokens (past the smoke window of 32), xlstm-350m;
  remat equals no remat exactly; the ``embeds=`` path (also with a
  sinusoidal table);
* ``train_step`` with two microbatches, and 3-step trajectories with
  gradient compression off and on;
* the trainer, ``python -m repro_torch.launch.train --smoke --device
  cpu``, for 2 steps;
* the EP-grouped ``apply_moe`` against JAX's grouped path, run under a
  mesh whose axes are Auto (JAX 0.9's ``jax.make_mesh`` default,
  Explicit, makes ``with_sharding_constraint`` refuse them), with and
  without drops, and a hypothesis property over 2, 4 and 8 groups.

Tolerances (float32 on both sides, summed in different orders):
``RTOL`` = 1e-5 on losses, gradient norms and scalars; each gradient
(and first moment) within ``GRAD_RTOL`` = 1e-4 of its largest magnitude
— for xlstm-350m ``XLSTM_GRAD_RTOL`` = 5e-4: a one-ulp relative change
of JAX's own embedding table moves its gradients by up to 1.6e-4 of a
leaf's largest (measured), and the port is within 1.4e-4; MoE outputs
1e-4 relative to the largest value, as in ``tests/test_torch_moe.py``.
Parameters after AdamW steps are held by ``_close_params``: an update is
about lr times sign(g), so an element whose gradient is smaller than the
two packages' rounding difference may move the other way; every element
stays within 2 lr a step, and all but 0.1% within ``PARAM_ATOL`` = 1e-5
(1% of one update at lr = 1e-3). The losses and gradient norms of every
step, which depend on every parameter, are held to ``RTOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config
from repro.models import moe as jax_moe
from repro.models.model import init_params as jax_init_params
from repro.training import compression as jc
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch import bridge
from repro_torch.launch import train as launch_train
from repro_torch.models import moe
from repro_torch.models.model import forward
from repro_torch.training import compression as pc
from repro_torch.training import data as pdata
from repro_torch.training import optimizer as popt
from repro_torch.training import train_step as pts
from repro_torch.training.tree import tree_leaves

RTOL = 1e-5
GRAD_RTOL = 1e-4
XLSTM_GRAD_RTOL = 5e-4
PARAM_ATOL = 1e-5
MOE_TOL = 1e-4


def _setup(arch, **kw):
    cfg = dataclasses.replace(get_smoke_config(arch, **kw), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _batch(cfg, B=2, S=16, step=0, seed=0):
    dc = jdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B, seed=seed)
    return jdata.batch_for_step(dc, step)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _close_rel(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |diff| {err} vs {scale}"


def _close_trees(got, want, rtol=None, atol=None):
    """Leaf by leaf in JAX's flattening order (sorted dict keys)."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        if atol is not None:
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol,
                                       err_msg=f"leaf {i}")
        else:
            _close_rel(a, b, rtol, f"leaf {i}")


def _close_params(got, want, lr, steps, frac=1e-3):
    """Every element within 2 lr a step; all but ``frac`` of a leaf's
    elements within ``PARAM_ATOL``."""
    for i, (a, b) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want))):
        d = np.abs(_np(a) - _np(b))
        assert d.max() <= 2 * lr * steps, (i, d.max())
        assert (d > PARAM_ATOL).mean() <= frac, (i, (d > PARAM_ATOL).sum())


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


# ------------------------------------------------------------------ #
# Data, compression, optimizer
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed,step,B,S", [(0, 0, 2, 16), (7, 5, 3, 100),
                                           (3, 1234, 4, 4096)])
def test_batch_for_step_bit_for_bit(seed, step, B, S):
    want = jdata.batch_for_step(jdata.DataConfig(50_000, S, B, seed), step)
    got = pdata.batch_for_step(pdata.DataConfig(50_000, S, B, seed), step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_quantize_int8_bit_for_bit():
    rng = np.random.default_rng(0)
    # amax 127 -> scale 1: every .5 is an exact tie (half to even).
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                     -126.5, 0.0], np.float32)
    cases = [ties, rng.standard_normal((64, 33)).astype(np.float32) * 1e-3,
             np.zeros((5, 4), np.float32),
             rng.standard_normal(1000).astype(np.float32) * 50]
    for x in cases:
        wq, ws = jc.quantize_int8(jnp.asarray(x))
        q, s = pc.quantize_int8(_t(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        assert s.item() == float(ws)
        np.testing.assert_array_equal(pc.dequantize_int8(q, s).numpy(),
                                      np.asarray(jc.dequantize_int8(wq, ws)))
    q, _ = pc.quantize_int8(_t(ties))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 0]
    assert pc.quantize_int8(torch.zeros(3))[1].item() == 1.0


def test_error_feedback_matches_jax_and_bounds_drift():
    rng = np.random.default_rng(1)
    g = {"w": rng.standard_normal((64, 64)).astype(np.float32) * 1e-3,
         "b": {"c": rng.standard_normal(17).astype(np.float32)}}
    jg = jax.tree.map(jnp.asarray, g)
    tg = {"w": _t(g["w"]), "b": {"c": _t(g["b"]["c"])}}
    jef, tef = jc.init_error_feedback(jg), pc.init_error_feedback(tg)
    acc = torch.zeros(64, 64)
    for _ in range(20):
        jq, jef = jc.compress_grads_with_ef(jg, jef)
        tq, tef = pc.compress_grads_with_ef(tg, tef)
        for (q, s), (wq, ws) in zip(
                [tq["b"]["c"], tq["w"]],
                [jq["b"]["c"], jq["w"]]):
            np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
            assert s.item() == float(ws)
        _close_trees(tef, jef, rtol=RTOL)
        acc += pc.decompress_grads(tq)["w"]
    drift = float((acc - 20 * tg["w"]).abs().max())
    assert drift < float(tg["w"].abs().max())


def test_lr_schedule_and_global_norm_match_jax():
    cfg = popt.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    steps = np.arange(0, 45, dtype=np.int32)
    got = popt.lr_schedule(cfg, _t(steps))
    want = jopt.lr_schedule(jcfg, jnp.asarray(steps))
    _close_rel(got, want, RTOL)
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((30, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    _close_rel(popt.global_norm(jax.tree.map(_t, tree)),
               jopt.global_norm(jax.tree.map(jnp.asarray, tree)), RTOL)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    rng = np.random.default_rng(3)
    shapes = {"emb": (40, 16), "w": (3, 16, 8), "ln": {"scale": (16,)}}

    def draw(scale=1.0):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    p, g, m = draw(), draw(3.0), draw(0.1)
    v = jax.tree.map(np.abs, draw(0.01))
    bf = {"emb", "w"}                       # bf16 leaves, as the models
    jp = {k: (jnp.asarray(a, jnp.bfloat16) if k in bf else
              jax.tree.map(jnp.asarray, a)) for k, a in p.items()}
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    cfgs = [c(lr=1e-2, warmup_steps=3, total_steps=20,
              moment_dtype=moment_dtype)
            for c in (popt.AdamWConfig, jopt.AdamWConfig)]
    mdt = jnp.dtype(moment_dtype)
    js = jopt.AdamWState(jnp.asarray(4, jnp.int32),
                         jax.tree.map(lambda a: jnp.asarray(a, mdt), m),
                         jax.tree.map(lambda a: jnp.asarray(a, mdt), v))
    ts = popt.AdamWState(torch.tensor(4, dtype=torch.int32),
                         *(bridge.from_numpy_tree(jax.tree.map(np.asarray, t),
                                                  device="cpu")
                           for t in (js.m, js.v)))
    jg = jax.tree.map(jnp.asarray, g)
    new_jp, new_js, jmet = jopt.adamw_update(jp, jg, js, cfgs[1])
    new_tp, new_ts, tmet = popt.adamw_update(tp, jax.tree.map(_t, g), ts,
                                             cfgs[0])
    assert int(new_ts.step) == int(new_js.step) == 5
    _close_rel(tmet["grad_norm"], jmet["grad_norm"], RTOL)
    _close_rel(tmet["lr"], jmet["lr"], RTOL)
    for got, want in ((new_tp, new_jp), (new_ts.m, new_js.m),
                      (new_ts.v, new_js.v)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            # One rounding of the stored dtype apart at most.
            ulp = 2 ** -8 if b.dtype == jnp.bfloat16 else 1e-6
            np.testing.assert_allclose(_np(a), _np(b), rtol=ulp,
                                       atol=1e-7)


# ------------------------------------------------------------------ #
# Loss and gradients, every family
# ------------------------------------------------------------------ #
GRAD_CASES = {
    "olmo-1b": ("olmo-1b", {}, {}),
    "qwen3-0.6b": ("qwen3-0.6b", {}, {}),
    "qwen2-moe-ep0": ("qwen2-moe-a2.7b", {}, {"moe_ep_groups": 0}),
    "qwen2-moe-ep2": ("qwen2-moe-a2.7b", {}, {"moe_ep_groups": 2}),
    "qwen2-moe-ep4": ("qwen2-moe-a2.7b", {}, {"moe_ep_groups": 4}),
    "qwen2-moe-ep3-plain": ("qwen2-moe-a2.7b", {}, {"moe_ep_groups": 3}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {"layers": 5}, {}),
    "xlstm-350m": ("xlstm-350m", {}, {}),
}


def _jax_value_and_grad(cfg, tcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, t, m, e: jts.lm_loss(p, cfg, t, m, tcfg, e)[0]))


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_lm_loss_and_grads_match_jax(case):
    arch, kw, tkw = GRAD_CASES[case]
    cfg, jp, tp = _setup(arch, **kw)
    S = 40 if cfg.family == "hybrid" else 16      # past the window of 32
    toks, mask = _batch(cfg, S=S)
    with _auto_mesh():
        jloss, jgrads = _jax_value_and_grad(cfg, jts.TrainConfig(**tkw))(
            jp, jnp.asarray(toks), jnp.asarray(mask), None)
    loss, _, grads = pts.loss_and_grads(tp, cfg, _t(toks), _t(mask),
                                        pts.TrainConfig(**tkw))
    _close_rel(loss, jloss, RTOL, "loss")
    _close_trees(grads, jgrads, rtol=(XLSTM_GRAD_RTOL if cfg.family == "ssm"
                                      else GRAD_RTOL))


@pytest.mark.parametrize("case", ["qwen3-0.6b", "qwen2-moe-ep2",
                                  "recurrentgemma-9b", "xlstm-350m"])
def test_remat_equals_no_remat(case):
    arch, kw, tkw = GRAD_CASES[case]
    cfg, _, tp = _setup(arch, **kw)
    toks, mask = _batch(cfg, S=40 if cfg.family == "hybrid" else 16)
    outs = [pts.loss_and_grads(tp, cfg, _t(toks), _t(mask),
                               pts.TrainConfig(remat=r, **tkw))
            for r in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][2]), tree_leaves(outs[1][2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("positional", ["rope", "sinusoidal"])
def test_embeds_path_matches_tokens_and_jax(positional):
    cfg, jp, tp = _setup("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, positional=positional)
    toks, mask = _batch(cfg)
    inp = _t(toks[:, :-1])
    want, _ = forward(tp, cfg, inp)
    got, _ = forward(tp, cfg, embeds=tp["embed"][inp])
    assert torch.equal(got, want)
    emb = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jloss, jgrads = _jax_value_and_grad(cfg, jts.TrainConfig())(
        jp, jnp.asarray(toks), jnp.asarray(mask), jnp.asarray(emb))
    loss, _, grads = pts.loss_and_grads(tp, cfg, _t(toks), _t(mask),
                                        pts.TrainConfig(), _t(emb))
    _close_rel(loss, jloss, RTOL, "loss")
    _close_trees(grads, jgrads, rtol=GRAD_RTOL)


# ------------------------------------------------------------------ #
# Train steps and trajectories
# ------------------------------------------------------------------ #
def _states(cfg, jp, tp, acfg_kw, tkw):
    jacfg, tacfg = jopt.AdamWConfig(**acfg_kw), popt.AdamWConfig(**acfg_kw)
    jtcfg, ttcfg = jts.TrainConfig(**tkw), pts.TrainConfig(**tkw)
    js = jts.init_train_state(jp, jacfg, jtcfg)
    ts = pts.init_train_state(tp, tacfg, ttcfg, device="cpu")
    jstep = jax.jit(lambda s, t, m: jts.train_step(
        s, t, m, cfg=cfg, tcfg=jtcfg, adam_cfg=jacfg))

    def tstep(s, t, m):
        return pts.train_step(s, t, m, cfg=cfg, tcfg=ttcfg, adam_cfg=tacfg)
    return js, ts, jstep, tstep


def _close_out(out, jout):
    for k in ("loss", "grad_norm", "lr"):
        _close_rel(out[k], jout[k], RTOL, k)


def test_microbatches_match_jax():
    cfg, jp, tp = _setup("qwen2-moe-a2.7b")
    js, ts, jstep, tstep = _states(
        cfg, jp, tp, {"lr": 1e-3, "warmup_steps": 1},
        {"microbatches": 2, "moe_ep_groups": 2})
    toks, mask = _batch(cfg, B=4)
    with _auto_mesh():
        js, jout = jstep(js, jnp.asarray(toks), jnp.asarray(mask))
    ts, out = tstep(ts, _t(toks), _t(mask))
    _close_out(out, jout)
    _close_trees(ts.opt.m, js.opt.m, rtol=GRAD_RTOL)
    _close_params(ts.params, js.params, lr=1e-3, steps=1)


@pytest.mark.parametrize("compression", [False, True])
def test_three_step_trajectory_matches_jax(compression):
    cfg, jp, tp = _setup("qwen3-0.6b")
    js, ts, jstep, tstep = _states(
        cfg, jp, tp, {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10},
        {"grad_compression": compression})
    dc = jdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                          global_batch=2, seed=1)
    for step in range(3):
        toks, mask = jdata.batch_for_step(dc, step)
        js, jout = jstep(js, jnp.asarray(toks), jnp.asarray(mask))
        ts, out = tstep(ts, _t(toks), _t(mask))
        _close_out(out, jout)
    assert int(ts.opt.step) == 3
    _close_params(ts.params, js.params, lr=1e-3, steps=3)
    if compression:
        # Residuals, held relative to the gradient's scale: its largest
        # magnitude is 127 quantization steps, and a residual is at most
        # half a step. An element rounded the other way (see
        # _close_params) differs by one step.
        for a, b in zip(tree_leaves(ts.ef), jax.tree.leaves(js.ef)):
            d = np.abs(_np(a) - _np(b))
            amax = 254 * np.abs(_np(b)).max()
            assert (d > GRAD_RTOL * amax).mean() <= 1e-3
    else:
        assert ts.ef is None and js.ef is None


def test_launch_train_smoke_on_the_cpu(capsys):
    recs = launch_train.main(["--arch", "qwen3-0.6b", "--steps", "2",
                              "--seq", "32", "--batch", "2", "--smoke",
                              "--device", "cpu"])
    assert [r["step"] for r in recs] == [0, 1]
    acfg = popt.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=2)
    for r in recs:
        assert np.isfinite([r["loss"], r["grad_norm"]]).all()
        assert r["seconds"] > 0 and r["tokens_per_s"] > 0
        assert r["lr"] == pytest.approx(
            float(popt.lr_schedule(acfg, torch.tensor(r["step"]))))
    assert "done: final loss" in capsys.readouterr().out


# ------------------------------------------------------------------ #
# EP-grouped MoE against JAX's grouped path
# ------------------------------------------------------------------ #
_JAX_MOE = jax.jit(jax_moe.apply_moe, static_argnums=(2, 3, 4))


def _moe_pair(cfg, jl, tl, x, cf, G):
    with _auto_mesh():
        want = _JAX_MOE(jl, jnp.asarray(x), cfg, cf, G)
    got = moe.apply_moe(tl, _t(x), cfg, cf, ep_groups=G)
    _close_rel(got, want, MOE_TOL, f"G={G} cf={cf}")


@pytest.fixture(scope="module")
def moe_layer():
    cfg, jp, tp = _setup("qwen2-moe-a2.7b")
    jl = jax.tree.map(lambda a: a[0], jp["moe_layers"]["moe"])
    tl = jax.tree.map(lambda a: a[0], tp["moe_layers"]["moe"])
    return cfg, jl, tl


@pytest.mark.parametrize("G,cf,T", [(2, -1.0, 8), (4, -1.0, 8),
                                    (4, 1.25, 16), (2, 0.5, 24),
                                    (8, 1.25, 32), (3, 1.25, 16)])
def test_ep_grouped_apply_moe_matches_jax(moe_layer, G, cf, T):
    """No drop (capacity -1), drops (1.25 and 0.5 over enough tokens that
    some expert overflows its group capacity) and 3 groups over 32
    tokens (the plain path, in both packages)."""
    cfg, jl, tl = moe_layer
    x = np.random.default_rng(T + G).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    _moe_pair(cfg, jl, tl, x, cf, G)


@settings(max_examples=10, deadline=None)
@given(groups=st.sampled_from([2, 4, 8]), seed=st.integers(0, 2**31 - 1),
       cf=st.sampled_from([-1.0, 1.25]))
def test_ep_grouped_property(moe_layer, groups, seed, cf):
    cfg, jl, tl = moe_layer
    x = np.random.default_rng(seed).standard_normal(
        (groups, 8, cfg.d_model)).astype(np.float32)
    _moe_pair(cfg, jl, tl, x, cf, groups)
