"""The port's checkpoints against the JAX package's, in one on-disk
format.

* A checkpoint JAX writes (bf16 smoke weights, AdamW moments, error
  feedback) restores into the port bit for bit, and two more train steps
  from it give JAX's losses and gradient norms (float32 weights: within
  1e-5 relative) — training continues as JAX's does.
* A checkpoint the port writes has JAX's manifest (the same leaf paths,
  shapes and dtypes) and restores in JAX bit for bit, bf16 leaves and the
  int32 step included.
* The atomic commit, ``keep`` and the reaping of crashed ``.tmp``
  directories, as ``tests/test_training.py`` checks them for JAX.
* A restart on the CPU reproduces the uninterrupted trajectory (loss
  within 1e-5 relative, parameters within 1e-6, as JAX's
  ``test_checkpoint_restart_identical_training``), and the restored
  state equals the saved one bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint import restore_train_state as jrestore
from repro.checkpoint import save_train_state as jsave
from repro.configs import get_smoke_config
from repro.models.model import init_params as jax_init_params
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    restore_train_state, save_train_state)
from repro_torch.models.model import init_params
from repro_torch.training import optimizer as popt
from repro_torch.training import train_step as pts
from repro_torch.training.data import DataConfig, batch_for_step
from repro_torch.training.tree import tree_leaves

RTOL = 1e-5


def _jax_state(cfg, tkw):
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    return jts.init_train_state(jp, jopt.AdamWConfig(lr=1e-3, warmup_steps=2),
                                jts.TrainConfig(**tkw))


def _like(cfg, tkw):
    """A fresh port state of the same structure (other weights)."""
    params = init_params(cfg, device="cpu")
    return pts.init_train_state(params, popt.AdamWConfig(lr=1e-3,
                                                         warmup_steps=2),
                                pts.TrainConfig(**tkw), device="cpu")


def _state_leaves(s):
    return [s.opt.step] + tree_leaves(s.params) + tree_leaves(s.opt.m) + \
        tree_leaves(s.opt.v) + ([] if s.ef is None else tree_leaves(s.ef))


def _jax_state_leaves(s):
    return [s.opt.step] + jax.tree.leaves(s.params) + \
        jax.tree.leaves(s.opt.m) + jax.tree.leaves(s.opt.v) + \
        jax.tree.leaves(s.ef)


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf (bf16 as uint16), for exact comparison."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def _jax_steps(cfg, state, steps, dc, tkw):
    tcfg = jts.TrainConfig(**tkw)
    acfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2)
    fn = jax.jit(lambda s, t, m: jts.train_step(s, t, m, cfg=cfg, tcfg=tcfg,
                                                adam_cfg=acfg))
    outs = []
    for step in steps:
        toks, mask = batch_for_step(dc, step)
        state, out = fn(state, jnp.asarray(toks), jnp.asarray(mask))
        outs.append(out)
    return state, outs


def _port_steps(cfg, state, steps, dc, tkw):
    tcfg = pts.TrainConfig(**tkw)
    acfg = popt.AdamWConfig(lr=1e-3, warmup_steps=2)
    outs = []
    for step in steps:
        toks, mask = batch_for_step(dc, step)
        state, out = pts.train_step(state, torch.from_numpy(toks),
                                    torch.from_numpy(mask), cfg=cfg,
                                    tcfg=tcfg, adam_cfg=acfg)
        outs.append(out)
    return state, outs


@pytest.mark.parametrize("dtype,tkw", [
    ("bfloat16", {"grad_compression": True}),
    ("float32", {}),
])
def test_jax_checkpoint_restores_into_the_port_and_training_continues(
        tmp_path, dtype, tkw):
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), dtype=dtype)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                    seed=1)
    js, _ = _jax_steps(cfg, _jax_state(cfg, tkw), range(2), dc, tkw)
    jsave(JCheckpointer(str(tmp_path)), 1, js)

    ck = Checkpointer(str(tmp_path))
    assert ck.latest() == 1 and latest_step(str(tmp_path)) == 1
    ts = restore_train_state(ck, 1, _like(cfg, tkw))
    got, want = _state_leaves(ts), _jax_state_leaves(js)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b), strict=True)
    if dtype == "bfloat16":
        return
    _, jouts = _jax_steps(cfg, js, range(2, 4), dc, tkw)
    _, touts = _port_steps(cfg, ts, range(2, 4), dc, tkw)
    for out, jout in zip(touts, jouts):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(out[k]), float(jout[k]),
                                       rtol=RTOL)


@pytest.mark.parametrize("tkw", [{"grad_compression": True}, {}])
def test_port_checkpoint_restores_in_jax(tmp_path, tkw):
    cfg = get_smoke_config("qwen2-moe-a2.7b")         # bf16 leaves
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                    seed=2)
    ts, _ = _port_steps(cfg, _like(cfg, tkw), range(2), dc, tkw)
    save_train_state(Checkpointer(str(tmp_path / "port")), 2, ts)
    jsave(JCheckpointer(str(tmp_path / "jax")), 2,
          _jax_state(cfg, tkw))
    manifests = [json.load(open(tmp_path / d / "step_00000002" /
                                "manifest.json")) for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    js = jrestore(JCheckpointer(str(tmp_path / "port")), 2,
                  _jax_state(cfg, tkw))
    assert int(js.opt.step) == 2
    for a, b in zip(_state_leaves(ts), _jax_state_leaves(js)):
        np.testing.assert_array_equal(_bits(a), _bits(b), strict=True)


def test_checkpoint_atomic_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.ones(4), "b": {"c": torch.zeros(2, 2)}}
    for s in (1, 2, 3):
        ck.save(s, tree)
    assert ck.steps() == [2, 3]                 # GC kept the last 2
    # A crash mid-save leaves a .tmp directory: ignored, then reaped.
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ck.latest() == 3
    ck.save(4, tree)
    assert not any(n.endswith(".tmp") for n in os.listdir(str(tmp_path)))
    assert ck.steps() == [3, 4]
    got = ck.restore(4, {"a": torch.empty(4), "b": {"c": torch.empty(2, 2)}})
    assert torch.equal(got["a"], tree["a"])
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(4, {"a": torch.empty(5), "b": {"c": torch.empty(2, 2)}})


def test_restart_reproduces_the_trajectory_on_the_cpu(tmp_path):
    """Save at step 2 of 6, restore into a fresh state, replay 3..5: the
    same losses and parameters as the uninterrupted run."""
    cfg = get_smoke_config("olmo-1b")
    tkw = {"remat": False}
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                    seed=1)
    ck = Checkpointer(str(tmp_path), keep=2)
    state = _like(cfg, tkw)
    outs = []
    for s in range(6):
        state, out = _port_steps(cfg, state, [s], dc, tkw)
        outs += out
        if s == 2:
            save_train_state(ck, s, state)
            saved = [t.clone() for t in _state_leaves(state)]
    assert ck.latest() == 2
    fresh = _like(cfg, tkw)
    restored = restore_train_state(ck, 2, fresh)
    for a, b in zip(_state_leaves(restored), saved):
        np.testing.assert_array_equal(_bits(a), _bits(b), strict=True)
    replay, routs = _port_steps(cfg, restored, range(3, 6), dc, tkw)
    np.testing.assert_allclose(float(routs[-1]["loss"]),
                               float(outs[-1]["loss"]), rtol=RTOL)
    for a, b in zip(tree_leaves(replay.params), tree_leaves(state.params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-6)
