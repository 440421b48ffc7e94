"""The port's MoE family against the JAX package.

The same float32 smoke weights (JAX ``init_params``, bridged) and the
same numpy-made inputs go through JAX and the port:

* ``apply_moe`` in both capacity modes — no drop (``capacity_factor``
  -1, the serving steps' mode) and JAX's default 1.25, at token counts
  where some expert overflows its capacity so tokens drop (the stable
  sort must drop the tokens JAX drops) — and ``moe_aux_loss``;
* ``forward`` logits and its summed aux loss, and ``prefill`` followed by
  teacher-forced ``decode_step`` against JAX's, for qwen2-moe-a2.7b and
  kimi-k2-1t-a32b (``first_k_dense=1``: a dense layer before the MoE
  layers) smoke configs.

The MoE paged steps (``prefill_chunk_paged``, ``decode_step_paged``) are
cases of ``tests/test_torch_model.py::test_paged_steps_match_jax_and_
dense_oracle``; the MoE bridge round trip is a case of
``tests/test_torch_bridge.py``.

Tolerance: float32 on both sides, summed in different orders; 1e-4
relative to the largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import moe as jax_moe
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro_torch import bridge
from repro_torch.models import moe
from repro_torch.models.model import decode_step, forward
from repro_torch.models.prefill import prefill

TOL = 1e-4
MOE_ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]


def _setup(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def _layer(tree):
    """Layer 0 of a stacked MoE parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v) for k, v in tree.items()}
    return tree[0]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor,T", [(-1.0, 9), (1.25, 9),
                                               (1.25, 40), (0.5, 24)])
def test_apply_moe_matches_jax(arch, capacity_factor, T):
    cfg, jp, tp = _setup(arch)
    jl, tl = _layer(jp["moe_layers"]["moe"]), _layer(tp["moe_layers"]["moe"])
    x = np.random.default_rng(T).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    want = jax_moe.apply_moe(jl, jnp.asarray(x), cfg, capacity_factor)
    got = moe.apply_moe(tl, torch.from_numpy(x), cfg, capacity_factor)
    _close(got.numpy(), want)
    _close(moe.moe_aux_loss(tl, torch.from_numpy(x), cfg).numpy(),
           jax_moe.moe_aux_loss(jl, jnp.asarray(x), cfg))


def test_capacity_drops_tokens_as_jax_does():
    """At capacity factor 0.5 some expert overflows: its later tokens
    (in sort order) drop, so the output differs from the no-drop output
    — identically in both packages."""
    cfg, jp, tp = _setup("qwen2-moe-a2.7b")
    jl, tl = _layer(jp["moe_layers"]["moe"]), _layer(tp["moe_layers"]["moe"])
    x = np.random.default_rng(3).standard_normal(
        (1, 24, cfg.d_model)).astype(np.float32)
    C = moe.moe_capacity(24, cfg, 0.5)
    assert C == jax_moe.moe_capacity(24, cfg, 0.5)
    _, _, idx = moe._route(torch.from_numpy(x[0]), tl["router"], cfg.top_k)
    assert int(torch.bincount(idx.reshape(-1)).max()) > C
    drop = moe.apply_moe(tl, torch.from_numpy(x), cfg, 0.5)
    keep = moe.apply_moe(tl, torch.from_numpy(x), cfg, -1.0)
    assert not torch.allclose(drop, keep)
    _close(drop.numpy(), jax_moe.apply_moe(jl, jnp.asarray(x), cfg, 0.5))


def test_expert_parallel_groups_wait_for_a_later_slice():
    """Since the training slice ``ep_groups > 1`` no longer raises: two
    groups of two tokens equal JAX's grouped path (run under a mesh whose
    axes are Auto; ``tests/test_torch_training.py`` holds more shapes)."""
    cfg, jp, tp = _setup("qwen2-moe-a2.7b")
    x = np.random.default_rng(3).standard_normal(
        (1, 4, cfg.d_model)).astype(np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with mesh:
        want = jax_moe.apply_moe(_layer(jp["moe_layers"]["moe"]),
                                 jnp.asarray(x), cfg, ep_groups=2)
    got = moe.apply_moe(_layer(tp["moe_layers"]["moe"]), torch.from_numpy(x),
                        cfg, ep_groups=2)
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch):
    cfg, jp, tp = _setup(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13))
    want, waux = jax_forward(jp, cfg, jnp.asarray(toks, jnp.int32))
    got, aux = forward(tp, cfg, torch.from_numpy(toks))
    assert got.shape == want.shape
    _close(got.numpy(), want)
    _close(aux.numpy(), waux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_then_decode_matches_jax(arch):
    cfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    forced = rng.integers(0, cfg.vocab_size, (4, 2))
    jlg, jst = jax_prefill(jp, cfg, jnp.asarray(toks, jnp.int32), max_len=20)
    lg, st = prefill(tp, cfg, torch.from_numpy(toks), max_len=20)
    _close(lg.numpy(), jlg)
    for tok in forced:
        jlg, jst = jax_decode_step(jp, cfg, jst, jnp.asarray(tok, jnp.int32))
        lg, st = decode_step(tp, cfg, st, torch.from_numpy(tok))
        _close(lg.numpy(), jlg)
    _close(st.kv_k.numpy(), jst.kv_k)
    assert st.lens.tolist() == [toks.shape[1] + len(forced)] * 2
