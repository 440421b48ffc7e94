"""The four dense architectures that only the paper's deployment shapes
exercise, against the JAX package: mistral-nemo-12b (GQA 32/8),
starcoder2-15b (GQA 48/4, LayerNorm with bias, non-gated GELU FFN),
chameleon-34b (qk-norm, fed patch-token embeddings) and musicgen-medium
(MHA at head_dim 64, sinusoidal positions, fed frame embeddings).

* The registry: ``ARCH_IDS`` is JAX's, in its order, and every config
  equals its JAX counterpart field by field.
* At smoke width, float32, the same bridged weights and numpy inputs:
  ``forward`` (tokens, and ``embeds`` for the vlm and audio archs),
  ``prefill`` then ``decode_step``, and ``prefill_chunk_paged`` over a
  prompt whose prefix stripes across creditor pools, then
  teacher-forced ``decode_step_paged`` — against JAX's and the port's
  dense oracle (``test_torch_model.check_paged_steps``).
* Smoke configs collapse the group (starcoder2's smoke is 4/1), so a
  variant keeps the full config's: starcoder2 at 12/1 heads (G = 12,
  as 48/4) with LayerNorm + GELU. musicgen's smoke config is its MHA
  at head_dim 16 with sinusoidal positions, streamed in two chunks, so
  the table must be added at absolute positions.
* The leaves at full size (meta tensors) equal JAX's, and
  ``seeded_params``'s draw rules cover the new ones (a LayerNorm
  ``bias`` is drawn as zeros, the FFN has no ``wg``).

Tolerance: 1e-4 relative to the largest logit, as in
``test_torch_model.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import forward as jax_forward
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import placement
from repro_torch.models.model import decode_step, forward
from repro_torch.models.prefill import prefill
from test_torch_model import _close, _close_logits, check_paged_steps

NEW_ARCHS = ("mistral-nemo-12b", "starcoder2-15b", "chameleon-34b",
             "musicgen-medium")
# name -> (arch, replace() fields) of the smoke variants
VARIANTS = {
    "starcoder2-g12": ("starcoder2-15b", {"num_heads": 12,
                                          "num_kv_heads": 1}),
}
_SETUPS = {}


def _cfg(name):
    arch, fields = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(jax_smoke(arch), dtype="float32", **fields)


def _setup(name):
    """(cfg, JAX params, port params), float32, built once per name."""
    if name not in _SETUPS:
        cfg = _cfg(name)
        jp = jax_init_params(jax.random.PRNGKey(0), cfg)
        tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _SETUPS[name] = (cfg, jp, tp)
    return _SETUPS[name]


def test_registry_equals_jax_field_by_field():
    from repro.configs import ARCH_IDS as JAX_IDS
    assert ARCH_IDS == JAX_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch)), arch


@pytest.mark.parametrize("name", NEW_ARCHS + tuple(VARIANTS))
def test_forward_prefill_and_decode_match_jax(name):
    cfg, jp, tp = _setup(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 12))
    want, _ = jax_forward(jp, cfg, jnp.asarray(toks, jnp.int32))
    full, _ = forward(tp, cfg, torch.from_numpy(toks))
    _close_logits(full.numpy(), want)
    T0 = 7
    lg, st = prefill(tp, cfg, torch.from_numpy(toks[:, :T0]), max_len=16)
    jlg, jst = jax_prefill(jp, cfg, jnp.asarray(toks[:, :T0], jnp.int32),
                           max_len=16)
    _close_logits(lg.numpy(), jlg)
    jstep = jax.jit(jax_decode_step, static_argnums=1)
    for t in range(T0, toks.shape[1]):
        lg, st = decode_step(tp, cfg, st, torch.from_numpy(toks[:, t]))
        jlg, jst = jstep(jp, cfg, jst, jnp.asarray(toks[:, t], jnp.int32))
        _close_logits(lg.numpy(), jlg)
        _close_logits(lg.numpy(), full[:, t].numpy())
    _close(st.kv_k.numpy(), jst.kv_k)


@pytest.mark.parametrize("arch", ["chameleon-34b", "musicgen-medium"])
def test_embeds_forward_and_prefill_match_jax(arch):
    """The vlm / audio archs take their frontend's embeddings [B, S, d]
    (musicgen adds its sinusoidal table to them)."""
    cfg, jp, tp = _setup(arch)
    emb = (np.random.default_rng(1).standard_normal(
        (2, 11, cfg.d_model)) * 0.1).astype(np.float32)
    want, _ = jax_forward(jp, cfg, embeds=jnp.asarray(emb))
    got, _ = forward(tp, cfg, embeds=torch.from_numpy(emb))
    _close_logits(got.numpy(), want)
    jlg, _ = jax_prefill(jp, cfg, embeds=jnp.asarray(emb), max_len=16)
    lg, _ = prefill(tp, cfg, embeds=torch.from_numpy(emb), max_len=16)
    _close_logits(lg.numpy(), jlg)
    _close_logits(lg.numpy(), got[:, -1].numpy())


@pytest.mark.parametrize("name,chunk,n_cred", [
    ("mistral-nemo-12b", 8, 2),
    ("starcoder2-15b", 5, 3),
    ("chameleon-34b", 8, 1),
    ("musicgen-medium", 16, 2),       # two chunks: absolute positions
    ("starcoder2-g12", 8, 2),         # G = 12, LayerNorm + GELU
])
def test_paged_steps_match_jax_and_dense_oracle(name, chunk, n_cred):
    check_paged_steps(*_setup(name), chunk, n_cred)


def test_sinusoidal_table_is_added_at_absolute_positions():
    """Tokens embedded at positions t0.. get JAX's table at t0.., not at
    0.. (a streamed chunk's positions are absolute)."""
    from repro.models.common import sinusoidal_embedding as jax_table
    from repro_torch.models.model import embed_tokens
    cfg, _, tp = _setup("musicgen-medium")
    tok = torch.tensor([[3, 5, 7]])
    pos = np.array([[16, 17, 18]])
    got = embed_tokens(tp, cfg, tok, positions=torch.from_numpy(pos))
    at0 = embed_tokens(tp, cfg, tok, positions=torch.tensor([[0, 1, 2]]))
    assert not torch.allclose(got, at0)
    _close((got - tp["embed"][tok]).numpy(),
           jax_table(jnp.asarray(pos), cfg.d_model))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_size_leaves_draw_and_place(arch):
    """At full size (meta tensors): the leaves JAX's init gives, with
    their dtypes; ``seeded_params``'s draw rules on each new leaf
    (LayerNorm ``bias`` zeros, ``scale`` ones, matrices N(0, 1/fan_in)).
    ``test_torch_placement.test_param_specs_equal_jax`` holds their
    specs to JAX's."""
    cfg = get_config(arch)
    shapes = placement.param_shapes(cfg)
    jshapes = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                     jax_get_config(arch)))
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}

    def walk(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{path}/{k}" if path else k)
        else:
            yield path, t
    got = dict(walk(shapes))
    assert set(got) == set(flat)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(flat[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(flat[k].dtype), k
    assert ("layers/ffn/wg" in got) == (cfg.activation == "swiglu")
    assert ("layers/ln1/bias" in got) == (cfg.norm_type == "layernorm")
    small = dataclasses.replace(jax_smoke(arch), dtype="float32",
                                num_layers=2)
    drawn = placement.seeded_params(small, seed=3, device="cpu")
    ln = drawn["layers"]["ln1"]
    assert torch.equal(ln["scale"], torch.ones_like(ln["scale"]))
    if cfg.norm_type == "layernorm":
        assert torch.equal(ln["bias"], torch.zeros_like(ln["bias"]))
    wi = drawn["layers"]["ffn"]["wi"]
    assert abs(float(wi.std()) - small.d_model ** -0.5) < 0.02
