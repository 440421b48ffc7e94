"""starcoder2-15b (GQA with LayerNorm + GELU) and musicgen-medium (MHA,
sinusoidal positions) served by the port's ``LLMServer``, float32 smoke
weights bridged from JAX: the greedy streams equal the JAX serving
stack's and the JAX dense oracle's, for two short prompts batched with a
prompt longer than one instance's quota (its KV spans creditors and its
decode steps LSE-merge their partials), with every allocator back to
empty afterwards.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models.model import init_params as jax_init_params
from repro import serving as jsv
from repro_torch import bridge
from repro_torch import serving as psv
from test_torch_examples import _jax_greedy
from test_torch_serving import _serve, _v5e_perf

KW = dict(n_instances=3, max_batch=2, max_local_len=16, pool_blocks=12,
          block_size=4)


@pytest.mark.parametrize("arch", ["starcoder2-15b", "musicgen-medium"])
def test_greedy_streams_equal_jax_server_and_oracle(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 9, 5)]
    n_new = 6
    got, server = _serve(psv, tp, cfg, psv.ServingConfig.smoke(**KW),
                         prompts, n_new, device="cpu", perf=_v5e_perf(cfg))
    jax_got, _ = _serve(jsv, jp, cfg, jsv.ServingConfig.smoke(**KW),
                        prompts, n_new)
    assert got == [_jax_greedy(jp, cfg, p, n_new) for p in prompts]
    assert got == jax_got
    cl = server.cluster
    assert cl.throughput_stats["query_shipped_bytes"] > 0, \
        "the long prompt did not span creditors"
    for e in cl.engines.values():
        a = e.rmanager.pool.alloc
        assert a.used_count == 0 and a.reserved == 0
