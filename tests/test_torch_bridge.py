"""Weight bridge: JAX ``init_params`` trees <-> the port's tensors.

The olmo-1b, qwen3-0.6b and recurrentgemma-9b smoke parameter trees (the
hybrid one: stacked ``groups`` plus unstacked ``leftover`` layers), in
bf16 and float32, cross into the port with the same keys, shapes and
dtypes and come back bit for bit (bf16 travels through float32, which is
exact). The port's own seeded initializer builds the same tree with the
same distributions.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models.model import init_params as jax_init_params
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.models.model import init_params as pt_init_params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


ARCHS = ["olmo-1b", "qwen3-0.6b", "recurrentgemma-9b"]
# Hybrid smoke depth with one whole group and two leftover layers.
LAYERS = {"recurrentgemma-9b": 5}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_round_trips_bit_for_bit(arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch, layers=LAYERS.get(arch)),
                              dtype=dtype)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    np_tree = jax.tree.map(np.asarray, params)
    tp = bridge.from_numpy_tree(np_tree, device="cpu")
    src, got = _leaves(np_tree), _leaves(tp)
    assert src.keys() == got.keys()
    back = _leaves(bridge.to_numpy_tree(tp))
    for key, a in src.items():
        t = got[key]
        assert t.device.type == "cpu"
        assert tuple(t.shape) == a.shape, key
        assert str(t.dtype).split(".")[-1] == a.dtype.name, key
        want = a.astype(np.float32)
        assert back[key].dtype == np.float32
        assert np.array_equal(want.view(np.uint32),
                              back[key].view(np.uint32)), key


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_jax_tree_and_distributions(arch):
    jcfg = get_smoke_config(arch, layers=LAYERS.get(arch))
    pcfg = pt_smoke_config(arch, layers=LAYERS.get(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    jtree = _leaves(jax.tree.map(np.asarray,
                                 jax_init_params(jax.random.PRNGKey(0), jcfg)))
    ptree = _leaves(pt_init_params(pcfg, torch.Generator().manual_seed(0),
                                   "cpu"))
    assert jtree.keys() == ptree.keys()
    for key, a in jtree.items():
        t = ptree[key]
        assert tuple(t.shape) == a.shape, key
        assert str(t.dtype).split(".")[-1] == a.dtype.name, key
        a32 = a.astype(np.float32)
        t32 = t.float().numpy()
        if a32.std() == 0:                 # norm scales: exact constants
            assert np.array_equal(a32, t32), key
        elif key.endswith("log_sig_lambda"):   # log(U(0.9, 0.999) ** 1/8)
            lo, hi = np.log(0.9) / 8, np.log(0.999) / 8
            for x in (a32, t32):
                assert lo <= x.min() and x.max() <= hi, key
            assert abs(t32.mean() - a32.mean()) < 0.2 * abs(a32.mean()), key
        else:                              # N(0, s^2) draws: same s
            assert abs(t32.std() / a32.std() - 1) < 0.1, key
            assert abs(t32.mean()) < 4 * a32.std() / np.sqrt(a32.size), key
