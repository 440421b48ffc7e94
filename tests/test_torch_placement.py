"""Parameter placements and DistAttention over a partition, against the
JAX package (no spawn).

* The port's ``param_specs`` + ``validate_divisibility`` equal JAX's leaf
  for leaf, for every port arch at smoke and full size, ``fsdp`` True and
  False, on mesh stand-ins (1, 2), (2, 2), (1, 4), (16, 16) and (2, 16,
  16) (JAX's functions read only ``axis_names`` and ``devices.shape``;
  the full-size trees are ``jax.eval_shape`` on the JAX side and meta
  tensors on the port's). A 16-head variant of the smoke configs (16
  and 8 kv heads, head_dim 8) splits q over "model", which the 4-head
  smoke configs never do.
* ``serve_fsdp`` decides against the H100's 80 GB, and equals JAX's
  decision for every arch when given v5e's 16 GB.
* ``place_params`` then ``gather_params`` is the identity, bit for bit,
  on a one-process mesh; ``seeded_params`` gives the same values with
  and without a mesh; ``spec_bytes`` predicts ``local_bytes``.
  (Meshes of 2 and 4 processes: ``tests/test_torch_serve_layout.py``.)
* ``dist_attention_decode``/``_prefill`` against JAX's on
  ``tests/test_distattention_equiv.py``'s cases (seeded draws of its
  strategies), 1e-5 in float32 (5e-2 bf16, as that file holds them).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import placement, sharding

MESHES = ((("data", "model"), (1, 2)), (("data", "model"), (2, 2)),
          (("data", "model"), (1, 4)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)))
# The smoke configs with 16 heads (q splits over "model"): 16 kv heads
# (wk/wv split too) and 8 (whole).
H16 = {"olmo-h16": ("olmo-1b", 16), "qwen3-h16": ("qwen3-0.6b", 8)}


def h16_config(name, get=get_smoke_config):
    base, kv = H16[name]
    return dataclasses.replace(get(base), num_heads=16, num_kv_heads=kv,
                               head_dim=8)


def _jax_cfg(arch, size):
    from repro.configs import get_config as jget, get_smoke_config as jsmoke
    if arch in H16:
        return h16_config(arch, jsmoke)
    return jsmoke(arch) if size == "smoke" else jget(arch)


def _port_cfg(arch, size):
    if arch in H16:
        return h16_config(arch)
    return get_smoke_config(arch) if size == "smoke" else get_config(arch)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


@pytest.mark.parametrize("arch,size", [
    (a, s) for a in ARCH_IDS for s in ("smoke", "full")] + [
    (h, "smoke") for h in H16])
def test_param_specs_equal_jax(arch, size):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.distributed import sharding as jsh
    from repro.models.model import init_params as jinit
    jcfg = _jax_cfg(arch, size)
    jshapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    shapes = placement.param_shapes(_port_cfg(arch, size))
    for names, shape in MESHES:
        jmesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
        mesh = SimpleNamespace(mesh_dim_names=names, size=lambda i: shape[i])
        for fsdp in (False, True):
            want = jsh.validate_divisibility(
                jsh.param_specs(jcfg, jshapes, fsdp=fsdp), jshapes, jmesh)
            want = {"/".join(str(getattr(k, "key", k)) for k in path):
                    tuple(leaf) for path, leaf in
                    jax.tree_util.tree_flatten_with_path(
                        want, is_leaf=lambda x: isinstance(x, P))[0]}
            got = _flat(sharding.validate_divisibility(
                sharding.param_specs(_port_cfg(arch, size), shapes,
                                     fsdp=fsdp), shapes, mesh))
            assert got == want, (names, shape, fsdp)
    if arch in H16:   # q splits over "model" (16 % 16 == 0); kv if 16
        sp = sharding.param_specs(_port_cfg(arch, size), shapes, fsdp=False)
        assert sp["layers"]["attn"]["wq"] == (None, None, "model")
        assert sp["layers"]["attn"]["wo"] == (None, "model", None)
        assert (sp["layers"]["attn"]["wk"][-1] == "model") == \
            (H16[arch][1] == 16)


def test_serve_fsdp_decides_on_the_h100_and_equals_jax_given_v5e():
    from repro.distributed import sharding as jsh
    from repro.distributed.hardware import V5E
    from repro_torch.distributed.hardware import HardwareSpec
    v5e = HardwareSpec(name="tpu-v5e", hbm_bytes=V5E.hbm_bytes)
    for names, shape in MESHES + ((("data", "model"), (1, 1)),):
        jmesh = SimpleNamespace(axis_names=names, devices=np.empty(shape))
        mesh = SimpleNamespace(mesh_dim_names=names, size=lambda i: shape[i])
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            assert sharding.serve_fsdp(cfg, mesh, v5e) == \
                jsh.serve_fsdp(cfg, jmesh), (arch, shape)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           size=lambda i: (16, 16)[i])
    want = {"kimi-k2-1t-a32b": True, "qwen2-moe-a2.7b": False,
            "qwen3-0.6b": False}
    assert {a: sharding.serve_fsdp(get_config(a), mesh) for a in want} == want


@pytest.fixture
def one_process(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "olmo-h16", "recurrentgemma-9b",
                                  "xlstm-350m"])
def test_place_gather_seeded_on_one_process(one_process, arch):
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models.model import init_params
    cfg = _port_cfg(arch, "smoke")
    mesh = make_mesh((1, 1), device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    specs = sharding.validate_divisibility(
        sharding.param_specs(cfg, params, fsdp=True), params, mesh)
    placed = placement.place_params(
        {k: v for k, v in params.items()}, specs, mesh)
    back = _flat(placement.gather_params(placed))
    for path, leaf in _flat(params).items():
        assert back[path].dtype == leaf.dtype
        assert torch.equal(back[path], leaf), path
    # Numpy leaves (a bridged JAX tree) are sliced before they move.
    npl = placement.place_params(
        {k: v for k, v in _flat_np(params).items()}, specs, mesh,
        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        _flat(npl.local).values(), _flat(params).values()))
    whole = placement.seeded_params(cfg, 5, device="cpu")
    seeded = placement.seeded_params(cfg, 5, mesh=mesh, specs=specs,
                                     device="cpu")
    for path, leaf in _flat(whole).items():
        assert torch.equal(_flat(seeded.local)[path], leaf), path
    shapes = placement.param_shapes(cfg)
    assert placement.spec_bytes(shapes, specs, {"data": 1, "model": 1}) == \
        placement.local_bytes(seeded) == placement.local_bytes(params)
    with pytest.raises(TypeError, match="ServeLayout"):
        seeded["embed"]


def _flat_np(tree):
    """The tree as numpy leaves of its dtypes (bf16 as ``ml_dtypes``', as
    ``jax.tree.map(np.asarray, ...)`` gives them)."""
    import ml_dtypes

    def one(v):
        a = v.float().numpy()
        return a.astype(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16 \
            else a
    return {k: (_flat_np(v) if isinstance(v, dict) else one(v))
            for k, v in tree.items()}


def test_seeded_draws_follow_init_distributions():
    cfg = get_config("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    p = placement.seeded_params(cfg, 0, device="cpu")
    assert abs(float(p["embed"].std()) - 0.02) < 1e-3
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 1e-2
    assert torch.equal(p["layers"]["ln1"]["scale"],
                       torch.ones_like(p["layers"]["ln1"]["scale"]))
    # The hybrid and ssm leaves (seeded_params draws every family).
    hcfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                               num_layers=3, vocab_size=512, d_ff=512,
                               dtype="float32")
    rg = placement.seeded_params(hcfg, 0, device="cpu")["groups"][
        "0_rglru"]["rglru"]
    # log_sig_lambda = log(u ** (1 / 8)), u uniform in [0.9, 0.999].
    u = torch.exp(8 * rg["log_sig_lambda"])
    assert u.shape == (1, hcfg.lru_width)
    assert float(u.min()) >= 0.9 - 1e-5 and float(u.max()) <= 0.999 + 1e-5
    assert abs(float(rg["conv_w"].std()) - 0.1) < 1e-2
    assert not rg["b_r"].any() and not rg["b_i"].any()
    assert abs(float(rg["w_r"].std()) * hcfg.lru_width ** 0.5 - 1) < 1e-2
    xcfg = dataclasses.replace(get_config("xlstm-350m"), num_layers=8,
                               vocab_size=512, dtype="float32")
    x = placement.seeded_params(xcfg, 0, device="cpu")["groups"]
    b_if = x["mlstm"]["blk"]["b_if"]
    nh = xcfg.num_heads
    assert b_if.shape == (1, 7, 2 * nh)
    assert not b_if[..., :nh].any() and (b_if[..., nh:] == 3.0).all()
    assert (x["mlstm"]["blk"]["gn_scale"] == 1).all()
    assert not x["slstm"]["blk"]["b"].any()
    # Each mLSTM layer of the (group, layer) stack has its own draw.
    w_up = x["mlstm"]["blk"]["w_up"]
    assert not torch.equal(w_up[0, 0], w_up[0, 1])


# --------------------------------------------------------------------- #
# DistAttention over a partition (test_distattention_equiv.py's cases)
# --------------------------------------------------------------------- #
def _split_points(rng, S, n_parts):
    cuts = sorted(rng.choice(np.arange(1, S), size=n_parts - 1,
                             replace=False)) if n_parts > 1 else []
    return [0] + list(cuts) + [S]


def _jcore():
    import jax.numpy as jnp
    from repro import core
    return jnp, core


def _jit(fn):
    """One compile of the whole JAX function (eager, each op compiles)."""
    import jax
    return jax.jit(fn)


@pytest.mark.parametrize("seed", range(6))
def test_dist_attention_decode_equals_jax(seed):
    from repro_torch import core
    jnp, jc = _jcore()
    rng = np.random.default_rng(seed)
    B, K, G = rng.integers(1, 4), rng.choice([1, 2, 4]), rng.choice([1, 2, 4])
    D, S = rng.choice([8, 16]), int(rng.integers(4, 65))
    n_parts = min(int(rng.integers(1, 6)), S)
    bf16 = seed % 2 == 1
    H = K * G
    q = rng.standard_normal((B, H, D), np.float32)
    k = rng.standard_normal((B, S, K, D), np.float32)
    v = rng.standard_normal((B, S, K, D), np.float32)
    mask = rng.random((B, S)) < 0.8
    pts = _split_points(rng, S, n_parts)
    order = rng.permutation(len(pts) - 1)
    spans = [(pts[i], pts[i + 1]) for i in order]
    dt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16 else
               (torch.float32, jnp.float32))

    def t(x):
        return torch.from_numpy(x).to(dt) if x.dtype != bool \
            else torch.from_numpy(x)

    got = core.dist_attention_decode(
        t(q), [(t(k)[:, a:b], t(v)[:, a:b], t(mask)[:, a:b])
               for a, b in spans])
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    want = _jit(jc.dist_attention_decode)(
        jq, [(jk[:, a:b], jv[:, a:b], jnp.asarray(mask)[:, a:b])
             for a, b in spans])
    full = core.full_attention_decode(t(q), t(k), t(v), t(mask))
    tol = 5e-2 if bf16 else 1e-5
    for x in (got, full):
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("seed", range(4))
def test_dist_attention_prefill_equals_jax(seed):
    from repro_torch import core
    jnp, jc = _jcore()
    rng = np.random.default_rng(100 + seed)
    B, K, G = rng.integers(1, 3), rng.choice([1, 2]), rng.choice([1, 3])
    T, S_extra = int(rng.integers(1, 17)), int(rng.integers(0, 17))
    H, D, S = K * G, 8, T + S_extra
    n_parts = min(int(rng.integers(1, 5)), S)
    q = rng.standard_normal((B, T, H, D), np.float32)
    k = rng.standard_normal((B, S, K, D), np.float32)
    v = rng.standard_normal((B, S, K, D), np.float32)
    pts = _split_points(rng, S, n_parts)
    spans = [(pts[i], pts[i + 1]) for i in rng.permutation(len(pts) - 1)]
    kv_pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    q_pos = (S_extra + np.arange(T, dtype=np.int32))[None].repeat(B, 0)
    f = torch.from_numpy
    got = core.dist_attention_prefill(
        f(q), [(f(k)[:, a:b], f(v)[:, a:b], f(kv_pos)[:, a:b],
                torch.ones((B, b - a), dtype=torch.bool)) for a, b in spans],
        f(q_pos))
    want = _jit(jc.dist_attention_prefill)(
        jnp.asarray(q), [(jnp.asarray(k)[:, a:b], jnp.asarray(v)[:, a:b],
                          jnp.asarray(kv_pos)[:, a:b],
                          jnp.ones((B, b - a), bool)) for a, b in spans],
        jnp.asarray(q_pos))
    full = core.full_attention_prefill(f(q), f(k), f(v), q_offset=S_extra)
    for x in (got, full):
        np.testing.assert_allclose(x.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def test_dist_attention_empty_part_and_all_masked():
    from repro_torch import core
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 10, 2, 8), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 10, 2, 8), np.float32))
    mask = torch.ones((2, 10), dtype=torch.bool)
    ref = core.full_attention_decode(q, k, v, mask)
    out = core.dist_attention_decode(q, [
        (k[:, :5], v[:, :5], mask[:, :5]),
        (k[:, :3], v[:, :3], torch.zeros((2, 3), dtype=torch.bool)),
        (k[:, 5:], v[:, 5:], mask[:, 5:])])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    none = core.dist_attention_decode(q, [(k, v, torch.zeros_like(mask))])
    assert not torch.isnan(none).any() and (none == 0).all()

