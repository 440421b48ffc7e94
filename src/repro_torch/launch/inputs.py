"""Meta-tensor stand-ins and placements for every (arch x shape x mesh).

``build_cell(arch, shape, mesh)`` returns what ``launch.dryrun`` plans
from: the step function, its keyword arguments as meta tensors (shapes
and dtypes, no storage), the spec of every argument, the output specs
and the donated arguments — with nothing allocated on any device.

The JAX package's ``repro.launch.inputs`` with the same cells and
arithmetic; what differs:

* the kwargs are ``device="meta"`` tensors where JAX has
  ``ShapeDtypeStruct``s, the parameter tree is
  ``distributed.placement.param_shapes``, and the shardings are the
  port's spec tuples (one entry a dim: an axis name, a tuple of names or
  None; ``distributed.sharding``), not ``NamedSharding``s;
* ``fn`` is a ``functools.partial`` of the port's step
  (``serving.sharded_step``, ``training.train_step``); called on real
  tensors (and ``mesh=`` a runtime ``DeviceMesh`` for the serve steps)
  it runs the cell;
* serve-time FSDP is decided against ``hw`` (default the H100's 80 GB;
  JAX decides against v5e's 16 GB: pass those constants to get its
  cells);
* JAX turns on Megatron-style sequence parallelism of the prefill from
  the ``REPRO_SP`` environment variable; the port reads no environment
  variable: ``build_prefill_cell(seq_parallel=True)`` (``dryrun
  --seq-parallel``) passes it to ``serve_prefill_step``, and the
  cell's ``meta["seq_parallel"]`` says whether JAX's rule applies (S a
  multiple of 16, a TP axis of several devices; the hybrid and ssm
  prefills have no such mode, as in JAX);
* JAX's ``_layer_constraints`` (re-pinning each sliced layer's weights
  inside the scan, so GSPMD does not gather a whole stack) has no
  counterpart: the port's placed steps gather one layer's leaves right
  before the layer uses them (``PlacedParams.layer``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.hardware import H100, HardwareSpec
from repro_torch.distributed.placement import param_shapes
from repro_torch.distributed.sharding import (batch_axes, param_specs,
                                              serve_fsdp, serve_pool_axes,
                                              validate_divisibility)
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import init_decode_state
from repro_torch.serving.sharded_step import (ServeLayout, serve_decode_step,
                                              serve_decode_step_opt,
                                              serve_decode_step_state,
                                              serve_prefill_step,
                                              serve_prefill_step_state)
from repro_torch.training.optimizer import AdamWConfig, AdamWState
from repro_torch.training.train_step import (TrainConfig, TrainState,
                                             init_train_state, train_step)

BLOCK_SIZE = 128            # KV pool block (tokens)


class Cell(NamedTuple):
    """One planned (arch x shape x mesh) step and its inputs."""
    fn: Any                     # callable(**kwargs)
    kwargs: Dict[str, Any]      # meta tensors (trees of them)
    in_shardings: Dict[str, Any]  # spec trees, one per kwarg
    out_shardings: Any          # spec tuple per output, or None
    donate: Tuple[str, ...]     # kwarg names the step updates in place
    meta: Dict[str, Any]


@functools.lru_cache(maxsize=None)
def _param_shapes(cfg: ModelConfig):
    """``param_shapes`` once per config: drawing a tree on the meta
    device still runs every initializer's shape logic (kimi's 384
    experts a layer take a second), and the cells of one arch share it
    (nothing mutates a meta tensor)."""
    return param_shapes(cfg)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh (a ``MeshShape`` or a
    ``DeviceMesh``)."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _axes_total(mesh, axes) -> int:
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _batch_spec(mesh, baxes, n) -> Tuple:
    """Batch over ``baxes`` only when divisible (long_500k has B=1)."""
    return (baxes,) if n % _axes_total(mesh, baxes) == 0 else ()


def _map_state(fn, state):
    """``fn`` over every tensor of a (nested) NamedTuple / dict / tuple
    state; None stays None."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: _map_state(fn, v) for k, v in state.items()}
    if isinstance(state, tuple):
        parts = [_map_state(fn, v) for v in state]
        return type(state)(*parts) if hasattr(state, "_fields") \
            else tuple(parts)
    return fn(state)


def decode_state_specs(cfg: ModelConfig, state, R: int, bax):
    """The specs of a hybrid/ssm ``DecodeState`` of ``R`` rows with the
    rows over ``bax`` (a tuple of axis names, or None: replicated)."""
    specs = _map_state(
        lambda s: (None, bax) if s.ndim >= 2 and s.shape[1] == R
        else ((bax,) if s.ndim >= 1 and s.shape[0] == R else ()), state)
    # mLSTM states are [ng, se-1, B, ...]: batch at axis 2.
    if cfg.family == "ssm":
        rec = state.rec
        specs = specs._replace(rec={
            "mlstm": type(rec["mlstm"])(
                *[(None, None, bax) for _ in rec["mlstm"]]),
            "slstm": type(rec["slstm"])(
                *[(None, bax) for _ in rec["slstm"]])})
    return specs


# ===================================================================== #
def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     *, microbatches: Optional[int] = None,
                     moment_dtype: Optional[str] = None) -> Cell:
    """A ``train_step`` over the global batch, FSDP over "data" and TP
    over "model"; bf16 moments and 8 microbatches for 100B-class
    models, expert-parallel groups over the batch axes for MoE."""
    baxes = batch_axes(mesh)
    n_data = _axes_total(mesh, baxes)
    # 1T-class models store AdamW moments in bf16 to fit device memory.
    if moment_dtype is None:
        moment_dtype = "bfloat16" if cfg.param_count() > 1e11 else "float32"
    if microbatches is None:
        # Keep per-microbatch activations (incl. MoE dispatch buffers)
        # within device memory: ~8 for >=100B-class models, else 1.
        microbatches = 8 if cfg.param_count() > 1e11 else 1
    ep = n_data if (cfg.is_moe and shape.global_batch % n_data == 0) else 0
    acfg = AdamWConfig(moment_dtype=moment_dtype)
    tcfg = TrainConfig(remat=True, microbatches=microbatches,
                       attn_chunk=1024, moe_ep_groups=ep)

    pshapes = _param_shapes(cfg)
    pspecs = validate_divisibility(
        param_specs(cfg, pshapes, fsdp=True, fsdp_axis="data"),
        pshapes, mesh)
    state_shapes = init_train_state(pshapes, acfg, tcfg, device="meta")
    state_specs = TrainState(params=pspecs,
                             opt=AdamWState((), pspecs, pspecs), ef=None)

    B, S = shape.global_batch, shape.seq_len
    kwargs = {"state": state_shapes,
              "tokens": _meta((B, S + 1), torch.int32),
              "mask": _meta((B, S), torch.float32)}
    in_sh = {"state": state_specs, "tokens": (baxes,), "mask": (baxes,)}
    if cfg.modality in ("vlm", "audio"):
        kwargs["embeds"] = _meta((B, S, cfg.d_model), torch_dtype(cfg))
        in_sh["embeds"] = (baxes,)

    fn = functools.partial(train_step, cfg=cfg, tcfg=tcfg, adam_cfg=acfg)
    return Cell(fn=fn, kwargs=kwargs, in_shardings=in_sh,
                out_shardings=None, donate=("state",),
                meta={"kind": "train", "batch_axes": baxes,
                      "moment_dtype": moment_dtype})


# ===================================================================== #
def _serve_param_sharding(cfg, mesh, hw: HardwareSpec):
    pshapes = _param_shapes(cfg)
    fsdp = serve_fsdp(cfg, mesh, hw)
    specs = validate_divisibility(
        param_specs(cfg, pshapes, fsdp=fsdp, fsdp_axis="data"),
        pshapes, mesh)
    return pshapes, specs, fsdp


def _pool_spec(paxes) -> Tuple:
    kvh = None if "model" in paxes else "model"
    return (None, paxes, None, None, kvh, None)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       hw: HardwareSpec = H100,
                       seq_parallel: bool = False) -> Cell:
    """``serve_prefill_step`` into a fresh pool of ``BLOCK_SIZE`` blocks
    (dense, MoE; ``embeds`` for the vlm and audio archs), or
    ``serve_prefill_step_state`` (hybrid, ssm). ``seq_parallel``: the
    pooled prefill's sequence parallelism (recorded in ``meta`` where
    asked, as whether it applies)."""
    baxes = batch_axes(mesh)
    paxes = serve_pool_axes(cfg, mesh)
    layout = ServeLayout(batch_axes=baxes, pool_axes=paxes)
    NP = _axes_total(mesh, paxes)
    B, S = shape.global_batch, shape.seq_len
    bspec = _batch_spec(mesh, baxes, B)

    pshapes, pspecs, fsdp = _serve_param_sharding(cfg, mesh, hw)
    if cfg.family in ("hybrid", "ssm"):
        # No KV pool: forward + recurrent/window state.
        kwargs = {"params": pshapes, "tokens": _meta((B, S), torch.int32)}
        in_sh = {"params": pspecs, "tokens": bspec}
        fn = functools.partial(serve_prefill_step_state, cfg=cfg,
                               layout=layout,
                               max_len=min(S, cfg.local_window or 1))
        meta = {"kind": "prefill_state", "fsdp": fsdp}
        if seq_parallel:
            meta["seq_parallel"] = False
        return Cell(fn=fn, kwargs=kwargs, in_shardings=in_sh,
                    out_shardings=None, donate=(), meta=meta)
    kwargs = {"params": pshapes}
    in_sh = {"params": pspecs}
    if cfg.modality in ("vlm", "audio"):
        kwargs["embeds"] = _meta((B, S, cfg.d_model), torch_dtype(cfg))
        in_sh["embeds"] = bspec
        kwargs["tokens"] = None
        in_sh["tokens"] = None
    else:
        kwargs["tokens"] = _meta((B, S), torch.int32)
        in_sh["tokens"] = bspec

    n_data = _axes_total(mesh, baxes)
    fn = functools.partial(serve_prefill_step, cfg=cfg, layout=layout,
                           block_size=BLOCK_SIZE, NP=NP, n_data=n_data,
                           seq_parallel=seq_parallel)
    pool_spec = _pool_spec(paxes)
    meta = {"kind": "prefill", "pool_axes": paxes, "NP": NP, "fsdp": fsdp}
    if seq_parallel:
        meta["seq_parallel"] = S % 16 == 0 and \
            mesh_axis_sizes(mesh).get("model", 1) > 1
    return Cell(fn=fn, kwargs=kwargs, in_shardings=in_sh,
                out_shardings=(bspec, pool_spec, pool_spec), donate=(),
                meta=meta)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      variant: str = "baseline", *,
                      hw: HardwareSpec = H100) -> Cell:
    """``serve_decode_step`` (``variant="opt"``: ``serve_decode_step_opt``)
    over a pool holding every request's S tokens (dense, MoE), or
    ``serve_decode_step_state`` over a decode state (hybrid, ssm)."""
    baxes = batch_axes(mesh)
    R, S = shape.global_batch, shape.seq_len
    pshapes, pspecs, fsdp = _serve_param_sharding(cfg, mesh, hw)

    if cfg.family in ("dense", "moe"):
        paxes = serve_pool_axes(cfg, mesh)
        layout = ServeLayout(batch_axes=baxes, pool_axes=paxes)
        NP = _axes_total(mesh, paxes)
        bs = BLOCK_SIZE
        blocks_per_req = -(-S // bs)
        MB = -(-blocks_per_req // NP) + 1
        NB = max(1, -(-R * blocks_per_req // NP))
        L = cfg.num_layers
        K, hd = cfg.num_kv_heads, cfg.head_dim
        i32 = torch.int32

        pool_spec = _pool_spec(paxes)
        itab = (paxes,)
        rspec = _batch_spec(mesh, baxes, R)
        kwargs = {
            "params": pshapes,
            "pool_k": _meta((L, NP, NB, bs, K, hd), torch_dtype(cfg)),
            "pool_v": _meta((L, NP, NB, bs, K, hd), torch_dtype(cfg)),
            "tables": _meta((NP, R, MB), i32),
            "nblk": _meta((NP, R), i32),
            "tails": _meta((NP, R), i32),
            "wblk": _meta((NP, R), i32),
            "woff": _meta((NP, R), i32),
            "tokens": _meta((R,), i32),
            "lens": _meta((R,), i32),
        }
        in_sh = {"params": pspecs,
                 "pool_k": pool_spec, "pool_v": pool_spec,
                 "tables": itab, "nblk": itab, "tails": itab,
                 "wblk": itab, "woff": itab,
                 "tokens": rspec, "lens": rspec}
        step = (serve_decode_step_opt if variant == "opt"
                else serve_decode_step)
        fn = functools.partial(step, cfg=cfg, layout=layout)
        return Cell(fn=fn, kwargs=kwargs, in_shardings=in_sh,
                    out_shardings=(rspec, pool_spec, pool_spec),
                    donate=("pool_k", "pool_v"),
                    meta={"kind": "decode", "pool_axes": paxes, "NP": NP,
                          "NB": NB, "MB": MB, "fsdp": fsdp,
                          "mode": ("seq_model" if "model" in paxes
                                   else "tp_head")})

    # hybrid / ssm: O(1) recurrent state (+ bounded window cache)
    layout = ServeLayout(batch_axes=baxes, pool_axes=baxes)
    bspec = _batch_spec(mesh, baxes, R)
    bax = bspec[0] if bspec else None
    state_shapes = init_decode_state(
        cfg, R, max_len=min(S, cfg.local_window or 1),
        prefix_lens=_meta((R,), torch.int32), device="meta")
    dstate_specs = decode_state_specs(cfg, state_shapes, R, bax)
    kwargs = {"params": pshapes, "state": state_shapes,
              "tokens": _meta((R,), torch.int32)}
    in_sh = {"params": pspecs, "state": dstate_specs, "tokens": bspec}
    fn = functools.partial(serve_decode_step_state, cfg=cfg, layout=layout)
    return Cell(fn=fn, kwargs=kwargs, in_shardings=in_sh,
                out_shardings=None, donate=("state",),
                meta={"kind": "decode_state", "fsdp": fsdp})


# ===================================================================== #
def build_cell(arch: str, shape_name: str, mesh, *,
               hw: HardwareSpec = H100, **kw) -> Cell:
    """The cell of ``arch`` at ``SHAPES[shape_name]`` on ``mesh`` (a
    ``launch.mesh.MeshShape`` or a ``DeviceMesh``); ``hw`` decides
    serve-time FSDP, ``kw`` goes to ``build_train_cell``,
    ``build_prefill_cell`` or ``build_decode_cell``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh, hw=hw, **kw)
    return build_decode_cell(cfg, shape, mesh, hw=hw, **kw)


def input_specs(arch: str, shape_name: str, mesh, **kw) -> Dict[str, Any]:
    """Public API: meta-tensor stand-ins for every model input."""
    return build_cell(arch, shape_name, mesh, **kw).kwargs


__all__ = ["BLOCK_SIZE", "Cell", "build_cell", "decode_state_specs",
           "build_decode_cell", "build_prefill_cell", "build_train_cell",
           "input_specs", "mesh_axis_sizes"]
