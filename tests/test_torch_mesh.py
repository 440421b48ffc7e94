"""The global KV pool sharded over processes, against the JAX package.

Two process groups are spawned once for the module (gloo, ``FileStore``
rendezvous): W = 2 on a (2, 1) mesh with ``pool_axes=("data",)``, and
W = 4 on a (2, 2) mesh with ``pool_axes=("data", "model")`` — the two
layouts of the JAX package's ``tests/helpers/global_check.py``. JAX
float32 smoke weights are bridged into every process; inputs are made
from a numpy seed here. Checked:

* the steps: ``prefill_chunk_global``/``decode_step_global`` with a mesh
  (a 4-rank pool: two ranks a process, then one) against JAX's
  single-device steps on the whole pool — logits within 1e-5 of the
  largest, every pool row within 1e-5 — and the rows a process writes
  are exactly its own chunk export, at exactly the rows the targets
  name; each process holds NR / shards ranks;
* the rank-local writers drop foreign, negative and sentinel rows and
  leave every other slab untouched;
* ``Cluster`` in mesh mode, global_check's three cases (olmo-1b on 2 and
  4 ranks, qwen2-moe-a2.7b on 2): greedy tokens equal the JAX dense
  oracle and the port's single-process global cluster, KV moved between
  processes, no step reallocates a slab; the prefix cache gets a warm
  and a copy-on-write hit under a mesh with the single-process streams;
* the divergence guard raises in every process when one process's plan
  is perturbed, and when one process's paused set, dead set or host
  tier keys are;
* the serving extensions under a mesh (W = 2, four or two global-pool
  instances), olmo-1b and qwen3-0.6b: the host tier (every cached
  replica spilled, then a host hit), overload preemption (an urgent
  arrival pauses a victim, which resumes), a creditor crash mid-decode
  replayed, and a ``FaultPlan`` with one event of each kind (prefix
  cache, host tier, verification on). Every process's streams, request
  states, replay and preemption counts, ``FaultStats``, preemption
  stats, host-tier counters and stager retries equal the single-process
  global cluster's, the streams equal the JAX dense oracle's, no step
  reallocates a slab, every allocator ends free, and the prefix cache's
  root hash (and so every host-tier key) is the same in every process;
* ``LLMServer`` under a mesh agrees on the clock once a step (one
  collective, not one for the server and one for its cluster), and a
  mesh works out its pool shards once.

As in ``test_torch_collectives.py``, JAX is imported only where the
references are computed: the spawned processes import this module.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch import serving as psv
from repro_torch.configs import get_smoke_config
from test_torch_collectives import Spawned

TOL = 1e-5
NR, NB, BS, MB = 4, 10, 4, 4
LAYOUTS = {2: ((2, 1), ("data",)), 4: ((2, 2), ("data", "model"))}
# global_check.py's cases: (arch, instances, processes)
CASES = [("olmo-1b", 2, 2), ("olmo-1b", 4, 4), ("qwen2-moe-a2.7b", 2, 2)]
N_NEW = 12


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _step_inputs(cfg, rng):
    """A noisy 4-rank pool, a prefill chunk whose rows land on every rank
    (and padding, a negative rank, ranks past the pool, the sentinel
    block), and a decode of two slots of rank 1 (the second inactive)."""
    shape = (NR, cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    gk, gv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))

    def tables(rows):
        t = -np.ones((NR, rows, MB), np.int32)
        tl = np.full((NR, rows), BS, np.int32)
        for p in range(NR):
            perm = rng.permutation(NB)
            for r in range(rows):
                n = int(rng.integers(0, 3))
                t[p, r, :n] = perm[2 * r:2 * r + n]
                if n:
                    tl[p, r] = rng.integers(1, BS + 1)
        return t, tl
    C = 10
    chunk = dict(toks=rng.integers(0, cfg.vocab_size, C).astype(np.int32),
                 t0=9, n_valid=8, tables=tables(1),
                 wrank=np.array([1, 1, 2, 3, 0, 0, -1, NR, 2, 0], np.int32),
                 wblk=np.array([7, 7, 8, 2, 9, 9, 3, 3, NB, 4], np.int32),
                 woff=np.array([0, 1, 3, 2, 0, 1, 1, 1, 0, 3], np.int32))
    decode = dict(tokens=rng.integers(0, cfg.vocab_size, 2).astype(np.int32),
                  lens=np.array([17, 3], np.int32), tables=tables(2),
                  wblk=np.array([9, NB], np.int32),
                  woff=np.array([2, 0], np.int32))
    return gk, gv, chunk, decode


def _prompts(cfg):
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, 40).tolist(),
            rng.integers(0, cfg.vocab_size, 9).tolist()]


def _cache_prompts(cfg):
    """A 24-token base (3 blocks), a prompt sharing its first 2 blocks,
    and the base again (a full hit: the copy-on-write path)."""
    rng = np.random.default_rng(8)
    base = rng.integers(0, cfg.vocab_size, 24).tolist()
    return [base, base[:16] + rng.integers(0, cfg.vocab_size, 6).tolist(),
            base]


def _cluster(params, cfg, n_inst, **kw):
    over = {k: kw.pop(k) for k in ("prefix_cache", "host_tier_blocks",
                                   "overload") if k in kw}
    return psv.Cluster(params, cfg, psv.ServingConfig.smoke(
        n_instances=n_inst, max_batch=2, pool_blocks=32, global_pool=True,
        **over), device="cpu", **kw)


def _serve(cl, prompts, *, one_by_one=False):
    reqs = [psv.Request(prompt=list(p),
                        sampling=psv.SamplingParams(max_new_tokens=N_NEW))
            for p in prompts]
    for r in reqs:
        cl.submit(r)
        if one_by_one:
            cl.run_until_done(max_steps=400)
    cl.run_until_done(max_steps=400)
    assert all(r.done for r in reqs), [r.state for r in reqs]
    return [r.output for r in reqs]


# ------------------------------------------------------------------ #
# The processes
# ------------------------------------------------------------------ #
def _steps(params, cfg, mesh, axes, inp):
    from repro_torch.serving.sharded_step import (decode_step_global,
                                                  prefill_chunk_global)
    from repro_torch.distributed.mesh import pool_shards, shard_rank_base
    gk, gv, c, d = inp
    r_loc = pool_shards(mesh, axes).local_ranks(NR)
    lo = shard_rank_base(mesh, axes, r_loc)
    tk = torch.from_numpy(gk[lo:lo + r_loc].copy())
    tv = torch.from_numpy(gv[lo:lo + r_loc].copy())
    ptr = tk.data_ptr()
    lg_c, _, _, kc, vc = prefill_chunk_global(
        params, cfg, c["toks"], c["t0"], c["n_valid"], tk, tv,
        c["tables"][0][:, 0], c["tables"][1][:, 0], c["wrank"], c["wblk"],
        c["woff"], mesh=mesh, pool_axes=axes)
    after_chunk = (tk.numpy().copy(), tv.numpy().copy())
    lg_d, _, _ = decode_step_global(
        params, cfg, d["tokens"], d["lens"], tk, tv, *d["tables"], d["wblk"],
        d["woff"], rank=1, mesh=mesh, pool_axes=axes)
    assert tk.data_ptr() == ptr
    return {"lo": lo, "shards_kept": pool_shards(mesh, axes) is pool_shards(
                mesh, list(axes)),
            "logits_chunk": lg_c.numpy(), "kc": kc.numpy(),
            "vc": vc.numpy(), "after_chunk": after_chunk,
            "logits_decode": lg_d.numpy(), "k": tk.numpy(), "v": tv.numpy()}


def _cluster_case(params, cfg, n_inst, mesh, layout):
    cl = _cluster(params, cfg, n_inst, mesh=mesh, layout=layout)
    outs = _serve(cl, _prompts(cfg))
    return {"outs": outs,
            "moved": sum(e.stats.kv_moved for e in cl.engines.values()),
            "copies": sum(e.stats.pool_copy_steps
                          for e in cl.engines.values()),
            "slab": tuple(cl.gpool.k.shape),
            "traffic": dataclasses.asdict(cl.gpool.traffic)}


def _cache_case(params, cfg, mesh, layout):
    cl = _cluster(params, cfg, 2, mesh=mesh, layout=layout,
                  prefix_cache=True)
    outs = _serve(cl, _cache_prompts(cfg), one_by_one=True)
    return {"outs": outs,
            "hit_tokens": sum(e.stats.cache_hit_tokens
                              for e in cl.engines.values()),
            "cow": cl.prefix_cache.stats.cow_copies}


# ------------------------------------------------------------------ #
# The serving extensions: the same scenario in every process of the
# mesh and in one process (the single-process global cluster)
# ------------------------------------------------------------------ #
EXT_ARCHS = ("olmo-1b", "qwen3-0.6b")
EXT_CASES = ("host_tier", "overload", "kill", "fault_plan")
# Host-tier counters that decisions follow from (stall counts and
# times may differ between processes: they read the card's events).
HOST_COUNTS = ("spills", "fetches", "evictions", "rejected",
               "fetch_retries", "fetch_failures", "corruptions",
               "spilled_bytes", "fetched_bytes")


def _ext_config(**over):
    base = dict(n_instances=4, max_batch=2, pool_blocks=32, global_pool=True,
                faults=psv.FaultPolicy(max_transfer_retries=2,
                                       verify_host_frames=True))
    base.update(over)
    return psv.ServingConfig.smoke(**base)


def _ext_prompts(cfg):
    """A creditor-spanning prompt (40 tokens over a 32-token quota), a
    3-block one (cacheable) and a short one."""
    rng = np.random.default_rng(12)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 24, 9)]


def _tier_counts(tier):
    return None if tier is None else {
        k: getattr(tier.stats, k) for k in HOST_COUNTS}


def _summary(cl, reqs):
    """What every process and the single-process cluster must agree on,
    after the allocators' check (a cache is cleared first)."""
    pre = cl.preemptor
    out = {"outs": [list(r.output) for r in reqs],
           "states": [r.state.name for r in reqs],
           "replays": [r.replays for r in reqs],
           "preemptions": [r.preemptions for r in reqs],
           "fault_stats": dataclasses.asdict(cl.fault_stats),
           "preempt": None if pre is None else dataclasses.asdict(pre.stats),
           "host": _tier_counts(cl.host_tier),
           "preempt_tier": _tier_counts(pre and pre.tier),
           "stager": (dict(cl.stager.retries), dict(cl.stager.failures)),
           "copies": sum(e.stats.pool_copy_steps
                         for e in cl.engines.values()),
           "dead": sorted(cl._dead)}
    if cl.prefix_cache is not None:
        out["root"] = cl.prefix_cache.root.hash
        out["host_keys"] = (cl.host_tier.lru_keys()
                            if cl.host_tier is not None else [])
        cl.prefix_cache.clear()
    for _ in range(2):                  # flush pending hosted releases
        cl.step()
    out["clean"] = all(
        e.rmanager.pool.alloc.used_count == 0 and
        e.rmanager.pool.alloc.reserved == 0 and not e.rmanager.pool.requests
        for e in cl.engines.values())
    return out


def _new_requests(prompts, n_new=N_NEW):
    return [psv.Request(prompt=list(p),
                        sampling=psv.SamplingParams(max_new_tokens=n_new))
            for p in prompts]


def _run_reqs(cl, reqs):
    for r in reqs:
        cl.submit(r)
    cl.run_until_done(max_steps=400)


def _host_tier_case(params, cfg, mesh=None, layout=None):
    """A 3-block prompt served and cached, every replica spilled to the
    host tier (pressure on every instance), then served again from the
    host (an H2D fetch) and once more (a device hit)."""
    cl = psv.Cluster(params, cfg, _ext_config(
        n_instances=2, prefix_cache=True, host_tier_blocks=16),
        device="cpu", mesh=mesh, layout=layout)
    base = _ext_prompts(cfg)[1]
    reqs = _new_requests([base] * 3)
    _run_reqs(cl, reqs[:1])
    for i in cl.engines:
        cl.prefix_cache.evict_device(i, 10 ** 6)
    held = cl.host_tier.held_bytes
    _run_reqs(cl, reqs[1:2])
    _run_reqs(cl, reqs[2:])
    return dict(_summary(cl, reqs), held_bytes=held), [(base, N_NEW)] * 3


def _overload_case(params, cfg, mesh=None, layout=None):
    """Two best-effort requests fill both slots; an urgent arrival pauses
    one (its chain spilled to the preempt tier), which resumes once the
    urgent request is done. A synthetic clock (``now=``), as the
    single-process tests use."""
    server = psv.LLMServer(params, cfg, _ext_config(
        n_instances=2, max_batch=1,
        overload=psv.OverloadPolicy(enabled=True)), device="cpu",
        mesh=mesh, layout=layout)
    bg_prompts, urgent = _ext_prompts(cfg)[1:], _ext_prompts(cfg)[0][:6]
    t, bg = 100.0, []
    for k in range(5):
        if k in (0, 2):     # one an instance (heartbeats lag a step)
            bg.append(server.submit(bg_prompts[k // 2], psv.SamplingParams(
                max_new_tokens=16), arrival_time=t + 0.1 * k))
        server.step(now=t + 0.1 * k)
    up = server.submit(urgent, psv.SamplingParams(max_new_tokens=4),
                       priority=1, deadline_s=60.0, arrival_time=t + 0.45)
    handles, k = bg + [up], 5
    while not all(h.done for h in handles) and k < 400:
        server.step(now=t + 0.1 * k)
        k += 1
    return (_summary(server.cluster, [h._req for h in handles]),
            [(p, 16) for p in bg_prompts] + [(urgent, 4)])


def _kill_case(params, cfg, mesh=None, layout=None):
    """The creditor of a spanning request dies mid-decode (a logical
    crash: its rank's slab stays); the request replays."""
    cl = psv.Cluster(params, cfg, _ext_config(), device="cpu", mesh=mesh,
                     layout=layout)
    prompts = _ext_prompts(cfg)
    reqs = _new_requests(prompts)
    for r in reqs:
        cl.submit(r)
    for _ in range(4):
        cl.step()
    owner = next(e for e in cl.engines.values() if reqs[0] in e.running)
    cl.kill_instance(owner.remote_insts[reqs[0].req_id][0])
    cl.run_until_done(max_steps=400)
    return _summary(cl, reqs), [(p, N_NEW) for p in prompts]


def _fault_plan_case(params, cfg, mesh=None, layout=None):
    """One event of each kind against a cluster with the prefix cache and
    a host tier; after the first round every replica is spilled and the
    3-block prompt comes back from the host (where the armed fetch error
    and corruption land)."""
    cl = psv.Cluster(params, cfg, _ext_config(
        prefix_cache=True, host_tier_blocks=16), device="cpu", mesh=mesh,
        layout=layout)
    inj = cl.install_faults(psv.FaultPlan(events=(
        psv.FaultEvent(step=1, kind="move_leg"),
        psv.FaultEvent(step=1, kind="host_fetch"),
        psv.FaultEvent(step=1, kind="host_corrupt"),
        psv.FaultEvent(step=2, kind="stager_timeout"),
        psv.FaultEvent(step=3, kind="silence", target=0, duration=2),
        psv.FaultEvent(step=6, kind="crash", target=3))))
    prompts = _ext_prompts(cfg)
    reqs = _new_requests(prompts)
    _run_reqs(cl, reqs)
    for i in cl.engines:
        if i not in cl._dead:
            cl.prefix_cache.evict_device(i, 10 ** 6)
    again = _new_requests([prompts[1]] * 2)
    for r in again:
        _run_reqs(cl, [r])
    out = _summary(cl, reqs + again)
    out["fired"] = [ev.kind for ev in inj.fired]
    return out, [(p, N_NEW) for p in prompts + [prompts[1]] * 2]


EXT = {"host_tier": _host_tier_case, "overload": _overload_case,
       "kill": _kill_case, "fault_plan": _fault_plan_case}


def _planted_guard(params, cfg, mesh, layout, rank, what):
    """Serve a request a few steps with the host tier and overload on,
    then plant a divergence in process 1's ``what``: the step's guard
    must raise in every process."""
    cl = _cluster(params, cfg, 2, mesh=mesh, layout=layout,
                  prefix_cache=True, host_tier_blocks=8,
                  overload=psv.OverloadPolicy(enabled=True))
    req = psv.Request(prompt=_prompts(cfg)[1],
                      sampling=psv.SamplingParams(max_new_tokens=N_NEW))
    cl.submit(req)
    for _ in range(3):
        cl.step()
    if rank == 1:
        if what == "paused":
            from repro_torch.serving.preempt import _PausedRecord
            cl.preemptor.paused[10 ** 6] = _PausedRecord(req, 0, 0, 0.0, [])
        elif what == "dead":
            cl._dead.add(1)
        else:
            k = torch.zeros(cfg.num_layers, BS, cfg.num_kv_heads,
                            cfg.head_dim)
            cl.host_tier.put(("planted", 0), k, k)
    try:
        cl.step()
    except RuntimeError as e:
        return str(e)
    return None


def _server_clock(params, cfg, mesh, layout, steps=4):
    """Clock collectives in ``steps`` steps of an LLMServer over the mesh
    (the cluster's ``agreed_clock`` counted), and the steps' streams."""
    import repro_torch.serving.cluster as cluster_mod
    server = psv.LLMServer(params, cfg, psv.ServingConfig.smoke(
        n_instances=2, max_batch=2, pool_blocks=32, global_pool=True),
        device="cpu", mesh=mesh, layout=layout)
    h = server.submit(_prompts(cfg)[1],
                      psv.SamplingParams(max_new_tokens=N_NEW))
    calls = []
    agreed = cluster_mod.agreed_clock

    def counted(group, now=None):
        calls.append(now)
        return agreed(group, now)
    cluster_mod.agreed_clock = counted
    try:
        for _ in range(steps):
            server.step()
    finally:
        cluster_mod.agreed_clock = agreed
    return {"steps": steps, "clock_calls": len(calls),
            "tokens": len(server.cluster.requests[h.req_id].output)}


def _guard(params, cfg, mesh, layout, rank):
    """Serve a request a few steps, then perturb rank 1's copy of it."""
    cl = _cluster(params, cfg, 2, mesh=mesh, layout=layout)
    req = psv.Request(prompt=_prompts(cfg)[1],
                      sampling=psv.SamplingParams(max_new_tokens=N_NEW))
    cl.submit(req)
    for _ in range(3):
        cl.step()
    if rank == 1:
        req.output.append(0)
    try:
        cl.step()
    except RuntimeError as e:
        return str(e)
    return None


def _worker(rank, store, W, payload, ext, queue):
    import traceback
    torch.set_num_threads(1)
    try:
        from repro_torch.distributed.mesh import make_mesh
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=W)
        shape, axes = LAYOUTS[W]
        mesh = make_mesh(shape, device="cpu")
        layout = psv.ServeLayout(batch_axes=("data",), pool_axes=axes)
        out = {}
        for arch, (np_params, inp) in payload.items():
            cfg = _cfg(arch)
            params = bridge.from_numpy_tree(np_params, device="cpu")
            out[arch] = {"steps": _steps(params, cfg, mesh, axes, inp)}
            for case_arch, n_inst, world in CASES:
                if (case_arch, world) == (arch, W):
                    out[arch]["cluster"] = _cluster_case(params, cfg, n_inst,
                                                         mesh, layout)
            if W == 2 and arch == "olmo-1b":
                out[arch]["cache"] = _cache_case(params, cfg, mesh, layout)
                out[arch]["guard"] = _guard(params, cfg, mesh, layout, rank)
                out[arch]["planted"] = {
                    what: _planted_guard(params, cfg, mesh, layout, rank,
                                         what)
                    for what in ("paused", "dead", "host_keys")}
                out[arch]["clock"] = _server_clock(params, cfg, mesh, layout)
        if W == 2:
            for arch in EXT_ARCHS:
                cfg = _cfg(arch)
                params = bridge.from_numpy_tree(
                    payload[arch][0] if arch in payload else ext[arch],
                    device="cpu")
                out.setdefault(arch, {})["ext"] = {
                    case: EXT[case](params, cfg, mesh, layout)[0]
                    for case in EXT_CASES}
        queue.put((rank, out))
    except Exception:
        queue.put((rank, traceback.format_exc()))


# ------------------------------------------------------------------ #
# References (this process)
# ------------------------------------------------------------------ #
def _oracle(jp, cfg, prompt, decode, n_new=N_NEW):
    import jax.numpy as jnp
    from repro.models.prefill import prefill
    logits, state = prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                            max_len=len(prompt) + n_new + 2)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = decode(jp, cfg, state, jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def _jax_steps(jp, cfg, inp):
    import jax.numpy as jnp
    from repro.serving.sharded_step import (decode_step_global,
                                            prefill_chunk_global)
    gk, gv, c, d = inp
    lg_c, jk, jv, kc, vc = prefill_chunk_global(
        jp, cfg, c["toks"], c["t0"], c["n_valid"], jnp.asarray(gk),
        jnp.asarray(gv), c["tables"][0][:, 0], c["tables"][1][:, 0],
        c["wrank"], c["wblk"], c["woff"])
    # JAX wraps the negative rank onto the last one: the port drops it
    # (mode="drop" only drops indices past the end). Compare the rows
    # the port is meant to write, from JAX's exports.
    after_k, after_v = gk.copy(), gv.copy()
    for i, (r, b, o) in enumerate(zip(c["wrank"], c["wblk"], c["woff"])):
        if 0 <= r < NR and 0 <= b < NB:
            after_k[r, :, b, o] = np.asarray(kc)[:, i]
            after_v[r, :, b, o] = np.asarray(vc)[:, i]
    lg_d, jk2, jv2 = decode_step_global(
        jp, cfg, d["tokens"], d["lens"], jnp.asarray(after_k),
        jnp.asarray(after_v), *d["tables"], d["wblk"], d["woff"], rank=1)
    return {"logits_chunk": np.asarray(lg_c), "kc": np.asarray(kc),
            "vc": np.asarray(vc), "after_chunk": (after_k, after_v),
            "logits_decode": np.asarray(lg_d), "k": np.asarray(jk2),
            "v": np.asarray(jv2)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.model import decode_step, init_params

    def jcfg(arch):
        return dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    payload = {}
    for i, arch in enumerate(("olmo-1b", "qwen2-moe-a2.7b")):
        cfg = _cfg(arch)
        jp = init_params(jax.random.PRNGKey(0), jcfg(arch))
        payload[arch] = (jax.tree.map(np.asarray, jp),
                         _step_inputs(cfg, np.random.default_rng(30 + i)))
    ext = {arch: jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(0), jcfg(arch)))
        for arch in EXT_ARCHS if arch not in payload}
    # Both process groups run while this process builds the references.
    groups = {W: Spawned(_worker, W, str(tmp_path_factory.mktemp(f"w{W}")),
                         W, payload, ext) for W in LAYOUTS}
    refs = {}
    jit_decode = jax.jit(decode_step, static_argnums=1)
    for arch in EXT_ARCHS:
        np_params = payload[arch][0] if arch in payload else ext[arch]
        jp = jax.tree.map(jnp.asarray, np_params)
        tp = bridge.from_numpy_tree(np_params, device="cpu")
        cfg = _cfg(arch)
        single, oracle = {}, {}
        for case in EXT_CASES:
            single[case], served = EXT[case](tp, cfg)
            oracle[case] = [_oracle(jp, jcfg(arch), p, jit_decode, n)
                            for p, n in served]
        refs.setdefault(arch, {})["ext"] = (single, oracle)
    for arch, (np_params, inp) in payload.items():
        cfg = _cfg(arch)
        jp = jax.tree.map(jnp.asarray, np_params)
        tp = bridge.from_numpy_tree(np_params, device="cpu")
        refs.setdefault(arch, {}).update({"inp": inp,
                      "jax_steps": _jax_steps(jp, jcfg(arch), inp),
                      "oracle": [_oracle(jp, jcfg(arch), p, jit_decode)
                                 for p in _prompts(cfg)],
                      "single": {n: _serve(_cluster(tp, cfg, n),
                                           _prompts(cfg)) for n in (2, 4)},
                      "cache": _serve(_cluster(tp, cfg, 2, prefix_cache=True),
                                      _cache_prompts(cfg), one_by_one=True)})
    return refs, {W: g.results() for W, g in groups.items()}


def _close_logits(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def _gather(res, W, arch, key):
    """The whole pool from every process's slab (one pool group)."""
    parts = {}
    for r in range(W):
        s = res[W][r][arch]["steps"]
        parts[s["lo"]] = s[key]
    return parts


@pytest.mark.parametrize("W", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_mesh_steps_match_jax_single_device(run, arch, W):
    refs, res = run
    want = refs[arch]["jax_steps"]
    for r in range(W):
        got = res[W][r][arch]["steps"]
        assert got["shards_kept"]
        for key in ("logits_chunk", "logits_decode"):
            _close_logits(got[key], want[key])
        for key in ("kc", "vc"):
            np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                       atol=TOL)
    for key in ("k", "v"):
        for lo, slab in _gather(res, W, arch, key).items():
            assert slab.shape[0] == NR // W         # NR / shards ranks
            np.testing.assert_allclose(slab, want[key][lo:lo + len(slab)],
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("W", sorted(LAYOUTS))
def test_mesh_writers_keep_only_local_rows_exactly(run, W):
    """After the chunk, each slab is its input with exactly the rows
    whose (rank, block) is local and in range replaced by the process's
    own chunk export: negative ranks, ranks past the pool, the sentinel
    block and other shards' rows leave it untouched."""
    refs, res = run
    arch = "olmo-1b"
    gk, gv, c, _ = refs[arch]["inp"]
    for r in range(W):
        s = res[W][r][arch]["steps"]
        lo = s["lo"]
        n = s["after_chunk"][0].shape[0]
        assert n == NR // W                  # NR / shards ranks a process
        for pool, got, exp in ((gk, s["after_chunk"][0], s["kc"]),
                               (gv, s["after_chunk"][1], s["vc"])):
            want = pool[lo:lo + n].copy()
            for i, (rk, b, o) in enumerate(zip(c["wrank"], c["wblk"],
                                               c["woff"])):
                if lo <= rk < lo + n and 0 <= b < NB:
                    want[rk - lo, :, b, o] = exp[:, i]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,n_inst,W", CASES)
def test_mesh_cluster_serves_the_oracle_streams(run, arch, n_inst, W):
    refs, res = run
    oracle = refs[arch]["oracle"]
    assert refs[arch]["single"][n_inst] == oracle
    for r in range(W):
        got = res[W][r][arch]["cluster"]
        assert got["outs"] == oracle
        assert got["moved"] > 0 and got["copies"] == 0
        assert got["slab"][0] == n_inst // W        # NR / shards ranks
        # KV crossed processes: a StripedMove leg between two shards.
        assert got["traffic"]["remote_copies"] > 0
        assert got["traffic"]["broadcasts"] >= got["traffic"][
            "remote_copies"]


def test_mesh_prefix_cache_warm_and_cow_hits(run):
    refs, res = run
    for r in range(2):
        got = res[2][r]["olmo-1b"]["cache"]
        assert got["outs"] == refs["olmo-1b"]["cache"]
        assert got["hit_tokens"] >= 16 + 23 and got["cow"] == 1


@pytest.mark.parametrize("case", EXT_CASES)
@pytest.mark.parametrize("arch", EXT_ARCHS)
def test_mesh_extensions_match_the_single_process_cluster(run, arch, case):
    refs, res = run
    single, oracle = refs[arch]["ext"]
    want = single[case]
    for r in range(2):
        got = res[2][r][arch]["ext"][case]
        assert got == want, (r, {k: (got[k], want.get(k)) for k in got
                                 if got[k] != want.get(k)})
    # Every request finished with the oracle's stream (a replayed or
    # resumed one included), nothing reallocated a slab, no leak.
    assert want["states"] == ["FINISHED"] * len(want["outs"])
    assert want["outs"] == oracle[case]
    assert want["copies"] == 0 and want["clean"]
    if case == "host_tier":
        assert want["host"]["spills"] >= 3 and want["host"]["fetches"] >= 3
        assert want["held_bytes"] > 0
    elif case == "overload":
        assert want["preempt"]["preemptions"] == 1
        assert want["preempt"]["resumes"] == 1
    elif case == "kill":
        assert want["fault_stats"]["dead_instances"] == 1
        assert want["replays"][0] == 1
    else:
        assert want["fired"] == ["move_leg", "host_fetch", "host_corrupt",
                                 "stager_timeout", "silence", "crash"]
        assert want["fault_stats"]["dead_instances"] == 1


def test_mesh_agrees_on_the_prefix_cache_root_hash(run):
    """Python salts a string's hash per process: the root's hash is a
    fixed int, so the chain hashes (the host tier's keys) are the same
    in every process of a mesh and in a single process."""
    refs, res = run
    for arch in EXT_ARCHS:
        want = refs[arch]["ext"][0]["host_tier"]
        assert want["host_keys"]
        for r in range(2):
            got = res[2][r][arch]["ext"]["host_tier"]
            assert got["root"] == want["root"]
            assert got["host_keys"] == want["host_keys"]


@pytest.mark.parametrize("what", ["paused", "dead", "host_keys"])
def test_divergence_planted_in_replicated_state_raises_everywhere(run, what):
    _, res = run
    for r in range(2):
        msg = res[2][r]["olmo-1b"]["planted"][what]
        assert msg is not None and "diverged" in msg


def test_divergence_guard_raises_in_every_process(run):
    _, res = run
    for r in range(2):
        msg = res[2][r]["olmo-1b"]["guard"]
        assert msg is not None and "diverged" in msg


def test_mesh_server_agrees_on_the_clock_once_a_step(run):
    _, res = run
    for r in range(2):
        got = res[2][r]["olmo-1b"]["clock"]
        assert got["clock_calls"] == got["steps"]
        assert got["tokens"] > 0
