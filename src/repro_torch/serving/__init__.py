"""Serving runtime of the port: request-lifecycle frontend over a
DistAttention cluster on one CUDA device.

Public API (start here)
-----------------------
``LLMServer`` is the serving frontend:

    from repro_torch.serving import LLMServer, ServingConfig, SamplingParams

    server = LLMServer(params, cfg, ServingConfig.h100(n_instances=3))
    handle = server.submit(prompt_tokens, SamplingParams(max_new_tokens=32))
    for tok in handle.tokens():      # incremental stream
        ...
    handle.result(); handle.status; handle.metrics; handle.cancel()

Every entry point runs on the card (``device=None`` means ``"cuda"``) and
raises when CUDA is absent unless the caller passes ``device="cpu"``.
``ServingConfig`` is the one frozen home of every serving knob, with
``smoke()``/``h100()`` presets. Cancellation propagates through every
layer: engine slot, in-flight streaming prefill (creditor reservations
rolled back via the all-or-nothing machinery), hosted spans, and planned
KV moves (-> ``MoveResult.GONE``).

Internal layers (exported for tests and tools)
----------------------------------------------
``Cluster`` executes steps: N ``InstanceEngine``s (each owning a paged
KV pool addressed through ``RankKVPool`` block tables) plus a
``GManager`` running the paper's Algorithm 1 via ``GreedyScheduler``.
The paged attention partials run in the hand-written CUDA kernels of
``repro_torch.kernels``. With ``ServingConfig(global_pool=True)`` the
engines alias rank slices of one cluster-wide ``GlobalKVPool`` tensor on
the card instead of owning private pools.

Memory hierarchy and overload survival (opt-in, both pool modes):
``ServingConfig(prefix_cache=True, host_tier_blocks=N)`` adopts every
finished request's full KV blocks into a ``RadixPrefixCache`` (warm
admissions attach them and prefill only the uncached tail; a full-prompt
hit copies its last block, copy-on-write) and spills evicted replicas to
a ``HostKVTier`` of pinned host frames (asynchronous D2H on a side
stream, H2D back on a hit). ``ServingConfig(overload=OverloadPolicy(
enabled=True))`` lets the frontend pause SLO-slack victims for urgent
arrivals: the ``Preemptor`` spills the victim's KV chain to its own
host tier and resumes it later over byte-identical KV.

Fault tolerance (always on; chaos injection opt-in, both pool modes): an
instance that misses ``FaultPolicy.heartbeat_timeout_steps`` heartbeats
is quarantined and every request that lost KV on it is re-admitted by
token replay (re-prefill of ``prompt + output[:-1]``, no resampling).
``cluster.kill_instance(i)`` simulates a crash; ``cluster.install_faults(
FaultPlan(...))`` (or ``FaultPlan.from_seed``) arms a deterministic plan
of crashes, silences, move-leg failures, host-tier fetch errors and
corruptions, and stager timeouts; ``server.metrics`` carries the fault
counters.

Mesh-sharded global KV pool (opt-in)
------------------------------------
``ServingConfig(global_pool=True)`` folds the per-instance pool tensors
into ONE cluster-wide ``GlobalKVPool`` ``[ranks, L, NB, bs, K, hd]``
whose rank axis can be sharded over the processes of a
``torch.distributed`` job. Spawn W processes (``torch.multiprocessing``
with the ``spawn`` method), and in each:

    dist.init_process_group("gloo", init_method="file:///.../store",
                            rank=rank, world_size=W)
    mesh = make_mesh((2, W // 2))             # repro_torch.distributed.mesh
    layout = ServeLayout(batch_axes=("data",), pool_axes=("data",))
    server = LLMServer(params, cfg,
                       ServingConfig.h100(n_instances=4, global_pool=True),
                       mesh=mesh, layout=layout)

then make the same calls (submit, step, drain) in every process, in the
same order, with the same weights: SPMD with replicated control, the
counterpart of the JAX package's single controller over a device mesh.
Knobs: ``LLMServer(..., mesh=...)`` attaches the mesh (omit it for the
single-process path — same math, no collectives); ``layout``
(``ServeLayout.pool_axes``) picks which mesh axes shard the rank axis
(``("data",)`` or ``("data", "model")``; n_instances must divide over
their total size). Each process allocates only its slab of ranks; every
process runs every engine's host logic over the shared allocator views;
decode and prefill run ``decode_step_global``/``prefill_chunk_global``
(per-process rank-form kernel partials, LSE-merged across processes with
one all-reduce MAX and two SUMs: queries and merge scalars cross, KV
never moves), and ``StripedMove`` legs and prefix-cache copies between
processes are broadcasts from the owner. Each step checks that every
process planned the same step (``RuntimeError`` otherwise). The host
tier, overload preemption and fault injection run under a mesh too: a
spill's block read is such a broadcast, so every process keeps the
frame and the tiers stay replicated; fetches and resumes write on the
owner; a crash is logical (the rank's slab stays); every process arms
the same ``FaultPlan``.
"""
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.config import (FaultPolicy, OverloadPolicy,
                                        ServingConfig)
from repro_torch.serving.engine import InstanceEngine
from repro_torch.serving.faults import (FaultEvent, FaultInjector, FaultPlan,
                                        FaultStats, FrameCorruptionError,
                                        TransferError)
from repro_torch.serving.globalpool import GlobalKVPool
from repro_torch.serving.gmanager import GManager
from repro_torch.serving.hosttier import HostKVTier
from repro_torch.serving.kvpool import BlockAllocator, RankKVPool
from repro_torch.serving.perfmodel import InstancePerfModel, cluster_tps
from repro_torch.serving.preempt import Preemptor, PreemptStats
from repro_torch.serving.prefixcache import RadixPrefixCache
from repro_torch.serving.request import (Request, RequestIdAllocator,
                                         RequestState, SamplingParams)
from repro_torch.serving.rmanager import RManager
from repro_torch.serving.scheduler import (GreedyScheduler, InstanceView,
                                           SpanLeg, StripedMove)
from repro_torch.serving.server import Arrival, LLMServer, RequestHandle
from repro_torch.serving.sharded_step import ServeLayout

__all__ = [
    "LLMServer", "RequestHandle", "Arrival", "ServingConfig",
    "OverloadPolicy", "FaultPolicy",
    "Cluster", "InstanceEngine", "GManager", "BlockAllocator", "RankKVPool",
    "InstancePerfModel", "cluster_tps", "Request", "RequestIdAllocator",
    "RequestState", "SamplingParams", "RManager", "GreedyScheduler",
    "InstanceView", "SpanLeg", "StripedMove", "GlobalKVPool",
    "HostKVTier", "RadixPrefixCache", "Preemptor", "PreemptStats",
    "FaultPlan", "FaultEvent", "FaultInjector", "FaultStats",
    "TransferError", "FrameCorruptionError", "ServeLayout",
]
