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
"""
from repro_torch.serving.cluster import Cluster
from repro_torch.serving.config import (FaultPolicy, OverloadPolicy,
                                        ServingConfig)
from repro_torch.serving.engine import InstanceEngine
from repro_torch.serving.globalpool import GlobalKVPool
from repro_torch.serving.gmanager import GManager
from repro_torch.serving.kvpool import BlockAllocator, RankKVPool
from repro_torch.serving.perfmodel import InstancePerfModel, cluster_tps
from repro_torch.serving.request import (Request, RequestIdAllocator,
                                         RequestState, SamplingParams)
from repro_torch.serving.rmanager import RManager
from repro_torch.serving.scheduler import (GreedyScheduler, InstanceView,
                                           SpanLeg, StripedMove)
from repro_torch.serving.server import Arrival, LLMServer, RequestHandle

__all__ = [
    "LLMServer", "RequestHandle", "Arrival", "ServingConfig",
    "OverloadPolicy", "FaultPolicy",
    "Cluster", "InstanceEngine", "GManager", "BlockAllocator", "RankKVPool",
    "InstancePerfModel", "cluster_tps", "Request", "RequestIdAllocator",
    "RequestState", "SamplingParams", "RManager", "GreedyScheduler",
    "InstanceView", "SpanLeg", "StripedMove", "GlobalKVPool",
]
