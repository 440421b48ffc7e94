"""Typed serving configuration: every cluster/engine/frontend knob in
one frozen dataclass.

Before this existed the same dozen kwargs were threaded (with drifting
values) through ``Cluster.__init__``, ``GManager``, ``InstanceEngine``,
every example, the launcher, and every benchmark. ``ServingConfig`` is
now the single source of truth: ``Cluster(params, cfg, config=...)`` and
``LLMServer(params, cfg, config=...)`` take it, and the presets below
pin the two configurations the repo actually runs —

  * ``ServingConfig.smoke()``  — CPU smoke scale (tests, examples, CI
    benchmarks): tiny pools, 8-token blocks, chunked prefill small
    enough that every code path (spill, striping, reclaim) triggers on
    40-token prompts.
  * ``ServingConfig.h100()``   — the deployment shape of one H100 card
    (16-token blocks, production batch, prefill chunks sized for the
    card's matrix units).

Both presets accept overrides: ``ServingConfig.smoke(n_instances=3)``.
Use ``cfg.replace(async_movement=False)`` to derive variants for A/Bs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class OverloadPolicy:
    """Overload-survival knobs: preemptive pause/host-spill scheduling.

    Off by default (``enabled=False``) the server behaves exactly as
    before: admission queues or rejects, running requests are never
    disturbed. Enabled, the frontend may PAUSE running requests at a
    step boundary — spilling their KV chain byte-for-byte to a
    dedicated pinned host-DRAM tier — to free slots/blocks for
    deadline-urgent arrivals, and resumes them later with identical
    tokens. Victim choice is SLO-aware: slack = deadline - predicted
    finish (perf model), charged the spill+resume round-trip via
    ``t_host_transfer``. Frozen like ``ServingConfig``; derive variants
    with ``dataclasses.replace``.
    """

    enabled: bool = False          # master switch for preemption
    preempt_host_blocks: int = 512  # host frames reserved for paused KV
    max_preemptions: int = 2       # per-request pause cap (anti-thrash)
    min_pause_s: float = 0.0       # min parked time before resume
    victim_min_slack_s: float = 0.5  # victim must keep this much slack
    #                                 AFTER paying the spill+resume cost
    arrival_alpha: float = 0.3     # EWMA weight of the arrival estimator

    def __post_init__(self):
        if not 0.0 < self.arrival_alpha <= 1.0:
            raise ValueError("arrival_alpha must be in (0, 1]")
        if self.enabled and self.preempt_host_blocks <= 0:
            raise ValueError(
                "preemption requires preempt_host_blocks > 0 (paused KV "
                "lives in the dedicated host tier)")
        if self.max_preemptions < 0 or self.min_pause_s < 0:
            raise ValueError("max_preemptions/min_pause_s must be >= 0")


@dataclass(frozen=True)
class FaultPolicy:
    """Fault-tolerance knobs: detection, retry budgets, replay caps.

    Always on — these bound how the cluster reacts when something
    breaks, they never cause work by themselves. Detection: an instance
    is marked DEAD and quarantined after ``heartbeat_timeout_steps``
    consecutive missed heartbeats (step-count based, deterministic —
    the wall-clock ``ServingConfig.heartbeat_timeout`` still applies
    independently). Recovery: every request that lost KV on a dead rank
    is re-admitted via token-replay re-prefill of ``prompt +
    output[:-1]`` (known tokens, no resampling), at most
    ``max_replays_per_request`` times before it FAILs. Transfers
    (stager drains, host-tier fetches) retry up to
    ``max_transfer_retries`` with bounded exponential backoff, and
    host frames are verified against the content hash they were stored
    under when ``verify_host_frames`` is set. Frozen like
    ``ServingConfig``; derive variants with ``dataclasses.replace``.
    """

    heartbeat_timeout_steps: int = 3   # missed beats before DEAD (0 = off)
    max_transfer_retries: int = 2      # per-transfer retry budget
    retry_backoff_base_s: float = 0.0  # backoff = min(cap, base * 2**i);
    retry_backoff_max_s: float = 0.05  # base 0 = immediate retries (tests)
    max_replays_per_request: int = 3   # replay recoveries before FAILED
    verify_host_frames: bool = True    # hash-check H2D host-tier fetches

    def __post_init__(self):
        if self.heartbeat_timeout_steps < 0:
            raise ValueError("heartbeat_timeout_steps must be >= 0")
        if self.max_transfer_retries < 0:
            raise ValueError("max_transfer_retries must be >= 0")
        if self.retry_backoff_base_s < 0 or self.retry_backoff_max_s < 0:
            raise ValueError("retry backoff times must be >= 0")
        if self.max_replays_per_request < 0:
            raise ValueError("max_replays_per_request must be >= 0")


@dataclass(frozen=True)
class ServingConfig:
    """All serving knobs. Frozen: derive variants via ``replace()``."""

    # --- cluster shape ------------------------------------------------ #
    n_instances: int = 2           # model replicas (paper: instances)
    max_batch: int = 8             # decode slots per instance
    global_pool: bool = False      # fold per-instance pools into ONE
    #                                mesh-shardable [ranks, L, NB, bs,
    #                                K, hd] tensor (GlobalKVPool); moves
    #                                and creditor reads become slice
    #                                assignments / shard_map partials
    # --- per-instance KV pool ----------------------------------------- #
    max_local_len: int = 128       # per-request LOCAL quota (tokens)
    pool_blocks: int = 64          # blocks in each instance's pool
    block_size: int = 16           # tokens per block
    prefill_chunk: int = 32        # streaming-admission chunk (tokens)
    # --- KV movement -------------------------------------------------- #
    move_chunk_tokens: int = 16    # reactive spill granularity
    async_movement: bool = True    # overlap pool-row copies with compute
    # --- prefix cache / host-DRAM tier -------------------------------- #
    prefix_cache: bool = False     # cross-request radix prefix caching
    host_tier_blocks: int = 0      # host-DRAM KV frames (0 = no tier;
    #                                requires prefix_cache — the cache
    #                                is the index into the tier)
    host_high_watermark: float = 0.9   # tier occupancy that triggers LRU
    host_low_watermark: float = 0.7    # ...eviction down to this level
    # --- gManager / Algorithm 1 --------------------------------------- #
    schedule_every: int = 4        # cluster steps between plan rounds
    heartbeat_timeout: float = 3.0
    beta_thres: int | None = None  # debtor batch threshold (None => max_batch)
    mem_util_thres: float = 0.8    # creditor memory threshold
    avg_new_req_len: int = 512     # batch-growth credit per freed token
    max_stripes: int = 8           # creditors one plan may fan out to
    reclaim_horizon_s: float = 1.0  # amortization window of reclaim gain
    # --- frontend (LLMServer) ----------------------------------------- #
    max_waiting: int = 256         # admission-queue bound (backpressure)
    admission_policy: str = "queue"  # "queue" | "reject" when bounded out
    # --- overload survival (preemption) -------------------------------- #
    overload: OverloadPolicy = OverloadPolicy()  # pause/spill/resume knobs
    # --- fault tolerance ----------------------------------------------- #
    faults: FaultPolicy = FaultPolicy()  # detection/retry/replay budgets

    def __post_init__(self):
        if self.admission_policy not in ("queue", "reject"):
            raise ValueError(
                f"admission_policy must be 'queue' or 'reject', got "
                f"{self.admission_policy!r}")
        if self.max_local_len < 2 * self.block_size:
            raise ValueError("max_local_len must cover >= 2 blocks")
        if self.host_tier_blocks > 0 and not self.prefix_cache:
            raise ValueError("host_tier_blocks requires prefix_cache=True"
                             " (the radix cache is the tier's index)")
        if not 0.0 < self.host_low_watermark <= self.host_high_watermark \
                <= 1.0:
            raise ValueError("need 0 < host_low_watermark <= "
                             "host_high_watermark <= 1")

    @property
    def beta_threshold(self) -> int:
        """Algorithm-1 debtor batch threshold (defaults to max_batch)."""
        return self.max_batch if self.beta_thres is None else self.beta_thres

    def replace(self, **overrides) -> "ServingConfig":
        """Derive a variant config (frozen dataclass ``replace``)."""
        return dataclasses.replace(self, **overrides)

    # --- presets ------------------------------------------------------ #
    @classmethod
    def smoke(cls, **overrides) -> "ServingConfig":
        """CPU smoke scale: tiny pools so every path triggers fast."""
        base = dict(n_instances=2, max_batch=3, max_local_len=32,
                    pool_blocks=48, block_size=8, prefill_chunk=8,
                    move_chunk_tokens=8, schedule_every=4,
                    heartbeat_timeout=1e9, avg_new_req_len=16,
                    max_waiting=64)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def h100(cls, **overrides) -> "ServingConfig":
        """Deployment shape of instances served from one H100 card."""
        base = dict(n_instances=4, max_batch=64, max_local_len=32_768,
                    pool_blocks=8192, block_size=16, prefill_chunk=512,
                    move_chunk_tokens=256, schedule_every=8,
                    heartbeat_timeout=60.0, avg_new_req_len=512,
                    max_waiting=1024)
        base.update(overrides)
        return cls(**base)
