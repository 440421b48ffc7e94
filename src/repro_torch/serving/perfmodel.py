"""The paper's performance model (Eq. 5-7), with H100 data-sheet constants.

  T_layer(beta, S) = T_natn(beta) + T_atn(S)
                   = W(beta) / f(beta) + sum_r S_r / g(S)        (Eq. 5)

* W(beta): non-attention FLOPs per layer for a decode step of batch beta —
  2 FLOPs per active parameter per token.
* f(beta): achieved FLOP/s. Non-attention GEMMs at decode are bandwidth
  bound until the batch reaches the critical arithmetic intensity
  (~295 FLOP/byte on an H100 by its data sheet):
  f(beta) = peak * min(1, beta / I_crit). This reproduces
  the paper's Fig. 2(c) saturation shape.
* g(S): attention "performance". Decode attention is strictly bandwidth
  bound (each KV byte read once, intensity ~1 FLOP/byte), so we express
  T_atn directly as KV bytes / HBM bandwidth; g(S) is constant in S —
  matching the paper's observation that attention does not batch.

Debtor/creditor adjustments (Eq. 6) subtract/add the offloaded KV-bytes
time; cluster throughput is the sum of instance TPS (Eq. 7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.hardware import H100, HardwareSpec


@dataclass
class InstancePerfModel:
    """Paper Eq. 5-7 analytic step-time model for one instance.

    Decomposes a decode step into non-attention compute (Eq. 5),
    bandwidth-bound attention over resident KV, TP collectives, and the
    debtor/creditor corrections (Eq. 6-7); the scheduler and SLO victim
    ranking consume ``predicted_finish_s``/``t_preempt_roundtrip``.
    """

    cfg: ModelConfig
    hw: HardwareSpec = H100
    chips: int = 1                 # chips per instance (TP degree)
    bytes_per_el: int = 2

    # ------------------------------------------------------------------ #
    def _active_params_per_layer(self) -> float:
        c = self.cfg
        body = c.active_param_count() - c.vocab_size * c.d_model * \
            (1 if c.tie_embeddings else 2)
        return body / max(1, c.num_layers)

    def w_natn(self, beta: int) -> float:
        """Non-attention FLOPs for one decode step of one layer (Eq. 5 W)."""
        return 2.0 * beta * self._active_params_per_layer()

    def f_natn(self, beta: int) -> float:
        """Achieved non-attention FLOP/s at batch beta (saturating ramp)."""
        peak = self.hw.peak_flops_bf16 * self.chips
        return peak * min(1.0, beta / self.hw.critical_intensity)

    def t_natn(self, beta: int) -> float:
        """Non-attention time of one layer at batch ``beta`` (Eq. 5)."""
        if beta <= 0:
            return 0.0
        return self.w_natn(beta) / self.f_natn(beta)

    def kv_bytes_per_token_layer(self) -> float:
        """KV bytes one token adds per layer (both K and V)."""
        c = self.cfg
        return 2.0 * c.num_kv_heads * c.head_dim * self.bytes_per_el

    def t_atn(self, lengths: Sequence[int]) -> float:
        """Attention time of one layer: sum_r S_r / g (bandwidth bound)."""
        kv_bytes = sum(lengths) * self.kv_bytes_per_token_layer()
        return kv_bytes / (self.hw.hbm_bw * self.chips)

    # Per-hop latency of one inter-instance message (modeled, not
    # measured).
    alpha_hop: float = 1e-6

    def t_tp_comm(self, beta: int) -> float:
        """Per-layer TP collective time: two all-reduces (attention out +
        FFN out) of [beta, d_model] activations over the ring, bandwidth
        PLUS per-hop latency 2(c-1)*alpha each — the latency term is what
        makes wide TP inefficient at decode (paper Fig. 1(c) / Obs. 1:
        over-segmentation of the non-attention layers)."""
        if self.chips <= 1:
            return 0.0
        bytes_ar = 2 * 2 * beta * self.cfg.d_model * self.bytes_per_el \
            * (self.chips - 1) / self.chips
        latency = 2 * 2 * (self.chips - 1) * self.alpha_hop
        return bytes_ar / self.hw.ici_link_bw + latency

    def t_layer(self, beta: int, lengths: Sequence[int]) -> float:
        """Undisturbed per-layer step time (Eq. 5 both terms + TP)."""
        return self.t_natn(beta) + self.t_atn(lengths) \
            + self.t_tp_comm(beta)

    # --- Eq. 6: debtor / creditor corrections ------------------------- #
    def t_layer_debtor(self, beta: int, lengths: Sequence[int],
                       offloaded_tokens: int) -> float:
        """Debtor: ``offloaded_tokens`` of its KV live on creditors."""
        off_bytes = offloaded_tokens * self.kv_bytes_per_token_layer()
        return self.t_layer(beta, lengths) - off_bytes / \
            (self.hw.hbm_bw * self.chips)

    def t_layer_creditor(self, beta: int, lengths: Sequence[int],
                         hosted_tokens: int) -> float:
        """Creditor: computes MicroAttention for ``hosted_tokens`` of
        others' KV."""
        host_bytes = hosted_tokens * self.kv_bytes_per_token_layer()
        return self.t_layer(beta, lengths) + host_bytes / \
            (self.hw.hbm_bw * self.chips)

    # --- striped-span merge traffic (per (request, creditor) entry) --- #
    def merge_bytes_per_span_layer(self) -> float:
        """Per-step, per-layer bytes exchanged for ONE (request, creditor)
        span entry: the shipped query q plus the returned MicroAttention
        partial (o, m, l) — exactly what ``CommStats.query_shipped``
        counts on the real engine. Every extra stripe of a request adds
        one more of these exchanges per step."""
        c = self.cfg
        q = c.num_heads * c.head_dim * self.bytes_per_el
        o = c.num_heads * c.head_dim * 4          # f32 partial output
        ml = 2 * c.num_heads * 4                  # f32 max + log-sum-exp
        return q + o + ml

    def t_span_merge(self, span_entries: int) -> float:
        """Per-layer time spent on striped-span query/merge traffic.

        Each entry pays its bytes over the inter-instance link plus a
        per-message hop latency — the term that makes striping a request
        across many creditors a modeled cost, not a free lunch."""
        if span_entries <= 0:
            return 0.0
        b = span_entries * self.merge_bytes_per_span_layer()
        return b / self.hw.ici_link_bw + span_entries * self.alpha_hop

    # --- host-tier (DRAM) transfer time -------------------------------- #
    def t_host_transfer(self, n_tokens: int) -> float:
        """Time for ``n_tokens`` of KV to cross the device<->host link —
        a spill (D2H) or prefetch (H2D) of that many cached tokens. The
        runtime overlaps these with decode; the scheduler still charges
        them un-overlapped as the conservative spill penalty when a plan
        displaces cached blocks (mirrors ``_reclaim_pays``)."""
        kv_bytes = n_tokens * self.kv_bytes_per_token_layer() \
            * self.cfg.num_layers
        return kv_bytes / (self.hw.host_link_bw * self.chips)

    def t_preempt_roundtrip(self, n_tokens: int) -> float:
        """Modeled cost of pausing+resuming a request with ``n_tokens``
        of resident KV: one D2H spill plus one H2D prefetch over the
        host link (2x ``t_host_transfer``). The SLO-aware victim picker
        charges this against a victim's slack so preemption is never
        modeled as free."""
        return 2.0 * self.t_host_transfer(n_tokens)

    def predicted_finish_s(self, beta: int, lengths: Sequence[int],
                           remaining_tokens: int,
                           offloaded_tokens: int = 0,
                           hosted_tokens: int = 0,
                           span_entries: int = 0) -> float:
        """Seconds until a request with ``remaining_tokens`` left to
        decode finishes on an instance in the given state (Eq. 5-7).

        Each decode step emits one token per running request, so the
        per-request token rate is ``tps / beta``; the finish horizon is
        remaining_tokens / that rate. Used for SLO slack
        (slack = deadline - now - predicted_finish) in victim selection
        and dispatch ordering."""
        if remaining_tokens <= 0:
            return 0.0
        rate = self.tps(max(1, beta), lengths, offloaded_tokens,
                        hosted_tokens, span_entries) / max(1, beta)
        return remaining_tokens / max(rate, 1e-9)

    # --- Eq. 7: instance / cluster throughput ------------------------- #
    def tps(self, beta: int, lengths: Sequence[int],
            offloaded_tokens: int = 0, hosted_tokens: int = 0,
            span_entries: int = 0, max_span_tokens: int = 0) -> float:
        """Decode tokens/second of the instance.

        Beyond the paper's Eq. 6 we enforce its §5.2.1 coverage
        constraint: the debtor cannot finish a step before the remote
        MicroAttention it depends on — its effective layer time is
        max(local time after offload, remote MA time). Without this the
        model claims unbounded gain from offloading everything.

        ``span_entries`` counts this instance's (request, creditor) span
        pairs: each pays per-step query/merge traffic (t_span_merge).
        ``max_span_tokens`` (optional) is the largest single-creditor
        slice of this instance's offloaded KV: remote MicroAttention
        runs in PARALLEL across creditors, so the remote bound is the
        slowest slice, not the total — striping over more creditors
        shrinks it (at the cost of more span entries). When 0, the
        single-creditor worst case (all offloaded on one rank) is
        assumed.
        """
        if beta <= 0:
            return 0.0
        per_tok_t = self.kv_bytes_per_token_layer() / \
            (self.hw.hbm_bw * self.chips)
        off_t = offloaded_tokens * per_tok_t
        slice_tokens = max_span_tokens if max_span_tokens > 0 \
            else offloaded_tokens
        t_local = self.t_layer(beta, lengths) - off_t
        t = max(t_local, slice_tokens * per_tok_t)  # Fig. 6(a) coverage
        t += hosted_tokens * per_tok_t
        t += self.t_span_merge(span_entries)
        t = max(t, 1e-12)
        return beta / (self.cfg.num_layers * t)

    # --- memory ------------------------------------------------------- #
    def kv_tokens_capacity(self, reserve_frac: float = 0.1) -> int:
        """How many KV tokens fit on this instance beside the weights."""
        c = self.cfg
        weight_bytes = c.param_count() * self.bytes_per_el
        total = self.hw.hbm_bytes * self.chips * (1 - reserve_frac)
        avail = max(0.0, total - weight_bytes)
        per_tok = c.kv_bytes_per_token(self.bytes_per_el)
        return int(avail / per_tok) if per_tok else 1 << 60


def cluster_tps(models: List[InstancePerfModel], betas: List[int],
                lengths: List[List[int]], offloaded: List[int],
                hosted: List[int]) -> float:
    """Eq. 7: aggregated cluster throughput."""
    return sum(m.tps(b, ls, off, host) for m, b, ls, off, host
               in zip(models, betas, lengths, offloaded, hosted))
