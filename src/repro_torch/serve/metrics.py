"""Per-request SLO accounting and the per-request ``ServeReport`` (copy of
``repro/serve/metrics.py``).

Timestamps are on the serve loop's virtual clock (``ServeConfig.step_s`` per
decode step, ``admit_cost_s`` per prefill), so TTFT / TPOT / queue-wait /
e2e are deterministic for a seeded workload; wall-clock time is
``ServeReport.wall_s``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.config import ServeConfig

# terminal request outcomes (every request lands in exactly one)
SERVED, REJECTED, SHED = "served", "rejected", "shed"


@dataclasses.dataclass
class RequestMetrics:
    """SLO record for one request (virtual-clock seconds).

    ``arrival_s`` (enters the wait queue) → ``admit_s`` (prefill starts) →
    ``first_token_s`` (= admit + prefill cost) → ``finish_s`` (slot
    evicted).  Rejected and shed requests keep only their arrival.
    """
    rid: int
    task: Optional[str] = None
    status: str = "pending"            # served | rejected | shed
    arrival_s: float = 0.0
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    n_prompt: int = 0
    n_budget: int = 0                  # requested n_new
    tokens: Optional[List[int]] = None  # generated tokens (served only)
    # speculative decoding only (0 otherwise)
    draft_proposed: int = 0
    draft_accepted: int = 0
    # tiered ScaleBank: the tier that held the task's scales when the
    # request reached the head of the queue ("device", "host" or "disk"),
    # and the virtual swap seconds the prefetcher failed to hide
    scale_tier: Optional[str] = None
    swap_wait_s: float = 0.0

    @property
    def n_generated(self) -> int:
        return 0 if self.tokens is None else len(self.tokens)

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Seconds spent waiting for a slot (arrival → prefill start)."""
        if self.admit_s is None:
            return None
        return self.admit_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token: arrival → first sampled token."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token after the first (decode cadence)."""
        if self.finish_s is None or self.first_token_s is None:
            return None
        if self.n_generated <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.n_generated - 1)

    @property
    def e2e_s(self) -> Optional[float]:
        """End-to-end latency: arrival → last token."""
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of proposed draft tokens the target verify accepted."""
        if self.draft_proposed == 0:
            return None
        return self.draft_accepted / self.draft_proposed


# the SLO dimensions ``slo_summary`` aggregates
SLO_FIELDS = ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s")
DEFAULT_QUANTILES = (50, 90, 99)


def percentiles(values: Sequence[float],
                qs: Sequence[int] = DEFAULT_QUANTILES) -> Dict[str, float]:
    """``{"p50": ..., "p90": ..., "p99": ...}`` (linear interpolation)."""
    if len(values) == 0:
        return {f"p{q}": float("nan") for q in qs}
    arr = np.asarray(list(values), np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


def slo_summary(metrics: Sequence[RequestMetrics],
                qs: Sequence[int] = DEFAULT_QUANTILES) -> Dict[str, Dict]:
    """Percentile summary of every SLO field over the SERVED requests."""
    served = [m for m in metrics if m.status == SERVED]
    out = {}
    for field in SLO_FIELDS:
        vals = [getattr(m, field) for m in served]
        out[field] = percentiles([v for v in vals if v is not None], qs)
    return out


@dataclasses.dataclass
class ServeReport:
    """What ``Engine.serve`` returns: one ``RequestMetrics`` per input
    request (index == request id) plus the loop's counters."""
    requests: List[RequestMetrics]
    steps: int = 0                     # pool steps, idle clock jumps included
    decoded: int = 0                   # useful tokens decoded
    bubble_slot_steps: int = 0         # 0 by construction (evict-on-finish)
    idle_slot_steps: int = 0           # arrival gaps / task-drain slack
    switches: int = 0                  # task switches the scheduler made
    wall_s: float = 0.0
    # idle slot-steps due to task incompatibility alone (0 under resident)
    task_drain_idle_slot_steps: int = 0
    draft_steps: int = 0               # speculative only
    resident_installs: int = 0         # stack rows (re)installed this serve
    tier_device_hits: int = 0
    tier_host_hits: int = 0
    tier_disk_loads: int = 0
    prefetch_issued: int = 0           # loads+installs the prefetcher ran
    prefetch_hidden_s: float = 0.0     # virtual swap cost hidden by overlap
    bank_disk_loads: int = 0           # real npz loads this serve
    bank_host_evictions: int = 0       # real host-tier evictions this serve
    # distinct prefill shapes admitted (bucketed length × padded-or-not)
    prefill_compiles: int = 0
    scheduler: str = "drain"           # which admission policy actually ran
    peak_queue_depth: int = 0
    config: Optional[ServeConfig] = None

    @property
    def tokens(self) -> List[Optional[List[int]]]:
        """Generated tokens per request (``None`` for rejected/shed)."""
        return [m.tokens if m.status == SERVED else None
                for m in self.requests]

    @property
    def n_served(self) -> int:
        return sum(m.status == SERVED for m in self.requests)

    @property
    def n_rejected(self) -> int:
        return sum(m.status == REJECTED for m in self.requests)

    @property
    def n_shed(self) -> int:
        return sum(m.status == SHED for m in self.requests)

    @property
    def draft_proposed(self) -> int:
        return sum(m.draft_proposed for m in self.requests)

    @property
    def draft_accepted(self) -> int:
        return sum(m.draft_accepted for m in self.requests)

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Aggregate accepted/proposed draft tokens (None off speculative)."""
        prop = self.draft_proposed
        return None if prop == 0 else self.draft_accepted / prop

    @property
    def swap_wait_total_s(self) -> float:
        """Total virtual swap seconds charged (the unhidden remainder)."""
        return sum(m.swap_wait_s for m in self.requests)

    def swap_percentiles(self, tier: Optional[str] = None,
                         qs: Sequence[int] = DEFAULT_QUANTILES
                         ) -> Dict[str, float]:
        """Percentiles of ``swap_wait_s`` over served tasked requests,
        optionally restricted to one ``scale_tier``."""
        vals = [m.swap_wait_s for m in self.requests
                if m.status == SERVED and m.scale_tier is not None
                and (tier is None or m.scale_tier == tier)]
        return percentiles(vals, qs)

    def slo(self, qs: Sequence[int] = DEFAULT_QUANTILES) -> Dict[str, Dict]:
        return slo_summary(self.requests, qs)
