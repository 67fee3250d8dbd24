"""The traffic driver: traffic → ``Engine.serve`` → telemetry (port of
``repro/serve/driver.py``).

It serves a request stream through ``Engine.serve`` under a
``ServeConfig``, summarizes the per-request SLO records into percentile
aggregates, and feeds a ``MetricSink``.

The SLO aggregates are on the VIRTUAL clock (deterministic — guarded);
wall-clock throughput rides along marked ``wall`` (unguarded).  The wall is
``time.perf_counter()`` around ``engine.serve``, which reads every step's
tokens back to the host, so on the card the window ends after the last
kernel.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.serve.config import ServeConfig
from repro_torch.serve.metrics import ServeReport
from repro_torch.serve.telemetry import MetricSink

# (metric field, short glossary name) — emission order
_SLO_NAMES = (("ttft_s", "ttft"), ("tpot_s", "tpot"),
              ("queue_wait_s", "queue_wait"), ("e2e_s", "e2e"))
# virtual-clock percentiles are deterministic for a seeded workload; the
# band absorbs scheduling drift from token changes only
SLO_GUARD_BAND = 0.15


def run(engine, requests: Sequence, config: ServeConfig, *,
        sink: Optional[MetricSink] = None,
        label: str = "serving") -> Tuple[ServeReport, Dict]:
    """Serve ``requests`` under ``config``; returns (report, summary).

    ``sink`` (optional): SLO aggregates are logged as
    ``{label}/{scheduler}_{metric}_{percentile}`` with trajectory guards,
    wall throughput as ``{label}/{scheduler}_tok_s`` (wall-marked).
    """
    t0 = time.perf_counter()
    report = engine.serve(requests, config)
    wall = time.perf_counter() - t0
    summary = summarize(report, wall_s=wall)
    if sink is not None:
        log_summary(sink, summary, label=label)
    return report, summary


def summarize(report: ServeReport, wall_s: Optional[float] = None) -> Dict:
    """Flatten one run into the telemetry-ready summary dict."""
    wall = report.wall_s if wall_s is None else wall_s
    served_tokens = sum(m.n_generated for m in report.requests
                        if m.status == "served")
    return {
        "scheduler": report.scheduler,
        "n_requests": len(report.requests),
        "n_served": report.n_served,
        "n_rejected": report.n_rejected,
        "n_shed": report.n_shed,
        "steps": report.steps,
        "decoded": report.decoded,
        "bubble_slot_steps": report.bubble_slot_steps,
        "idle_slot_steps": report.idle_slot_steps,
        "task_drain_idle_slot_steps": report.task_drain_idle_slot_steps,
        "switches": report.switches,
        "peak_queue_depth": report.peak_queue_depth,
        "draft_steps": report.draft_steps,
        "draft_proposed": report.draft_proposed,
        "draft_accepted": report.draft_accepted,
        "acceptance_rate": report.acceptance_rate,
        "tok_per_target_step": (report.decoded / report.steps
                                if report.steps else 0.0),
        "tier_device_hits": report.tier_device_hits,
        "tier_host_hits": report.tier_host_hits,
        "tier_disk_loads": report.tier_disk_loads,
        "prefetch_issued": report.prefetch_issued,
        "prefetch_hidden_s": report.prefetch_hidden_s,
        "swap_wait_total_s": report.swap_wait_total_s,
        "swap_device_p99_s": report.swap_percentiles("device")["p99"],
        "slo": report.slo(),
        "wall_s": wall,
        "tok_s_wall": served_tokens / wall if wall > 0 else 0.0,
    }


def log_summary(sink: MetricSink, summary: Dict, *,
                label: str = "serving") -> None:
    """Feed one run summary into the sink, guards attached.

    Counts and SLO percentiles are deterministic → guarded; wall
    throughput is machine-dependent → wall-marked, unguarded.
    """
    sched = summary["scheduler"]
    base = f"{label}/{sched}"
    for key in ("n_served", "n_rejected", "n_shed"):
        sink.log(f"{base}_{key}", summary[key], "req",
                 guard=("higher" if key == "n_served" else "lower", 0.0))
    sink.log(f"{base}_steps", summary["steps"], "steps")
    sink.log(f"{base}_peak_queue_depth", summary["peak_queue_depth"], "req")
    for field, short in _SLO_NAMES:
        for pname, val in summary["slo"][field].items():
            if val != val:               # NaN: nothing served
                continue
            sink.log(f"{base}_{short}_{pname}", round(val, 9), "s",
                     guard=("lower", SLO_GUARD_BAND))
    if summary["draft_steps"]:
        # speculative decode: acceptance is a model/traffic property
        # (deterministic for a seeded workload) — guarded; tokens emitted
        # per TARGET step is the speedup the draft buys
        sink.log(f"{base}_acceptance_rate",
                 round(summary["acceptance_rate"], 6), "frac",
                 guard=("higher", SLO_GUARD_BAND))
        sink.log(f"{base}_tok_per_target_step",
                 round(summary["tok_per_target_step"], 6), "tok/step",
                 guard=("higher", SLO_GUARD_BAND))
        sink.log(f"{base}_draft_steps", summary["draft_steps"], "steps")
    tier_total = (summary["tier_device_hits"] + summary["tier_host_hits"]
                  + summary["tier_disk_loads"])
    if tier_total:
        # tiered-bank admits ran: per-tier counts are informational; the
        # charged swap total is virtual-clock deterministic → guarded like
        # the SLO percentiles
        for key in ("tier_device_hits", "tier_host_hits",
                    "tier_disk_loads", "prefetch_issued"):
            sink.log(f"{base}_{key}", summary[key], "req")
        sink.log(f"{base}_swap_wait_total_s",
                 round(summary["swap_wait_total_s"], 9), "s",
                 guard=("lower", SLO_GUARD_BAND))
    sink.log(f"{base}_tok_s", round(summary["tok_s_wall"], 3), "tok/s",
             wall=True)
