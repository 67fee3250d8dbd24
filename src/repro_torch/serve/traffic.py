"""Arrival processes for the traffic harness (port of
``repro/serve/traffic.py``).

Two ways to make a request stream, both fully seeded (same arguments → the
identical arrival sequence, prompts, tasks and budgets):

  * ``poisson`` — memoryless arrivals at ``rate`` requests/second
    (exponential inter-arrival gaps), each request drawing its task,
    prompt length and budget independently from the given mixtures.
  * ``trace`` — replay a recorded trace (a JSON list of records; see
    ``serve.request.from_trace``), or the built-in ``canned_trace``.

Every draw is numpy's ``default_rng(seed)``, in the reference's order, so a
stream is also byte-equal to the reference's for the same arguments.
Arrivals are in virtual seconds (``Request.arrival_s``); the serve loop's
clock admits them (``ServeConfig.step_s``).
"""
from __future__ import annotations

import json
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.request import Request, from_trace, to_trace

KINDS = ("poisson", "trace")


def poisson_traffic(*, rate: float, n_requests: int, vocab: int,
                    seed: int = 0,
                    tasks: Sequence[Optional[str]] = (None,),
                    prompt_lens: Sequence[int] = (8,),
                    n_new: Sequence[int] = (16,),
                    eos_id: Optional[int] = None) -> list:
    """Seeded Poisson request stream.

    ``rate`` is in requests per (virtual) second.  Tasks, prompt lengths
    and budgets are drawn uniformly and independently from their choice
    sets — one ``default_rng(seed)`` drives everything, so the WHOLE
    stream (timestamps and contents) is a pure function of the arguments.
    """
    if rate <= 0:
        raise ValueError(f"rate={rate} must be > 0 req/s")
    if n_requests < 1:
        raise ValueError(f"n_requests={n_requests} must be >= 1")
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        plen = int(prompt_lens[rng.integers(len(prompt_lens))])
        budget = int(n_new[rng.integers(len(n_new))])
        task = tasks[rng.integers(len(tasks))]
        toks = rng.integers(0, vocab, size=plen, dtype=np.int32)
        reqs.append(Request(tokens=toks, n_new=budget, task=task,
                            eos_id=eos_id, arrival_s=t))
    return reqs


def load_trace(path: str, *, vocab: Optional[int] = None,
               seed: int = 0) -> list:
    """Replay a JSON trace file into requests (see ``from_trace``)."""
    with open(path) as f:
        records = json.load(f)
    if not isinstance(records, list):
        raise ValueError(f"trace {path} must be a JSON list of records, "
                         f"got {type(records).__name__}")
    return from_trace(records, vocab=vocab, seed=seed)


def save_trace(path: str, requests) -> None:
    """Record a request stream as a replayable JSON trace."""
    with open(path, "w") as f:
        json.dump(to_trace(requests), f, indent=2, sort_keys=True)


def canned_trace(*, vocab: int, tasks: Sequence[Optional[str]] = (None,),
                 n_requests: int = 12, seed: int = 0) -> list:
    """A small built-in trace: two bursts + a steady tail.

    Deterministic traffic SHAPE without a trace file on disk: a burst of
    max(1, n // 3) at t=0, another at t=4, then one request per second
    from t=8.  Prompts (4–8 tokens) are seeded; budgets cycle 4, 8, 12 and
    tasks round-robin.
    """
    rng = np.random.default_rng(seed)
    burst = max(1, n_requests // 3)
    times = ([0.0] * burst + [4.0] * burst
             + [8.0 + i for i in range(n_requests - 2 * burst)])
    reqs = []
    for i, t in enumerate(times[:n_requests]):
        plen = int(rng.integers(4, 9))
        budget = int((4, 8, 12)[i % 3])
        reqs.append(Request(
            tokens=rng.integers(0, vocab, size=plen, dtype=np.int32),
            n_new=budget, task=tasks[i % len(tasks)], arrival_s=float(t)))
    return reqs


def make(kind: str, *, vocab: int, seed: int = 0,
         tasks: Sequence[Optional[str]] = (None,),
         rate: float = 2.0, n_requests: int = 12,
         trace_path: Optional[str] = None,
         prompt_lens: Sequence[int] = (4, 6, 8),
         n_new: Sequence[int] = (4, 8, 12)) -> Tuple[list, dict]:
    """Build a request stream by kind name; returns (requests, meta).

    ``meta`` records the generating parameters, for a telemetry document
    to say which workload two runs served.
    """
    if kind == "poisson":
        reqs = poisson_traffic(rate=rate, n_requests=n_requests, vocab=vocab,
                               seed=seed, tasks=tasks,
                               prompt_lens=prompt_lens, n_new=n_new)
        meta = {"traffic": "poisson", "rate": rate, "seed": seed,
                "n_requests": n_requests}
    elif kind == "trace":
        if trace_path is not None:
            reqs = load_trace(trace_path, vocab=vocab, seed=seed)
            meta = {"traffic": "trace", "path": trace_path, "seed": seed,
                    "n_requests": len(reqs)}
        else:
            reqs = canned_trace(vocab=vocab, tasks=tasks,
                                n_requests=n_requests, seed=seed)
            meta = {"traffic": "trace", "path": "<canned>", "seed": seed,
                    "n_requests": len(reqs)}
    else:
        raise ValueError(f"unknown traffic kind {kind!r} "
                         f"(know: {', '.join(KINDS)})")
    return reqs, meta
