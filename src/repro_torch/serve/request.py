"""The serving request type and its trace records (port of
``repro/serve/request.py``: ``Request``, ``TraceRecord``, ``to_trace``,
``from_trace``).

A request arrives on one of two clocks: ``arrival_s`` (virtual seconds, the
traffic harness's unit) or ``arrival_step`` (the pool's decode-step counter,
for deterministic tests).  Not ported: the deprecated ``Request(arrival=)``
alias of ``arrival_step``.

A trace is a list of plain-dict records (JSON-ready), the same in both
packages: a trace written by one replays in the other, request for request.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request for the continuous scheduler."""
    tokens: np.ndarray                  # (S,) int prompt
    n_new: int                          # generation budget (includes token 0)
    task: Optional[str] = None          # ScaleBank task the request targets
    eos_id: Optional[int] = None        # early-stop token
    # per-request prefix state admitted once into the slot (family-keyed by
    # the registry capability record): (P, d_model) float32 image patch
    # embeddings for a vlm
    prefix: Optional[np.ndarray] = None
    arrival_s: Optional[float] = None   # virtual seconds
    arrival_step: int = 0               # decode-step index

    def __post_init__(self):
        if self.arrival_s is not None and self.arrival_step:
            raise ValueError(
                f"request sets both arrival_s={self.arrival_s} and "
                f"arrival_step={self.arrival_step}; pick one clock")
        if self.arrival_s is not None and self.arrival_s < 0:
            raise ValueError(f"arrival_s={self.arrival_s} must be >= 0")
        if self.arrival_step < 0:
            raise ValueError(f"arrival_step={self.arrival_step} must be >= 0")

    def arrival_time(self, step_s: float) -> float:
        """The arrival instant in virtual seconds (step clock scaled)."""
        if self.arrival_s is not None:
            return float(self.arrival_s)
        return self.arrival_step * step_s

    @property
    def n_prompt(self) -> int:
        return int(np.asarray(self.tokens).size)


TraceRecord = dict


def to_trace(requests) -> List[TraceRecord]:
    """Serialize requests to plain-dict trace records (JSON-ready)."""
    recs = []
    for r in requests:
        rec = {
            "arrival_s": r.arrival_time(1.0) if r.arrival_s is None
            else float(r.arrival_s),
            "tokens": [int(t) for t in np.asarray(r.tokens).reshape(-1)],
            "n_new": int(r.n_new),
            "task": r.task,
            "eos_id": r.eos_id,
        }
        if r.prefix is not None:
            rec["prefix"] = np.asarray(r.prefix, np.float32).tolist()
        recs.append(rec)
    return recs


def from_trace(records, *, vocab: Optional[int] = None,
               seed: int = 0) -> List[Request]:
    """Rebuild requests from trace records.

    A record carries either explicit ``tokens`` or a ``prompt_len`` — the
    latter gets a seeded synthetic prompt (needs ``vocab``) from numpy's
    ``default_rng(seed)``, drawn in record order as the reference draws
    it, so a trace can describe traffic SHAPE without shipping the token
    streams and still give both packages the same prompts.
    """
    rng = np.random.default_rng(seed)
    reqs = []
    for i, rec in enumerate(records):
        if "tokens" in rec:
            toks = np.asarray(rec["tokens"], np.int32)
        elif "prompt_len" in rec:
            if vocab is None:
                raise ValueError(
                    f"trace record {i} gives prompt_len but no vocab was "
                    f"passed to synthesize tokens from")
            toks = rng.integers(0, vocab, size=int(rec["prompt_len"]),
                                dtype=np.int32)
        else:
            raise ValueError(f"trace record {i} has neither tokens nor "
                             f"prompt_len: {sorted(rec)}")
        prefix = rec.get("prefix")
        reqs.append(Request(
            tokens=toks, n_new=int(rec["n_new"]),
            task=rec.get("task"), eos_id=rec.get("eos_id"),
            prefix=None if prefix is None
            else np.asarray(prefix, np.float32),
            arrival_s=float(rec.get("arrival_s", 0.0))))
    return reqs
