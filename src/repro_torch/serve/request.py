"""The serving request type (port of ``repro/serve/request.py::Request``;
trace (de)serialization comes with the traffic harness).

A request arrives on one of two clocks: ``arrival_s`` (virtual seconds) or
``arrival_step`` (the pool's decode-step counter, for deterministic tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
