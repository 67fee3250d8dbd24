"""``ServeConfig`` — the one serving-policy surface (copy of
``repro/serve/config.py``: every field and every check).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SCHEDULERS = ("auto", "resident", "drain", "speculative")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Policy for one ``Engine.serve`` run.

    Pool shape:
      * ``n_slots`` — KV slots decoded per step.
      * ``cache_len`` — KV capacity per slot; ``None`` sizes it to the
        longest request (prompt + budget).

    Mixed-task policy (``scheduler``): ``"drain"`` | ``"resident"`` |
    ``"auto"`` | ``"speculative"`` — semantics in ``Engine.serve``'s
    docstring.  ``spec_k`` and ``draft_bits`` configure the speculative
    scheduler only.

    Admission control (every outcome is accounted in ``ServeReport``):
      * ``queue_bound`` — max requests WAITING for a slot; arrivals past it
        are rejected, newest first.  ``None`` = unbounded.
      * ``shed_after_s`` — a request still waiting after this many
        (virtual) seconds is shed at its next admission consideration.

    Virtual clock: ``step_s`` seconds per pool decode step, ``prefill_s``
    per admit (``None`` = ``step_s``).

    Tiered ScaleBank: ``prefetch_depth`` distinct upcoming tasks warmed per
    loop iteration; ``host_cache_tasks`` bounds the bank's host tier for the
    run; ``disk_load_s`` / ``install_s`` are the virtual costs of a disk
    load and of a device install (resident row write or drain swap).

    ``bucket_prompts`` right-pads admitted prompts to power-of-two lengths
    (the padded rows are causally invisible; token streams are unchanged).
    """
    n_slots: int = 4
    cache_len: Optional[int] = None
    scheduler: str = "auto"
    resident_tasks: int = 4
    queue_bound: Optional[int] = None
    shed_after_s: Optional[float] = None
    step_s: float = 1.0
    prefill_s: Optional[float] = None
    spec_k: int = 2
    draft_bits: Optional[int] = None
    prefetch_depth: int = 2
    host_cache_tasks: Optional[int] = None
    disk_load_s: float = 0.0
    install_s: float = 0.0
    bucket_prompts: bool = True

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots={self.n_slots} must be >= 1")
        if self.cache_len is not None and self.cache_len < 1:
            raise ValueError(f"cache_len={self.cache_len} must be >= 1")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r} "
                             f"(know: {', '.join(SCHEDULERS)})")
        if self.resident_tasks < 1:
            raise ValueError(
                f"resident_tasks={self.resident_tasks} must be >= 1")
        if self.queue_bound is not None and self.queue_bound < 0:
            raise ValueError(f"queue_bound={self.queue_bound} must be >= 0")
        if self.shed_after_s is not None and self.shed_after_s < 0:
            raise ValueError(
                f"shed_after_s={self.shed_after_s} must be >= 0")
        if self.step_s <= 0:
            raise ValueError(f"step_s={self.step_s} must be > 0")
        if self.prefill_s is not None and self.prefill_s < 0:
            raise ValueError(f"prefill_s={self.prefill_s} must be >= 0")
        if self.spec_k < 1:
            raise ValueError(f"spec_k={self.spec_k} must be >= 1")
        if self.draft_bits is not None and self.draft_bits < 1:
            raise ValueError(
                f"draft_bits={self.draft_bits} must be >= 1")
        if self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth={self.prefetch_depth} must be >= 0")
        if self.host_cache_tasks is not None and self.host_cache_tasks < 1:
            raise ValueError(
                f"host_cache_tasks={self.host_cache_tasks} must be >= 1")
        if self.disk_load_s < 0:
            raise ValueError(f"disk_load_s={self.disk_load_s} must be >= 0")
        if self.install_s < 0:
            raise ValueError(f"install_s={self.install_s} must be >= 0")

    @property
    def admit_cost_s(self) -> float:
        return self.step_s if self.prefill_s is None else self.prefill_s
