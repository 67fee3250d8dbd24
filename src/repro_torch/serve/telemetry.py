"""Run telemetry: a metric sink with a stable schema (port of
``repro/serve/telemetry.py``).

Callers push ``(name, value, unit, extras)`` rows into one ``MetricSink``
as they go; the sink serializes everything at the end.  The serve driver
(``serve.driver``) feeds it per-run SLO summaries.

Schema (version 1, field for field the reference's, so a document from
either package reads the same):

    {"schema": 1,
     "run": {...generating parameters, free-form...},
     "metrics": [{"name": str, "value": number, "unit": str,
                  "wall": bool?,            # wall-clock: machine-dependent,
                                            # excluded from reproducibility
                                            # diffs and trajectory gates
                  "guard": {"direction": "higher"|"lower",
                            "band": float}?,  # trajectory-gated metric:
                                            # fail on a regression beyond
                                            # band (relative)
                  ...extra number/string fields}]}

Wall-clock rows are marked at the CALL SITE (``wall=True``): the sink
cannot know which numbers are machine-dependent.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

SCHEMA_VERSION = 1
GUARD_DIRECTIONS = ("higher", "lower")


def _jsonable(v):
    """Coerce numpy and torch scalars (a 0-d tensor, on any device) to
    Python numbers, so ``json.dump`` never chokes mid-run."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise TypeError(f"a metric value must be a scalar, got a tensor "
                            f"of shape {tuple(v.shape)}")
        return v.item()
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


class MetricSink:
    """Append-only metric stream; optionally echoes rows as they land."""

    def __init__(self, printer: Optional[Callable[[str], None]] = None):
        self._metrics: List[Dict] = []
        self._printer = printer

    def log(self, name: str, value, unit: str = "", *,
            wall: bool = False, guard: Optional[tuple] = None, **extra):
        """Record one metric row.

        ``guard=(direction, band)`` marks the row trajectory-gated:
        ``("higher", 0.15)`` fails a gate when the value drops more than
        15% below the committed baseline (``"lower"``: rises above).
        """
        entry = {"name": str(name), "value": _jsonable(value),
                 "unit": str(unit)}
        if wall:
            entry["wall"] = True
        if guard is not None:
            direction, band = guard
            if direction not in GUARD_DIRECTIONS:
                raise ValueError(f"guard direction {direction!r} "
                                 f"(know: {GUARD_DIRECTIONS})")
            if not 0 <= float(band) < 1:
                raise ValueError(f"guard band {band} must be in [0, 1)")
            if wall:
                # a guarded wall metric must be SELF-NORMALIZED (a ratio
                # of two same-run timings) to survive machine changes —
                # trust the call site, but keep the mark visible
                entry["wall"] = True
            entry["guard"] = {"direction": direction, "band": float(band)}
        for k, v in extra.items():
            entry[k] = _jsonable(v)
        self._metrics.append(entry)
        if self._printer is not None:
            self._printer(f"{name}={entry['value']}{unit and ' ' + unit}")
        return entry

    @property
    def metrics(self) -> List[Dict]:
        return list(self._metrics)

    def payload(self, metrics: Optional[List[Dict]] = None,
                **run_meta) -> Dict:
        """The schema-1 document for (a subset of) the recorded metrics.

        ``run_meta`` must be deterministic for a seeded run — no
        timestamps — so two same-seed runs produce identical files modulo
        wall-marked rows.
        """
        return {"schema": SCHEMA_VERSION,
                "run": {k: _jsonable(v) for k, v in sorted(run_meta.items())},
                "metrics": metrics if metrics is not None else self.metrics}

    def write(self, path: str, metrics: Optional[List[Dict]] = None,
              **run_meta) -> None:
        with open(path, "w") as f:
            json.dump(self.payload(metrics, **run_meta), f, indent=2,
                      sort_keys=True)


def load(path: str) -> Dict:
    """Read a metrics document (schema 1, or the pre-schema
    ``{"metrics": [...]}`` layout)."""
    with open(path) as f:
        doc = json.load(f)
    if "metrics" not in doc:
        raise ValueError(f"{path}: no 'metrics' key")
    doc.setdefault("schema", 0)
    doc.setdefault("run", {})
    return doc


def stable_metrics(doc: Dict) -> List[Dict]:
    """The machine-independent rows: everything not marked ``wall`` —
    the reproducibility contract ("identical across two seeded runs,
    modulo wall-clock fields") compares exactly this view."""
    return [m for m in doc["metrics"] if not m.get("wall")]
