"""Train state (port of ``repro/train/state.py::make_state``; sharding the
state comes with several GPUs).

The state is a plain dict: ``{"params": the model (an nn.Module, updated
in place), "opt": the masked-AdamW state, "step": int}`` —
``bridge.state_to_tree`` gives the reference's tree of it.
"""
from __future__ import annotations

from torch import nn


def make_state(model: nn.Module, opt_state: dict, step: int = 0) -> dict:
    return {"params": model, "opt": opt_state, "step": int(step)}
