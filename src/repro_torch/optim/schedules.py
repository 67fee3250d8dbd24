"""LR schedules (port of ``repro/optim/schedules.py``).  The paper uses
linear decay with warmup (App. A).  Each schedule maps a step (an int or an
integer tensor) to a float32 0-d tensor, in float32 arithmetic as the
reference's."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimConfig

SCHEDULES = ("linear", "cosine", "constant")


def make_schedule(ocfg: OptimConfig, total_steps: int):
    if ocfg.schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {ocfg.schedule!r}; known: "
                         f"{', '.join(SCHEDULES)}")
    warm = max(ocfg.warmup_steps, 1)
    span = max(total_steps - warm, 1)

    def _ramp(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm_f = torch.clamp(s / warm, max=1.0)
        frac = torch.clamp((s - warm) / span, 0.0, 1.0)
        return warm_f, frac

    def linear(step):
        warm_f, frac = _ramp(step)
        return ocfg.lr * warm_f * (1.0 - frac)

    def cosine(step):
        warm_f, frac = _ramp(step)
        return ocfg.lr * warm_f * 0.5 * (1 + torch.cos(math.pi * frac))

    def constant(step):
        return ocfg.lr * _ramp(step)[0]

    return {"linear": linear, "cosine": cosine,
            "constant": constant}[ocfg.schedule]
