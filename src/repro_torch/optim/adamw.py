"""Masked AdamW (port of ``repro/optim/adamw.py``), a plain class over
named tensors — not ``torch.optim.AdamW``: the arithmetic is the
reference's, step for step.

The mask is the whole point (paper §3.1): frozen tensors get NO moment
buffers, so PEQA's optimizer state is O(#scales).  The state has the
reference's structure: ``{"mv": {name: (mom, vel)} for the trainable
names only, "count": int32}``, moments float32 (``bridge.opt_to_tree``
writes it in the reference's tree layout, so a checkpoint crosses
packages).  ``update`` works in place: the parameters and the moments are
overwritten, as the reference's donated buffers are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Collection, Dict, Mapping

import torch

from repro_torch.configs.base import OptimConfig


@dataclasses.dataclass(frozen=True)
class MaskedAdamW:
    cfg: OptimConfig
    schedule: Callable  # step -> lr (float32 0-d tensor)

    def init(self, params: Dict[str, torch.Tensor],
             mask: Dict[str, bool]) -> dict:
        mv = {name: (torch.zeros_like(p, dtype=torch.float32),
                     torch.zeros_like(p, dtype=torch.float32))
              for name, p in params.items() if mask.get(name)}
        return {"mv": mv, "count": torch.zeros((), dtype=torch.int32)}

    @staticmethod
    def state_bytes(state: dict) -> int:
        """Bytes of the moments (the count is not counted, as in the
        reference)."""
        return sum(t.numel() * t.element_size()
                   for pair in state["mv"].values() for t in pair)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor],
               mask: Dict[str, bool], *, ctx=None,
               sharded: Collection[str] = ()) -> torch.Tensor:
        """One step in place; returns the global gradient norm over the
        trainable gradients (before clipping).  A name with no gradient is
        left alone, as the reference's float0 leaves are.

        On a mesh (``ctx``, the rank's shard: ``grads`` already summed over
        the data axis) the norm is the whole model's: the squares of the
        ``sharded`` names — each rank's block of a model-sharded leaf — are
        summed over the model axis, every other name counted once; a
        mapping gives each name the number of model ranks that hold its
        block (a KV head that ranks share), whose square counts once."""
        c = self.cfg
        state["count"] = state["count"] + 1
        count = state["count"]
        lr = self.schedule(count)
        live = [name for name in params if mask.get(name)
                and grads.get(name) is not None]

        # global-norm clip over trainable grads only
        square = lambda n: torch.sum(torch.square(grads[n].to(torch.float32)))
        sq = [square(n) for n in live if n not in sharded]
        if ctx is not None:
            held = sharded.get if isinstance(sharded, Mapping) \
                else (lambda n: 1)
            blocks = [square(n) / held(n) for n in live if n in sharded]
            dev = grads[live[0]].device if live else None
            sq.append(ctx.all_reduce(
                torch.stack(blocks).sum() if blocks
                else torch.zeros((), device=dev), "model"))
        gnorm = torch.sqrt(sum(sq)) if sq else torch.zeros(())
        clip = torch.clamp(c.grad_clip / (gnorm + 1e-9), max=1.0) \
            if c.grad_clip else 1.0

        b1, b2 = c.betas
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), cf)
        for name in live:
            p = params[name]
            mom, vel = state["mv"][name]
            gf = grads[name].to(torch.float32) * clip
            mom.copy_(b1 * mom + (1 - b1) * gf)
            vel.copy_(b2 * vel + (1 - b2) * gf * gf)
            upd = (mom / bc1) / (torch.sqrt(vel / bc2) + c.eps)
            pf = p.to(torch.float32)
            pf = pf - lr * (upd + c.weight_decay * pf)
            p.copy_(pf.to(p.dtype))
        return gnorm


def make_optimizer(ocfg: OptimConfig, total_steps: int) -> MaskedAdamW:
    from repro_torch.optim.schedules import make_schedule
    return MaskedAdamW(cfg=ocfg, schedule=make_schedule(ocfg, total_steps))
