"""Greedy samplers (port of ``repro/dist/sampling.py``: the off-mesh
``shard_argmax`` and ``shard_argmax_masked``).

The reference builds shard-local samplers over vocab-sharded logits; with
no mesh (``ctx is None``) they are plain argmax reductions, which is all
the port serves yet.  Passing a mesh context raises.
"""
from __future__ import annotations

import torch


def _off_mesh(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError(
            "sharded sampling over a device mesh is not ported yet "
            "(pass ctx=None)")


def shard_argmax(ctx, batch: int):
    """Greedy sampler → ``fn(logits (B, V)) -> (B,) int64`` token ids; ties
    resolve to the lowest index, as the reference's."""
    _off_mesh(ctx)
    return lambda lg: torch.argmax(lg, dim=-1)


def shard_argmax_masked(ctx, batch: int, fill: int = 0):
    """Active-mask-aware greedy sampler for the slot pool →
    ``fn(logits (B, V), active (B,) bool) -> (B,) int64``.  Free slots
    still flow through the decode step (the batch is the fixed pool), but
    their logits are garbage: the mask pins their sample to ``fill``."""
    base = shard_argmax(ctx, batch)

    def sample(lg, active):
        return base(lg).masked_fill(~active, fill)
    return sample
