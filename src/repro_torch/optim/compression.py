"""QSGD-style int8 gradient compression (port of
``repro/optim/compression.py``: ``compress``, ``decompress``,
``compress_tree`` — the loop-level hook of ``grad_compression="int8"`` —
and ``compressed_psum``, the collective).

    scale = max|g| / 127     q = round(g / scale) ∈ int8     g̃ = q · scale

Rounding is to nearest, ties to even, as ``jnp.round``.

On a ``(data, model)`` mesh the train step compresses the global gradient,
as the reference's step does: after the data-axis sum, each leaf's codes
from its whole ``max|g|`` — all-reduced (max) over the model axis for a
model-sharded leaf (``compress_tree(..., ctx=, sharded=)``).
``compressed_psum`` is the reference's building block of a compressed
reduction (a max all-reduce, int32 codes, an exact int32 sum, a rescale);
as in the reference, the step does not call it.
"""
from __future__ import annotations

from typing import Collection, Dict, Optional

import torch


def compress(g: torch.Tensor, gmax: Optional[torch.Tensor] = None):
    """(int8 codes, scale) of ``g``; ``gmax``: the max |g| of the whole leaf
    where ``g`` is a block of it (by default ``g``'s own)."""
    gf = g.to(torch.float32)
    if gmax is None:
        gmax = torch.max(torch.abs(gf))
    scale = gmax / 127.0 + 1e-20
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_tree(grads: Dict[str, torch.Tensor],
                  mask: Optional[Dict[str, bool]] = None, *, ctx=None,
                  sharded: Collection[str] = ()
                  ) -> Dict[str, torch.Tensor]:
    """Each floating gradient (of a trainable name, when ``mask`` is given)
    through the int8 codec; the others as they are.  On a mesh (``ctx``)
    the ``sharded`` names are blocks of model-sharded leaves: their max
    |g| is all-reduced over the model axis in one call."""
    def wanted(name, g):
        return g is not None and g.is_floating_point() and \
            (mask is None or bool(mask.get(name)))
    names = [n for n, g in grads.items() if wanted(n, g)]
    gmax = {}
    if ctx is not None:
        blocks = [n for n in names if n in sharded]
        if blocks:
            maxes = torch.stack([torch.max(torch.abs(
                grads[n].to(torch.float32))) for n in blocks])
            maxes = ctx.all_reduce(maxes, "model", "max")
            gmax = dict(zip(blocks, maxes))
    out = dict(grads)
    for n in names:
        out[n] = decompress(*compress(grads[n], gmax.get(n)), grads[n].dtype)
    return out


def compressed_psum(g: torch.Tensor, ctx, axis: str) -> torch.Tensor:
    """``g`` summed over ``axis`` through int8 codes (the reference's
    ``compressed_psum``): the ranks agree on a scale from a max
    all-reduce, quantize locally, sum the codes exactly in int32 and
    rescale."""
    gmax = ctx.all_reduce(torch.max(torch.abs(g.to(torch.float32))), axis,
                          "max")
    scale = gmax / 127.0 + 1e-20
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127
                    ).to(torch.int32)
    total = ctx.all_reduce(q, axis)
    return (total.to(torch.float32) * scale).to(g.dtype)
