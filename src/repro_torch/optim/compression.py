"""QSGD-style int8 gradient compression (port of
``repro/optim/compression.py``: ``compress``, ``decompress`` and
``compress_tree``, the loop-level hook of ``grad_compression="int8"``;
``compressed_psum``, the collective, comes with several GPUs).

    scale = max|g| / 127     q = round(g / scale) ∈ int8     g̃ = q · scale

Rounding is to nearest, ties to even, as ``jnp.round``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def compress(g: torch.Tensor):
    gf = g.to(torch.float32)
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-20
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_tree(grads: Dict[str, torch.Tensor],
                  mask: Optional[Dict[str, bool]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Each floating gradient (of a trainable name, when ``mask`` is given)
    through the int8 codec; the others as they are."""
    def leaf(name, g):
        if g is None or not g.is_floating_point() or \
                (mask is not None and not mask.get(name)):
            return g
        return decompress(*compress(g), g.dtype)
    return {name: leaf(name, g) for name, g in grads.items()}
