"""Batched greedy decode engine (port of ``repro/train/serve.py::Engine``:
``__init__`` and the lockstep ``generate``).

One prefill over the prompt, then one decode step per new token against the
KV cache; every quantized linear runs through the port's kernels (the tiled
GEMM for the prefill's B·S rows, the GEMV for each step's B rows).  The
continuous-batching slot pool, task switching and the other schedulers come
in later slices.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.models.registry import ModelAPI

__all__ = ["Engine", "greedy"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits → (B,) token ids, lowest index on ties (the
    reference's off-mesh ``dist/sampling.py::shard_argmax``)."""
    return torch.argmax(logits, dim=-1)


class Engine:
    def __init__(self, api: ModelAPI, model: nn.Module, *, device=None):
        """Serve ``model`` on ``device`` (the card unless ``device="cpu"``);
        the model is moved there if it is elsewhere."""
        self.device = _device.resolve(device)
        if self.device != api.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"model API's {api.device}")
        self.api = api
        self.model = model.to(self.device)

    @torch.inference_mode()
    def generate(self, tokens, n_new: int,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        """Greedy decode (LOCKSTEP). tokens (B, S) → (B, S + n_new) int64.

        ``cache_len`` is validated, not clamped: the deepest cache write is
        position prompt+n_new-2 (the final sampled token's KV is never
        written), so prompt+n_new-1 slots suffice and fewer raise.
        """
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        b, s = tokens.shape
        total = s + n_new
        if cache_len is None:
            cache_len = total
        elif cache_len <= 0:
            raise ValueError(
                f"cache_len={cache_len} must be positive (omit it for the "
                f"default prompt+n_new={total})")
        elif cache_len < total - 1:
            raise ValueError(
                f"cache_len={cache_len} < prompt+n_new-1={total - 1}: a "
                f"dense cache cannot hold the generation")
        logits, pcache = self.api.prefill(self.model, {"tokens": tokens})
        # re-home the prompt-sized prefill cache into one with headroom
        cache = self.api.init_cache(b, cache_len)
        for key in cache:
            cache[key][:, :, :s] = pcache[key]
        del pcache
        out = [tokens]
        tok = greedy(logits)[:, None]
        for i in range(n_new):
            out.append(tok)
            if i == n_new - 1:
                break
            logits, cache = self.api.decode_step(self.model, cache, tok, s + i)
            tok = greedy(logits)[:, None]
        return torch.cat(out, dim=1)
