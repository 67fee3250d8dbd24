"""GQA attention with RoPE and a KV cache (port of ``repro/models/attention.py``:
``init``, ``init_cache``, ``_qkv``, ``_rope_decode``, ``apply_prefill`` and
``apply_decode``, for full causal attention with a scalar decode position).

Cache layout (all layers stacked): {"k": (L, B, C, Hkv, D), "v": same} in the
activation dtype, C = cache capacity; decode writes slot ``pos``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import linear
from repro_torch.models.common import apply_rope, model_dtype, rope_table


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dh = cfg.d_model, cfg.d_head
        self.wq = linear.Linear(d, cfg.n_heads * dh, device=device)
        self.wk = linear.Linear(d, cfg.n_kv_heads * dh, device=device)
        self.wv = linear.Linear(d, cfg.n_kv_heads * dh, device=device)
        self.wo = linear.Linear(cfg.n_heads * dh, d, device=device)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Stacked-over-layers self-attention cache, zero-filled."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.d_head)
    dtype = model_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    dh = cfg.d_head
    q = linear.apply(p.wq, x).reshape(b, s, cfg.n_heads, dh)
    k = linear.apply(p.wk, x).reshape(b, s, cfg.n_kv_heads, dh)
    v = linear.apply(p.wv, x).reshape(b, s, cfg.n_kv_heads, dh)
    return q, k, v


def _rope_decode(cfg: ModelConfig, pos: int, s: int, device):
    """RoPE table for a decode step of S ≥ 1 tokens starting at scalar
    ``pos``."""
    return rope_table(cfg, pos + torch.arange(s, device=device))


def apply_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                 rope):
    """Decode step of S ≥ 1 tokens: x (B, S, d); cache (B, C, Hkv, D);
    rope: ``_rope_decode(cfg, pos, S, device)``.

    The new K/V rows are written into ``cache_k``/``cache_v`` IN PLACE at
    slots pos..pos+S-1 (the reference returns updated copies; writing in
    place keeps one cache in memory).  Returns (out (B, S, d_model),
    cache_k, cache_v).
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    cache_k[:, pos:pos + s] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + s] = v.to(cache_v.dtype)
    # visible = slots with index <= query position
    o = ops.attention(q, cache_k, cache_v, causal=True, offset=pos)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    return linear.apply(p.wo, o), cache_k, cache_v


def apply_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope):
    """Full-sequence causal attention that also emits the decode cache;
    rope: ``rope_table`` at positions 0..S-1.

    Returns (out (B,S,d_model), ck (B,S,Hkv,D), cv) in the activation dtype.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    o = ops.attention(q, k, v, causal=True)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    out = linear.apply(p.wo, o)
    return out, k.to(x.dtype), v.to(x.dtype)
