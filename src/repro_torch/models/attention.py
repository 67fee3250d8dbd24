"""GQA attention with RoPE and a KV cache (port of ``repro/models/attention.py``:
``init``, ``init_cache``, ``_qkv``, ``_rope_decode``, ``_cache_write``,
``apply_train``, ``apply_prefill`` and ``apply_decode``, for full causal
attention through
``ops.attention`` under ``cfg.attn_impl``: dense, or chunked — K4; on the
card a decode or verify takes K4 under either).

Cache layout (all layers stacked): {"k": (L, B, C, Hkv, D), "v": same} in the
activation dtype, C = cache capacity; the batch dim is ``CACHE_BATCH_DIM``
and the position dim ``CACHE_SEQ_DIM``.  A decode step at scalar ``pos``
writes slot ``pos`` of every row; at a (B,) position vector (the slot pool)
each row writes its own slot.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import linear
from repro_torch.models.common import (apply_rope, apply_rope_slots,
                                       model_dtype, rope_table)

# dims of every cache leaf (L, B, C, Hkv, D): the slot pool admits along
# the batch dim and pages along the position dim
CACHE_BATCH_DIM, CACHE_SEQ_DIM = 1, 2


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


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, slots=None,
         draft_bits=None):
    b, s, _ = x.shape
    dh = cfg.d_head

    def proj(lin, name, heads):
        return linear.apply(lin, x, slots=linear.slot_entry(slots, name),
                            draft_bits=draft_bits).reshape(b, s, heads, dh)
    return (proj(p.wq, "wq", cfg.n_heads), proj(p.wk, "wk", cfg.n_kv_heads),
            proj(p.wv, "wv", cfg.n_kv_heads))


def _rope_decode(cfg: ModelConfig, pos, s: int, device):
    """RoPE table for a decode step of S ≥ 1 tokens starting at ``pos``:
    a scalar (one (S,) table for the batch) or a (B,) per-slot tensor (a
    (B, S) table: token s of row b at position pos[b] + s)."""
    steps = torch.arange(s, device=device)
    if torch.is_tensor(pos) and pos.dim() == 1:
        return rope_table(cfg, pos.to(device)[:, None] + steps[None, :])
    return rope_table(cfg, pos + steps)


def _cache_write(buf: torch.Tensor, val: torch.Tensor, pos) -> None:
    """Write the step's K/V rows into ``buf`` (B, C, Hkv, D) IN PLACE (the
    reference returns an updated copy; writing in place keeps one cache in
    memory).

    pos scalar: rows pos..pos+S-1 of every batch row (lockstep decode).
    pos (B,): batch row b writes its OWN rows pos[b]..pos[b]+S-1 (the slot
    pool).  Like the reference's ``dynamic_update_slice``, a start past
    C − S is clamped to C − S — only evicted slots, whose rows nobody
    reads, ever sit there.
    """
    val = val.to(buf.dtype)
    s = val.shape[1]
    if torch.is_tensor(pos) and pos.dim() == 1:
        start = pos.to(buf.device).clamp(0, buf.shape[1] - s)
        rows = start[:, None] + torch.arange(s, device=buf.device)[None, :]
        buf[torch.arange(buf.shape[0], device=buf.device)[:, None], rows] = val
    else:
        start = min(max(int(pos), 0), buf.shape[1] - s)
        buf[:, start:start + s] = val


def _decode_attention(q, cache_k, cache_v, pos, impl: str):
    """Causal attention of S ≥ 1 decode queries (query s at pos + s: keys
    with index <= its position are visible) over the cache.

    Each query's rows must depend neither on S (a verify of k+1 tokens has
    to give the bits of k+1 decode steps) nor on the cache's capacity C (a
    speculative pool holds spec_k more rows than a greedy one).  On CUDA
    tensors under the default kernel route both ``attn_impl`` values take
    K4, all S queries in one launch: its key splits are a fixed number of
    keys, so its rows are the same at any S and, since the splits past the
    last visible key add exactly nothing, at any C.  Under ``"dense"`` this
    replaces the reference's f32 einsum and softmax by K4 (bf16 for a bf16
    model), held to ``flash_attention.error_bound``.  On CPU tensors and under
    ``force_impl("torch")`` ``"dense"`` stays the plain f32 einsum, whose
    summation order PyTorch picks from the shapes, so there query s runs as
    its own S = 1 call at pos + s, the decode step's shapes."""
    s = q.shape[1]
    if impl == "dense" and (q.device.type != "cuda"
                            or ops.default_impl() != "cuda"):
        if s > 1:
            return torch.cat([ops.attention(q[:, j:j + 1], cache_k, cache_v,
                                            causal=True, offset=pos + j,
                                            impl=impl) for j in range(s)],
                             dim=1)
        return ops.attention(q, cache_k, cache_v, causal=True, offset=pos,
                             impl=impl)
    return ops.attention(q, cache_k, cache_v, causal=True, offset=pos,
                         impl="chunked")


def apply_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 cache_k: torch.Tensor, cache_v: torch.Tensor, pos, rope,
                 slots=None, draft_bits=None):
    """Decode step of S ≥ 1 tokens: x (B, S, d); cache (B, C, Hkv, D); pos
    an int or a (B,) per-slot position tensor; rope:
    ``_rope_decode(cfg, pos, S, device)``.

    slots: optional (task_ids, stacked-scale subtree) — mixed-task decode
    reads per-slot scale rows in every quantized linear (linear.apply);
    draft_bits: the speculative draft's plane read width.

    The new K/V rows go into ``cache_k``/``cache_v`` in place
    (``_cache_write``).  Returns (out (B, S, d_model), cache_k, cache_v).
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, slots=slots, draft_bits=draft_bits)
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    rot = apply_rope_slots if per_slot else apply_rope
    q, k = rot(q, rope), rot(k, rope)
    _cache_write(cache_k, k, pos)
    _cache_write(cache_v, v, pos)
    o = _decode_attention(q, cache_k, cache_v, pos, cfg.attn_impl)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    out = linear.apply(p.wo, o, slots=linear.slot_entry(slots, "wo"),
                       draft_bits=draft_bits)
    return out, cache_k, cache_v


def apply_train(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope
                ) -> torch.Tensor:
    """Full-sequence causal attention for training (reference
    ``attention.apply_train``): x (B, S, d); rope: ``rope_table`` at
    positions 0..S-1.  ``ops.attention`` under ``cfg.attn_impl`` (K4 with
    its logsumexp under "chunked" on the card), never the decode route; no
    cache is written.  Returns (B, S, d_model) in x's dtype."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    o = ops.attention(q, k, v, causal=True, impl=cfg.attn_impl)
    return linear.apply(p.wo, o.reshape(b, s, cfg.n_heads * cfg.d_head))


def apply_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope,
                  slots=None):
    """Full-sequence causal attention that also emits the decode cache;
    rope: ``rope_table`` at positions 0..S-1.

    slots: optional (task_ids, stacked-scale subtree) — a resident-stack
    prefill reads per-row scales in every quantized linear (task_ids
    already repeated per token, B·S rows).

    Returns (out (B,S,d_model), ck (B,S,Hkv,D), cv) in the activation dtype.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, slots=slots)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    o = ops.attention(q, k, v, causal=True, impl=cfg.attn_impl)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    out = linear.apply(p.wo, o, slots=linear.slot_entry(slots, "wo"))
    return out, k.to(x.dtype), v.to(x.dtype)
