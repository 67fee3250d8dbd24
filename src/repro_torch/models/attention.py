"""GQA attention with RoPE and a KV cache (port of ``repro/models/attention.py``:
``init``, ``cache_capacity``, ``init_cache``, ``_qkv``, ``_rope_decode``,
``_cache_write``, ``apply_train``, ``apply_prefill``, ``apply_decode``, the
int8 cache's ``quantize_kv``, ``dequantize_kv``, ``apply_decode_q8`` and
``prefill_cache_entry``, for causal attention, windowed under
``cfg.swa_window``, through ``ops.attention`` under ``cfg.attn_impl``:
dense, or chunked — K4; on the card a decode or verify takes K4 under
either — and the whisper decoder's ``cross_init`` / ``cross_apply``, dense
as the reference's).  ``rope`` None (learned positions) rotates nothing.

Cache layout (all layers stacked): {"k": (L, B, C, Hkv, D), "v": same} in the
activation dtype, C = cache capacity; under ``kv_cache_dtype="int8"`` k and v
are int8 codes with a float16 scale per (token, head), {"k_scale",
"v_scale": (L, B, C, Hkv)}.  Without a window C is the sequence
length and a decode step at position ``pos`` writes slot ``pos``; under a
window C is ``min(window, seq_len)`` and the cache is a ring: position
``pos`` writes slot ``pos mod C``, so the slots hold exactly the last C
tokens, and the causal mask "slot ≤ pos" is right in both regimes (once the
ring has wrapped every slot is visible).  At a (B,) position vector (the
slot pool) each row writes its own slot.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import linear
from repro_torch.models.common import (apply_rope, apply_rope_slots,
                                       model_dtype, rope_table)

class Attention(nn.Module):
    """wq, wk, wv over ``d_in`` inputs (``cfg.d_model`` unless given: zamba2's
    shared block reads the 2·d_model concat) and wo back to ``cfg.d_model``
    (reference ``init(..., d_in=)``)."""

    def __init__(self, cfg: ModelConfig, device=None, *, d_in=None):
        super().__init__()
        d, dh = cfg.d_model, cfg.d_head
        d_in = d_in or d
        kw = dict(bias=cfg.qkv_bias, device=device)
        self.wq = linear.Linear(d_in, cfg.n_heads * dh, **kw)
        self.wk = linear.Linear(d_in, cfg.n_kv_heads * dh, **kw)
        self.wv = linear.Linear(d_in, cfg.n_kv_heads * dh, **kw)
        self.wo = linear.Linear(cfg.n_heads * dh, d, device=device)


def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Cache rows for ``seq_len`` positions: the window's ring when there
    is one."""
    if cfg.swa_window is not None:
        return min(cfg.swa_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Stacked-over-layers self-attention cache, zero-filled, of capacity
    ``cache_capacity(cfg, seq_len)``."""
    c = cache_capacity(cfg, seq_len)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.d_head)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1]
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float16,
                                       device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float16,
                                       device=device)}
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
    """Write the step's rows — K/V, or the int8 cache's scales — into
    ``buf`` (B, C, …) IN PLACE (the reference returns an updated copy;
    writing in place keeps one cache in memory).

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


def _ring_slot(cfg: ModelConfig, pos, cap: int):
    """The cache slot of position ``pos`` (an int or a (B,) tensor): itself,
    or ``pos mod cap`` in a window's ring."""
    return pos % cap if cfg.swa_window is not None else pos


def _rotated_qkv(p, x, cfg, pos, rope, slots, draft_bits):
    """q, k, v of a decode step, q and k rotated at its positions (not at
    all when ``rope`` is None)."""
    q, k, v = _qkv(p, x, cfg, slots=slots, draft_bits=draft_bits)
    if rope is None:
        return q, k, v
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    rot = apply_rope_slots if per_slot else apply_rope
    return rot(q, rope), rot(k, rope), v


def apply_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 cache_k: torch.Tensor, cache_v: torch.Tensor, pos, rope,
                 slots=None, draft_bits=None):
    """Decode step of S ≥ 1 tokens: x (B, S, d); cache (B, C, Hkv, D); pos
    an int or a (B,) per-slot position tensor; rope:
    ``_rope_decode(cfg, pos, S, device)``, or None.

    slots: optional (task_ids, stacked-scale subtree) — mixed-task decode
    reads per-slot scale rows in every quantized linear (linear.apply);
    draft_bits: the speculative draft's plane read width.

    The new K/V rows go into ``cache_k``/``cache_v`` in place
    (``_cache_write``), at slot ``pos mod C`` in a window's ring.  Returns
    (out (B, S, d_model), cache_k, cache_v).
    """
    b, s, _ = x.shape
    q, k, v = _rotated_qkv(p, x, cfg, pos, rope, slots, draft_bits)
    slot = _ring_slot(cfg, pos, cache_k.shape[1])
    _cache_write(cache_k, k, slot)
    _cache_write(cache_v, v, slot)
    o = _decode_attention(q, cache_k, cache_v, pos, cfg.attn_impl)
    out = linear.apply(p.wo, o.reshape(b, s, cfg.n_heads * cfg.d_head),
                       slots=linear.slot_entry(slots, "wo"),
                       draft_bits=draft_bits)
    return out, cache_k, cache_v


def quantize_kv(t: torch.Tensor):
    """(…, H, D) → (int8 codes, float16 per-(…, H) scale): symmetric,
    amax/127 floored at 1e-8, rounded half to even, clipped to ±127
    (reference ``quantize_kv``; the codes come from the float32 scale,
    the stored scale is its float16 rounding).  Divides by tensors, as
    the reference does: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal instead."""
    tf = t.to(torch.float32)
    amax = tf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale.to(torch.float32)[..., None]
            ).to(dtype)


def apply_decode_q8(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    cache: dict, pos, rope, slots=None, draft_bits=None):
    """``apply_decode`` against an int8 cache (``kv_cache_dtype="int8"``):
    cache {k, v: int8 (B, C, Hkv, D); k_scale, v_scale: float16 (B, C,
    Hkv)}, one layer's views, written in place with the step's quantized
    K/V.  The whole cache is dequantized to x's dtype in plain torch and
    attended as ``apply_decode`` attends (K4 on the card), as the
    reference dequantizes and calls ``ops.attention``.  Returns (out,
    cache)."""
    b, s, _ = x.shape
    q, k, v = _rotated_qkv(p, x, cfg, pos, rope, slots, draft_bits)
    slot = _ring_slot(cfg, pos, cache["k"].shape[1])
    for name, t in (("k", k), ("v", v)):
        codes, scale = quantize_kv(t)
        _cache_write(cache[name], codes, slot)
        _cache_write(cache[f"{name}_scale"], scale, slot)
    kf = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
    vf = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    o = _decode_attention(q, kf, vf, pos, cfg.attn_impl)
    out = linear.apply(p.wo, o.reshape(b, s, cfg.n_heads * cfg.d_head),
                       slots=linear.slot_entry(slots, "wo"),
                       draft_bits=draft_bits)
    return out, cache


def apply_train(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope=None
                ) -> torch.Tensor:
    """Full-sequence causal attention for training (reference
    ``attention.apply_train``): x (B, S, d); rope: ``rope_table`` at
    positions 0..S-1, or None.  ``ops.attention`` under ``cfg.attn_impl``
    (K4 with its logsumexp under "chunked" on the card) and
    ``cfg.swa_window``, never the decode route; no cache is written.
    Returns (B, S, d_model) in x's dtype."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if rope is not None:
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    o = ops.attention(q, k, v, causal=True, window=cfg.swa_window,
                      impl=cfg.attn_impl)
    return linear.apply(p.wo, o.reshape(b, s, cfg.n_heads * cfg.d_head))


def apply_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope,
                  cap: int, slots=None):
    """Full-sequence causal attention (windowed under ``cfg.swa_window``)
    that also emits the decode cache; rope: ``rope_table`` at positions
    0..S-1, or None; cap: the cache's capacity, ``cache_capacity(cfg, S)``.

    slots: optional (task_ids, stacked-scale subtree) — a resident-stack
    prefill reads per-row scales in every quantized linear (task_ids
    already repeated per token, B·S rows).

    Returns (out (B,S,d_model), ck (B,cap,Hkv,D), cv) in the activation
    dtype, the cache in ring layout: the last ``cap`` keys, token t in slot
    t mod cap (no roll when cap = S).
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, slots=slots)
    if rope is not None:
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    o = ops.attention(q, k, v, causal=True, window=cfg.swa_window,
                      impl=cfg.attn_impl)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    out = linear.apply(p.wo, o, slots=linear.slot_entry(slots, "wo"))
    ring = lambda t: torch.roll(t[:, s - cap:], s % cap, dims=1).to(x.dtype)
    return out, ring(k), ring(v)


def prefill_cache_entry(ck: torch.Tensor, cv: torch.Tensor,
                        cfg: ModelConfig) -> dict:
    """One layer's prefill K/V in the configured cache layout."""
    if cfg.kv_cache_dtype == "int8":
        k8, ks = quantize_kv(ck)
        v8, vs = quantize_kv(cv)
        return {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Cross-attention (the whisper decoder)
# ---------------------------------------------------------------------------

def cross_init(cfg: ModelConfig, device=None) -> Attention:
    """The cross-attention's wq, wk, wv, wo: the self-attention's linears
    (reference ``cross_init`` = ``init``)."""
    return Attention(cfg, device=device)


def cross_apply(p: Attention, x: torch.Tensor, enc: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) decoder states attend over enc: (B, T, d) encoder
    states, every key visible.  The plain float32 attention
    (``ops.attention``'s default impl, not ``cfg.attn_impl``), as the
    reference's call passes none."""
    b, s, _ = x.shape
    t = enc.shape[1]
    dh = cfg.d_head
    q = linear.apply(p.wq, x).reshape(b, s, cfg.n_heads, dh)
    k = linear.apply(p.wk, enc).reshape(b, t, cfg.n_kv_heads, dh)
    v = linear.apply(p.wv, enc).reshape(b, t, cfg.n_kv_heads, dh)
    o = ops.attention(q, k, v, causal=False)
    return linear.apply(p.wo, o.reshape(b, s, cfg.n_heads * dh))
