"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

They are the ground truth the CUDA kernels are held to on the card, and the
path CPU tensors take.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import (QuantSpec, pack_codes, pack_codes_planes,
                                    rtn_quantize, unpack_codes,
                                    unpack_codes_planes)


def dequant_ref(qw, scale, zero, shape, spec: QuantSpec, dtype=torch.bfloat16):
    """Ŵ = s·(q−z) from packed codes — nibble words, or the top
    ``spec.bits`` planes of a bit-plane buffer. shape = logical (n, m)."""
    spec.check_ported()
    n, m = shape
    codes = unpack_codes_planes(qw, m, spec.bits) if spec.plane \
        else unpack_codes(qw, m)
    g = scale.shape[-1]
    qg = codes.reshape(n, g, m // g).to(torch.float32)
    w = scale[..., None].to(torch.float32) * (
        qg - zero[..., None].to(torch.float32))
    return w.reshape(n, m).to(dtype)


def quant_matmul_ref(x, qw, scale, zero, shape, spec: QuantSpec, out_dtype=None):
    """y = x @ Ŵᵀ ;  x: (..., K), Ŵ: (N, K) stored as codes; → (..., N),
    multiplied and summed in float32."""
    out_dtype = out_dtype or x.dtype
    w = dequant_ref(qw, scale, zero, shape, spec, torch.float32)
    return torch.matmul(x.to(torch.float32), w.T).to(out_dtype)


def quant_matmul_tasks_ref(x, qw, scale_stack, zero_stack, task_ids, shape,
                           spec: QuantSpec, out_dtype=None):
    """Naive mixed-task oracle: y[i] = x[i] @ Ŵ(task_ids[i])ᵀ.

    scale_stack/zero_stack: (T, N, G); task_ids: (M,) rows into the stack.
    Materializes all T dequantized weights — ground truth only.
    """
    out_dtype = out_dtype or x.dtype
    w_all = torch.stack([dequant_ref(qw, s, z, shape, spec, torch.float32)
                         for s, z in zip(scale_stack, zero_stack)])
    y = torch.einsum("mk,mnk->mn", x.to(torch.float32),
                     w_all[task_ids.long()])
    return y.to(out_dtype)


def rtn_pack_ref(w, spec: QuantSpec, n_grid: int = 20):
    """Quantize and pack: ``rtn_quantize`` then the spec's packing (the
    reference's ``ref.rtn_pack_ref``, for the packed codes the port
    serves).  With ``n_grid=1`` it is plain min/max RTN, the function of
    the pack kernels (K3, K6b)."""
    spec.check_ported()
    q, s, z = rtn_quantize(w, spec, n_grid=n_grid)
    qw = pack_codes_planes(q, spec.bits) if spec.plane else pack_codes(q)
    return qw, s, z


def visible(b, sq, sk, causal, window, offset, device):
    """Which key each query sees: (Sq, Sk), or (B, Sq, Sk) for a (B,)
    ``offset`` tensor (``flash_attention_ref``'s rule; offset None means
    Sk − Sq)."""
    if offset is None:
        offset = sk - sq
    if torch.is_tensor(offset) and offset.dim():         # (B,) per-row
        iq = (torch.arange(sq, device=device)[None, :, None]
              + offset.to(device)[:, None, None])
        jk = torch.arange(sk, device=device)[None, None, :]
        mask = torch.ones((b, sq, sk), dtype=torch.bool, device=device)
    else:
        iq = torch.arange(sq, device=device)[:, None] + offset
        jk = torch.arange(sk, device=device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= jk <= iq
    if window is not None:
        mask &= jk > iq - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale=None, offset=None, return_lse=False):
    """Reference (GQA-aware) attention, in float32 einsum and softmax.

    q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D), Hq % Hkv == 0.
    window: sliding-window size — key j is visible to query i only if
    j > i − window.  scale: the logit scale, D^−½ by default.
    offset: absolute position of query 0; key slot j is at absolute position
    j.  Defaults to Sk - Sq (prefill: ends aligned).  Decode against a KV
    cache passes offset = pos so unwritten slots (> pos) are masked.  A
    (B,) tensor gives every batch row its own query position (the slot
    pool's decode step, where slots sit at different depths).  A row that
    sees no key returns 0.

    return_lse: also return each row's logsumexp of the scaled, masked
    logits, (B, Hq, Sq) float32, −inf for a row that sees no key (the
    reference keeps it as (B, Hkv, rep, Sq) in ``chunked_attention._fwd``:
    the same values, head h = kv_head·rep + r).
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    # (B, Hkv, rep, Sq, Sk)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf.reshape(b, sq, hkv, rep, d), kf)
    mask = visible(b, sq, sk, causal, window, offset, q.device)
    # broadcast over (Hkv, rep): (B|1, 1, 1, Sq, Sk)
    mask = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, vf)
    out = out.reshape(b, sq, hq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)
