"""Attention forward with an online softmax: the hand-written CUDA kernel and
its plain PyTorch version (``csrc/flash_attention.cu``).

  * ``flash_attention``       — K4; replaces
                                ``repro/kernels/flash_attention.py::
                                flash_attention_pallas`` (``_fa_kernel``).
  * ``flash_attention_plain`` — ``ref.flash_attention_ref``: float32 einsum
                                logits, masked softmax, einsum with V.

Operands in the port's layout: q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D)
with Hq % Hkv == 0 (GQA: query head h reads KV head h // (Hq/Hkv)), bf16 or
f32, any strides of whole 16-byte vectors with the last dim contiguous and
each tensor starting on 16 bytes (a layer's slice of the stacked KV cache
goes in as it is); D a multiple of 8, at most 128.
``causal``, ``window`` (key j visible to query i only if j > i − window),
``scale`` (D^−½ by default) and ``offset`` (query 0's absolute position;
None: Sk − Sq; an int; or a (B,) integer tensor on q's device, one
position per batch row, which the kernel reads itself — no host sync).
Returns (B, Sq, Hq, D) in q's dtype; a query that sees no key gets 0.
With ``return_lse=True`` it returns (o, lse): lse (B, Hq, Sq) float32, the
logsumexp of each row's scaled, masked logits (−inf for a row that sees no
key), which the training backward (``ops.attention(impl="chunked")``)
reads; o's bits do not depend on whether it is asked for.

Two kernels behind the wrapper: bf16 operands take the tensor cores
(mma.sync bf16 for q·kᵀ, and for P·V with P split into bf16 hi + lo), and
for Sq ≤ ``SPLIT_MAX_SQ`` (decode, verify) the key range is split across
blocks of ``SPLIT_KEYS`` keys each, ``decode_splits(Sq, Sk)`` of them, whose
partials a second launch combines; f32 operands take the SIMT f32 kernel.
The split boundaries do not depend on Sk: a cache of larger capacity only
adds splits past the last visible key, whose empty partials the combine
skips, so a decode or verify gives the same bits at any capacity that
holds its keys.  ``split_p_product`` and
``flash_attention_split_plain`` emulate the split-P product and the
split-KV combine (for the tests and ``chip_smoke.py`` only).

A wrapper given CPU tensors returns the plain version; given CUDA tensors it
launches its kernel or raises.  It counts its launches in the integer
attribute ``launches``: one per call (incremented only where the kernel
launches), also when a split call makes a second, combining launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_DTYPES = (torch.bfloat16, torch.float32)
D_MAX = 128
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 5 + [_L] * 9 + [_I] * 9 + [ctypes.c_float, _I, _I, _I]
             + [_P] * 4)
_entries: dict = {}
# decode and verify: split the keys across blocks for Sq up to this, each
# split SPLIT_KEYS keys (whole 64-key tiles; the constant is chosen by
# measurement, PERF.md §6)
SPLIT_MAX_SQ, SPLIT_KEYS, KEY_TILE = 4, 64, 64

flash_attention_plain = ref.flash_attention_ref


def decode_splits(sq: int, sk: int) -> int:
    """Blocks the bf16 kernel splits the keys over: one per SPLIT_KEYS
    keys for Sq ≤ 4, else 1.  Fixed by the shapes, so a captured step
    replays with any offsets."""
    if sq > SPLIT_MAX_SQ:
        return 1
    return max(1, -(-sk // SPLIT_KEYS))


def split_chunk(sk: int, splits: int) -> int:
    """Keys a split when Sk is cut into ``splits`` chunks of whole 64-key
    tiles: Sk / splits rounded up (the emulation's default)."""
    return -(-(-(-sk // splits)) // KEY_TILE) * KEY_TILE


def split_p_product(p, v):
    """P·V as the bf16 kernel takes it: f32 P split into hi = bf16(P) and
    lo = bf16(P − hi), both multiplied with bf16-exact V, summed in f32."""
    hi = p.to(torch.bfloat16).to(torch.float32)
    lo = (p - hi).to(torch.bfloat16).to(torch.float32)
    return hi @ v + lo @ v


def flash_attention_split_plain(q, k, v, *, causal=True, window=None,
                                scale=None, offset=None, splits=1,
                                chunk=None):
    """An emulation of the bf16 kernel's arithmetic: logits in f32, the keys
    cut into ``splits`` chunks of ``chunk`` keys (default ``split_chunk(Sk,
    splits)``; the kernel's own cut is ``decode_splits`` chunks of
    ``SPLIT_KEYS``), each chunk's partial (max m_s, sum l_s, unnormalised
    split-P product o_s), then the combine o = Σ o_s·e^(m_s − M) / Σ
    l_s·e^(m_s − M) over the partials that saw a key.  Every chunk is
    taken at its full width, keys past Sk masked, as the kernel takes whole
    key tiles, so keys past the last visible one change no bit.  A row
    that sees no key gets 0.  Returns q's dtype."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.to(torch.float32).reshape(b, sq, hkv, rep, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    mask = ref.visible(b, sq, sk, causal, window, offset, q.device)
    mask = mask.expand(b, sq, sk)
    chunk = chunk or split_chunk(sk, splits)
    parts = []
    for c0 in range(0, min(sk, chunk * splits), chunk):
        c1 = min(sk, c0 + chunk)
        pad = (0, 0, 0, 0, 0, chunk - (c1 - c0))
        kc = torch.nn.functional.pad(kf[:, c0:c1], pad)
        vc = torch.nn.functional.pad(vf[:, c0:c1], pad)
        mc = torch.nn.functional.pad(mask[..., c0:c1], (0, chunk - (c1 - c0)))
        lg = torch.einsum("bqhrd,bkhd->bhrqk", qf, kc) * scale
        lg = lg.masked_fill(~mc[:, None, None], float("-inf"))
        m = lg.amax(dim=-1, keepdim=True)
        p = torch.where(torch.isinf(m), torch.zeros_like(lg),
                        torch.exp(lg - m))
        # (B, Hkv, 1, chunk, D)
        parts.append((m, p.sum(dim=-1, keepdim=True), split_p_product(
            p, vc.permute(0, 2, 1, 3)[:, :, None])))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, o in parts:
        w = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - mx))
        num = num + o * w
        den = den + l * w
    tiny = torch.finfo(torch.float32).tiny
    out = torch.where(den > 0, num / den.clamp_min(tiny), torch.zeros_like(num))
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def error_bound(q, k, v, plain, *, scale=None):
    """Elementwise bound on |kernel − plain| for the same inputs
    (u = 2⁻²⁴, f32 round to nearest).

    f32 operands (the SIMT kernel): each logit is a D-long float32 dot
    taken in two orders, so each is within D·u·S of the exact one (S =
    scale·Σ_d |q_d k_d|, the standard recursive-summation bound) and the
    two differ by δ ≤ 2·D·u·S.  Perturbing the logits by δ moves each
    softmax weight by at most about 2δ of itself; exp, the normalizing sum
    and the Sk-long sum with V add (2·Sk + 8)·u more, relative.  The output
    is a convex combination of V rows, so with vmax = the largest |v| of
    that KV head and dim, the bound is vmax·(4δ + 2·(Sk + 8)·u), δ taken
    with the row's largest S over all keys.

    bf16 operands (the tensor-core kernel): the products are exact and the
    tensor cores accumulate in f32 without a promise of rounding to
    nearest (u_t = 2u), so a kernel logit is within D·u_t·S, plus u·S for
    the scale applied to the f32 logit; the plain version's within
    (D + 1)·u·S; δ ≤ (3·D + 2)·u·S.  On the weights: P = hi + lo keeps 16
    bits, 2⁻¹⁶ = 2⁸·u relative; the tensor cores add 2·Sk products (hi
    and lo) at u_t, 4·Sk·u; the running sum, the per-tile rescales, the
    split combine (at most Sk terms) and the division add Sk + Sk + 8; the
    plain version's softmax and Sk-long sum add 2·Sk.  So the bound is
    vmax·(4δ + (2⁸ + 8·Sk + 32)·u).  On an H100 (NVIDIA H100 80GB HBM3,
    700 W; ``chip_smoke.py`` phase ``kernels`` at llama3.2-1b's heads) the
    worst |kernel − plain| is 0.0078 (the window case; outputs in bf16, so
    mostly their last-ulp rounding), inside this bound.

    A bf16 output adds one bf16 ulp of the larger result, as
    ``quant_matmul.error_bound`` does.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    u = 2.0 ** -24
    qa = q.to(torch.float32).abs().reshape(b, sq, hkv, rep, d)
    s = torch.einsum("bqhrd,bkhd->bqhrk", qa, k.to(torch.float32).abs())
    smax = (s.amax(dim=-1) * abs(scale)).reshape(b, sq, hq, 1)
    vmax = v.to(torch.float32).abs().amax(dim=1)              # (B, Hkv, D)
    vmax = vmax.repeat_interleave(rep, dim=1)[:, None]        # (B, 1, Hq, D)
    if q.dtype == torch.bfloat16:
        delta = (3 * d + 2) * u * smax
        bound = vmax * (4 * delta + (2 ** 8 + 8 * sk + 32) * u)
    else:
        delta = 2 * d * u * smax
        bound = vmax * (4 * delta + 2 * (sk + 8) * u)
    if plain.dtype == torch.bfloat16:
        mag = plain.to(torch.float32).abs() + bound
        ulp = torch.exp2(torch.floor(torch.log2(
            mag.clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        bound = bound + ulp
    return bound


def lse_error_bound(q, k, lse_plain, *, scale=None):
    """Elementwise bound on |kernel lse − plain lse| (B, Hq, Sq) for the
    same inputs (``return_lse``).  lse = log Σ_j e^(s_j): moving every
    logit by at most δ moves it by at most δ, with δ the logit bound of
    ``error_bound`` (bf16: (3·D + 2)·u·S, f32: 2·D·u·S); the exponentials
    and the Sk-long sum add (Sk + 4)·u relative to the sum on either side
    (the kernel also rescales its running sum once a key tile), which the
    log turns into as much absolute error; the final addition m + log(l)
    rounds once, u·|lse| on either side.  So 2·(Sk + 4 + Sk / 64)·u +
    2·u·|lse| + δ.  A row that sees no key is −inf on both sides."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    u = 2.0 ** -24
    qa = q.to(torch.float32).abs().reshape(b, sq, hkv, rep, d)
    s = torch.einsum("bqhrd,bkhd->bqhrk", qa, k.to(torch.float32).abs())
    smax = (s.amax(dim=-1) * abs(scale)).reshape(b, sq, hq).transpose(1, 2)
    delta = ((3 * d + 2) if q.dtype == torch.bfloat16 else 2 * d) * u * smax
    finite = torch.where(torch.isfinite(lse_plain), lse_plain.abs(),
                         torch.zeros_like(lse_plain))
    return delta + 2 * (sk + 4 + sk / 64) * u + 2 * u * finite


def _check(q, k, v):
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B={b}, Sk, Hkv, D={d})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype of bfloat16 or "
                        f"float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    sk, hkv = k.shape[1], k.shape[2]
    if sq < 1 or sk < 1 or hkv < 1 or hq % hkv:
        raise ValueError(f"need Sq, Sk >= 1 and Hq={hq} a multiple of "
                         f"Hkv={hkv}")
    if d % 8 or d > D_MAX:
        raise ValueError(f"head dim {d}: need a multiple of 8, at most "
                         f"{D_MAX}")
    if b > 65535 or hkv > 65535:
        raise ValueError(f"B={b} and Hkv={hkv} must be at most 65535")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last dim")
    vec = 16 // q.element_size()
    if any(t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3])
           for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16 bytes with strides of "
                         "whole 16-byte vectors (the kernel loads 16-byte "
                         "vectors)")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v on several devices")


def _offsets(offset, b, sq, sk, device):
    """(scalar offset, (B,) int64 device tensor or None) for the kernel."""
    if offset is None:
        return sk - sq, None
    if torch.is_tensor(offset):
        if offset.dim() > 1 or (offset.dim() == 1 and offset.shape[0] != b):
            raise ValueError(f"offset {tuple(offset.shape)}: need a scalar "
                             f"or (B={b},)")
        if offset.dtype.is_floating_point or offset.dtype == torch.bool:
            raise TypeError(f"offset must be an integer tensor, got "
                            f"{offset.dtype}")
        if offset.device != device:
            raise ValueError(f"offset on {offset.device}, q on {device}")
        return 0, offset.to(torch.int64).expand(b).contiguous()
    return int(offset), None


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    offset=None, return_lse=False):
    """K4: softmax(scale·q·kᵀ, masked)·v in q's dtype, and with
    ``return_lse`` the rows' logsumexp (see the module docstring)."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window {window}: need None or >= 1")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, offset=offset,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got "
                         f"{q.device}")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    off, offs = _offsets(offset, b, sq, sk, q.device)
    fn = _entries.get("flash_attention")
    if fn is None:
        fn = _build.load("flash_attention").flash_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entries["flash_attention"] = fn
    bf16 = q.dtype == torch.bfloat16
    splits = decode_splits(sq, sk) if bf16 else 1
    if hkv * splits > 65535:
        raise ValueError(f"Sk={sk}: {splits} splits of {SPLIT_KEYS} keys for "
                         f"{hkv} KV heads exceed the grid")
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    part_o = part_ml = None
    if splits > 1:     # the partials the combining launch reads: grow with Sk
        rows = sq * (hq // hkv)
        part_o = torch.empty((b, hkv, splits, rows, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((b, hkv, splits, rows, 2), dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if offs is None else offs.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                b, sq, sk, hq, hkv, d, off, int(causal), int(window or 0),
                float(scale if scale is not None else d ** -0.5),
                int(bf16), splits, SPLIT_KEYS,
                None if part_o is None else part_o.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(),
                None if lse is None else lse.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {rc} (B={b}, Sq={sq}, Sk={sk}, Hq={hq}, "
                           f"Hkv={hkv}, D={d}, {q.dtype}, {splits} splits)")
    flash_attention.launches += 1            # one per call, split or not
    return (o, lse) if return_lse else o


def tc_smem_bytes() -> dict:
    """Dynamic shared memory of a 4-warp block of the bf16 kernel, per
    padded head dim (above 48 KB at 128: set with cudaFuncSetAttribute)."""
    fn = _build.load("flash_attention").flash_attention_tc_smem
    fn.argtypes, fn.restype = [_I], ctypes.c_int
    return {"D<=64": fn(64), "D<=128": fn(128)}


KERNELS = (flash_attention,)
flash_attention.launches = 0
