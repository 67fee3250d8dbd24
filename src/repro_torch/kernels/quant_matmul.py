"""Fused 4-bit dequant + matmul: the two hand-written CUDA kernels and their
plain PyTorch version.

  * ``quant_gemv``   — K1, decode-shaped (M ≤ 32 rows), ``csrc/quant_gemv.cu``;
                       replaces ``repro/kernels/quant_matmul.py::quant_gemv_pallas``.
  * ``quant_matmul`` — K2, the tiled GEMM for prefill, ``csrc/quant_matmul.cu``;
                       replaces ``repro/kernels/quant_matmul.py::quant_matmul_pallas``.
  * ``quant_matmul_plain`` — ``x.float() @ dequant_f32(qw, s, z).T → x.dtype``,
                       the semantics of both TPU kernels and of
                       ``ref.quant_matmul_ref``.

Operands: x (M, K) bf16 or f32; qw (N, K/8) int32 words, each the bits of the
reference's uint32 (8 nibble codes, code i in bits 4i..4i+3); scale and zero
(N, G) f32 with G | K; the result is (M, N) in x's dtype.

A wrapper given CPU tensors returns the plain version; given CUDA tensors it
launches its kernel or raises.  Each wrapper counts its launches in the
integer attribute ``launches`` (incremented only where the kernel launches).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import PACK, QuantSpec
from repro_torch.kernels import _build, ref

GEMV_MAX_M = 32
_DTYPES = (torch.bfloat16, torch.float32)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_entries: dict = {}


def quant_matmul_plain(x, qw, scale, zero):
    """The plain version of both kernels: f32 dequantize, f32 matmul."""
    return ref.quant_matmul_ref(x, qw, scale, zero,
                                (qw.shape[0], x.shape[-1]), QuantSpec())


def error_bound(x, qw, scale, zero, plain):
    """Elementwise bound on |kernel − plain| for the same inputs.

    Both sum the same float32 products in different orders, so each is
    within K·2⁻²⁴·Σₖ|x·ŵ| of the exact sum (the standard recursive-summation
    bound, with u = 2⁻²⁴); the bound on their difference is twice that.
    A bf16 output adds one bf16 ulp of the larger result (rounding to 8
    significant bits can split two float32 sums across a rounding step).
    """
    k = x.shape[-1]
    w = ref.dequant_ref(qw, scale, zero, (qw.shape[0], k), QuantSpec(),
                        torch.float32)
    bound = 2 * k * 2.0 ** -24 * (x.to(torch.float32).abs() @ w.abs().T)
    if plain.dtype == torch.bfloat16:
        mag = plain.to(torch.float32).abs() + bound
        ulp = torch.exp2(torch.floor(torch.log2(
            mag.clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        bound = bound + ulp
    return bound


def _check(x, qw, scale, zero, max_m=None):
    """Raise on anything the kernels do not take."""
    if x.dim() != 2 or qw.dim() != 2 or scale.dim() != 2 or zero.dim() != 2:
        raise ValueError(
            f"need x (M, K), qw (N, K/8), scale and zero (N, G); got "
            f"{tuple(x.shape)}, {tuple(qw.shape)}, {tuple(scale.shape)}, "
            f"{tuple(zero.shape)}")
    m, k = x.shape
    n = qw.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if qw.dtype != torch.int32:
        raise TypeError(f"qw must be int32 words, got {qw.dtype}")
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise TypeError(f"scale and zero must be float32, got "
                        f"{scale.dtype}, {zero.dtype}")
    if m < 1 or k % PACK or qw.shape[1] != k // PACK:
        raise ValueError(f"x {tuple(x.shape)} and qw {tuple(qw.shape)}: need "
                         f"M >= 1, K % {PACK} == 0 and qw (N, K/{PACK})")
    g = scale.shape[1]
    if scale.shape != (n, g) or zero.shape != (n, g) or g < 1 or k % g:
        raise ValueError(f"scale {tuple(scale.shape)} / zero "
                         f"{tuple(zero.shape)} must be (N={n}, G) with G | K={k}")
    if max_m is not None and m > max_m:
        raise ValueError(f"quant_gemv takes M <= {max_m} rows, got {m}")
    devs = {t.device for t in (x, qw, scale, zero)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if not all(t.is_contiguous() for t in (x, qw, scale, zero)):
        raise ValueError("operands must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernels "
                         "read it in 16-byte vectors)")


def _entry(name: str):
    """The C entry point ``name`` of library ``name``, typed once."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load(name), name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _launch(name: str, x, qw, scale, zero):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    fn = _entry(name)
    m, k = x.shape
    n, g = qw.shape[0], scale.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), qw.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                y.data_ptr(), m, n, k, g, int(x.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc} "
                           f"(M={m}, N={n}, K={k}, G={g}, {x.dtype})")
    return y


def quant_gemv(x, qw, scale, zero):
    """K1: y = x @ Ŵᵀ for M ≤ 32 rows (the decode GEMV)."""
    _check(x, qw, scale, zero, max_m=GEMV_MAX_M)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qw, scale, zero)
    y = _launch("quant_gemv", x, qw, scale, zero)
    quant_gemv.launches += 1
    return y


def quant_matmul(x, qw, scale, zero):
    """K2: y = x @ Ŵᵀ, tiled GEMM (the prefill)."""
    _check(x, qw, scale, zero)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qw, scale, zero)
    y = _launch("quant_matmul", x, qw, scale, zero)
    quant_matmul.launches += 1
    return y


quant_gemv.launches = 0
quant_matmul.launches = 0
