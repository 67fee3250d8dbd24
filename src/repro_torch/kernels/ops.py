"""Public kernel ops: backend dispatch (port of ``repro/kernels/ops.py``,
forward only — the scale gradient comes with the training slice).

``quant_matmul`` is the single entry point models use for every quantized
fully-connected layer, ``quant_matmul_slotted`` its mixed-task form (each
row under its own task's scales, the resident scheduler's decode and
prefill), ``rtn_pack`` the min/max quantize-and-pack of model conversion
and ``attention`` the attention forward.  Implementations:

  * ``cuda``  — the hand-written kernels of ``kernels/quant_matmul.py``:
                M ≤ ``GEMV_MAX_M`` rows go to the GEMV (every decode step;
                K5 when slotted), larger M to the tiled GEMM (the prefill;
                once per task present when slotted); bit-plane codes to
                the plane branch of each (K6a); ``rtn_pack`` to K3
                (nibbles) or K6b (bit-planes), ``kernels/rtn_pack.py``;
                ``attention(impl="chunked")`` to K4,
                ``kernels/flash_attention.py``.  A CUDA tensor
                launches the kernel; a CPU tensor takes the kernel's plain
                version.  The default.
  * ``torch`` — the plain version on whatever device the tensors are on
                (the card's comparison run of ``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch

from repro_torch.core.quant import QuantSpec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rtn_pack as _rp
from repro_torch.kernels.quant_matmul import GEMV_MAX_M

__all__ = ["ATTN_IMPLS", "GEMV_MAX_M", "KERNELS", "KNOWN_IMPLS", "attention",
           "default_impl", "force_impl", "quant_matmul",
           "quant_matmul_slotted", "rtn_pack"]

_tls = threading.local()

KNOWN_IMPLS = ("cuda", "torch")
# attention implementations a model config names (ModelConfig.attn_impl)
ATTN_IMPLS = ("dense", "chunked")
# every kernel wrapper, each with its ``launches`` counter
KERNELS = _qm.KERNELS + _rp.KERNELS + _fa.KERNELS


def _check_impl(impl: str) -> str:
    """Reject unknown impl names instead of silently taking another path."""
    if impl not in KNOWN_IMPLS:
        raise ValueError(f"unknown quant_matmul impl {impl!r}; known: "
                         f"{', '.join(KNOWN_IMPLS)}")
    return impl


@contextlib.contextmanager
def force_impl(impl: str):
    """Override the quant-matmul implementation within a scope (this
    thread only)."""
    prev = getattr(_tls, "impl", None)
    _tls.impl = _check_impl(impl)
    try:
        yield
    finally:
        _tls.impl = prev


def default_impl() -> str:
    return getattr(_tls, "impl", None) or "cuda"


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x (..., K) → a contiguous (M, K) that starts on a 16-byte boundary."""
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    if x2d.data_ptr() % 16:              # a view starting mid-vector
        x2d = x2d.clone()
    return x2d


def _layout(qw: torch.Tensor, spec: QuantSpec, draft_bits):
    """``(planes read, draft rescale exponent)`` for bit-plane codes, None
    for nibbles; refuses what the port does not serve."""
    spec.check_ported()
    if not spec.plane:
        if draft_bits is not None:
            raise ValueError("a draft read needs bit-plane codes "
                             "(QuantConfig(layout='plane'))")
        return None
    read = spec.bits if draft_bits is None else draft_bits
    if not 1 <= read <= spec.bits or qw.dim() != 3 or qw.shape[0] < read:
        raise ValueError(f"cannot read {read} planes of a {spec.bits}-bit "
                         f"code from a buffer of shape {tuple(qw.shape)} "
                         f"(need (bits' >= {read}, N, K/32))")
    return read, spec.bits - read


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, spec: QuantSpec, *,
                 draft_bits: Optional[int] = None) -> torch.Tensor:
    """y = x @ Ŵᵀ for arbitrary leading batch dims on x; y in x's dtype,
    through ``default_impl()``.

    Bit-plane specs read the top ``spec.bits`` planes of qw (bits', N,
    K/32).  ``draft_bits`` = p < ``spec.bits`` = b is the self-speculative
    draft: the top p planes under the draft's scales, scale·2^(b−p) and
    zero/2^(b−p) (``core.quant.draft_scales``; the reference passes a
    rescaled tree and a p-bit spec instead, the values are the same)."""
    impl = default_impl()
    planes = _layout(qw, spec, draft_bits)
    lead = x.shape[:-1]
    x2d = _rows(x)
    scale = scale.to(torch.float32).contiguous()
    zero = zero.to(torch.float32).contiguous()
    if planes is None:
        plain, gemv, gemm = (_qm.quant_matmul_plain, _qm.quant_gemv,
                             _qm.quant_matmul)
    else:
        plain, gemv, gemm = (
            functools.partial(f, bits=planes[0], shift=planes[1])
            for f in (_qm.quant_matmul_planes_plain, _qm.quant_gemv_planes,
                      _qm.quant_matmul_planes))
    if impl == "torch":
        y = plain(x2d, qw, scale, zero)
    elif x2d.shape[0] <= GEMV_MAX_M:
        y = gemv(x2d, qw, scale, zero)
    else:
        y = gemm(x2d, qw, scale, zero)
    return y.reshape(*lead, y.shape[-1])


def quant_matmul_slotted(x: torch.Tensor, qw: torch.Tensor,
                         scale_stack: torch.Tensor, zero_stack: torch.Tensor,
                         task_ids: torch.Tensor, spec: QuantSpec, *,
                         draft_bits: Optional[int] = None) -> torch.Tensor:
    """Mixed-task y[i] = x[i] @ Ŵ(task_ids[i])ᵀ, forward only (serving).

    x (..., K) with prod(leading dims) == M rows; scale/zero stacks
    (T, N, G); task_ids (M,) int32 rows into the stacks.  Row i is bit for
    bit ``quant_matmul``'s row i when the live scales are
    ``scale_stack[task_ids[i]]`` — the resident scheduler's token equality
    with drain rests on it:

      * ``torch`` impl: the plain matmul per task present, rows selected;
      * M ≤ ``GEMV_MAX_M``: K5 (its plain version for CPU tensors), which
        is K1's template with a per-row task gather;
      * larger M (the slotted prefill, every row the request's task): K2
        once per task present under ``scale_stack[t]``, rows selected —
        the same GEMM on the same scale values as the drain prefill.  The
        distinct ids are read on the host (one sync per call on the card).

    Bit-plane specs route the same way to K6a (the plane branch of K5 and
    K2), with ``draft_bits`` as in ``quant_matmul``.
    """
    impl = default_impl()
    planes = _layout(qw, spec, draft_bits)
    lead = x.shape[:-1]
    x2d = _rows(x)
    if x2d.shape[0] != task_ids.shape[0]:
        raise ValueError(
            f"task_ids has {task_ids.shape[0]} rows for {x2d.shape[0]} slots")
    scale_stack = scale_stack.to(torch.float32).contiguous()
    zero_stack = zero_stack.to(torch.float32).contiguous()
    task_ids = task_ids.to(torch.int32).contiguous()
    if planes is None:
        plain, gemv, gemm = (_qm.quant_matmul_tasks_plain,
                             _qm.quant_gemv_tasks, _qm.quant_matmul)
    else:
        plain, gemv, gemm = (
            functools.partial(f, bits=planes[0], shift=planes[1])
            for f in (_qm.quant_matmul_tasks_planes_plain,
                      _qm.quant_gemv_tasks_planes, _qm.quant_matmul_planes))
    if impl == "torch":
        y = plain(x2d, qw, scale_stack, zero_stack, task_ids)
    elif x2d.shape[0] <= GEMV_MAX_M:
        y = gemv(x2d, qw, scale_stack, zero_stack, task_ids)
    else:
        y = _qm.per_task(gemm, x2d, qw, scale_stack, zero_stack, task_ids)
    return y.reshape(*lead, y.shape[-1])


def rtn_pack(w: torch.Tensor, spec: QuantSpec):
    """Min/max RTN quantize and pack w (N, K) → (qw, scale (N, G), zero (N,
    G)): qw (N, K/8) nibble words or (bits, N, K/32) bit-planes per
    ``spec.layout`` (port of the reference's ops.py:252, which is
    ``ref.rtn_pack_ref(w, spec, n_grid=1)`` off the TPU).  ``cuda`` takes
    K3 or K6b, ``torch`` their plain version.

    Asymmetric specs only: the reference's Pallas kernel ignores
    ``spec.symmetric`` and always computes the asymmetric formula, while
    its ``rtn_pack_ref`` honours it — so a symmetric spec raises here
    rather than pick one of the two."""
    spec.check_ported()
    if spec.symmetric:
        raise NotImplementedError(
            "rtn_pack takes asymmetric specs only (the reference's kernel "
            "and its plain version disagree on symmetric ones); quantize "
            "with core.quant.rtn_quantize instead")
    spec.validate(w.shape[-1])
    w = w.contiguous()
    if default_impl() == "torch":
        return _ref.rtn_pack_ref(w, spec, n_grid=1)
    fn = _rp.rtn_pack_planes if spec.plane else _rp.rtn_pack
    return fn(w, spec.bits, spec.group_size)


def attention(q, k, v, *, causal=True, window=None, scale=None, offset=None,
              impl: str = "dense"):
    """Attention entry point (GQA-aware): q (B, Sq, Hq, D), k/v (B, Sk,
    Hkv, D); ``offset`` a scalar or a (B,) tensor of per-row query
    positions.

    impl='dense'   — the plain float32 einsum and softmax (the reference's
                     dense path is XLA, not Pallas);
    impl='chunked' — K4, the online-softmax kernel, on CUDA tensors; its
                     plain version on CPU tensors or under
                     ``force_impl("torch")``."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: "
                         f"{', '.join(ATTN_IMPLS)}")
    if impl == "chunked" and default_impl() == "cuda":
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, offset=offset)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale, offset=offset)
