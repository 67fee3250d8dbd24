"""Public kernel ops: backend dispatch and the training gradients (port of
``repro/kernels/ops.py``).

``quant_matmul`` is the single entry point models use for every quantized
fully-connected layer, ``quant_matmul_slotted`` its mixed-task form (each
row under its own task's scales, the resident scheduler's decode and
prefill), ``quant_matmul_experts`` its form over an MoE block's stacked
experts (the reference's ``quant_matmul`` under ``jax.vmap``), ``rtn_pack`` the min/max quantize-and-pack of model conversion
and ``attention`` the attention forward.  Implementations:

  * ``cuda``  — the hand-written kernels of ``kernels/quant_matmul.py``:
                M ≤ ``GEMV_MAX_M`` rows go to the GEMV (every decode step;
                K5 when slotted), larger M to the tiled GEMM (the prefill;
                once per task present when slotted); bit-plane codes to
                the plane branch of each (K6a); the expert-axis forms of
                K1 and K2, nibble or plane, for ``quant_matmul_experts``; ``rtn_pack`` to K3
                (nibbles) or K6b (bit-planes), ``kernels/rtn_pack.py``;
                ``attention(impl="chunked")`` to K4,
                ``kernels/flash_attention.py``.  A CUDA tensor
                launches the kernel; a CPU tensor takes the kernel's plain
                version.  The default.
  * ``torch`` — the plain version on whatever device the tensors are on
                (the card's comparison run of ``chip_smoke.py``).

Gradients (the reference's custom VJPs; neither has a Pallas backward, so
both backwards are plain PyTorch on either impl).  ``quant_matmul``, with
y = x·Ŵᵀ and Ŵ = s·(q − z) (paper Eq. (2), reference ``_qmm_bwd``)::

    dx         = dy · Ŵ
    ds[n, g]   = Σ_{k∈g} (dyᵀx)[n, k] · (q − z)[n, k]
    dz[n, g]   = −s[n, g] · Σ_{k∈g} (dyᵀx)[n, k]      (peqa_z only)

and the codes get none.  ``attention(impl="chunked")``'s backward is the
reference's ``_ca_bwd``: the flash-attention backward from the forward's
logsumexp, blocked over keys.  The autograd node is made only when grad
mode is on and an input requires grad: a serving call (no grad) takes the
forward alone, with the same launches and bits as before.  The backward's
products: Ŵ is dequantized in x's dtype; dx = dy·Ŵ multiplies those
operands exactly and sums in float32 (on the card a bf16 GEMM with a
float32 output, so no reduction rounds to bf16 whatever
``allow_bf16_reduced_precision_reduction`` says), then rounds to x's
dtype; c = dyᵀx is float32 — for bf16 operands on the card the exact bf16
products on the tensor cores with a float32 output (``qmm_grad_bound``
states what that costs against the reference's float32 CUDA-core product),
elsewhere a float32 product of the widened operands (full float32: TF32
stays off, PyTorch's default, which ``chip_smoke.py`` also sets).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch

from repro_torch.core.quant import (QuantSpec, unpack_codes,
                                    unpack_codes_planes)
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rtn_pack as _rp
from repro_torch.kernels.quant_matmul import GEMV_MAX_M

__all__ = ["ATTN_IMPLS", "GEMV_MAX_M", "KERNELS", "KNOWN_IMPLS", "attention",
           "chunked_attention_bwd", "default_impl", "dot_f32",
           "dot_f32_experts", "force_impl", "in_kernel", "kernel_region",
           "qmm_grad_bound", "quant_matmul",
           "quant_matmul_bwd", "quant_matmul_experts",
           "quant_matmul_experts_bwd", "quant_matmul_slotted", "rtn_pack"]

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


@contextlib.contextmanager
def kernel_region():
    """Mark the forward of a kernel op (K1, K2 and their plane and expert
    forms, K4) within its scope, this thread only.  On the card a kernel
    is a launch the dispatcher never sees; its plain version on the CPU is
    dispatched matmuls.  ``in_kernel`` lets ``remat="dots"`` treat both
    alike — as the reference's ``checkpoint_dots`` treats a custom VJP
    over a ``pallas_call`` — and recompute the op rather than save its
    products."""
    _tls.kernel = getattr(_tls, "kernel", 0) + 1
    try:
        yield
    finally:
        _tls.kernel -= 1


def in_kernel() -> bool:
    """True within a kernel op's forward (``kernel_region``)."""
    return getattr(_tls, "kernel", 0) > 0


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


def _grad_wanted(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, spec: QuantSpec, *,
                 draft_bits: Optional[int] = None) -> torch.Tensor:
    """y = x @ Ŵᵀ for arbitrary leading batch dims on x; y in x's dtype,
    through ``default_impl()``.  Differentiable in (x, scale, zero) when
    grad mode is on (``_QuantMatmul``); the codes are frozen.

    Bit-plane specs read the top ``spec.bits`` planes of qw (bits', N,
    K/32).  ``draft_bits`` = p < ``spec.bits`` = b is the self-speculative
    draft: the top p planes under the draft's scales, scale·2^(b−p) and
    zero/2^(b−p) (``core.quant.draft_scales``; the reference passes a
    rescaled tree and a p-bit spec instead, the values are the same).  It
    is forward only, as in the reference: with grad wanted it raises."""
    planes = _layout(qw, spec, draft_bits)
    lead = x.shape[:-1]
    x2d = _rows(x)
    if _grad_wanted(x2d, scale, zero):
        if draft_bits is not None:
            raise ValueError("the speculative draft (draft_bits) is forward "
                             "only: call it under torch.no_grad()")
        y = _QuantMatmul.apply(x2d, qw, scale, zero, spec)
    else:
        y = _qmm_forward(x2d, qw, scale, zero, planes)
    return y.reshape(*lead, y.shape[-1])


def _qmm_forward(x2d, qw, scale, zero, planes) -> torch.Tensor:
    """The forward dispatch: (M, K) → (M, N) in x's dtype."""
    impl = default_impl()
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
    with kernel_region():
        if impl == "torch":
            return plain(x2d, qw, scale, zero)
        if x2d.shape[0] <= GEMV_MAX_M:
            return gemv(x2d, qw, scale, zero)
        return gemm(x2d, qw, scale, zero)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b summed in float32 with a float32 result: on the card bf16
    operands go to the tensor cores as they are (their products are exact
    in float32); otherwise both are widened to float32 first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_mm_f32`` over a leading batch axis: a (E, M, K) · b (E, K, N)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x·wᵀ in float32 for x (..., K) and w (N, K) of x's dtype — the
    reference's einsum with bf16 (or f32) operands and
    ``preferred_element_type=float32``: the products of the operands as
    they are, summed in float32 (``_mm_f32``; on the card a bf16 GEMM
    with a float32 output, which reads w once).  The tied head (w the
    token table) and every fp linear (``models.linear.apply``) take it.
    Differentiable in both (``_DotF32``)."""
    y = _DotF32.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[0])


class _DotF32(torch.autograd.Function):
    """``dot_f32``'s backward in float32, as the reference differentiates
    its float32-output dot: dx = dy·w rounded to x's dtype, and dw =
    dyᵀ·x rounded to w's (the reference's cotangent of its cast operand;
    the cast back to a float32 master weight is autograd's)."""

    @staticmethod
    def forward(ctx, x2d, w):
        ctx.save_for_backward(x2d, w)
        return _mm_f32(x2d, w.T)

    @staticmethod
    def backward(ctx, dy):
        x2d, w = ctx.saved_tensors
        dy = dy.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(dy, w.to(torch.float32)).to(x2d.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(dy.T, x2d.to(torch.float32)).to(w.dtype)
        return dx, dw


def dot_f32_experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dot_f32`` for each expert of an MoE block: x (E, C, K) · w (E, N,
    K)ᵀ → (E, C, N) float32 (the reference's fp einsum under ``jax.vmap``).
    Differentiable in both."""
    return _DotF32Experts.apply(x, w)


class _DotF32Experts(torch.autograd.Function):
    """``_DotF32`` batched over the expert axis."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _bmm_f32(x, w.transpose(1, 2))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(dy, w.to(torch.float32)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.bmm(dy.transpose(1, 2), x.to(torch.float32)).to(w.dtype)
        return dx, dw


def _codes_f32(qw, k: int, spec: QuantSpec, g: int) -> torch.Tensor:
    """The codes (N, G, K/G) in float32, nibbles or bit-planes (…, N rows
    flattened into one axis: (bits', E, N, K/32) planes give (E·N, G,
    K/G))."""
    codes = unpack_codes_planes(qw, k, spec.bits) if spec.plane \
        else unpack_codes(qw, k)
    return codes.to(torch.float32).reshape(-1, g, k // g)


def quant_matmul_bwd(x2d, qw, scale, zero, spec: QuantSpec, dy,
                     need=(True, True, True)):
    """The reference's ``_qmm_bwd`` (ops.py:140): (dx, ds, dz) for
    y = x·Ŵᵀ, x (M, K), dy (M, N); ``need`` says which of the three to
    compute (None for the others).  dx in x's dtype, ds and dz in scale's
    and zero's."""
    k = x2d.shape[-1]
    n, g = scale.shape
    dx = ds = dz = None
    if need[0]:
        w = _ref.dequant_ref(qw, scale, zero, (n, k), spec, x2d.dtype)
        dx = _mm_f32(dy.to(x2d.dtype), w).to(x2d.dtype)
    if need[1] or need[2]:
        c = _mm_f32(dy.to(x2d.dtype).T, x2d).reshape(n, g, k // g)
        if need[1]:
            zf = zero.to(torch.float32)[..., None]
            ds = (c * (_codes_f32(qw, k, spec, g) - zf)).sum(-1).to(
                scale.dtype)
        if need[2]:
            dz = (-scale.to(torch.float32) * c.sum(-1)).to(zero.dtype)
    return dx, ds, dz


def qmm_grad_bound(x2d, qw, scale, zero, spec: QuantSpec, dy):
    """Elementwise bounds (on ds, on dz) on the distance between the
    backward's scale and zero gradients as computed here, for the same
    (x, dy), and the reference's (float32 c = dyᵀx, then the group sums).

    u = 2⁻²⁴.  c[n, k] is an M-long float32 sum of exact products (bf16 or
    f32 operands widened: exact in either case for bf16; for f32 operands
    each product rounds once): the reference's is within (M + 1)·u·C of
    the exact c, with C[n, k] = Σ_m |dy[m, n]·x[m, k]|; the tensor cores'
    (bf16 on the card) accumulate without a promise of rounding to nearest,
    u_t = 2u, so within M·u_t·C.  Then ds = Σ_{k∈g} c·(q − z) adds n_g + 2
    roundings (the subtraction, the product, n_g = K/G additions) on terms
    bounded by |c|·(q + |z|), and dz = −s·Σ c adds n_g + 1 on |c|.  So
    |Δds| ≤ Σ_{k∈g} ((3·M + 2)·u·C + 2·(n_g + 2)·u·|c|)·(q + |z|) —
    both sides' rounding counted — and |Δdz| ≤ |s|·Σ_{k∈g} ((3·M + 2)·u·C
    + 2·(n_g + 1)·u·|c|).  Returns float32 (N, G) tensors."""
    u = 2.0 ** -24
    k = x2d.shape[-1]
    n, g = scale.shape
    ng = k // g
    dyf, xf = dy.to(torch.float32), x2d.to(torch.float32)
    cmag = (dyf.abs().T @ xf.abs()).reshape(n, g, ng)
    c = (dyf.T @ xf).abs().reshape(n, g, ng)
    m = x2d.shape[0]
    qz = _codes_f32(qw, k, spec, g) + zero.to(torch.float32).abs()[..., None]
    base = (3 * m + 2) * u * cmag
    ds = ((base + 2 * (ng + 2) * u * c) * qz).sum(-1)
    dz = scale.to(torch.float32).abs() * (base + 2 * (ng + 1) * u * c).sum(-1)
    return ds, dz


class _QuantMatmul(torch.autograd.Function):
    """quant_matmul with the reference's analytic backward: the forward is
    ``_qmm_forward`` (the kernels), the backward ``quant_matmul_bwd``."""

    @staticmethod
    def forward(ctx, x2d, qw, scale, zero, spec):
        ctx.spec = spec
        ctx.save_for_backward(x2d, qw, scale, zero)
        return _qmm_forward(x2d, qw, scale, zero, _layout(qw, spec, None))

    @staticmethod
    def backward(ctx, dy):
        x2d, qw, scale, zero = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], ctx.needs_input_grad[2],
                ctx.needs_input_grad[3])
        dx, ds, dz = quant_matmul_bwd(x2d, qw, scale, zero, ctx.spec, dy,
                                      need)
        return dx, None, ds, dz, None


def quant_matmul_experts(x: torch.Tensor, qw: torch.Tensor,
                         scale: torch.Tensor, zero: torch.Tensor,
                         spec: QuantSpec) -> torch.Tensor:
    """y[e] = x[e] @ Ŵ[e]ᵀ over an MoE block's stacked experts: x (E, C, K),
    qw (E, N, K/8) nibble words or (E, bits', N, K/32) bit-planes (the
    reference's per-expert (bits, N, K/32) under ``jax.vmap``; the top
    ``spec.bits`` planes are read), scale and zero (E, N, G) → (E, C, N) in
    x's dtype, through ``default_impl()``.  The reference calls
    ``quant_matmul`` under ``jax.vmap`` over the experts, so its dispatch
    rule applies to each vmapped call of C rows: C ≤ ``GEMV_MAX_M`` takes
    the expert-axis GEMV (K1, or K1-plane), more rows the expert-axis GEMM
    (K2, or K2-plane) — one launch for all E experts either way (every
    expert has the same C rows: the capacity dispatch pads empty slots with
    zero rows).  Differentiable in (x, scale, zero) when grad mode is on
    (``_QuantMatmulExperts``, the reference's ``_qmm_bwd`` for each
    expert); the codes are frozen.

    The expert axis is named by this entry point, never inferred from qw's
    rank (a 2-D linear's bit-plane buffer is 3-D too).  One task's scales
    and every stored plane's precision: the MoE block has no slotted or
    verify step, so no draft read."""
    bits = _expert_planes(qw, spec)
    x = x.contiguous()
    if x.data_ptr() % 16:                # a view starting mid-vector
        x = x.clone()
    if _grad_wanted(x, scale, zero):
        return _QuantMatmulExperts.apply(x, qw, scale, zero, spec)
    return _qmm_experts_forward(x, qw, scale, zero, bits)


def _expert_planes(qw: torch.Tensor, spec: QuantSpec):
    """The planes an expert stack's forward reads (``spec.bits``), None for
    nibbles; refuses a buffer that does not hold them."""
    spec.check_ported()
    if not spec.plane:
        return None
    if qw.dim() != 4 or not spec.bits <= qw.shape[1]:
        raise ValueError(f"cannot read {spec.bits} planes of an expert "
                         f"stack of shape {tuple(qw.shape)} (need (E, "
                         f"bits' >= {spec.bits}, N, K/32))")
    return spec.bits


def _qmm_experts_forward(x, qw, scale, zero, bits=None) -> torch.Tensor:
    """The expert-axis forward dispatch: (E, C, K) → (E, C, N); ``bits``:
    qw holds bit-planes, of which the top ``bits`` are read."""
    scale = scale.to(torch.float32).contiguous()
    zero = zero.to(torch.float32).contiguous()
    if bits is None:
        plain, gemv, gemm = (_qm.quant_matmul_experts_plain,
                             _qm.quant_gemv_experts, _qm.quant_matmul_experts)
    else:
        plain, gemv, gemm = (
            functools.partial(f, bits=bits)
            for f in (_qm.quant_matmul_experts_planes_plain,
                      _qm.quant_gemv_experts_planes,
                      _qm.quant_matmul_experts_planes))
    with kernel_region():
        if default_impl() == "torch":
            return plain(x, qw, scale, zero)
        if x.shape[1] <= GEMV_MAX_M:
            return gemv(x, qw, scale, zero)
        return gemm(x, qw, scale, zero)


def quant_matmul_experts_bwd(x, qw, scale, zero, spec: QuantSpec, dy,
                             need=(True, True, True)):
    """``quant_matmul_bwd`` for each expert, batched over the expert axis:
    x (E, C, K), dy (E, C, N) → (dx, ds, dz) with the same products and
    sums per expert (Ŵ dequantized in x's dtype, dx = dy·Ŵ and c = dyᵀx
    summed in float32)."""
    e, _, k = x.shape
    n, g = scale.shape[-2:]
    # the stack's codes as one 2-D linear's of E·N rows: nibble words (E·N,
    # K/8), or the planes axis first, (bits', E, N, K/32) — a view
    flat = qw.transpose(0, 1) if spec.plane else qw.reshape(e * n, -1)
    dx = ds = dz = None
    if need[0]:
        w = _ref.dequant_ref(flat, scale.reshape(e * n, g),
                             zero.reshape(e * n, g), (e * n, k), spec,
                             x.dtype).reshape(e, n, k)
        dx = _bmm_f32(dy.to(x.dtype), w).to(x.dtype)
    if need[1] or need[2]:
        c = _bmm_f32(dy.to(x.dtype).transpose(1, 2), x).reshape(
            e, n, g, k // g)
        if need[1]:
            codes = _codes_f32(flat, k, spec, g)
            zf = zero.to(torch.float32)[..., None]
            ds = (c * (codes.reshape(e, n, g, k // g) - zf)).sum(-1).to(
                scale.dtype)
        if need[2]:
            dz = (-scale.to(torch.float32) * c.sum(-1)).to(zero.dtype)
    return dx, ds, dz


class _QuantMatmulExperts(torch.autograd.Function):
    """``quant_matmul_experts`` with the reference's analytic backward for
    each expert: the forward is ``_qmm_experts_forward`` (the expert-axis
    kernels), the backward ``quant_matmul_experts_bwd``."""

    @staticmethod
    def forward(ctx, x, qw, scale, zero, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, qw, scale, zero)
        return _qmm_experts_forward(x, qw, scale, zero,
                                    _expert_planes(qw, spec))

    @staticmethod
    def backward(ctx, dy):
        x, qw, scale, zero = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], ctx.needs_input_grad[2],
                ctx.needs_input_grad[3])
        dx, ds, dz = quant_matmul_experts_bwd(x, qw, scale, zero, ctx.spec,
                                              dy, need)
        return dx, None, ds, dz, None


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
                     dense path is XLA, not Pallas), differentiated by
                     autograd;
    impl='chunked' — K4, the online-softmax kernel, on CUDA tensors; its
                     plain version on CPU tensors or under
                     ``force_impl("torch")``.  With grad wanted the call
                     goes through ``_ChunkedAttention``: the forward also
                     returns the rows' logsumexp, and the backward is the
                     reference's ``_ca_bwd``."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: "
                         f"{', '.join(ATTN_IMPLS)}")
    if impl == "dense":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        scale=scale, offset=offset)
    if _grad_wanted(q, k, v):
        return _ChunkedAttention.apply(q, k, v, causal, window, scale, offset)
    return _chunked_forward(q, k, v, causal, window, scale, offset, False)


def _chunked_forward(q, k, v, causal, window, scale, offset, return_lse):
    fn = _fa.flash_attention if default_impl() == "cuda" \
        else _ref.flash_attention_ref
    with kernel_region():
        return fn(q, k, v, causal=causal, window=window, scale=scale,
                  offset=offset, return_lse=return_lse)


# the reference's key block for the chunked scan (chunked_attention.py:23)
CHUNK_BLOCK = 1024


def _pick_block(sk: int, block: int) -> int:
    """Largest divisor of sk that is ≤ block (the reference's rule)."""
    block = min(block, sk)
    while sk % block:
        block -= 1
    return block


def chunked_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                          scale=None, offset=None, block=CHUNK_BLOCK):
    """The reference's ``_ca_bwd`` (chunked_attention.py:114) in float32:
    with P = e^(scale·q·kᵀ − lse) over the visible keys and
    Δ = rowsum(dO·O), dV = Pᵀ·dO, dS = P·(dO·Vᵀ − Δ), dQ = dS·K·scale,
    dK = dSᵀ·(scale·Q); keys in blocks of ``_pick_block(Sk, block)``,
    GQA by summing each KV head's query group.  lse (B, Hq, Sq); a row
    that sees no key (lse −inf) gets a zero gradient.  Returns (dq, dk,
    dv) in q's, k's and v's dtypes."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    bk = _pick_block(sk, block)
    qf = (q.to(torch.float32) * scale).reshape(b, sq, hkv, rep, d)
    dof = do.to(torch.float32).reshape(b, sq, hkv, rep, d
                                       ).permute(0, 2, 3, 1, 4)
    of = o.to(torch.float32).reshape(b, sq, hkv, rep, d
                                     ).permute(0, 2, 3, 1, 4)
    delta = (dof * of).sum(-1)                          # (b, hkv, rep, sq)
    lse = lse.reshape(b, hkv, rep, sq)
    seen = torch.isfinite(lse)[..., None]
    mask = _ref.visible(b, sq, sk, causal, window, offset, q.device)
    mask = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dq = torch.zeros((b, sq, hkv, rep, d), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for j0 in range(0, sk, bk):
        kb, vb = kf[:, j0:j0 + bk], vf[:, j0:j0 + bk]
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qf, kb)
        vis = mask[..., j0:j0 + bk] & seen
        p = torch.where(vis, torch.exp(logits - lse[..., None]),
                        torch.zeros((), device=q.device))
        dp = torch.einsum("bhrqd,bkhd->bhrqk", dof, vb)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bhrqk,bkhd->bqhrd", ds, kb) * scale
        dks.append(torch.einsum("bhrqk,bqhrd->bkhd", ds, qf))
        dvs.append(torch.einsum("bhrqk,bhrqd->bkhd", p, dof))
    return (dq.reshape(b, sq, hq, d).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _ChunkedAttention(torch.autograd.Function):
    """``attention(impl="chunked")`` with the reference's custom VJP: K4
    (or its plain version) with the logsumexp forward, the blocked
    ``chunked_attention_bwd`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, offset):
        o, lse = _chunked_forward(q, k, v, causal, window, scale, offset,
                                  True)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        offset=offset)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = chunked_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None
