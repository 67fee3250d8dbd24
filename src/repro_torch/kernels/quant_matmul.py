"""Fused 4-bit dequant + matmul: the hand-written CUDA kernels and their
plain PyTorch versions.

  * ``quant_gemv``   — K1, decode-shaped (M ≤ 32 rows), ``csrc/quant_gemv.cu``;
                       replaces ``repro/kernels/quant_matmul.py::quant_gemv_pallas``.
                       Two routes behind it, as for K2 (``tc_route``): bf16 x
                       at whole 64-code blocks and groups takes mma.sync on
                       the same factored sum, K split over the 8 warps of
                       each of ``gemv_block_split`` blocks (``gemv_segments``;
                       emulation ``quant_gemv_factored_plain``); f32 x and
                       other shapes a SIMT f32 GEMV whose K chunk is the
                       same at every M.  Either way a row's result does not
                       depend on M: a verify of k+1 tokens gives the bits of
                       k+1 decode steps.
  * ``quant_matmul`` — K2, the tiled GEMM for prefill, ``csrc/quant_matmul.cu``;
                       replaces ``repro/kernels/quant_matmul.py::quant_matmul_pallas``.
                       Two routes behind it (``tc_route``): bf16 x with K and
                       the group size multiples of 64 (every llama3.2-1b
                       linear) take the tensor cores (wgmma) on the factored
                       sum Σ_g s·(Σ x·q − z·Σ x), whose emulation is
                       ``quant_matmul_factored_plain``; f32 x and other shapes
                       take a SIMT f32 GEMM.
  * ``quant_gemv_tasks`` — K5, K1 with per-row task scales, ``csrc/quant_gemv.cu``;
                       replaces ``quant_gemv_pallas`` called with ``task_ids``.
  * ``quant_gemv_planes``, ``quant_gemv_tasks_planes``, ``quant_matmul_planes``
                     — K6a, the bit-plane branch of K1, K5 and K2 (the same
                       sources); replaces ``_unpack_planes`` / ``_qw_layout``
                       of ``repro/kernels/quant_matmul.py``.
  * ``quant_gemv_experts``, ``quant_matmul_experts``
                     — K1 and K2 over an expert axis (the same sources, the
                       experts on the grid's z axis); replaces
                       ``quant_gemv_pallas`` and ``quant_matmul_pallas``
                       under ``jax.vmap`` over an MoE block's experts
                       (``repro/models/moe.py``, the vmapped MLP).  Slice e of
                       one launch is bit for bit the 2-D kernel on expert
                       e's operands; their plain version
                       ``quant_matmul_experts_plain`` is ``quant_matmul_plain``
                       on each expert in turn.
  * ``quant_gemv_experts_planes``, ``quant_matmul_experts_planes``
                     — their bit-plane forms (K1-plane and K2-plane over the
                       expert axis): qw (E, bits', N, K/32), each expert's
                       top ``bits`` planes read; replaces the plane branch
                       of ``quant_gemv_pallas`` and ``quant_matmul_pallas``
                       under the same ``jax.vmap``.  Slice e is bit for bit
                       the 2-D plane kernel on expert e's operands;
                       ``quant_matmul_experts_planes_plain`` is
                       ``quant_matmul_planes_plain`` on each expert in turn.
  * ``quant_matmul_plain`` — ``x.float() @ dequant_f32(qw, s, z).T → x.dtype``,
                       the semantics of the TPU kernels and of
                       ``ref.quant_matmul_ref``; ``quant_matmul_tasks_plain``
                       runs it once per task present and selects rows; the
                       ``*_planes_plain`` versions read bit-planes.

Operands: x (M, K) bf16 or f32; qw (N, K/8) int32 words, each the bits of the
reference's uint32 (8 nibble codes, code i in bits 4i..4i+3); scale and zero
(N, G) f32 with G | K — for K5 (T, N, G) stacks and task_ids (M,) int32; the
result is (M, N) in x's dtype.  K5's row i is bit for bit K1's row i under
``scale[task_ids[i]]``; task ids are validated by the caller on the host
(``train.serve.Engine``), the kernel only clamps them into the stack.

K6a takes qw (bits', N, K/32) int32 bit-planes (MSB plane first, code i in
bit i of its word, K % 32 == 0) and reads only the top ``bits`` ≤ bits'
planes — with ``bits`` < bits' the low-bit draft, a prefix of the target's
buffer.  ``shift`` = b − p applies the draft's rescale scale·2^shift,
zero / 2^shift (``core.quant.draft_scales``; exact, powers of two) as the
scales are read, so no rescaled copy exists.  Each plane kernel is bit for
bit its nibble kernel on the nibble words of ``q >> (bits' − bits)`` under
the rescaled scales: it rebuilds those words from the planes as it loads
them.

The GEMV's forms (K1, K5, K1-plane, K5-plane) share its two routes; the
route follows from x's dtype and the shapes alone.

A wrapper given CPU tensors returns the plain version; given CUDA tensors it
launches its kernel or raises.  Each wrapper counts its launches in the
integer attribute ``launches`` (incremented only where the kernel launches).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quant import (PACK, PLANE_PACK, QuantSpec, unpack_codes,
                                    unpack_codes_planes)
from repro_torch.kernels import _build, ref

GEMV_MAX_M = 32
# K2's tensor-core route works in tiles of 64 codes, each product in k-steps
# of 16 (csrc/quant_matmul.cu); so does the GEMV's (csrc/quant_gemv.cu),
# whose 8 warps a block, in clusters of up to 4 blocks over a 16-channel
# tile, split K into slices of whole 64-code blocks
TC_TILE_K, TC_K_STEP = 64, 16
GEMV_KSPLIT, GEMV_MAX_SPLIT, GEMV_FILL_BLOCKS = 8, 4, 264
GEMV_MIN_WARP_BLOCKS = 8
# codes the kernels rebuild into nibble words: at most 4 planes; a draft
# rescale factor 2^shift with shift < 8
MAX_PLANES, MAX_SHIFT = 4, 7
_DTYPES = (torch.bfloat16, torch.float32)
_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point → (library, argument types)
_ENTRIES = {
    "quant_gemv": ("quant_gemv", [_P] * 5 + [_I] * 5 + [_P]),
    "quant_matmul": ("quant_matmul", [_P] * 5 + [_I] * 5 + [_P]),
    "quant_gemv_tasks": ("quant_gemv", [_P] * 6 + [_I] * 6 + [_P]),
    "quant_gemv_planes": ("quant_gemv", [_P] * 5 + [_I] * 7 + [_P]),
    "quant_matmul_planes": ("quant_matmul", [_P] * 5 + [_I] * 7 + [_P]),
    "quant_gemv_tasks_planes": ("quant_gemv", [_P] * 6 + [_I] * 8 + [_P]),
    "quant_matmul_tc_smem": ("quant_matmul", [_I]),
    "quant_gemv_tc_split": ("quant_gemv", [_I, _I]),
    "quant_gemv_experts": ("quant_gemv", [_P] * 5 + [_I] * 6 + [_P]),
    "quant_matmul_experts": ("quant_matmul", [_P] * 5 + [_I] * 6 + [_P]),
    "quant_gemv_experts_planes": ("quant_gemv", [_P] * 5 + [_I] * 8 + [_P]),
    "quant_matmul_experts_planes": ("quant_matmul",
                                    [_P] * 5 + [_I] * 8 + [_P]),
}
_entries: dict = {}


def _dequant_f32(qw, scale, zero, k, planes=None):
    """Ŵ (N, K) in float32 from nibble words, or with ``planes = (bits,
    shift)`` from the top ``bits`` planes under scale·2^shift, zero/2^shift
    (the reference's draft rescale: ``scale * f``, ``zero / f``)."""
    if planes is None:
        return ref.dequant_ref(qw, scale, zero, (qw.shape[0], k), QuantSpec(),
                               torch.float32)
    bits, shift = planes
    f = float(1 << shift)
    return ref.dequant_ref(qw, scale * f, zero / f, (qw.shape[1], k),
                           QuantSpec(bits=bits, layout="plane"), torch.float32)


def quant_matmul_plain(x, qw, scale, zero):
    """The plain version of K1 and K2: f32 dequantize, f32 matmul."""
    w = _dequant_f32(qw, scale, zero, x.shape[-1])
    return torch.matmul(x.to(torch.float32), w.T).to(x.dtype)


def quant_matmul_experts_plain(x, qw, scale, zero):
    """The plain version of the expert-axis K1 and K2: x (E, C, K), qw (E,
    N, K/8), scale and zero (E, N, G) → (E, C, N), ``quant_matmul_plain``
    on each expert in turn."""
    return torch.stack([quant_matmul_plain(x[e], qw[e], scale[e], zero[e])
                        for e in range(x.shape[0])])


def quant_matmul_experts_planes_plain(x, qw, scale, zero, bits):
    """The plain version of the expert-axis plane kernels: x (E, C, K), qw
    (E, bits', N, K/32), scale and zero (E, N, G) → (E, C, N),
    ``quant_matmul_planes_plain`` on each expert's top ``bits`` planes in
    turn."""
    return torch.stack([quant_matmul_planes_plain(x[e], qw[e], scale[e],
                                                  zero[e], bits)
                        for e in range(x.shape[0])])


def tc_route(x, scale) -> bool:
    """True when K2, the GEMV (K1, K5) and their plane forms take the
    tensor-core route for x and scale (N, G): bf16 x, K % 64 == 0 and a
    group size K/G that is a multiple of 64 — whole 64-code tiles in whole
    groups."""
    k, g = x.shape[-1], scale.shape[-1]
    return (x.dtype == torch.bfloat16 and k % TC_TILE_K == 0
            and (k // g) % TC_TILE_K == 0)


def _codes_scales(qw, scale, zero, k, planes=None):
    """(codes (N, K) f32, scale, zero) as a kernel reads them: nibbles, or
    the top ``bits`` planes under scale·2^shift, zero/2^shift."""
    if planes is None:
        return unpack_codes(qw, k).to(torch.float32), scale, zero
    bits, shift = planes
    f = float(1 << shift)
    return (unpack_codes_planes(qw, k, bits).to(torch.float32), scale * f,
            zero / f)


def quant_matmul_factored_plain(x, qw, scale, zero, planes=None):
    """An emulation of K2's tensor-core route (feeds only the tests and
    ``chip_smoke.py``): per group g, A = Σ x·q and R = Σ x accumulated in
    f32 one k-step of ``TC_K_STEP`` codes at a time (bf16 x and 4-bit codes are
    exact in f32, so is every product), then y += s·(A − z·R) in f32.
    ``planes = (bits, shift)`` reads qw as K6a does."""
    m, k = x.shape
    q, s, z = _codes_scales(qw, scale, zero, k, planes)
    xf = x.to(torch.float32)
    g = s.shape[1]
    gs = k // g
    out = torch.zeros((m, q.shape[0]), dtype=torch.float32, device=x.device)
    for gi in range(g):
        a = torch.zeros_like(out)
        r = torch.zeros((m, 1), dtype=torch.float32, device=x.device)
        for k0 in range(gi * gs, (gi + 1) * gs, TC_K_STEP):
            k1 = min(k0 + TC_K_STEP, (gi + 1) * gs)
            a = a + xf[:, k0:k1] @ q[:, k0:k1].T
            r = r + xf[:, k0:k1].sum(dim=1, keepdim=True)
        out = out + s[:, gi] * (a - z[:, gi] * r)
    return out.to(x.dtype)


def gemv_block_split(n: int, k: int) -> int:
    """S, the blocks the tensor-core GEMV splits one 16-channel tile's K
    over (csrc/quant_gemv.cu ``tc_block_split``): enough to bring the grid
    to ``GEMV_FILL_BLOCKS`` (2 on each of an H100's 132 SMs), at most
    ``GEMV_MAX_SPLIT``, and at least ``GEMV_MIN_WARP_BLOCKS`` 64-code
    blocks for every warp.  It depends on (N, K) only."""
    s = min(GEMV_FILL_BLOCKS // -(-n // 16), GEMV_MAX_SPLIT,
            k // TC_TILE_K // (GEMV_KSPLIT * GEMV_MIN_WARP_BLOCKS))
    return max(s, 1)


def gemv_segments(n: int, k: int, g: int) -> list:
    """The tensor-core GEMV's K schedule for an (N, K) layer in G groups:
    per slice i of the W = ``GEMV_KSPLIT`` · ``gemv_block_split(n, k)``
    (warp i % 8 of block rank i // 8), 64-code blocks [i·nb/W,
    (i+1)·nb/W) of nb = K/64, cut at group boundaries, as a list of
    (slice, k0, k1, group) pieces in the kernel's order.  It depends on
    (N, K, G) only."""
    nb, gs = k // TC_TILE_K, k // g
    slices = GEMV_KSPLIT * gemv_block_split(n, k)
    out = []
    for w in range(slices):
        b0, b1 = w * nb // slices, (w + 1) * nb // slices
        k0, end = b0 * TC_TILE_K, b1 * TC_TILE_K
        while k0 < end:
            k1 = min(end, (k0 // gs + 1) * gs)
            out.append((w, k0, k1, k0 // gs))
            k0 = k1
    return out


def quant_gemv_factored_plain(x, qw, scale, zero, task_ids=None,
                              planes=None):
    """An emulation of the tensor-core GEMV (feeds only the tests and
    ``chip_smoke.py``): the ``gemv_segments`` schedule, each k-step's 16
    exact products summed exactly (float64) and rounded to float32, the
    k-steps of a piece summed in f32 into A = Σ x·q and R = Σ x, the slice's
    y += s·(A − z·R) under each row's scales (with ``task_ids``: scale and
    zero are (T, N, G) stacks, row i under task ``task_ids[i]``), then the
    slices' y summed in slice order.  Every op is elementwise over rows, so
    row i does not depend on the other rows.  ``planes = (bits, shift)``
    reads qw as K6a does."""
    m, k = x.shape
    if task_ids is None:
        q, s, z = _codes_scales(qw, scale, zero, k, planes)
        s, z = s[None], z[None]
    else:
        q, s, z = _codes_scales(qw, scale, zero, k, planes)
        s, z = s[task_ids.long()], z[task_ids.long()]
    n, g = q.shape[0], s.shape[-1]
    xd = x.to(torch.float64).reshape(m, k // TC_K_STEP, TC_K_STEP)
    steps = torch.einsum("msk,nsk->mns", xd, q.to(torch.float64).reshape(
        n, k // TC_K_STEP, TC_K_STEP)).to(torch.float32)
    rsteps = xd.sum(-1).to(torch.float32)                     # (M, K/16)
    ys = {}
    for w, k0, k1, gi in gemv_segments(n, k, g):
        a = torch.zeros((m, n), dtype=torch.float32, device=x.device)
        r = torch.zeros((m, 1), dtype=torch.float32, device=x.device)
        for st in range(k0 // TC_K_STEP, k1 // TC_K_STEP):
            a = a + steps[:, :, st]
            r = r + rsteps[:, st:st + 1]
        term = s[..., gi] * (a - z[..., gi] * r)
        ys[w] = term if w not in ys else ys[w] + term
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for w in sorted(ys):
        y = y + ys[w]
    return y.to(x.dtype)


def quant_matmul_planes_plain(x, qw, scale, zero, bits, shift=0):
    """The plain version of K6a's GEMV and GEMM: the top ``bits`` planes of
    qw, dequantized in f32 under the draft rescale, f32 matmul."""
    w = _dequant_f32(qw, scale, zero, x.shape[-1], (bits, shift))
    return torch.matmul(x.to(torch.float32), w.T).to(x.dtype)


def per_task(fn, x, qw, scale_stack, zero_stack, task_ids):
    """Mixed-task y[i] = fn under task ``task_ids[i]``'s scales: ``fn`` runs
    once per task present on all M rows, and a select keeps each row from
    its own task's result — so every row is bit for bit ``fn``'s row under
    its task.  Reads the distinct ids on the host (a sync for CUDA ids)."""
    n_tasks = scale_stack.shape[0]
    y = None
    for t in torch.unique(task_ids).tolist():
        if not 0 <= t < n_tasks:
            raise ValueError(f"task id {t} outside the stack of {n_tasks}")
        yt = fn(x, qw, scale_stack[t], zero_stack[t])
        y = yt if y is None else torch.where((task_ids == t)[:, None], yt, y)
    return y


def quant_matmul_tasks_plain(x, qw, scale_stack, zero_stack, task_ids):
    """The plain version of K5: the plain matmul per task present, rows
    selected (the reference's xla branch of ``quant_matmul_slotted``)."""
    return per_task(quant_matmul_plain, x, qw, scale_stack, zero_stack,
                    task_ids)


def quant_matmul_tasks_planes_plain(x, qw, scale_stack, zero_stack, task_ids,
                                    bits, shift=0):
    """The plain version of K6a's task GEMV: the plain plane matmul per task
    present, rows selected."""
    return per_task(functools.partial(quant_matmul_planes_plain, bits=bits,
                                      shift=shift),
                    x, qw, scale_stack, zero_stack, task_ids)


def error_bound(x, qw, scale, zero, plain, task_ids=None, planes=None,
                factored=False, gemv=False):
    """Elementwise bound on |kernel − plain| for the same inputs (with
    ``task_ids``: scale and zero are (T, N, G) stacks, row i under task
    ``task_ids[i]``; with ``planes = (bits, shift)``: qw is bit-planes read
    as K6a reads them; ``factored``: the kernel is K2's tensor-core route,
    ``tc_route``, or its emulation ``quant_matmul_factored_plain``).

    u = 2⁻²⁴ (f32, round to nearest).  Not factored (K1, K5, K2's SIMT
    route): both sum the same float32 products s·(q − z)·x in different
    orders, so each is within K·u·Σₖ|x·ŵ| of the exact sum of those
    products (the standard recursive-summation bound); the bound on their
    difference is twice that.

    Factored: the kernel computes, per group g of n = K/G codes,
    A_g = Σ x·q and R_g = Σ x (exact products; tensor-core f32
    accumulation, which need not round to nearest, so u_t = 2⁻²³ each
    addition: |ΔA_g| ≤ n·u_t·Σ|x|·q, |ΔR_g| ≤ n·u_t·Σ|x|), then
    y = Σ_g s·(A_g − z·R_g) with at most G + 3 roundings on the way (the
    subtraction, the scaling and G additions).  With T = Σₖ |x|·|s|·(q +
    |z|) (s, z of k's group), the kernel is within (n·u_t + (G + 3)·u)·T
    of the exact y, and its round-to-nearest emulation
    ``quant_matmul_factored_plain`` within (n + G + 3)·u·T.  The plain
    version rounds ŵ = s·(q − z) twice (2u|ŵ|) and sums K products
    (K·u·Σ|x·ŵ|); |ŵ| ≤ |s|·(q + |z|), so it is within (K + 2)·u·T.  Any
    two of the three differ by at most (n·u_t + (K + 2·G + 6)·u)·T
    (n ≤ K), the bound returned: it grows with Σ|x|·(q + |z|)·s, not
    Σ|x·ŵ|, because the two sums are subtracted.  u_t stays 2⁻²³: no
    measurement here isolates the tensor cores' rounding.  On an H100
    (NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py`` phase ``kernels`` at
    the llama3.2-1b linears, M = 1024, bf16) the worst |kernel − plain|
    is 0.0156 on outputs of magnitude ≈ 4: one or two bf16 ulps, inside
    this bound.

    ``gemv`` (with ``factored``): the kernel is the GEMV's tensor-core
    route, ``quant_gemv_factored_plain`` its emulation.  Its K split cuts a
    group into pieces (``gemv_segments``: P pieces an output, each at most
    n codes), and the y of its W slices (``GEMV_KSPLIT`` warps in each of
    ``gemv_block_split`` blocks) are added at the end.  Per piece the same
    A, R and s·(A − z·R) as above; then P terms summed within the slices
    and W partial sums across them, at most P + W additions on any term's
    way: the kernel is within (n·u_t + (P + W + 3)·u)·T of the exact y, the
    emulation within (n + P + W + 3)·u·T (its k-step sums round once, from
    float64), and the bound returned is K2's with G replaced by P + W:
    (n·u_t + (K + 2·(P + W) + 6)·u)·T.  On an H100 (NVIDIA H100 80GB
    HBM3, 700 W; ``chip_smoke.py`` phase ``kernels``, the llama3.2-1b
    linears, M = 4 to 32, bf16) the worst |kernel − plain| is 0.0156
    (K1-plane, outputs of ≈ 4) and |kernel − emulation| 0.0078.

    A bf16 output adds one bf16 ulp of the larger result (rounding to 8
    significant bits can split two float32 sums across a rounding step).

    An expert axis (x (E, C, K), qw (E, N, K/8) or with ``planes`` (E,
    bits', N, K/32), scale and zero (E, N, G), plain (E, C, N)): each
    expert's bound, the same formula batched (every expert has the same N,
    K and G, so the same n, P, W and G).
    """
    if x.dim() == 3:
        return _error_bound_experts(x, qw, scale, zero, plain, factored,
                                    gemv, planes)
    if task_ids is not None:
        out = torch.empty(plain.shape, dtype=torch.float32,
                          device=plain.device)
        for t in torch.unique(task_ids).tolist():
            rows = task_ids == t
            out[rows] = error_bound(x[rows], qw, scale[t], zero[t],
                                    plain[rows], planes=planes,
                                    factored=factored, gemv=gemv)
        return out
    k = x.shape[-1]
    u = 2.0 ** -24
    xa = x.to(torch.float32).abs()
    if factored:
        q, s, z = _codes_scales(qw, scale, zero, k, planes)
        g = s.shape[1]
        n = k // g
        wt = (s.abs()[:, :, None] * (q.reshape(q.shape[0], g, n)
                                     + z.abs()[:, :, None])).reshape(q.shape)
        adds = (len(gemv_segments(q.shape[0], k, g)) + GEMV_KSPLIT
                * gemv_block_split(q.shape[0], k) if gemv else g)
        bound = (n * 2 * u + (k + 2 * adds + 6) * u) * (xa @ wt.T)
    else:
        w = _dequant_f32(qw, scale, zero, k, planes)
        bound = 2 * k * u * (xa @ w.abs().T)
    if plain.dtype == torch.bfloat16:
        mag = plain.to(torch.float32).abs() + bound
        ulp = torch.exp2(torch.floor(torch.log2(
            mag.clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        bound = bound + ulp
    return bound


def _expert_codes(qw, k: int, planes=None) -> torch.Tensor:
    """An expert stack's codes (E·N, K) uint8: nibble words (E, N, K/8), or
    with ``planes = (bits, shift)`` the top ``bits`` planes of (E, bits',
    N, K/32)."""
    if planes is None:
        return unpack_codes(qw.reshape(-1, qw.shape[-1]), k)
    return unpack_codes_planes(qw.transpose(0, 1), k, planes[0]).reshape(-1, k)


def _error_bound_experts(x, qw, scale, zero, plain, factored, gemv,
                         planes=None):
    """``error_bound`` over an expert axis, batched (nibble codes, or
    ``planes = (bits, 0)``)."""
    e, _, k = x.shape
    n, g = scale.shape[-2:]
    u = 2.0 ** -24
    xa = x.to(torch.float32).abs()
    if factored:
        q = _expert_codes(qw, k, planes).to(torch.float32)
        wt = (scale.abs()[..., None] * (q.reshape(e, n, g, k // g)
                                        + zero.abs()[..., None])
              ).reshape(e, n, k)
        del q
        adds = (len(gemv_segments(n, k, g)) + GEMV_KSPLIT
                * gemv_block_split(n, k) if gemv else g)
        coef = k // g * 2 * u + (k + 2 * adds + 6) * u
    else:
        q = _expert_codes(qw, k, planes).to(torch.float32)
        wt = (scale.reshape(e * n, g, 1) * (
            q.reshape(e * n, g, k // g) - zero.reshape(e * n, g, 1))
              ).abs().reshape(e, n, k)
        del q
        coef = 2 * k * u
    bound = coef * torch.bmm(xa, wt.transpose(1, 2))
    if plain.dtype == torch.bfloat16:
        mag = plain.to(torch.float32).abs() + bound
        ulp = torch.exp2(torch.floor(torch.log2(
            mag.clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        bound = bound + ulp
    return bound


def _check(x, qw, scale, zero, max_m=None, planes=None):
    """Raise on anything the kernels do not take (``planes = (bits,
    shift)``: qw is (bits', N, K/32) bit-planes)."""
    qdim, pack = (2, PACK) if planes is None else (3, PLANE_PACK)
    qshape = "(N, K/8)" if planes is None else "(bits', N, K/32)"
    if x.dim() != 2 or qw.dim() != qdim or scale.dim() != 2 or zero.dim() != 2:
        raise ValueError(
            f"need x (M, K), qw {qshape}, scale and zero (N, G); got "
            f"{tuple(x.shape)}, {tuple(qw.shape)}, {tuple(scale.shape)}, "
            f"{tuple(zero.shape)}")
    m, k = x.shape
    n = qw.shape[-2]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if qw.dtype != torch.int32:
        raise TypeError(f"qw must be int32 words, got {qw.dtype}")
    if scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise TypeError(f"scale and zero must be float32, got "
                        f"{scale.dtype}, {zero.dtype}")
    if m < 1 or k % pack or qw.shape[-1] != k // pack:
        raise ValueError(f"x {tuple(x.shape)} and qw {tuple(qw.shape)}: need "
                         f"M >= 1, K % {pack} == 0 and qw {qshape}")
    if planes is not None:
        bits, shift = planes
        if not 1 <= bits <= min(qw.shape[0], MAX_PLANES):
            raise ValueError(f"cannot read {bits} planes of a "
                             f"{qw.shape[0]}-plane buffer (at most "
                             f"{MAX_PLANES})")
        if not 0 <= shift <= MAX_SHIFT:
            raise ValueError(f"draft rescale shift {shift} outside "
                             f"[0, {MAX_SHIFT}]")
    g = scale.shape[1]
    if scale.shape != (n, g) or zero.shape != (n, g) or g < 1 or k % g:
        raise ValueError(f"scale {tuple(scale.shape)} / zero "
                         f"{tuple(zero.shape)} must be (N={n}, G) with G | K={k}")
    if max_m is not None and m > max_m:
        raise ValueError(f"the GEMV takes M <= {max_m} rows, got {m}")
    devs = {t.device for t in (x, qw, scale, zero)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if not all(t.is_contiguous() for t in (x, qw, scale, zero)):
        raise ValueError("operands must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernels "
                         "read it in 16-byte vectors)")


def _check_tasks(x, qw, scale_stack, zero_stack, task_ids, planes=None):
    """Raise on anything K5 does not take (shapes, dtypes, devices; the id
    values are the caller's to validate on the host)."""
    if scale_stack.dim() != 3 or zero_stack.dim() != 3:
        raise ValueError(f"need scale and zero stacks (T, N, G); got "
                         f"{tuple(scale_stack.shape)}, {tuple(zero_stack.shape)}")
    if scale_stack.shape != zero_stack.shape or scale_stack.shape[0] < 1:
        raise ValueError(f"scale stack {tuple(scale_stack.shape)} and zero "
                         f"stack {tuple(zero_stack.shape)} must match, T >= 1")
    if scale_stack.numel() >= 2 ** 31:
        raise ValueError(f"scale stack {tuple(scale_stack.shape)}: K5 indexes "
                         f"the stacks with 32-bit offsets (T·N·G < 2^31)")
    _check(x, qw, scale_stack[0], zero_stack[0], max_m=GEMV_MAX_M,
           planes=planes)
    if task_ids.dtype != torch.int32 or task_ids.dim() != 1:
        raise TypeError(f"task_ids must be (M,) int32, got {task_ids.dtype} "
                        f"{tuple(task_ids.shape)}")
    if task_ids.shape[0] != x.shape[0]:
        raise ValueError(f"task_ids has {task_ids.shape[0]} rows for "
                         f"{x.shape[0]} rows of x")
    if task_ids.device != x.device or scale_stack.device != x.device \
            or zero_stack.device != x.device:
        raise ValueError("task_ids and the stacks must be on x's device")
    if not (scale_stack.is_contiguous() and zero_stack.is_contiguous()
            and task_ids.is_contiguous()):
        raise ValueError("operands must be contiguous")


def _check_experts(x, qw, scale, zero, max_m=None, bits=None):
    """Raise on anything the expert-axis kernels do not take: x (E, C, K),
    qw (E, N, K/8) nibble words — or, with ``bits`` (the planes read), (E,
    bits', N, K/32) bit-planes —, scale and zero (E, N, G), each expert's
    slice what ``_check`` asks of a 2-D call."""
    qdim, qshape = (3, "(E, N, K/8)") if bits is None \
        else (4, "(E, bits', N, K/32)")
    if x.dim() != 3 or qw.dim() != qdim or scale.dim() != 3 \
            or zero.dim() != 3:
        raise ValueError(
            f"need x (E, C, K), qw {qshape}, scale and zero (E, N, G); "
            f"got {tuple(x.shape)}, {tuple(qw.shape)}, {tuple(scale.shape)}, "
            f"{tuple(zero.shape)}")
    e = x.shape[0]
    if not 1 <= e <= 65535 or any(t.shape[0] != e for t in (qw, scale, zero)):
        raise ValueError(f"x, qw, scale and zero need the same expert count "
                         f"1..65535; got {x.shape[0]}, {qw.shape[0]}, "
                         f"{scale.shape[0]}, {zero.shape[0]}")
    _check(x[0], qw[0], scale[0], zero[0], max_m=max_m,
           planes=None if bits is None else (bits, 0))
    if not all(t.is_contiguous() for t in (x, qw, scale, zero)):
        raise ValueError("operands must be contiguous")


def _entry(name: str):
    """The C entry point ``name``, typed once."""
    fn = _entries.get(name)
    if fn is None:
        lib, argtypes = _ENTRIES[name]
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def gemv_tc_split(n: int, k: int) -> int:
    """The tensor-core GEMV's K split over blocks for an (N, K) layer, as
    the built kernel computes it (``gemv_block_split`` mirrors it)."""
    return _entry("quant_gemv_tc_split")(n, k)


def tc_smem_bytes() -> dict:
    """Dynamic shared memory a block of K2's tensor-core route takes, per
    tile shape (set above the 48 KB default with cudaFuncSetAttribute)."""
    fn = _entry("quant_matmul_tc_smem")
    return {"128x256": fn(2), "128x128": fn(1), "64x64": fn(0)}


def _launch(name: str, x, qw, scale, zero, task_ids=None, planes=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    fn = _entry(name)
    m, k = x.shape
    n, g = scale.shape[-2], scale.shape[-1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ptrs = [x.data_ptr(), qw.data_ptr(), scale.data_ptr(), zero.data_ptr()]
    dims = [m, n, k, g]
    if task_ids is not None:
        ptrs.append(task_ids.data_ptr())
        dims.append(scale.shape[0])
    if planes is not None:
        dims.extend(planes)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, y.data_ptr(), *dims, int(x.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc} "
                           f"(M={m}, N={n}, K={k}, G={g}, {x.dtype}"
                           f"{'' if planes is None else f', planes {planes}'})")
    return y


def _launch_experts(name: str, x, qw, scale, zero, bits=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    fn = _entry(name)
    e, m, k = x.shape
    n, g = scale.shape[-2], scale.shape[-1]
    # the planes read and the planes each expert stores (its stride)
    planes = [] if bits is None else [bits, qw.shape[1]]
    y = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                zero.data_ptr(), y.data_ptr(), e, m, n, k, g, *planes,
                int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc} "
                           f"(E={e}, M={m}, N={n}, K={k}, G={g}, {x.dtype}"
                           f"{'' if bits is None else f', planes {planes}'})")
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


def quant_gemv_tasks(x, qw, scale_stack, zero_stack, task_ids):
    """K5: y[i] = x[i] @ Ŵ(task_ids[i])ᵀ for M ≤ 32 rows, scale and zero
    (T, N, G) stacks (the mixed-task decode GEMV)."""
    _check_tasks(x, qw, scale_stack, zero_stack, task_ids)
    if x.device.type == "cpu":
        return quant_matmul_tasks_plain(x, qw, scale_stack, zero_stack,
                                        task_ids)
    y = _launch("quant_gemv_tasks", x, qw, scale_stack, zero_stack, task_ids)
    quant_gemv_tasks.launches += 1
    return y


def quant_gemv_planes(x, qw, scale, zero, bits, shift=0):
    """K6a, K1's plane branch: y = x @ Ŵᵀ for M ≤ 32 rows, Ŵ from the top
    ``bits`` planes of qw under scale·2^shift, zero/2^shift."""
    _check(x, qw, scale, zero, max_m=GEMV_MAX_M, planes=(bits, shift))
    if x.device.type == "cpu":
        return quant_matmul_planes_plain(x, qw, scale, zero, bits, shift)
    y = _launch("quant_gemv_planes", x, qw, scale, zero, planes=(bits, shift))
    quant_gemv_planes.launches += 1
    return y


def quant_matmul_planes(x, qw, scale, zero, bits, shift=0):
    """K6a, K2's plane branch: the tiled GEMM on the top ``bits`` planes."""
    _check(x, qw, scale, zero, planes=(bits, shift))
    if x.device.type == "cpu":
        return quant_matmul_planes_plain(x, qw, scale, zero, bits, shift)
    y = _launch("quant_matmul_planes", x, qw, scale, zero,
                planes=(bits, shift))
    quant_matmul_planes.launches += 1
    return y


def quant_gemv_tasks_planes(x, qw, scale_stack, zero_stack, task_ids, bits,
                            shift=0):
    """K6a, K5's plane branch: per-row task scales over the top ``bits``
    planes."""
    _check_tasks(x, qw, scale_stack, zero_stack, task_ids,
                 planes=(bits, shift))
    if x.device.type == "cpu":
        return quant_matmul_tasks_planes_plain(x, qw, scale_stack, zero_stack,
                                               task_ids, bits, shift)
    y = _launch("quant_gemv_tasks_planes", x, qw, scale_stack, zero_stack,
                task_ids, planes=(bits, shift))
    quant_gemv_tasks_planes.launches += 1
    return y


def quant_gemv_experts(x, qw, scale, zero):
    """K1 over an expert axis: y[e] = x[e] @ Ŵ[e]ᵀ for x (E, C ≤ 32, K), qw
    (E, N, K/8), scale and zero (E, N, G) — one launch for all E experts,
    slice e bit for bit ``quant_gemv`` on expert e's operands."""
    _check_experts(x, qw, scale, zero, max_m=GEMV_MAX_M)
    if x.device.type == "cpu":
        return quant_matmul_experts_plain(x, qw, scale, zero)
    y = _launch_experts("quant_gemv_experts", x, qw, scale, zero)
    quant_gemv_experts.launches += 1
    return y


def quant_matmul_experts(x, qw, scale, zero):
    """K2 over an expert axis: y[e] = x[e] @ Ŵ[e]ᵀ for x (E, C, K) — one
    launch for all E experts, slice e bit for bit ``quant_matmul`` on
    expert e's operands."""
    _check_experts(x, qw, scale, zero)
    if x.device.type == "cpu":
        return quant_matmul_experts_plain(x, qw, scale, zero)
    y = _launch_experts("quant_matmul_experts", x, qw, scale, zero)
    quant_matmul_experts.launches += 1
    return y


def quant_gemv_experts_planes(x, qw, scale, zero, bits):
    """K1-plane over an expert axis: y[e] = x[e] @ Ŵ[e]ᵀ for x (E, C ≤ 32,
    K), Ŵ[e] from the top ``bits`` planes of qw[e] (E, bits', N, K/32) —
    one launch for all E experts, slice e bit for bit
    ``quant_gemv_planes`` on expert e's operands."""
    _check_experts(x, qw, scale, zero, max_m=GEMV_MAX_M, bits=bits)
    if x.device.type == "cpu":
        return quant_matmul_experts_planes_plain(x, qw, scale, zero, bits)
    y = _launch_experts("quant_gemv_experts_planes", x, qw, scale, zero,
                        bits)
    quant_gemv_experts_planes.launches += 1
    return y


def quant_matmul_experts_planes(x, qw, scale, zero, bits):
    """K2-plane over an expert axis: y[e] = x[e] @ Ŵ[e]ᵀ for x (E, C, K), Ŵ[e]
    from the top ``bits`` planes of qw[e] — one launch for all E experts,
    slice e bit for bit ``quant_matmul_planes`` on expert e's operands."""
    _check_experts(x, qw, scale, zero, bits=bits)
    if x.device.type == "cpu":
        return quant_matmul_experts_planes_plain(x, qw, scale, zero, bits)
    y = _launch_experts("quant_matmul_experts_planes", x, qw, scale, zero,
                        bits)
    quant_matmul_experts_planes.launches += 1
    return y


KERNELS = (quant_gemv, quant_matmul, quant_gemv_tasks, quant_gemv_planes,
           quant_matmul_planes, quant_gemv_tasks_planes, quant_gemv_experts,
           quant_matmul_experts, quant_gemv_experts_planes,
           quant_matmul_experts_planes)
for _k in KERNELS:
    _k.launches = 0
