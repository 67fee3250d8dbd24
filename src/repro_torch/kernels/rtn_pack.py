"""Min/max RTN quantize + pack: the hand-written CUDA kernels and their plain
PyTorch versions (``csrc/rtn_pack.cu``).

  * ``rtn_pack``        — K3, codes packed as nibbles; replaces
                          ``repro/kernels/rtn_pack.py::rtn_pack_pallas``,
                          nibble branch (``_rtn_pack_kernel``).
  * ``rtn_pack_planes`` — K6b, codes packed as bit-planes; replaces its
                          plane branch (``_rtn_pack_planes_kernel``).
  * ``rtn_pack_plain``, ``rtn_pack_planes_plain`` — ``ref.rtn_pack_ref``
                          with ``n_grid=1``: ``rtn_quantize`` without the
                          range search, then ``pack_codes`` or
                          ``pack_codes_planes``.

Operands: w (N, K) bf16 or f32, contiguous (on the card starting on 16
bytes); ``bits`` in 2..4 and ``group_size`` None (per-channel) or a divisor
of K; K % 8 == 0 for nibbles and K % 32 == 0 for planes; a block stages
whole rows, 8192 codes or one longer row, so one row with its partials
must fit in shared memory (``smem_bytes``: K up to about 54000 f32
weights when K is a multiple of 32).  Returns (qw, scale, zero): qw (N,
K/8) int32 nibble words or (bits, N, K/32) int32 bit-planes — each the
bits of the reference's uint32 words —, scale and zero (N, G) f32.  The
kernels repeat the plain version's f32 operations in its order, so their
outputs are bit for bit the plain version's.

A wrapper given CPU tensors returns the plain version; given CUDA tensors it
launches its kernel or raises.  Each wrapper counts its launches in the
integer attribute ``launches`` (incremented only where the kernel launches).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import PACK, PLANE_PACK, QuantSpec
from repro_torch.kernels import _build, ref

_DTYPES = (torch.bfloat16, torch.float32)
MAX_GROUPS = 4096
# a block's tile: whole rows, this many codes (or one longer row), in
# dynamic shared memory of at most SMEM_LIMIT bytes
TILE_CODES, SMEM_LIMIT = 8192, 227 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]
_entries: dict = {}


def _spec(bits, group_size, plane):
    return QuantSpec(bits=bits, group_size=group_size,
                     layout="plane" if plane else "nibble")


def rtn_pack_plain(w, bits, group_size=None):
    """The plain version of K3."""
    return ref.rtn_pack_ref(w, _spec(bits, group_size, False), n_grid=1)


def rtn_pack_planes_plain(w, bits, group_size=None):
    """The plain version of K6b."""
    return ref.rtn_pack_ref(w, _spec(bits, group_size, True), n_grid=1)


def smem_bytes(n: int, k: int, groups: int, elt: int, plane: bool) -> int:
    """Dynamic shared memory of a block, as ``csrc/rtn_pack.cu`` sizes it:
    the tile (R rows of K values in whole 128-byte lines), a (min, max)
    partial per 32-code chunk (8-code when a nibble K is no multiple of
    32) and (s, z) per group of the tile."""
    rows = 1 if k >= TILE_CODES else min(n, TILE_CODES // k)
    chunk = 32 if plane or k % 32 == 0 else 8
    return (-(-rows * k * elt // 128) * 128 + 2 * (rows * k // chunk) * 4
            + 2 * rows * groups * 4)


def _check(w, bits, group_size, plane):
    """Raise on anything the kernels do not take."""
    if w.dim() != 2:
        raise ValueError(f"need w (N, K), got {tuple(w.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be bfloat16 or float32, got {w.dtype}")
    n, k = w.shape
    pack = PLANE_PACK if plane else PACK
    if not 2 <= bits <= 4:
        raise ValueError(f"the pack kernels take 2 to 4 bits, got {bits}")
    if n < 1 or k < pack or k % pack:
        raise ValueError(f"w {tuple(w.shape)}: need N >= 1 and K a multiple "
                         f"of {pack}")
    group = group_size or k
    if group < 1 or k % group or k // group > MAX_GROUPS:
        raise ValueError(f"group size {group_size} must divide K={k} into at "
                         f"most {MAX_GROUPS} groups")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    if smem_bytes(n, k, k // group, w.element_size(), plane) > SMEM_LIMIT:
        raise ValueError(f"w {tuple(w.shape)}: a row of K={k} does not fit "
                         f"the kernel's {SMEM_LIMIT} bytes of shared memory")


def _launch(name, w, bits, group_size):
    if w.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {w.device}")
    if w.data_ptr() % 16:
        raise ValueError(f"{name} loads w in 16-byte vectors: it must start "
                         f"on 16 bytes")
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("rtn_pack"), name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entries[name] = fn
    n, k = w.shape
    g = k // (group_size or k)
    qshape = (bits, n, k // PLANE_PACK) if name == "rtn_pack_planes" \
        else (n, k // PACK)
    qw = torch.empty(qshape, dtype=torch.int32, device=w.device)
    scale = torch.empty((n, g), dtype=torch.float32, device=w.device)
    zero = torch.empty((n, g), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(w.data_ptr(), qw.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                n, k, g, bits, int(w.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc} "
                           f"(N={n}, K={k}, G={g}, bits={bits}, {w.dtype})")
    return qw, scale, zero


def rtn_pack(w, bits, group_size=None):
    """K3: min/max RTN of w (N, K) → (qw (N, K/8) nibble words, scale,
    zero (N, G))."""
    _check(w, bits, group_size, plane=False)
    if w.device.type == "cpu":
        return rtn_pack_plain(w, bits, group_size)
    out = _launch("rtn_pack", w, bits, group_size)
    rtn_pack.launches += 1
    return out


def rtn_pack_planes(w, bits, group_size=None):
    """K6b: min/max RTN of w (N, K) → (qw (bits, N, K/32) bit-planes, MSB
    plane first, scale, zero (N, G))."""
    _check(w, bits, group_size, plane=True)
    if w.device.type == "cpu":
        return rtn_pack_planes_plain(w, bits, group_size)
    out = _launch("rtn_pack_planes", w, bits, group_size)
    rtn_pack_planes.launches += 1
    return out


KERNELS = (rtn_pack, rtn_pack_planes)
for _k in KERNELS:
    _k.launches = 0
