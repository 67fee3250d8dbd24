"""Round-to-nearest (RTN) uniform asymmetric quantization — the paper's Eq. (1)
(port of ``repro/core/quant.py``: the nibble and bit-plane layouts).

For a weight matrix ``W ∈ R^{n×m}`` (n = output channels, m = input features)
and bit-width ``b``::

    q  = clamp(round(W / s) + z, 0, 2**b - 1)     # unsigned integer codes
    Ŵ  = s · (q - z)                               # dequantized weights

``s, z`` are per-output-channel (``group_size is None``) or per
``(channel, group)`` with groups of ``group_size`` consecutive input features.
RTN grid-searches a shrink factor on the (min, max) range to minimize
``‖W − Ŵ‖_F²`` per group.

Packing — two layouts, both as in the reference:

  * ``nibble``: 8 codes per 32-bit word, code ``i`` in bits ``4i..4i+3``.
  * ``plane``: ``bits`` bit-planes, most significant first — ``qw[p]`` is a
    (N, K/32) array of words holding bit ``bits-1-p`` of every code, code
    ``i`` in bit ``i`` of its word.  The top ``p`` planes ``qw[:p]`` are a
    contiguous prefix of the buffer and decode, alone, to ``q >> (bits-p)``:
    the low-bit draft of self-speculative decoding reads the target's own
    codes.

The reference stores ``uint32``; the port stores the same bits as
``torch.int32`` (PyTorch has no CPU shifts for ``uint32``).  A right shift of
an ``int32`` sign-extends, so every unpack masks after the shift.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Number of codes packed per 32-bit word (3-bit codes ride in nibbles too).
PACK = 8

# Codes per 32-bit word per bit-plane (one bit per code per plane).
PLANE_PACK = 32


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a quantized tensor layout."""

    bits: int = 4                  # 2..8
    group_size: Optional[int] = None  # None → per-channel (one group = whole row)
    symmetric: bool = False        # paper uses asymmetric (zero-points)
    packed: bool = True            # bit-pack codes into 32-bit words
    layout: str = "nibble"         # nibble (8 codes/word) | plane (bit-planes)

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1

    @property
    def packs(self) -> bool:
        """Nibble packing only holds codes < 16 (bits ≤ 4)."""
        return self.packed and self.bits <= 4 and self.layout == "nibble"

    @property
    def plane(self) -> bool:
        """Bit-plane packed: ``qw`` is (bits', N, K/32) with ``bits' >=
        bits`` — decode consumes the top ``bits`` planes."""
        return self.packed and self.layout == "plane"

    def n_groups(self, in_features: int) -> int:
        if self.group_size is None:
            return 1
        if in_features % self.group_size:
            raise ValueError(
                f"in_features={in_features} not divisible by group_size={self.group_size}"
            )
        return in_features // self.group_size

    def validate(self, in_features: int) -> None:
        if not (2 <= self.bits <= 8):
            raise ValueError(f"bits must be in [2, 8], got {self.bits}")
        if self.layout not in ("nibble", "plane"):
            raise ValueError(f"unknown layout {self.layout!r} "
                             f"(know: nibble, plane)")
        self.n_groups(in_features)
        if self.packs and in_features % PACK:
            raise ValueError(f"packed layout needs in_features % {PACK} == 0")
        if self.plane and in_features % PLANE_PACK:
            raise ValueError(
                f"plane layout needs in_features % {PLANE_PACK} == 0")

    def check_ported(self) -> None:
        """Raise for the storage the port does not serve: unpacked codes
        and codes wider than a nibble (the kernels rebuild bit-planes into
        nibble words, so planes serve bits <= 4 too)."""
        if self.layout not in ("nibble", "plane"):
            raise ValueError(f"unknown layout {self.layout!r} "
                             f"(know: nibble, plane)")
        if not self.packed or self.bits > 4:
            raise NotImplementedError(
                f"{self.layout} codes with packed={self.packed}, "
                f"bits={self.bits} are not ported: the port serves packed "
                f"codes of bits <= 4")


# ---------------------------------------------------------------------------
# Pack / unpack (bijective on codes in [0, 15])
# ---------------------------------------------------------------------------

def pack_codes(q: torch.Tensor) -> torch.Tensor:
    """Pack codes (…, K) with values < 16 into int32 words (…, K // 8)."""
    if q.shape[-1] % PACK:
        raise ValueError(f"last dim {q.shape[-1]} not divisible by {PACK}")
    q = q.to(torch.int64).reshape(*q.shape[:-1], q.shape[-1] // PACK, PACK)
    shifts = torch.arange(PACK, dtype=torch.int64, device=q.device) * 4
    # words in [0, 2**32): the uint32 bit pattern as int32
    return _as_int32((q << shifts).sum(dim=-1))


def unpack_codes(packed: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """Unpack int32 words (…, K//8) → uint8 codes (…, K)."""
    shifts = torch.arange(PACK, dtype=torch.int32, device=packed.device) * 4
    q = (packed[..., None] >> shifts) & 0xF            # mask the sign fill
    q = q.reshape(*packed.shape[:-1], packed.shape[-1] * PACK)
    if k is not None:
        q = q[..., :k]
    return q.to(torch.uint8)


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) → the same bits as int32."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


# ---------------------------------------------------------------------------
# Bit-plane pack / unpack (plane-major, MSB first: qw[:p] IS the p-bit draft)
# ---------------------------------------------------------------------------

def pack_codes_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack codes (…, K) < 2**bits into int32 planes (bits, …, K // 32).

    Plane p holds bit ``bits-1-p`` of every code (most significant first),
    32 codes per word, code ``i`` in bit ``i`` of its word — the top-p
    planes are a contiguous buffer prefix that decodes to ``code >>
    (bits-p)``."""
    if q.shape[-1] % PLANE_PACK:
        raise ValueError(
            f"last dim {q.shape[-1]} not divisible by {PLANE_PACK}")
    lead, words = q.shape[:-1], q.shape[-1] // PLANE_PACK
    q = q.to(torch.int32).reshape(*lead, words, PLANE_PACK)
    shifts = torch.arange(PLANE_PACK, dtype=torch.int64, device=q.device)
    out = torch.empty((bits, *lead, words), dtype=torch.int32,
                      device=q.device)
    # one plane at a time: the temporaries are one plane's int64 bits, not
    # every plane's (an MoE build packs chunks of 2^26 codes)
    for p in range(bits):
        bit = ((q >> (bits - 1 - p)) & 1).to(torch.int64)
        bit <<= shifts
        out[p] = _as_int32(bit.sum(dim=-1))
    return out


def unpack_codes_planes(packed: torch.Tensor, k: Optional[int] = None,
                        bits: Optional[int] = None) -> torch.Tensor:
    """Unpack int32 planes (bits', …, K//32) → uint8 codes (…, K).

    ``bits`` (≤ bits') consumes only the top planes — the draft decode."""
    bits = packed.shape[0] if bits is None else bits
    shifts = torch.arange(PLANE_PACK, dtype=torch.int32, device=packed.device)
    # MSB plane first, one plane at a time, in place: the temporaries are
    # two int32 planes of codes, not every plane's bits
    q = None
    for p in range(bits):
        b = packed[p, ..., None] >> shifts
        b &= 1                                          # mask the sign fill
        if q is None:
            q = b
        else:
            q <<= 1
            q |= b
    q = q.reshape(*packed.shape[1:-1], packed.shape[-1] * PLANE_PACK)
    if k is not None:
        q = q[..., :k]
    return q.to(torch.uint8)


def draft_scales(scale: torch.Tensor, zero: torch.Tensor, bits: int,
                 draft_bits: int):
    """(scale, zero) for decoding the top ``draft_bits`` planes of a
    ``bits``-bit tensor: the p-bit truncation satisfies q ≈ q_p·2**(b-p), so
    s·(q − z) ≈ (s·2**(b-p))·(q_p − z/2**(b-p)).  Both factors are powers of
    two, so the rescale is exact in float32."""
    f = float(1 << (bits - draft_bits))
    return scale * f, zero / f


# ---------------------------------------------------------------------------
# RTN quantization
# ---------------------------------------------------------------------------

def _grouped(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """(n, m) → (n, G, m/G) view."""
    n, m = w.shape
    g = spec.n_groups(m)
    return w.reshape(n, g, m // g)


def _rtn_params_for_range(lo, hi, spec: QuantSpec):
    """Given per-group (lo, hi), produce (scale, zero).

    Both divisors (``levels``, and ``(levels − 1)/2`` for a symmetric spec)
    are tensors, not Python numbers: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which differs from the reference's
    division in the last bit; a tensor divisor divides on every device (and
    is the plain version the pack kernels match bit for bit)."""
    levels = spec.levels
    if spec.symmetric:
        amax = torch.maximum(lo.abs(), hi.abs())
        scale = torch.clamp(amax / torch.full_like(amax, (levels - 1) / 2),
                            min=1e-12)
        zero = torch.full_like(scale, (levels + 1) / 2)  # midpoint code
    else:
        scale = torch.clamp((hi - lo) / torch.full_like(hi, levels),
                            min=1e-12)
        zero = -lo / scale
    return scale, zero


def _quantize_with(wg, scale, zero, spec: QuantSpec):
    return torch.clamp(torch.round(wg / scale[..., None] + zero[..., None]),
                       0, spec.levels)


def shrink_grid(n_grid: int, max_shrink: float, device) -> torch.Tensor:
    """The shrink factors 1 → 1 − max_shrink, by the reference's linspace
    formula ``start·(1 − t) + stop·t`` in float32, ``t = i / (n − 1)``.
    XLA folds that expression with its own rounding, so a few entries may
    differ from the reference's by one float32 ulp (tests/test_torch_quant.py
    states how a resulting near-tie is judged)."""
    div = n_grid - 1
    t = torch.arange(div, dtype=torch.float32, device=device) / div
    start = torch.tensor(1.0, dtype=torch.float32)
    stop = torch.tensor(1.0 - max_shrink, dtype=torch.float32)
    out = start * (1 - t) + stop * t
    return torch.cat([out, stop[None].to(device)])


def rtn_quantize(w: torch.Tensor, spec: QuantSpec, *, n_grid: int = 20,
                 max_shrink: float = 0.45):
    """RTN with per-group range grid-search (minimize per-group Frobenius err).

    Returns (q_codes uint8 (n, m), scale (n, G), zero (n, G)).
    ``n_grid=1`` disables the search (plain min/max RTN).
    """
    w = w.to(torch.float32)
    wg = _grouped(w, spec)
    lo = torch.clamp(wg.amin(dim=-1), max=0.0)
    hi = torch.clamp(wg.amax(dim=-1), min=0.0)

    def err_for(shrink):
        s, z = _rtn_params_for_range(lo * shrink, hi * shrink, spec)
        q = _quantize_with(wg, s, z, spec)
        deq = s[..., None] * (q - z[..., None])
        return ((deq - wg) ** 2).sum(dim=-1), s, z

    # a device-side 1.0 (no host copy: a CUDA graph can capture this)
    best_e, scale, zero = err_for(torch.ones((), dtype=torch.float32,
                                             device=w.device))
    if n_grid > 1:
        for shrink in shrink_grid(n_grid, max_shrink, w.device)[1:]:
            e, s, z = err_for(shrink)
            take = e < best_e
            best_e = torch.where(take, e, best_e)
            scale = torch.where(take, s, scale)
            zero = torch.where(take, z, zero)

    q = _quantize_with(wg, scale, zero, spec).reshape(w.shape).to(torch.uint8)
    return q, scale, zero


def dequantize(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               spec: QuantSpec, dtype=torch.float32) -> torch.Tensor:
    """Ŵ = s · (q − z), per Eq. (1)/(2). q: (n, m) codes; scale/zero: (n, G)."""
    n, m = q.shape
    g = scale.shape[-1]
    qg = q.reshape(n, g, m // g).to(torch.float32)
    deq = scale[..., None].to(torch.float32) * (
        qg - zero[..., None].to(torch.float32))
    return deq.reshape(n, m).to(dtype)
