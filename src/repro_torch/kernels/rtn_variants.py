"""Where K3 and K6b (``csrc/rtn_pack.cu``) spend their time: variants,
compiled and timed.

    PYTHONPATH=src python -m repro_torch.kernels.rtn_variants

Needs ``nvcc`` and the card.  Compiles ``csrc/rtn_pack.cu`` as committed
and as variants, all in parallel and into a temporary directory, then times
each variant's ``rtn_pack`` (K3, nibbles) and ``rtn_pack_planes`` (K6b,
4 bit-planes) at the llama3.2-1b linears, f32 and bf16 weights, per-channel
and groups of 128, 4 bits, the weights rotated through more than twice the
L2 as a conversion streams them, CUDA-graph replay, every variant in turn
and then again in reverse order.  Prints one JSON line per shape, dtype and
group: device µs per launch of each variant (both turns), whether its
outputs are bit-equal to the committed kernel's, and the bytes bound; then
one line with each variant's ms per conversion of llama3.2-1b's f32
weights, per-channel (16 layers of 2 q/o, 2 k/v, 2 gate/up and 1 down,
from the mean of the two turns).  The variants:

  * ``committed``   — the source as it is;
  * ``legacy``      — the earlier design, one block per row reading each
                      weight twice (``csrc/rtn_pack_rowblock.cu``);
  * ``no_swizzle``  — the tile stored in shared memory in order: the 8
                      threads of an access phase on the same bank quads;
  * ``no_division`` — w · s in place of the IEEE division w / s (wrong
                      codes: the division's cost);
  * ``no_stores``   — the codes computed but not stored (wrong results);
  * ``loads_range`` — the tile staged and the ranges, scales and zeros
                      computed, no quantization (wrong codes);
  * ``five_blocks``, ``six_blocks`` — ``__launch_bounds__`` for 5 or 6
                      blocks an SM (51 or 42 registers a thread), not 4;
  * ``small_tiles`` — tiles of 4096 codes, blocks of 128 threads, 8 an SM:
                      twice the blocks (bit-equal: the same chunks).
"""
from __future__ import annotations

import ctypes
import json

from repro_torch.kernels import _build, _variants
from repro_torch.kernels._variants import SHAPES

_SWZ = "__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 7); }"
_DIV = "return min(__float2uint_rn(__fadd_rn(__fdiv_rn(w, s), z)), levels);"
_PLANE_ST = "dst[(size_t)pl * p.N * words] = __byte_perm(lo, hi, 0x5410);"
_NIB_ST = ("reinterpret_cast<uint4*>(p.qw + (size_t)n0 * (K >> 3))[c] =\n"
           "          make_uint4(acc[0], acc[1], acc[2], acc[3]);")
_QUANT = ("  for (int c = threadIdx.x; c < chunks; c += THREADS) {\n"
          "    uint32_t acc[CW / 8];")
_BOUNDS = "__launch_bounds__(THREADS, 4) rtn_pack_kernel("
_THREADS = "constexpr int THREADS = 256;"
_TILE = "constexpr int TILE_CODES = 8192;"
_NEVER = "0x9E3779B9u"                  # a word the stores are kept behind
BITS, GROUP = 4, 128
# a llama3.2-1b layer's linears: (N, K) → how many
LAYER = {(2048, 2048): 2, (512, 2048): 2, (8192, 2048): 2, (2048, 8192): 1}
LAYERS = 16


def variants(src: str, legacy: str) -> dict:
    _variants.require(src, "rtn_pack.cu",
                      (_SWZ, _DIV, _PLANE_ST, _NIB_ST, _QUANT, _BOUNDS,
                       _THREADS, _TILE))
    return {
        "committed": src,
        "legacy": legacy,
        "no_swizzle": src.replace(_SWZ, _SWZ.replace(
            "i ^ ((i >> 3) & 7)", "i")),
        "no_division": src.replace(_DIV, _DIV.replace("__fdiv_rn",
                                                      "__fmul_rn")),
        "no_stores": src.replace(_PLANE_ST, (
            "{ const uint32_t word = __byte_perm(lo, hi, 0x5410); "
            f"if (word == {_NEVER}) dst[(size_t)pl * p.N * words] = word; }}"
        )).replace(_NIB_ST, (
            f"if ((acc[0] ^ acc[1] ^ acc[2] ^ acc[3]) == {_NEVER})\n"
            "        " + _NIB_ST)),
        "loads_range": src.replace(_QUANT, _QUANT.replace(
            "c < chunks", "c < 0")),
        "five_blocks": src.replace(_BOUNDS, _BOUNDS.replace(", 4)", ", 5)")),
        "six_blocks": src.replace(_BOUNDS, _BOUNDS.replace(", 4)", ", 6)")),
        "small_tiles": src.replace(_BOUNDS, _BOUNDS.replace(", 4)", ", 8)"))
        .replace(_THREADS, _THREADS.replace("256", "128"))
        .replace(_TILE, _TILE.replace("8192", "4096")),
    }


def _entries(lib):
    """(K3 entry, K6b entry) of a built variant."""
    P, I = ctypes.c_void_p, ctypes.c_int
    out = []
    for name in ("rtn_pack", "rtn_pack_planes"):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 4 + [I] * 5 + [P]
        fn.restype = ctypes.c_int
        out.append(fn)
    return tuple(out)


def bound_us(n: int, k: int, groups: int, elt: int) -> float:
    """Bytes bound of one launch: w read once, 4-bit codes, scales and
    zeros written once, at 3.35 TB/s."""
    return (n * k * elt + n * k * BITS // 8 + 2 * n * groups * 4) / 3.35e12 * 1e6


def main() -> None:
    import torch

    src = (_build.CSRC / "rtn_pack.cu").read_text()
    legacy = (_build.CSRC / "rtn_pack_rowblock.cu").read_text()
    conv = {}
    with _variants.built(variants(src, legacy)) as libs:
        entries = {name: _entries(lib) for name, lib in libs.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        for n, k in SHAPES:
            w32 = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
            for dtype in (torch.float32, torch.bfloat16):
                w = w32.to(dtype)
                elt = w.element_size()
                copies = _variants.copies(n * k * elt)
                sets = [(w.clone(),) for _ in range(copies)]
                for group in (None, GROUP):
                    g = 1 if group is None else k // group
                    row = {"N": n, "K": k, "dtype": str(dtype).split(".")[1],
                           "group": group, "us": {},
                           "bitwise_committed": {},
                           "bound_us": bound_us(n, k, g, elt)}
                    ref = {}
                    order = list(entries)
                    for turn in (order, order[::-1]):
                        for name in turn:
                            for form, fn in zip(("rtn_pack",
                                                 "rtn_pack_planes"),
                                                entries[name]):
                                qshape = ((BITS, n, k // 32)
                                          if form == "rtn_pack_planes"
                                          else (n, k // 8))
                                out = [torch.empty(qshape, dtype=torch.int32,
                                                   device="cuda"),
                                       torch.empty((n, g), device="cuda"),
                                       torch.empty((n, g), device="cuda")]

                                def run(x, fn=fn, out=out):
                                    return fn(x.data_ptr(),
                                              *(t.data_ptr() for t in out),
                                              n, k, g, BITS,
                                              int(dtype == torch.bfloat16),
                                              torch.cuda.current_stream()
                                              .cuda_stream)
                                if run(*sets[0]) != 0:
                                    raise RuntimeError(
                                        f"{name} {form}: launch failed")
                                torch.cuda.synchronize()
                                got = [t.clone() for t in out]
                                if name == "committed":
                                    ref[form] = got
                                elif form in ref:
                                    eq = all(torch.equal(a, b) for a, b in
                                             zip(got, ref[form]))
                                    key = row["bitwise_committed"]
                                    key[name] = key.get(name, True) and eq
                                us = _variants.graph_us(torch, run, sets,
                                                        2 * copies)
                                row["us"].setdefault(name, {}).setdefault(
                                    form, []).append(round(us, 3))
                    print(json.dumps(row), flush=True)
                    if dtype == torch.float32 and group is None:
                        for name, forms in row["us"].items():
                            for form, ts in forms.items():
                                c = conv.setdefault(name, {}).setdefault(
                                    form, 0.0)
                                conv[name][form] = c + (
                                    LAYERS * LAYER[(n, k)] * sum(ts)
                                    / len(ts) / 1e3)
                del sets, w
    print(json.dumps({"ms_per_conversion_f32_per_channel": {
        name: {form: round(ms, 4) for form, ms in forms.items()}
        for name, forms in conv.items()},
        "bound_ms": round(sum(LAYERS * c * bound_us(n, k, 1, 4)
                              for (n, k), c in LAYER.items()) / 1e3, 4)}),
        flush=True)


if __name__ == "__main__":
    main()
