"""Where K2's tensor-core route spends its time: variants, compiled and timed.

    python -m repro_torch.kernels.tc_variants

Needs ``nvcc`` and the card.  Compiles ``csrc/quant_matmul.cu`` as
committed and as variants of its tensor-core kernel, all in parallel and
into a temporary directory, then times each variant's ``quant_matmul``
entry point at the llama3.2-1b linears (M = 1024, bf16 x, per-channel
scales), the weights rotated through more than twice the L2 as the model
streams them, CUDA-graph replay.  Prints one JSON line per shape: device µs
per launch of each variant, and whether its output is within
``quant_matmul.error_bound`` of the plain version.  The variants:

  * ``committed``    — the source as it is;
  * ``tile_WxH``     — one tile shape forced (128 × 256, 128 × 128, 64 × 64);
  * ``no_mma``       — the loop without its ``wgmma``s (wrong results);
  * ``no_unpack``    — the loop without the codes' unpack (wrong results);
  * ``no_loads``     — the loop without its copies, the first stages'
                       kept (wrong results);
  * ``no_x_loads``   — without the copies of the x tiles (wrong results);
  * ``empty_loop``   — without copies, unpack and ``wgmma``: the launch,
                       prologue, barriers and epilogue (wrong results).
"""
from __future__ import annotations

import ctypes
import json

from repro_torch.kernels import _build, _variants
from repro_torch.kernels._variants import SHAPES

_MMA = ("      wgmma_tile<C::BN>(acc, da, desc(bt + 32 * ks));\n"
        "      wgmma_n8(rs, da, desc(ones + 32 * ks));\n")
_UNPACK = ("      unpack_tile<C, PLANES>(stage(t + 1) + C::X_BYTES, wb + "
           "((t + 1) & 1) * C::B_BYTES,\n                             "
           "pl.planes);\n")
_LOADS = "    if (t + STAGES - 1 < tiles) load(t + STAGES - 1);\n"
_X_LOADS = ("    cp16(xs + chunk_off(r, c), x + (size_t)(gm < M ? gm : 0)"
            " * K + k0 + c * 8, gm < M);\n")
_FILLS = ("  const auto fills = [&](int bm, int bn) {\n"
          "    return 4L * ((M + bm - 1) / bm) * ((N + bn - 1) / bn) >= "
          "3L * sms;\n  };\n")
M = 1024


def variants(src: str) -> dict:
    _variants.require(src, "quant_matmul.cu",
                      (_MMA, _UNPACK, _LOADS, _X_LOADS, _FILLS))

    def cut(*markers):
        out = src
        for m in markers:
            out = out.replace(m, "")
        return out

    def tile(rule):
        return src.replace(_FILLS, "  const auto fills = [&](int bm, int bn) "
                                   f"{{ return {rule}; }};\n")

    return {
        "committed": src,
        "tile_128x256": tile("true"),
        "tile_128x128": tile("bn == 128"),
        "tile_64x64": tile("false"),
        "no_mma": cut(_MMA),
        "no_unpack": cut(_UNPACK),
        "no_loads": cut(_LOADS),
        "no_x_loads": cut(_X_LOADS),
        "empty_loop": cut(_MMA, _UNPACK, _LOADS),
    }


def main() -> None:
    import torch

    from repro_torch.core.quant import QuantSpec, pack_codes, rtn_quantize
    from repro_torch.kernels import quant_matmul as qm

    src = (_build.CSRC / "quant_matmul.cu").read_text()
    with _variants.built(variants(src)) as libs:
        entries = {}
        for name, lib in libs.items():
            fn = lib.quant_matmul
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            entries[name] = fn

        gen = torch.Generator(device="cuda").manual_seed(0)
        for n, k in SHAPES:
            w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
            q, s, z = rtn_quantize(w, QuantSpec(bits=4), n_grid=2)
            qw = pack_codes(q)
            x = torch.randn(M, k, generator=gen, device="cuda").bfloat16()
            plain = qm.quant_matmul_plain(x, qw, s, z)
            bound = qm.error_bound(x, qw, s, z, plain, factored=True)
            copies = _variants.copies(n * k // 2)
            sets = [(x, qw.clone(), s, z) for _ in range(copies)]
            row = {"M": M, "N": n, "K": k}
            for name, fn in entries.items():
                def run(x, qw, s, z, fn=fn):
                    y = torch.empty((M, n), dtype=torch.bfloat16, device="cuda")
                    rc = fn(x.data_ptr(), qw.data_ptr(), s.data_ptr(),
                            z.data_ptr(), y.data_ptr(), M, n, k, 1, 1,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                    return y
                y = run(*sets[0])
                torch.cuda.synchronize()
                ok = bool(((y.float() - plain.float()).abs() <= bound).all())
                row[name] = {"us": _variants.graph_us(torch, run, sets,
                                                      2 * copies),
                             "within_bound": ok}
            print(json.dumps(row), flush=True)
            del sets


if __name__ == "__main__":
    main()
