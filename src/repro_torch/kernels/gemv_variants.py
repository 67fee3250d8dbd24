"""Where the GEMV's tensor-core route spends its time: variants, compiled and
timed.

    python -m repro_torch.kernels.gemv_variants

Needs ``nvcc`` and the card.  Compiles ``csrc/quant_gemv.cu`` as committed
and as variants of its tensor-core kernel, all in parallel and into a
temporary directory, then times each variant's ``quant_gemv`` (K1) at
M = 4, 8 and 32 and ``quant_gemv_tasks_planes`` (K5-plane over 4 tasks:
the draft's 3 planes at M = 8, the verify's 4 at M = 32) at the
llama3.2-1b linears (bf16 x, per-channel scales), the weights rotated
through more than twice the L2 as the model streams them, CUDA-graph
replay, every variant in turn and then again in reverse order.  Prints one
JSON line per shape: device µs per launch of each variant (both turns),
whether its output is bit-equal to the committed kernel's, and
``torch.matmul`` on a bf16 Ŵ at each M as a yardstick.  The variants:

  * ``committed``     — the source as it is;
  * ``no_block_split`` — K split over the 8 warps of one block only, as
                        before the split over a cluster of blocks (its sums
                        meet in another order: not bit-equal where the
                        committed kernel splits);
  * ``short_warps``   — the split allowed down to one 64-code block a
                        warp, not 8 (k/v then split over 4 blocks, q/o
                        over 2);
  * ``one_batch``     — at M <= 8 too one batch loaded and multiplied at a
                        time (no loads in flight while a batch multiplies),
                        the per-channel scales read at the end;
  * ``pipelined_all`` — two batches in flight and the scales read first at
                        every M, also at M = 16 and 32;
  * ``three_blocks``  — ``__launch_bounds__`` for 3 blocks an SM (85
                        registers a thread);
  * ``no_mma``        — the loop without its ``mma.sync``s (wrong results);
  * ``no_loads``      — the loop without its code and x loads (wrong
                        results): launch, unpack, products and epilogue.
"""
from __future__ import annotations

import ctypes
import json

from repro_torch.kernels import _build, _variants
from repro_torch.kernels._variants import SHAPES

_PIPE = "  constexpr bool PIPE = NT == 1;\n"
_BOUNDS = "__launch_bounds__(TC_THREADS, 2) quant_gemv_tc_kernel("
_MMA = ("          mma16816(acc[j], a, b0r, b1r);\n"
        "          mma16816(rs[j], ones, b0r, b1r);\n")
_Q_LOAD = ("__ldg(reinterpret_cast<const uint2*>(qw + (size_t)n * (K >> 3) + "
           "8 * b) + t)")
_P_LOAD = "rc.p[i] = __ldg(src + i * plane_stride);"
_X_LOAD = ("            bt.xv[u][j][0] = __ldg(src);\n"
           "            bt.xv[u][j][1] = __ldg(src + 1);\n")
_SPLIT = "  return s < 1 ? 1 : s;\n"
_WARP_BLOCKS = "constexpr int TC_MIN_WARP_BLOCKS = 8;"
N_TASKS = 4


def variants(src: str) -> dict:
    _variants.require(src, "quant_gemv.cu", (_PIPE, _BOUNDS, _MMA, _Q_LOAD,
                                             _P_LOAD, _X_LOAD, _SPLIT,
                                             _WARP_BLOCKS))
    return {
        "committed": src,
        "no_block_split": src.replace(_SPLIT, "  return 1;\n"),
        "short_warps": src.replace(_WARP_BLOCKS,
                                   _WARP_BLOCKS.replace("8;", "1;")),
        "one_batch": src.replace(_PIPE, "  constexpr bool PIPE = false;\n"),
        "pipelined_all": src.replace(_PIPE, "  constexpr bool PIPE = true;\n"),
        "three_blocks": src.replace(_BOUNDS, _BOUNDS.replace(", 2)", ", 3)")),
        "no_mma": src.replace(_MMA, ""),
        "no_loads": src.replace(_Q_LOAD, "make_uint2(n + b, t)").replace(
            _P_LOAD, "rc.p[i] = (uint32_t)(n + b + i);").replace(
            _X_LOAD, "            bt.xv[u][j][0] = bt.xv[u][j][1] = "
                     "make_uint4(b, t, m, 0x3F80u);\n"),
    }


def _entries(lib):
    """(K1 entry, K5-plane entry) of a built variant."""
    P, I = ctypes.c_void_p, ctypes.c_int
    k1, k5p = lib.quant_gemv, lib.quant_gemv_tasks_planes
    k1.argtypes = [P] * 5 + [I] * 5 + [P]
    k5p.argtypes = [P] * 6 + [I] * 8 + [P]
    k1.restype = k5p.restype = ctypes.c_int
    return k1, k5p


def main() -> None:
    import torch

    from repro_torch.core.quant import (QuantSpec, pack_codes,
                                        pack_codes_planes, rtn_quantize)
    from repro_torch.kernels.ref import dequant_ref

    src = (_build.CSRC / "quant_gemv.cu").read_text()
    with _variants.built(variants(src)) as libs:
        entries = {name: _entries(lib) for name, lib in libs.items()}

        def stream():
            return torch.cuda.current_stream().cuda_stream

        gen = torch.Generator(device="cuda").manual_seed(0)
        for n, k in SHAPES:
            w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
            q, s, z = rtn_quantize(w, QuantSpec(bits=4), n_grid=2)
            qw, planes = pack_codes(q), pack_codes_planes(q, 4)
            ss = torch.stack([s * (0.9 + 0.2 * torch.rand(
                s.shape, generator=gen, device="cuda"))
                for _ in range(N_TASKS)]).contiguous()
            zs = torch.stack([z] * N_TASKS).contiguous()
            w16 = dequant_ref(qw, s, z, (n, k), QuantSpec(), torch.bfloat16)
            x = torch.randn(32, k, generator=gen, device="cuda").bfloat16()
            copies = _variants.copies(n * k // 2)
            cases = {f"k1_m{m}": ("k1", m, 4) for m in (4, 8, 32)}
            cases.update(k5p_m8_p3=("k5p", 8, 3), k5p_m32_p4=("k5p", 32, 4))
            row = {"N": n, "K": k, "us": {}, "bitwise_committed": {}}
            ref = {}
            order = list(entries)
            for turn in (order, order[::-1]):
                for name in turn:
                    k1, k5p = entries[name]
                    for case, (form, m, p) in cases.items():
                        xm = x[:m].contiguous()
                        ids = torch.arange(m, dtype=torch.int32,
                                           device="cuda") % N_TASKS
                        y = torch.empty((m, n), dtype=torch.bfloat16,
                                        device="cuda")
                        if form == "k1":
                            sets = [(qw.clone(),) for _ in range(copies)]

                            def run(c, xm=xm, y=y, m=m, k1=k1):
                                return k1(xm.data_ptr(), c.data_ptr(),
                                          s.data_ptr(), z.data_ptr(),
                                          y.data_ptr(), m, n, k, 1, 1,
                                          stream())
                        else:
                            sets = [(planes.clone(),) for _ in range(copies)]

                            def run(c, xm=xm, y=y, m=m, p=p, ids=ids,
                                    k5p=k5p):
                                return k5p(xm.data_ptr(), c.data_ptr(),
                                           ss.data_ptr(), zs.data_ptr(),
                                           ids.data_ptr(), y.data_ptr(), m, n,
                                           k, 1, N_TASKS, p, 4 - p, 1,
                                           stream())
                        if run(*sets[0]) != 0:
                            raise RuntimeError(f"{name} {case}: launch failed")
                        torch.cuda.synchronize()
                        out = y.clone()
                        if name == "committed":
                            ref[case] = out
                        elif case in ref:
                            row["bitwise_committed"].setdefault(name, True)
                            row["bitwise_committed"][name] &= bool(
                                torch.equal(out, ref[case]))
                        us = _variants.graph_us(torch, run, sets,
                                                2 * copies)
                        row["us"].setdefault(name, {}).setdefault(
                            case, []).append(round(us, 3))
                        del sets
            lib_sets = [(w16.clone(),)
                        for _ in range(_variants.copies(n * k * 2))]
            row["matmul_bf16_us"] = {
                m: round(_variants.graph_us(torch, lambda b, m=m: torch.matmul(
                    x[:m], b.T), lib_sets, 2 * len(lib_sets)), 3)
                for m in (4, 8, 32)}
            print(json.dumps(row), flush=True)
            del lib_sets


if __name__ == "__main__":
    main()
