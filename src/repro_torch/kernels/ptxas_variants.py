"""Register reports of the kernels: every instantiation, and K5's variants.

    python -m repro_torch.kernels.ptxas_variants

Needs ``nvcc`` (the machine with the card).  Compiles ``csrc/quant_gemv.cu``
as committed and as four variants of K5's loops, and
``csrc/quant_matmul.cu``, ``csrc/rtn_pack.cu`` and
``csrc/flash_attention.cu`` as committed, all in parallel and into a
temporary directory.  Prints one JSON line per variant with each bf16 K5
instantiation's registers, local-memory stack frame and spill stores
(``nvcc -Xptxas -v``), then one line listing every bit-plane (K6a)
instantiation of the committed sources the same way, and one listing every
instantiation of K3, K6b and K4, and one listing the tensor-core
instantiations (the GEMV's ``mma`` kernels for 1, 2 and 4 n-tiles, K2's
``wgmma`` tiles, nibble and plane, and K4's ``mma.sync`` kernel and its
combine) with the dynamic shared memory each K2 and K4 block takes
(above the 48 KB default: set with ``cudaFuncSetAttribute``; read from the
built libraries' ``*_tc_smem`` entry points, no kernel runs).  ``report`` parses
any such log into one row per instantiation (``chip_smoke.py`` phase
``device`` uses it).  The variants only exist to be compiled — two of them
compute wrong results:

  * ``committed``   — the source as it is;
  * ``j_unrolled``  — the per-code branch (groups narrower than a packed
                      word) with its j-loop unrolled, as the kernel first was;
  * ``m_rolled``    — that branch's m-loop rolled instead: the accumulators
                      are then indexed by a loop variable;
  * ``no_percode``  — that branch removed (wrong results);
  * ``one_block``   — K5 bounded to one block per SM (255 registers).
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

from repro_torch.kernels import _build

_J_LOOP = ("#pragma unroll 1\n            for (int j = 0; j < 8; ++j) {\n"
           "              const int g = (k0 + j) / group;")
_M_LOOP = ("#pragma unroll\n              for (int m = 0; m < MT; ++m) {\n"
           "                const int o = tofs[m] + n * G + g;")
_BRANCH = "        if (G != 1 && !word_groups) {\n          // j stays a loop"
_BRANCH_END = ("          continue;\n        }\n"
               "        const int g = G == 1 ? 0 : k0 / group;")
_BOUNDS = "__launch_bounds__(THREADS, 2) quant_gemv_kernel("


def variants(src: str) -> dict:
    for marker in (_J_LOOP, _M_LOOP, _BRANCH, _BRANCH_END, _BOUNDS):
        if src.count(marker) != 1:
            raise ValueError(f"quant_gemv.cu no longer has {marker!r} once")
    j_unrolled = src.replace(_J_LOOP, _J_LOOP.replace("unroll 1", "unroll"))
    start, end = src.index(_BRANCH), src.index(_BRANCH_END)
    return {
        "committed": src,
        "j_unrolled": j_unrolled,
        "m_rolled": j_unrolled.replace(_M_LOOP,
                                       _M_LOOP.replace("unroll", "unroll 1")),
        "no_percode": (src[:start] + "        if (G != 1 && !word_groups) {\n"
                       + src[end:]),
        "one_block": src.replace(
            _BOUNDS, "__launch_bounds__(THREADS, TASKS ? 1 : 2) "
                     "quant_gemv_kernel("),
    }


# the wrapper (``kernels/quant_matmul.py``) that launches each instantiation
_GEMV_NAMES = {(False, False): "quant_gemv", (True, False): "quant_gemv_tasks",
               (False, True): "quant_gemv_planes",
               (True, True): "quant_gemv_tasks_planes"}


def report(log: str) -> list:
    """One row per kernel instantiation in an ``nvcc -Xptxas -v`` log: the
    wrapper that launches it, dtype, (MT, R) for the GEMV, the route and
    tile of the tensor-core kernels, registers, static shared memory,
    stack frame and spill-store bytes.  (The tensor-core kernels' shared
    memory is dynamic: ``quant_matmul.tc_smem_bytes``,
    ``flash_attention.tc_smem_bytes``.)"""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?quant_matmul_tc_kernelI"
                      r"NS0_3CfgILi(\d+)ELi(\d+)EEELb([01])E", line)
        if m:                    # K2's tensor-core route <Cfg<BN, WGS>, PLANES>
            bn, wgs = int(m.group(1)), int(m.group(2))
            cur = {"kernel": "quant_matmul" + ("_planes" if m.group(3) == "1"
                                               else ""),
                   "dtype": "bf16", "route": "wgmma",
                   "tile": f"{64 * wgs}x{bn}"}
            rows.append(cur)
            continue
        m = re.search(r"Compiling entry function '\S*?quant_gemv_tc_kernelI"
                      r"Li(\d+)ELb([01])ELb([01])E", line)
        if m:            # the GEMV's tensor-core route <NT, TASKS, PLANES>
            cur = {"kernel": _GEMV_NAMES[m.group(2) == "1",
                                         m.group(3) == "1"],
                   "dtype": "bf16", "route": "mma", "NT": int(m.group(1))}
            rows.append(cur)
            continue
        m = re.search(r"Compiling entry function '\S*?flash_attention_"
                      r"(tc|combine)_kernel(?:ILi(\d+)E)?", line)
        if m:                    # K4's tensor-core kernel <DP> and its combine
            cur = {"kernel": "flash_attention", "dtype": "bf16",
                   "route": "mma.sync" if m.group(1) == "tc" else "combine"}
            if m.group(2):
                cur["DP"] = int(m.group(2))
            rows.append(cur)
            continue
        m = re.search(r"Compiling entry function '\S*?(quant_gemv|quant_matmul|"
                      r"rtn_pack|flash_attention)_kernelI(13__nv_bfloat16|f)"
                      r"((?:L[ib]\d+E)*)", line)
        if m:
            args = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(3))]
            cur = {"dtype": "bf16" if m.group(2) != "f" else "f32"}
            if m.group(1) == "quant_gemv":
                mt, r, tasks, planes = args[:4]
                cur = {"kernel": _GEMV_NAMES[bool(tasks), bool(planes)],
                       **cur, "MT": mt, "R": r}
            elif m.group(1) == "flash_attention":    # <T, output dims a lane>
                cur = {"kernel": "flash_attention", **cur, "DL": args[0]}
            else:                        # quant_matmul, rtn_pack: <T, PLANES>
                cur = {"kernel": m.group(1) + ("_planes" if args[0] else ""),
                       **cur}
            rows.append(cur)
            continue
        if "Compiling entry function" in line:
            cur = None
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            cur["stack"], cur["spill_stores"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            cur["regs"], cur["smem"] = int(m.group(1)), int(m.group(2))
        elif "Used" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["regs"] = int(m.group(1))
    return rows


def k5_report(log: str) -> list:
    """bf16 K5 instantiations (TASKS = true, nibble codes): MT, R,
    registers, stack frame and spill-store bytes."""
    return [{k: r[k] for k in ("MT", "R", "regs", "stack", "spill_stores")
             if k in r}
            for r in report(log)
            if r["kernel"] == "quant_gemv_tasks" and r["dtype"] == "bf16"]


def _nvcc(src: str, tmp: str, name: str) -> subprocess.Popen:
    cu = Path(tmp) / f"{name}.cu"
    cu.write_text(src)
    return subprocess.Popen(
        [_build.nvcc(), *_build.FLAGS, "-o", str(cu.with_suffix(".so")),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _log(name: str, proc: subprocess.Popen) -> str:
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
    return log


def _tc_smem(tmp: str) -> dict:
    """Dynamic shared memory of the tensor-core tiles, from the libraries
    just built in ``tmp`` (host functions: no kernel is launched)."""
    qm = ctypes.CDLL(str(Path(tmp) / "quant_matmul.so")).quant_matmul_tc_smem
    fa = ctypes.CDLL(str(Path(tmp) / "flash_attention.so")
                     ).flash_attention_tc_smem
    return {"quant_matmul": {tile: qm(i) for i, tile in
                             enumerate(("64x64", "128x128", "128x256"))},
            "flash_attention": {"D<=64": fa(64), "D<=128": fa(128)}}


def main() -> None:
    src = (_build.CSRC / "quant_gemv.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: _nvcc(text, tmp, name)
                 for name, text in variants(src).items()}
        gemm = _nvcc((_build.CSRC / "quant_matmul.cu").read_text(), tmp,
                     "quant_matmul")
        others = {name: _nvcc((_build.CSRC / f"{name}.cu").read_text(), tmp,
                              name)
                  for name in ("rtn_pack", "flash_attention")}
        planes = []
        for name, proc in procs.items():
            log = _log(name, proc)
            print(json.dumps({"variant": name, "k5": k5_report(log)}),
                  flush=True)
            if name == "committed":
                gemv_log = log
                planes += [r for r in report(log)
                           if r["kernel"].endswith("_planes")]
        gemm_log = _log("quant_matmul", gemm)
        planes += [r for r in report(gemm_log)
                   if r["kernel"].endswith("_planes")]
        print(json.dumps({"variant": "committed", "planes": planes}),
              flush=True)
        logs = {name: _log(name, proc) for name, proc in others.items()}
        print(json.dumps({"variant": "committed", "pack_attention": [
            r for log in logs.values() for r in report(log)]}), flush=True)
        print(json.dumps({"variant": "committed", "tensor_cores": [
            r for log in (gemv_log, gemm_log, logs["flash_attention"])
            for r in report(log) if "route" in r],
            "dynamic_smem": _tc_smem(tmp)}), flush=True)


if __name__ == "__main__":
    main()
