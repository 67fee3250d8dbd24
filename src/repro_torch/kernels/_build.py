"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``.  The library name carries a hash of the source
and the flags, so an edited source is rebuilt and a current one is reused;
the compiler's register and shared-memory report is kept beside it
(``lib<name>-<hash>.ptxas.txt``) so a reused build still reports it.
``build()`` starts one ``nvcc`` per missing source, all at once.  A missing
``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("quant_gemv", "quant_matmul", "rtn_pack", "flash_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; have {SOURCES}")
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source whose library is missing, in parallel.

    Returns ``{name: {"seconds": wall time of its nvcc (0 when reused),
    "ptxas": the compiler's register and shared-memory report}}``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, out = {}, {}
    for name in names:
        path = lib_path(name)
        if path.exists():
            log = path.with_suffix(".ptxas.txt")
            out[name] = {"seconds": 0.0,
                         "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        todo[name] = (path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (path, tmp, t0, proc) in todo.items():
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{stderr}{stdout}")
            tmp.unlink(missing_ok=True)
            continue
        path.with_suffix(".ptxas.txt").write_text(stderr + stdout)
        os.replace(tmp, path)                 # atomic: readers see whole files
        out[name] = {"seconds": secs, "ptxas": stderr + stdout}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first when missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
