"""What the variant tools (``tc_variants``, ``gemv_variants``) share: the
llama3.2-1b linears they time, how many copies of a weight rotate it past
the L2, the parallel build of a source's variants and CUDA-graph timing."""
from __future__ import annotations

import contextlib
import ctypes
import math
import subprocess
import tempfile
from pathlib import Path

from repro_torch.kernels import _build

SHAPES = ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192))
L2_BYTES = 50 * 2 ** 20


def require(src: str, name: str, markers) -> None:
    """Raise unless each marker a variant edits occurs once in ``src``."""
    for marker in markers:
        if src.count(marker) != 1:
            raise ValueError(f"{name} no longer has {marker!r} once")


def copies(nbytes: int) -> int:
    """Copies of an ``nbytes`` operand that rotate through twice the L2, as
    the model streams its weights."""
    return max(2, math.ceil(2 * L2_BYTES / nbytes))


@contextlib.contextmanager
def built(sources: dict):
    """Compile each ``{name: CUDA source}``, all nvcc processes at once, into
    a temporary directory; yield ``{name: ctypes.CDLL}``."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, text in sources.items():
            cu = Path(tmp) / f"{name}.cu"
            cu.write_text(text)
            procs[name] = subprocess.Popen(
                [_build.nvcc(), *_build.FLAGS, "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        libs = {}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{name}: nvcc exit {proc.returncode}\n{log}")
            libs[name] = ctypes.CDLL(str(Path(tmp) / f"{name}.so"))
        yield libs


def graph_us(torch, fn, argsets, iters: int) -> float:
    """Device µs a call: ``iters`` calls over ``argsets`` in one CUDA graph."""
    for args in argsets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3
