"""Public kernel ops: backend dispatch (port of ``repro/kernels/ops.py``,
forward only — the scale gradient comes with the training slice).

``quant_matmul`` is the single entry point models use for every quantized
fully-connected layer.  Implementations:

  * ``cuda``  — the hand-written kernels of ``kernels/quant_matmul.py``:
                M ≤ ``GEMV_MAX_M`` rows go to the GEMV (every decode step),
                larger M to the tiled GEMM (the prefill).  A CUDA tensor
                launches the kernel; a CPU tensor takes the kernel's plain
                version.  The default.
  * ``torch`` — the plain version on whatever device the tensors are on
                (the card's comparison run of ``chip_smoke.py``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.core.quant import QuantSpec
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.quant_matmul import GEMV_MAX_M

__all__ = ["GEMV_MAX_M", "KNOWN_IMPLS", "attention", "default_impl",
           "force_impl", "quant_matmul"]

_tls = threading.local()

KNOWN_IMPLS = ("cuda", "torch")


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


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                 zero: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """y = x @ Ŵᵀ for arbitrary leading batch dims on x; y in x's dtype,
    through ``default_impl()``."""
    impl = default_impl()
    spec.check_ported()
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2d = x.reshape(-1, k).contiguous()
    if x2d.data_ptr() % 16:              # a view starting mid-vector
        x2d = x2d.clone()
    scale = scale.to(torch.float32).contiguous()
    zero = zero.to(torch.float32).contiguous()
    if impl == "torch":
        y = _qm.quant_matmul_plain(x2d, qw, scale, zero)
    elif x2d.shape[0] <= GEMV_MAX_M:
        y = _qm.quant_gemv(x2d, qw, scale, zero)
    else:
        y = _qm.quant_matmul(x2d, qw, scale, zero)
    return y.reshape(*lead, y.shape[-1])


def attention(q, k, v, *, causal=True, offset=None):
    """Attention entry point (GQA-aware): the plain float32 version."""
    return _ref.flash_attention_ref(q, k, v, causal=causal, offset=offset)
