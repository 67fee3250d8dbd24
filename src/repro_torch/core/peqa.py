"""PEQA model transform — the paper's step (a): Decomposition (port of
``repro/core/peqa.py``).

Walks a model's linears and replaces every eligible fully-connected weight
``w (n, m)`` with its quantized form ``qw`` (packed codes), ``scale`` and
``zero`` (n, G) (Eq. (1)).  The port does this IN PLACE, one linear at a
time, freeing each fp weight as its codes land: peak memory stays near the
fp model's instead of holding both trees.

Eligibility is decided on the reference's parameter paths
(``/layers/attn/wq/w``: module names without the layer index), so the
``EXCLUDE`` rule carries over unchanged.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import QuantConfig
from repro_torch.core.quant import pack_codes, rtn_quantize
from repro_torch.models.linear import Linear

# paths whose "w" leaf must never be quantized
EXCLUDE = re.compile(
    r".*(router|embed|conv|/sr|/sb|pos|lm_head).*")


def ref_path(name: str) -> str:
    """Module/tensor name → the reference's tree path: ``layers.3.attn.wq.w``
    → ``/layers/attn/wq/w`` (the reference stacks layers instead of
    numbering them)."""
    return "/" + "/".join(p for p in name.split(".") if not p.isdigit())


def layer_index(name: str):
    """The layer number in a module/tensor name (``layers.3.attn.wq.w`` →
    3), or None for a tensor outside the layer stack."""
    nums = [int(p) for p in name.split(".") if p.isdigit()]
    return nums[0] if nums else None


def eligible(path: str, leaf: torch.Tensor, qcfg: QuantConfig) -> bool:
    if not path.endswith("/w"):
        return False
    if leaf.dim() < 2:
        return False
    if EXCLUDE.match(path) and not (
            qcfg.quantize_lm_head and "lm_head" in path):
        return False
    m = leaf.shape[-1]
    spec = qcfg.spec()
    if spec.packs and m % 8:
        return False
    if spec.group_size and m % spec.group_size:
        return False
    return True


def quantize_leaf(w: torch.Tensor, qcfg: QuantConfig) -> dict:
    """(n, m) fp → dict(qw, scale, zero).  (The reference maps over stacked
    leading dims; the port's layers are separate modules.)"""
    spec = qcfg.spec()
    spec.check_ported()
    q, s, z = rtn_quantize(w, spec, n_grid=qcfg.n_grid)
    return {"qw": pack_codes(q), "scale": s, "zero": z}


@torch.no_grad()
def quantize_params(model: nn.Module, qcfg: QuantConfig, *, device=None
                    ) -> nn.Module:
    """fp model → PEQA model (integer backbone + scales), in place, on
    ``device`` (the card unless ``device="cpu"``).  Returns the model."""
    dev = _device.resolve(device)
    model.to(dev)
    spec = qcfg.spec()
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and not mod.quantized \
                and eligible(ref_path(f"{name}.w"), mod.w, qcfg):
            q = quantize_leaf(mod.w, qcfg)
            mod.set_quantized(q["qw"], q["scale"], q["zero"], spec)
    return model


def model_size_bytes(model: nn.Module, qcfg: QuantConfig) -> int:
    """Deployed size: b-bit codes + fp16 scales/zeros + fp16 fp leaves."""
    total = 0
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if name.endswith("qw"):
            total += int(np.prod(t.shape)) * 8 * qcfg.bits // 8
        else:
            total += int(np.prod(t.shape)) * 2
    return total
