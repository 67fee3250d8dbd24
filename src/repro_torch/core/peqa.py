"""PEQA model transform — the paper's step (a): Decomposition (port of
``repro/core/peqa.py``).

Walks a model's linears and replaces every eligible fully-connected weight
``w (n, m)`` with its quantized form ``qw`` (packed codes: (n, m/8) nibble
words, or (bits, n, m/32) bit-plane words), ``scale`` and ``zero`` (n, G)
(Eq. (1)).  The port does this IN PLACE, one linear at a
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
from repro_torch.core.quant import (PLANE_PACK, pack_codes, pack_codes_planes,
                                    rtn_quantize, unpack_codes,
                                    unpack_codes_planes)
from repro_torch.kernels import ops
from repro_torch.models.linear import Linear

# paths whose "w" leaf must never be quantized
EXCLUDE = re.compile(
    r".*(router|embed|conv|/sr|/sb|pos|lm_head).*")
# float32 weights the quantizer takes at once when it maps over a leaf's
# leading dims (an MoE block's expert stack): one (n, m) matrix at a time,
# or as many small ones as fit this budget as one (k·n, m) matrix — its
# rows are quantized independently —, so the temporaries stay one large
# expert's (mixtral-8x7b's 14336 × 4096 experts go one by one) while
# deepseek-moe-16b's 1408 × 2048 ones go 23 at a time, not in 64 host-bound
# rounds of the grid search
QUANT_CHUNK_ELEMENTS = 1 << 26


def ref_path(name: str) -> str:
    """Module/tensor name → the reference's tree path: ``layers.3.attn.wq.w``
    → ``/layers/attn/wq/w`` (the reference stacks layers instead of
    numbering them)."""
    return "/" + "/".join(p for p in name.split(".") if not p.isdigit())


def layer_index(name: str):
    """The layer number in a module/tensor name (``layers.3.attn.wq.w`` →
    3), a tuple of them in a stack two deep (``mlstm.2.1.wq.w`` → (2, 1):
    the reference's (n_groups, n_m, …) leaves), or None for a tensor
    outside every stack."""
    nums = tuple(int(p) for p in name.split(".") if p.isdigit())
    if not nums:
        return None
    return nums[0] if len(nums) == 1 else nums


def stacked_shape(indices) -> tuple:
    """The leading dims of a stacked leaf from its entries' ``layer_index``
    values: (L,) for layer numbers, (n_groups, n_m) for pairs."""
    indices = list(indices)
    if not isinstance(indices[0], tuple):
        return (len(indices),)
    shape = tuple(max(i[d] for i in indices) + 1
                  for d in range(len(indices[0])))
    if int(np.prod(shape)) != len(indices):
        raise ValueError(f"stack indices {sorted(indices)} do not fill "
                         f"{shape}")
    return shape


def stack_indexed(by_index: dict) -> np.ndarray:
    """{layer_index: array} → one array stacked in index order, its leading
    dims ``stacked_shape``'s; a single unindexed entry (key None) as it
    is."""
    if None in by_index:
        return by_index[None]
    keys = sorted(by_index)
    flat = np.stack([by_index[k] for k in keys])
    return flat.reshape(*stacked_shape(keys), *flat.shape[1:])


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
    if spec.plane and m % PLANE_PACK:
        return False
    if spec.group_size and m % spec.group_size:
        return False
    return True


def quantize_leaf(w: torch.Tensor, qcfg: QuantConfig) -> dict:
    """(…, n, m) fp → dict(qw, scale, zero), each with w's leading dims (an
    MoE block's expert stack (E, n, m): qw (E, n, m/8) nibble words or (E,
    bits, n, m/32) bit-planes, the reference's per-expert layout under its
    map).  As the reference's ``quantize_leaf``, the leading dims are
    mapped SEQUENTIALLY — one (n, m) matrix at a time, or a chunk of small
    ones within ``QUANT_CHUNK_ELEMENTS`` quantized as one (k·n, m) matrix
    (its rows are independent, so the codes are each expert's own; a
    chunk's planes (bits, k·n, m/32) are split back into k experts'), each
    result written into the stacked output — so the quantizer's
    temporaries are one large expert's, not E's.  (The reference maps over
    stacked layers too; the port's layers are separate modules.)

    Plain min/max RTN (``n_grid <= 1``) of an asymmetric spec is the
    conversion kernel's function: it goes through ``ops.rtn_pack`` (K3 for
    nibbles, K6b for bit-planes, on the card).  Everything else runs
    ``rtn_quantize`` and packs — the same function as the reference's
    ``quantize_leaf`` either way.  On ``meta`` (the dry run's build) it
    returns the same shapes and dtypes and reads no value."""
    if w.is_meta:
        return abstract_leaf(w.shape, qcfg)
    if w.dim() > 2:
        lead, (n, m) = w.shape[:-2], w.shape[-2:]
        flat = w.reshape(-1, n, m)
        step = max(1, QUANT_CHUNK_ELEMENTS // (n * m))
        out = None
        for i in range(0, flat.shape[0], step):
            part = flat[i:i + step]
            q = quantize_leaf(part.reshape(-1, m), qcfg)
            if qcfg.layout == "plane":           # (bits, k·n, m/32)
                q["qw"] = q["qw"].reshape(q["qw"].shape[0], part.shape[0], n,
                                          -1).transpose(0, 1)
            else:
                q["qw"] = q["qw"].reshape(part.shape[0], n, -1)
            q["scale"] = q["scale"].reshape(part.shape[0], n, -1)
            q["zero"] = q["zero"].reshape(part.shape[0], n, -1)
            if out is None:
                out = {k: torch.empty((flat.shape[0], *v.shape[1:]),
                                      dtype=v.dtype, device=v.device)
                       for k, v in q.items()}
            for k, v in q.items():
                out[k][i:i + step] = v
            del q
        return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}
    spec = qcfg.spec()
    spec.check_ported()
    spec.validate(w.shape[-1])
    if qcfg.n_grid <= 1 and not spec.symmetric:
        qw, s, z = ops.rtn_pack(w, spec)
        return {"qw": qw, "scale": s, "zero": z}
    q, s, z = rtn_quantize(w, spec, n_grid=qcfg.n_grid)
    qw = pack_codes_planes(q, spec.bits) if spec.plane else pack_codes(q)
    return {"qw": qw, "scale": s, "zero": z}


def abstract_leaf(shape, qcfg: QuantConfig) -> dict:
    """``quantize_leaf``'s result for a (…, n, m) weight on ``meta``:
    (…, n, m/8) nibble words or (…, bits, n, m/32) bit-planes, and (…, n,
    G) float32 scales and zeros."""
    spec = qcfg.spec()
    *lead, n, m = shape
    qw = (*lead, spec.bits, n, m // PLANE_PACK) if spec.plane \
        else (*lead, n, m // 8)
    sz = (*lead, n, spec.n_groups(m))
    return {"qw": torch.empty(qw, dtype=torch.int32, device="meta"),
            "scale": torch.empty(sz, device="meta"),
            "zero": torch.empty(sz, device="meta")}


@torch.no_grad()
def quantize_module(module: nn.Module, qcfg: QuantConfig, prefix: str = ""
                    ) -> nn.Module:
    """Quantize every eligible fp linear of ``module`` in place, where it
    lies.  ``prefix`` is the module's path in the whole model (``layers.3``,
    ``lm_head``): eligibility is decided on the whole model's names.
    Returns the module."""
    spec = qcfg.spec()
    for name, mod in module.named_modules(prefix=prefix):
        if isinstance(mod, Linear) and not mod.quantized \
                and eligible(ref_path(f"{name}.w"), mod.w, qcfg):
            q = quantize_leaf(mod.w, qcfg)
            mod.set_quantized(q["qw"], q["scale"], q["zero"], spec)
    return module


@torch.no_grad()
def quantize_params(model: nn.Module, qcfg: QuantConfig, *, device=None
                    ) -> nn.Module:
    """fp model → PEQA model (integer backbone + scales), in place, on
    ``device`` (the card unless ``device="cpu"``).  Returns the model."""
    dev = _device.resolve(device)
    model.to(dev)
    return quantize_module(model, qcfg)


@torch.no_grad()
def dequantize_params(model: nn.Module, qcfg: QuantConfig) -> nn.Module:
    """PEQA model → fp model, in place: every quantized linear's ``w`` is
    Ŵ = s·(q − z) in float32 (merges the tuned scales into the weights;
    for export and comparisons).  An expert stack's leading axis is kept:
    its rows are dequantized as (E·out) channels."""
    spec = qcfg.spec()
    for mod in model.modules():
        if isinstance(mod, Linear) and mod.quantized:
            k = mod.in_features
            lead = mod.scale.shape[:-1]           # (out,) or (E, out)
            rows = int(np.prod(lead))
            # planes: the bits axis first, (bits, [E,] out, in/32)
            codes = unpack_codes_planes(mod.qw.movedim(-3, 0), k) \
                if spec.plane else unpack_codes(mod.qw.reshape(rows, -1), k)
            s, z = mod.scale.detach(), mod.zero.detach()
            g = s.shape[-1]
            cg = codes.reshape(*lead, g, k // g).to(torch.float32)
            w = (s[..., None] * (cg - z[..., None])).reshape(*lead, k)
            mod.set_dense(w)
    return model


def model_size_bytes(model: nn.Module, qcfg: QuantConfig) -> int:
    """Deployed size: b-bit codes + fp16 scales/zeros + fp16 fp leaves
    (bit-planes count their raw words: b bits per weight)."""
    spec = qcfg.spec()
    total = 0
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if name.endswith("qw"):
            if spec.plane:
                total += int(np.prod(t.shape)) * 4
            else:
                total += int(np.prod(t.shape)) * 8 * qcfg.bits // 8
        else:
            total += int(np.prod(t.shape)) * 2
    return total
