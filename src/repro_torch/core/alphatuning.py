"""AlphaTuning (Kwon et al. [43]) — paper Appendix J comparison (port of
``repro/core/alphatuning.py``).

Binary-coding quantization (BCQ): W ≈ Σ_{b=1..B} α_b ⊙ sign-matrix B_b with
per-channel α_b, built greedily (alternating sign/least-squares).  Only α_1
is trainable (the paper's point: the other b−1 static scales are dead
weight → PEQA's single uniform scale wins; Table 15 reproduces this).

In the reference this is not a tuning arm: ``linear.apply`` has no BCQ
mode, and only its Table J benchmark drives it, with a forward of its own.
So here, too, it is functions over a flat dict of tensors keyed by the
reference's paths (``/layers/attn/wq/w``; ``core.peqa.ref_path`` of a
module's tensor names), not a storage mode of ``Linear``.  A linear's BCQ
leaves are ``alpha1`` (…, n), ``alpha_rest`` (…, B−1, n) and ``signs``
(…, B, n, m) int8 ±1.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core.peqa import eligible
from repro_torch.kernels import ops


def _signs(r: torch.Tensor) -> torch.Tensor:
    return torch.where(r >= 0, 1.0, -1.0).to(r.dtype)


def bcq_decompose(w: torch.Tensor, bits: int, n_iter: int = 6):
    """w (n, m) → (alphas (bits, n), signs (bits, n, m) ∈ {−1,+1}),
    float32: ``bits`` greedy residual steps (sign, mean magnitude), then
    ``n_iter`` rounds of refitting each (α_i, B_i) to the residual the
    others leave."""
    w = w.to(torch.float32)
    n, m = w.shape
    signs, alphas = [], []
    r = w
    for _ in range(bits):
        b = _signs(r)
        a = r.abs().mean(-1)
        signs.append(b)
        alphas.append(a)
        r = r - a[:, None] * b
    signs, alphas = torch.stack(signs), torch.stack(alphas)
    for _ in range(n_iter):  # alternating refinement
        for i in range(bits):
            r = w - torch.einsum("bn,bnm->nm", alphas, signs) \
                + alphas[i][:, None] * signs[i]
            b = _signs(r)
            signs[i] = b
            alphas[i] = (r * b).sum(-1) / m
    return alphas, signs


def bcq_apply(alphas: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bn,bnm->nm", alphas, signs.detach())


@torch.no_grad()
def alphatuning_params(params: Dict[str, torch.Tensor],
                       qcfg: QuantConfig) -> Dict[str, torch.Tensor]:
    """fp tensors → BCQ tensors: each eligible ``…/w`` (leading layer dims
    allowed) becomes ``…/alpha1`` (α_1, the one trained), ``…/alpha_rest``
    and ``…/signs`` (int8); every other tensor is kept."""
    out = {}
    for path, val in params.items():
        if not eligible(path, val, qcfg):
            out[path] = val
            continue
        lead = val.shape[:-2]
        flat = val.reshape(-1, *val.shape[-2:])
        dec = [bcq_decompose(wi, qcfg.bits) for wi in flat]
        a = torch.stack([d[0] for d in dec]).reshape(*lead, qcfg.bits, -1)
        s = torch.stack([d[1] for d in dec]).reshape(*lead, *dec[0][1].shape)
        base = path[:-len("/w")]
        out[f"{base}/alpha1"] = a[..., 0, :].contiguous()
        out[f"{base}/alpha_rest"] = a[..., 1:, :].contiguous()
        out[f"{base}/signs"] = s.to(torch.int8)
    return out


def alphatuning_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """Trainable = α_1 only (first BCQ scale), per AlphaTuning."""
    return {path: path.rsplit("/", 1)[-1] == "alpha1" for path in params}


def linear_entry(params: Dict[str, torch.Tensor], prefix: str
                 ) -> Dict[str, torch.Tensor]:
    """One linear's leaves by leaf name: ``prefix`` ``/layers/attn/wq`` →
    {"alpha1", "alpha_rest", "signs"[, "b"]} (the reference's subtree)."""
    return {path[len(prefix) + 1:]: t for path, t in params.items()
            if path.rsplit("/", 1)[0] == prefix}


def bcq_weight(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Reassemble W = Σ_b α_b ⊙ B_b from (alpha1, alpha_rest, signs);
    supports stacked leading layer dims."""
    alphas = torch.cat([p["alpha1"][..., None, :], p["alpha_rest"]], dim=-2)
    signs = p["signs"].to(torch.float32).detach()
    return torch.einsum("...bn,...bnm->...nm", alphas, signs)


def linear_apply_bcq(p: Dict[str, torch.Tensor], x: torch.Tensor
                     ) -> torch.Tensor:
    """Forward for a BCQ layer: y = x·(Σ α_b B_b)ᵀ in x's dtype (the
    reference's einsum with a float32 output, ``ops.dot_f32``, then
    rounded); only α_1 trains (alpha_rest is frozen by
    ``alphatuning_mask``)."""
    y = ops.dot_f32(x, bcq_weight(p).to(x.dtype)).to(x.dtype)
    return y + p["b"].to(x.dtype) if "b" in p else y
