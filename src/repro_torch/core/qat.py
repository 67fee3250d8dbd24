"""QAT baseline (paper §4.1 upper bound; port of ``repro/core/qat.py``):
keep the fp weights, learn the scales too, fake-quantize on the fly with a
straight-through estimator.

Every eligible linear keeps ``w`` and GAINS ``scale``/``zero``, initialised
by the same RTN grid search as PEQA's (``core.quant.rtn_quantize``, the
configured ``n_grid``) — ``models.linear.apply`` sees all three and runs the
fake-quant path.  QAT trains everything (w, scales, zero points, norms, the
token table), which is exactly why the paper calls it infeasible at LLM
scale.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import QuantConfig
from repro_torch.core.peqa import eligible, ref_path
from repro_torch.core.quant import rtn_quantize
from repro_torch.models.linear import Linear


@torch.no_grad()
def add_fake_quant(model: nn.Module, qcfg: QuantConfig) -> nn.Module:
    """Attach RTN-initialised (scale, zero) beside every eligible ``w``, in
    place.  Returns the model."""
    spec = qcfg.spec()
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and not mod.quantized \
                and eligible(ref_path(f"{name}.w"), mod.w, qcfg):
            # an expert stack's (E, out, in): one expert at a time, as the
            # reference's lax.map
            w = mod.w.to(torch.float32)
            flat = w.reshape(-1, *w.shape[-2:])
            sz = [rtn_quantize(wi, spec, n_grid=qcfg.n_grid)[1:]
                  for wi in flat]
            s = torch.stack([t[0] for t in sz]).reshape(
                *w.shape[:-2], *sz[0][0].shape)
            z = torch.stack([t[1] for t in sz]).reshape(
                *w.shape[:-2], *sz[0][1].shape)
            mod.set_fake_quant(s, z, spec)
    return model
