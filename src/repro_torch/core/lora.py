"""LoRA adapters — the paper's PEFT baseline (QV4 and QKVO16 configs; port
of ``repro/core/lora.py``).

The adapter sits beside a linear's fp weight or its quantized form
(``models.linear.Linear.set_lora``): ``lora_a`` (r, in) ~ N(0, 1/in) and
``lora_b`` (out, r) = 0, both float32, so a fresh adapter adds nothing.
The reference draws ``lora_a`` from a ``fold_in`` stream of its PRNG key,
which PyTorch cannot reproduce; here it comes from an explicit
``torch.Generator``, and a comparison with the reference carries the
reference's tensors across (``bridge.to_module``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import TuningConfig
from repro_torch.models.linear import Linear


def targets(model: nn.Module, tcfg: TuningConfig):
    """(name, linear) of every projection whose module name is one of
    ``tcfg.lora_targets`` (wq/wk/wv/wo — the paper's QV4 is ("wq", "wv")
    at rank 4, QKVO16 all four at rank 16), in module order."""
    names = set(tcfg.lora_targets)
    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, Linear) and name.rsplit(".", 1)[-1] in names]


@torch.no_grad()
def add_lora(model: nn.Module, generator: torch.Generator,
             tcfg: TuningConfig) -> nn.Module:
    """Insert lora_a/lora_b into every target projection, in place (on the
    model's device; ``generator`` must live there).  Returns the model."""
    r = tcfg.lora_rank
    for _, mod in targets(model, tcfg):
        dev = mod.qw.device if mod.quantized else mod.w.device
        m, n = mod.in_features, mod.out_features
        a = torch.empty(r, m, device=dev)
        if not a.is_meta:                   # the dry run draws nothing
            a.normal_(generator=generator)
        mod.set_lora(a * m ** -0.5, torch.zeros(n, r, device=dev))
    return model


def lora_param_count(model: nn.Module) -> int:
    """Values of every tensor whose name contains ``lora``."""
    return sum(p.numel() for name, p in model.named_parameters()
               if "lora" in name)


@torch.no_grad()
def merge_lora(model: nn.Module, tcfg: TuningConfig) -> nn.Module:
    """Fold each adapter into its fp weight, in place: w += (B·A)·alpha in
    float32 (``lora_alpha``, as the reference's merge, although its forward
    adds the delta at scale 1; they agree at the default alpha of 1).  Only
    fp backbones fold: a quantized linear keeps its adapter — folding it
    into integer codes would break their structure, which is the paper's
    PEFT+PTQ argument."""
    for mod in model.modules():
        if isinstance(mod, Linear) and mod.has_lora and not mod.quantized:
            delta = torch.mm(mod.lora_b, mod.lora_a) * tcfg.lora_alpha
            mod.w.copy_(mod.w + delta.to(mod.w.dtype))
            mod.drop_lora()
    return model
