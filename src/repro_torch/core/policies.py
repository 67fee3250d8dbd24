"""TuningPolicy: prepares (model, trainable mask) for a comparison arm (port
of ``repro/core/policies.py`` for the ``full`` and ``peqa`` arms).

    full — full fine-tuning (fp backbone, every float tensor trainable)
    peqa — the paper: integer backbone frozen, ONLY scales trainable

The other arms are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import peqa

PORTED_MODES = ("full", "peqa")


def _check_mode(mode: str) -> None:
    if mode not in PORTED_MODES:
        raise NotImplementedError(
            f"tuning mode {mode!r} is not ported yet (have {PORTED_MODES})")


def transform(model: nn.Module, cfg: ModelConfig, *, device=None) -> nn.Module:
    """fp-initialized model → policy model, in place, on ``device`` (the
    card unless ``device="cpu"``)."""
    _check_mode(cfg.tuning.mode)
    if cfg.tuning.mode == "peqa":
        return peqa.quantize_params(model, cfg.quant, device=device)
    return model.to(_device.resolve(device))


def make_mask(model: nn.Module, cfg: ModelConfig) -> Dict[str, bool]:
    """Trainable flag per parameter name, for an ALREADY-transformed model;
    also sets each parameter's ``requires_grad`` to match."""
    _check_mode(cfg.tuning.mode)
    mask = {}
    for name, p in model.named_parameters():
        train = p.is_floating_point() if cfg.tuning.mode == "full" \
            else name.endswith("scale")
        p.requires_grad_(train)
        mask[name] = train
    return mask


def prepare(model: nn.Module, cfg: ModelConfig, *, device=None
            ) -> Tuple[nn.Module, Dict[str, bool]]:
    """fp-initialized model → (policy model, trainable mask)."""
    model = transform(model, cfg, device=device)
    return model, make_mask(model, cfg)
