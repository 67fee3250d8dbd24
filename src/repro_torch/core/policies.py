"""TuningPolicy: prepares (model, trainable mask) for a comparison arm (port
of ``repro/core/policies.py`` for the ``full``, ``peqa`` and ``peqa_z``
arms).

    full   — full fine-tuning (fp backbone, every float tensor trainable)
    peqa   — the paper: integer backbone frozen, ONLY scales trainable
    peqa_z — Table 17 ablation: scales + zero-points trainable (also peqa
             with ``tuning.train_zero_points``)

The other arms are not ported yet and raise ``NotImplementedError``.  The
mask names every parameter (the codes are buffers, always frozen); the
trainable mask drives the masked optimizer (``optim/adamw.py``), which
keeps no state for frozen tensors.
"""
from __future__ import annotations

from typing import Dict, Tuple

from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import peqa

PORTED_MODES = ("full", "peqa", "peqa_z")


def _check_mode(mode: str) -> None:
    if mode not in PORTED_MODES:
        raise NotImplementedError(
            f"tuning mode {mode!r} is not ported yet (have {PORTED_MODES})")


def transform(model: nn.Module, cfg: ModelConfig, *, device=None) -> nn.Module:
    """fp-initialized model → policy model, in place, on ``device`` (the
    card unless ``device="cpu"``)."""
    _check_mode(cfg.tuning.mode)
    if cfg.tuning.mode in ("peqa", "peqa_z"):
        return peqa.quantize_params(model, cfg.quant, device=device)
    return model.to(_device.resolve(device))


def make_mask(model: nn.Module, cfg: ModelConfig) -> Dict[str, bool]:
    """Trainable flag per parameter name, for an ALREADY-transformed model;
    also sets each parameter's ``requires_grad`` to match."""
    mode = cfg.tuning.mode
    _check_mode(mode)
    train_zero = mode == "peqa_z" or cfg.tuning.train_zero_points
    mask = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        train = p.is_floating_point() if mode == "full" \
            else leaf == "scale" or (train_zero and leaf == "zero")
        p.requires_grad_(train)
        mask[name] = train
    return mask


def prepare(model: nn.Module, cfg: ModelConfig, *, device=None
            ) -> Tuple[nn.Module, Dict[str, bool]]:
    """fp-initialized model → (policy model, trainable mask)."""
    model = transform(model, cfg, device=device)
    return model, make_mask(model, cfg)


def _tensors(model: nn.Module):
    return list(model.named_parameters()) + list(model.named_buffers())


def trainable_count(model: nn.Module, mask: Dict[str, bool]) -> int:
    """Values the optimizer trains (the reference's leaf sizes summed)."""
    return sum(t.numel() for name, t in _tensors(model) if mask.get(name))


def frozen_count(model: nn.Module, mask: Dict[str, bool]) -> int:
    """Stored values it does not: frozen parameters and the code words."""
    return sum(t.numel() for name, t in _tensors(model)
               if not mask.get(name))
