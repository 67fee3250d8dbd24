"""TuningPolicy: prepares (model, trainable mask) for any of the paper's
comparison arms (port of ``repro/core/policies.py``).

    full      — full fine-tuning (fp backbone, every float tensor trainable)
    lora      — LoRA on the fp backbone (the paper's PEFT baseline)
    lora_optq — LoRA on a quantized backbone (the PTQ+PEFT arm): RTN here,
                as the reference's ``transform``; the OPTQ backbone is
                ``core.gptq.gptq_quantize_transformer`` then
                ``core.lora.add_lora``, as ``benchmarks/common.py`` composes
                them, with this arm's mask
    qat       — fake-quant STE, w + scales + zero points trainable (the
                upper bound)
    peqa      — the paper: integer backbone frozen, ONLY scales trainable
    peqa_z    — Table 17 ablation: scales + zero-points trainable (also peqa
                with ``tuning.train_zero_points``)

The mask names every parameter (the codes are buffers, always frozen); the
trainable mask drives the masked optimizer (``optim/adamw.py``), which
keeps no state for frozen tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora, peqa, qat

MODES = ("full", "lora", "lora_optq", "qat", "peqa", "peqa_z")
# the arms whose policy quantizes the backbone (RTN): ``build`` streams them
QUANTIZING = ("lora_optq", "peqa", "peqa_z")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown tuning mode {mode!r}")


def transform(model: nn.Module, cfg: ModelConfig, *, device=None,
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """fp-initialized model → policy model, in place, on ``device`` (the
    card unless ``device="cpu"``).  ``generator`` draws the LoRA arms'
    ``lora_a`` (on ``device``; seed 0 when None).  On ``device="meta"``
    (a model built there) it is the reference's ``jax.eval_shape`` of
    ``transform``: every leaf's shape and dtype, no value drawn or read
    (``launch/dryrun.py``)."""
    mode = cfg.tuning.mode
    _check_mode(mode)
    meta = str(device) == "meta"
    dev = torch.device("meta") if meta else _device.resolve(device)
    model = model.to(dev)
    if mode in QUANTIZING:
        peqa.quantize_module(model, cfg.quant)
    if mode == "qat":
        qat.add_fake_quant(model, cfg.quant)
    if mode in ("lora", "lora_optq"):
        if generator is None and not meta:
            generator = torch.Generator(device=dev).manual_seed(0)
        lora.add_lora(model, generator, cfg.tuning)
    return model


def make_mask(model: nn.Module, cfg: ModelConfig) -> Dict[str, bool]:
    """Trainable flag per parameter name, for an ALREADY-transformed model;
    also sets each parameter's ``requires_grad`` to match."""
    mode = cfg.tuning.mode
    _check_mode(mode)
    train_zero = mode == "peqa_z" or cfg.tuning.train_zero_points
    mask = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if mode in ("full", "qat"):
            train = p.is_floating_point()
        elif mode in ("lora", "lora_optq"):
            train = "lora" in name
        else:
            train = leaf == "scale" or (train_zero and leaf == "zero")
        p.requires_grad_(train)
        mask[name] = train
    return mask


def prepare(model: nn.Module, cfg: ModelConfig, *, device=None,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[nn.Module, Dict[str, bool]]:
    """fp-initialized model → (policy model, trainable mask)."""
    model = transform(model, cfg, device=device, generator=generator)
    return model, make_mask(model, cfg)


def build(api, seed: int = 0, *,
          generator: Optional[torch.Generator] = None,
          calib: Optional[torch.Tensor] = None
          ) -> Tuple[nn.Module, Dict[str, bool]]:
    """``api.cfg``'s policy model from the seed's random weights → (model,
    trainable mask), on ``api.device``: ``prepare(api.init(seed), cfg)``'s
    result, for every arm.

    A quantizing arm (``QUANTIZING``: RTN codes) is built layer by layer:
    each block's float32 weights are drawn and quantized before the next
    block exists (``api.init``'s ``transform``), so the build's peak is the
    finished model plus about one block's float32 weights and the
    quantizer's temporaries, and a model whose float32 weights exceed the
    card still builds.  Its codes, scales, zeros, biases, norms and table
    are bit-equal to the whole build's: the draws come in the same order.
    The fp arms keep float32 weights anyway and take the whole build.
    ``generator`` draws the LoRA arms' ``lora_a``, as in ``prepare``.

    ``calib`` (B, S) tokens: ``lora_optq``'s backbone is OPTQ's instead of
    RTN's — the whole fp model, quantized by
    ``gptq.gptq_quantize_transformer`` on those tokens, then ``prepare``
    (which leaves GPTQ's codes as they are and adds the adapters), as
    ``benchmarks/common.py`` composes the arm."""
    cfg = api.cfg
    _check_mode(cfg.tuning.mode)
    if calib is not None and cfg.tuning.mode == "lora_optq":
        from repro_torch.core import gptq
        model = gptq.gptq_quantize_transformer(
            api.init(seed), cfg, calib.to(api.device))
    elif cfg.tuning.mode in QUANTIZING:
        model = api.init(seed, transform=lambda name, mod:
                         peqa.quantize_module(mod, cfg.quant, prefix=name))
    else:
        model = api.init(seed)
    return prepare(model, cfg, device=api.device, generator=generator)


def _tensors(model: nn.Module):
    return list(model.named_parameters()) + list(model.named_buffers())


def trainable_count(model: nn.Module, mask: Dict[str, bool]) -> int:
    """Values the optimizer trains (the reference's leaf sizes summed)."""
    return sum(t.numel() for name, t in _tensors(model) if mask.get(name))


def frozen_count(model: nn.Module, mask: Dict[str, bool]) -> int:
    """Stored values it does not: frozen parameters and the code words."""
    return sum(t.numel() for name, t in _tensors(model)
               if not mask.get(name))
