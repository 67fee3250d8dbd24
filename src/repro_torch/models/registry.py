"""Model registry (port of ``repro/models/registry.py``: ``FamilyCaps``,
``ModelAPI`` and ``build``'s dense branch).

``build(cfg)`` returns a ``ModelAPI`` with the functions the trainer and the
server call, the speculative ``decode_verify`` and
``decode_verify_slotted`` among them.
Configurations the port does not serve yet raise here, at build time,
instead of computing something else.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, transformer


@dataclasses.dataclass(frozen=True)
class FamilyCaps:
    """Per-family capability record — what the serving engine may assume
    about a family's decode state (the reference's record, with the fields
    the dense family's serving reads; the prefix and verify fields come
    with the families and the slice that read them).

      * ``bucketable`` — prompt-length bucketing (right-pad + last-position
        gather) is sound: padded rows stay causally invisible.
      * ``slotted_reason`` — why ``decode_step_slotted`` is None (the
        resident scheduler's refusal message); None = supported.
      * ``verify_reason`` — why ``decode_verify`` is unusable (the
        speculative scheduler's refusal message); None = supported.
    """
    bucketable: bool = False
    slotted_reason: Optional[str] = None
    verify_reason: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable            # (seed) -> Transformer on device
    forward: Callable         # (model, tokens (B, S)) -> logits (B, S, V) f32
    loss_fn: Callable         # (model, batch) -> scalar loss
    prefill: Callable         # (model, batch) -> (last_logits, cache)
    # (model, cache, tokens, pos, draft_bits=None) -> (logits, cache)
    decode_step: Callable
    init_cache: Callable      # (batch, seq_len) -> cache
    # (model, task_stack, cache, tokens, pos (B,), task_ids,
    # draft_bits=None) -> (logits, cache): mixed-task decode against
    # (T, …)-stacked scales
    decode_step_slotted: Optional[Callable] = None
    # (model, task_stack, batch, task_ids) -> (last_logits, cache): prefill
    # reading per-row scales from the resident stack
    prefill_slotted: Optional[Callable] = None
    # (model, cache, tokens (B, S), pos (B,)) -> (logits (B, S, V), cache):
    # score S tokens in one pass for speculative verify
    decode_verify: Optional[Callable] = None
    # slotted variant (+ task_stack, task_ids)
    decode_verify_slotted: Optional[Callable] = None
    caps: Optional[FamilyCaps] = None


KV_CACHE_DTYPES = ("model", "int8")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every configuration this slice of the port does not serve."""
    refused = [
        (cfg.family != "dense", f"family {cfg.family!r}"),
        (cfg.moe is not None, "mixture-of-experts blocks"),
        (cfg.kv_cache_dtype not in KV_CACHE_DTYPES,
         f"kv_cache_dtype={cfg.kv_cache_dtype!r}"),
        (cfg.bf16_reduce, "bf16_reduce (it halves the tensor-parallel "
         "collectives' bytes, so it comes with the mesh: queue 6)"),
        (cfg.attn_impl not in ops.ATTN_IMPLS, f"attn_impl={cfg.attn_impl!r}"),
        (not cfg.use_rope, "learned positions (use_rope=False)"),
        (cfg.act not in ("silu", "gelu"), f"act={cfg.act!r}"),
        (cfg.norm_type not in ("rmsnorm", "layernorm"),
         f"norm_type={cfg.norm_type!r}"),
        (cfg.remat not in transformer.REMATS, f"remat={cfg.remat!r}"),
    ]
    bad = [why for flag, why in refused if flag]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {'; '.join(bad)}")
    if cfg.tuning.mode in ("lora_optq", "peqa", "peqa_z"):
        cfg.quant.spec().check_ported()
    if cfg.tuning.mode == "lora_optq" and cfg.quant.layout == "plane":
        raise NotImplementedError(
            f"{cfg.name}: lora_optq on layout='plane' is refused: the "
            f"reference's add_lora reads a quantized linear's input width as "
            f"qw.shape[-1] * 8, which is in/4 for (bits, out, in/32) "
            f"bit-planes, and its GPTQ writes nibble words whatever the "
            f"layout (use layout='nibble')")


def build(cfg: ModelConfig, device=None) -> ModelAPI:
    """Dense decoder API on ``device`` (the card unless ``device="cpu"``)."""
    check_supported(cfg)
    dev = _device.resolve(device)

    def init(seed: int = 0) -> transformer.Transformer:
        return transformer.init(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        forward=lambda m, tokens: transformer.forward(m, tokens, cfg),
        loss_fn=lambda m, batch: transformer.loss_fn(m, batch, cfg),
        prefill=lambda m, batch: transformer.prefill(
            m, batch["tokens"], cfg, last_pos=batch.get("last_pos")),
        decode_step=lambda m, c, t, pos, draft_bits=None:
            transformer.decode_step(m, c, t, pos, cfg, draft_bits=draft_bits),
        init_cache=lambda b, s: attention.init_cache(cfg, b, s, dev),
        decode_step_slotted=lambda m, st, c, t, pos, tid, draft_bits=None:
            transformer.decode_step(m, c, t, pos, cfg, task_stack=st,
                                    task_ids=tid, draft_bits=draft_bits),
        prefill_slotted=lambda m, st, batch, tid: transformer.prefill(
            m, batch["tokens"], cfg, last_pos=batch.get("last_pos"),
            task_stack=st, task_ids=tid),
        decode_verify=lambda m, c, t, pos: transformer.decode_verify(
            m, c, t, pos, cfg),
        decode_verify_slotted=lambda m, st, c, t, pos, tid:
            transformer.decode_verify(m, c, t, pos, cfg, task_stack=st,
                                      task_ids=tid),
        caps=FamilyCaps(bucketable=True),
    )
