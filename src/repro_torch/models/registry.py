"""Model registry (port of ``repro/models/registry.py``: ``FamilyCaps``,
``ModelAPI`` and ``build``'s dense, moe and vlm branch).

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
    """Per-family capability record — the serving engine's one source of
    truth for what a family's decode state looks like.

    The slot pool consults this record instead of pattern-matching on
    ``cfg.family``: every registered family gets one, and a family whose
    API lacks it is refused by ``SlotPool`` (no silent garbage tracing).

      * ``positional`` — decode threads an absolute position through the
        cache (attention KV rows).  False for pure recurrent state (SSM),
        whose ``decode_step`` ignores ``pos`` entirely.
      * ``prefix_key`` — batch key for per-request prefix state admitted
        once per slot (``"image_embeds"`` for vlm patch embeddings,
        ``"frames"`` for encdec encoder inputs); ``None`` = no prefix.
      * ``prefix_required`` — prefill raises without the prefix (encdec:
        there is nothing to cross-attend); vlm prefixes are optional.
      * ``prefix_positions`` — the prefix occupies decoder cache
        positions (vlm: patch rows share the causal sequence).  Encdec
        cross-KV lives in its own position-free leaves, so frames consume
        ZERO decoder slots.
      * ``bucketable`` — prompt-length bucketing (right-pad + masked
        last-position gather) is sound: padded rows must stay causally
        invisible, which rules out recurrent state (it integrates every
        input) and is additionally gated on no sliding-window ring.
      * ``slotted_reason`` — why ``decode_step_slotted`` is None (the
        resident scheduler's refusal message); None = supported.
      * ``verify_reason`` — why ``decode_verify`` is unusable (the
        speculative scheduler's refusal message); None = supported.
    """
    positional: bool = True
    prefix_key: Optional[str] = None
    prefix_required: bool = False
    prefix_positions: bool = False
    bucketable: bool = False
    slotted_reason: Optional[str] = None
    verify_reason: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    # (seed, transform=None) -> Transformer on device, built block by block
    # (``transformer.init``)
    init: Callable
    forward: Callable         # (model, tokens (B, S)) -> logits (B, S, V) f32
    loss_fn: Callable         # (model, batch) -> scalar loss
    # (model, batch) -> (last_logits, cache); batch: "tokens", optional
    # "last_pos" and, for a vlm, "image_embeds"
    prefill: Callable
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
# the families the port builds: the dense decoder, the moe — the same
# decoder with MoE blocks —, and the vlm — the dense decoder behind a
# prefix of precomputed patch embeddings
FAMILIES = ("dense", "moe", "vlm")
EXPERT_SHARDINGS = ("tensor", "expert")
# the reference's reasons (its registry.py) why an MoE model has no slotted
# steps and no usable verify: the resident and speculative schedulers'
# refusal messages
MOE_SLOTTED_REASON = ("MoE expert dispatch cannot thread per-slot scales "
                      "(no slotted decode step)")
MOE_VERIFY_REASON = "MoE expert dispatch is not supported in the verify step"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every configuration this slice of the port does not serve."""
    moe = cfg.moe is not None
    refused = [
        (cfg.family not in FAMILIES, f"family {cfg.family!r}"),
        (moe and cfg.moe.expert_sharding not in EXPERT_SHARDINGS,
         f"expert_sharding={cfg.moe.expert_sharding!r}" if moe else ""),
        (moe and cfg.quant.layout == "plane",
         "bit-plane codes on MoE experts (MoE has no verify step, so planes "
         "would only be storage; use layout='nibble')"),
        (moe and cfg.tuning.mode == "lora_optq",
         "lora_optq on MoE: the reference's GPTQ replays only a dense block "
         "(core/gptq.py reads layer_p['mlp']), so it has no OPTQ backbone "
         "for an MoE model"),
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
    """The dense, moe or vlm decoder's API on ``device`` (the card unless
    ``device="cpu"``).  A vlm's prefill takes the batch's optional
    ``"image_embeds"`` (B, P, d): its rows take the first P cache
    positions.  With MoE blocks, as in the reference, there is no slotted
    decode, slotted prefill or slotted verify (None, with the reference's
    reasons in ``FamilyCaps``), and ``decode_verify`` is built but fenced
    off by ``verify_reason``."""
    check_supported(cfg)
    dev = _device.resolve(device)
    vlm = cfg.family == "vlm"
    moe = cfg.moe is not None

    def init(seed: int = 0, transform=None) -> transformer.Transformer:
        return transformer.init(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev,
            transform=transform)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        forward=lambda m, tokens: transformer.forward(m, tokens, cfg),
        loss_fn=lambda m, batch: transformer.loss_fn(m, batch, cfg),
        prefill=lambda m, batch: transformer.prefill(
            m, batch["tokens"], cfg, prefix_embeds=batch.get("image_embeds"),
            last_pos=batch.get("last_pos")),
        decode_step=lambda m, c, t, pos, draft_bits=None:
            transformer.decode_step(m, c, t, pos, cfg, draft_bits=draft_bits),
        init_cache=lambda b, s: attention.init_cache(cfg, b, s, dev),
        decode_step_slotted=None if moe else (
            lambda m, st, c, t, pos, tid, draft_bits=None:
            transformer.decode_step(m, c, t, pos, cfg, task_stack=st,
                                    task_ids=tid, draft_bits=draft_bits)),
        prefill_slotted=None if moe else (
            lambda m, st, batch, tid: transformer.prefill(
                m, batch["tokens"], cfg,
                prefix_embeds=batch.get("image_embeds"),
                last_pos=batch.get("last_pos"), task_stack=st, task_ids=tid)),
        decode_verify=lambda m, c, t, pos: transformer.decode_verify(
            m, c, t, pos, cfg),
        decode_verify_slotted=None if moe else (
            lambda m, st, c, t, pos, tid:
            transformer.decode_verify(m, c, t, pos, cfg, task_stack=st,
                                      task_ids=tid)),
        caps=FamilyCaps(bucketable=True,
                        prefix_key="image_embeds" if vlm else None,
                        prefix_positions=vlm,
                        slotted_reason=MOE_SLOTTED_REASON if moe else None,
                        verify_reason=MOE_VERIFY_REASON if moe else None),
    )
