"""Model registry (port of ``repro/models/registry.py``: ``FamilyCaps``,
``ModelAPI`` and ``build``'s dense, moe, vlm, encdec, ssm and hybrid
branches).

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
from repro_torch.models import attention, transformer, whisper, xlstm, zamba2


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


def prefix_rows(cfg: ModelConfig) -> Optional[tuple]:
    """(batch key, rows P) of the per-row prefix state ``cfg``'s family
    takes (``PREFIXES``: a vlm's ``n_img_tokens`` image embeddings, an
    encdec's ``enc_frames`` frames); None for a family that takes none."""
    got = PREFIXES.get(cfg.family)
    return None if got is None else (got[0], getattr(cfg, got[1]))


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    # (seed, transform=None) -> the family's model on device, built block by
    # block (``transformer.init``, ``whisper.init``)
    init: Callable
    # (model, tokens (B, S)) -> logits (B, S, V) f32; an encdec's takes
    # (model, tokens, frames)
    forward: Callable
    loss_fn: Callable         # (model, batch) -> scalar loss
    # (model, batch) -> (last_logits, cache); batch: "tokens", optional
    # "last_pos", for a vlm optional "image_embeds", for an encdec "frames"
    prefill: Callable
    # (model, cache, tokens, pos, draft_bits=None) -> (logits, cache)
    decode_step: Callable
    # (batch, seq_len, device=the API's) -> zero-filled cache
    init_cache: Callable
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
# decoder with MoE blocks —, the vlm — the dense decoder behind a prefix of
# precomputed patch embeddings —, the encdec (whisper): an encoder over
# precomputed frames and a decoder that cross-attends to it —, the ssm
# (xlstm: mLSTM and sLSTM blocks) and the hybrid (zamba2: Mamba2 blocks and
# one shared attention block)
FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")
RECURRENT = ("ssm", "hybrid")
# each family's per-row prefix state: its batch key (``FamilyCaps.prefix_key``)
# and the config field that gives its rows (``prefix_rows``)
PREFIXES = {"vlm": ("image_embeds", "n_img_tokens"),
            "encdec": ("frames", "enc_frames")}
EXPERT_SHARDINGS = ("tensor", "expert")
# the reference's reasons (its registry.py) why an MoE model has no slotted
# steps and no usable verify: the resident and speculative schedulers'
# refusal messages
MOE_SLOTTED_REASON = ("MoE expert dispatch cannot thread per-slot scales "
                      "(no slotted decode step)")
MOE_VERIFY_REASON = "MoE expert dispatch is not supported in the verify step"
# and why an encoder-decoder has neither
ENCDEC_SLOTTED_REASON = "encoder-decoder backbone has no slotted decode step"
NO_VERIFY_REASON = "family has no multi-token verify step (decode_verify)"
# and why the recurrent families (ssm, hybrid) have no slotted step
RECURRENT_SLOTTED_REASON = ("recurrent state layers cannot thread per-slot "
                            "scales (no slotted decode step)")


# why training on a mesh refuses a global batch (the reference homes the
# batch P(data): every data rank takes an equal block of rows)
MESH_BATCH_REASON = ("the global batch of {batch} rows is not divisible by "
                     "the data axis ({data}): every data rank trains on an "
                     "equal block of the batch's rows")


def check_supported(cfg: ModelConfig, mesh=None, *, train: bool = False,
                    batch: Optional[int] = None) -> None:
    """Raise for every configuration this slice of the port does not serve;
    with ``mesh`` (a mesh context), also for what it does not serve on a
    mesh (``dist.sharding.shard_problems``).  With
    ``train`` for what it does not train there: the same, and
    ``remat="dots"``; ``batch``, a training run's global batch, must
    divide the data axis."""
    moe = cfg.moe is not None
    encdec = cfg.family == "encdec"
    fam = cfg.family
    recurrent = fam in RECURRENT
    if fam == "ssm" and cfg.slstm_every:
        xlstm._layout(cfg)              # n_layers % slstm_every, as asserted
    refused = [
        (cfg.family not in FAMILIES, f"family {cfg.family!r}"),
        (encdec and (cfg.enc_layers < 1 or cfg.enc_frames < 1),
         f"family 'encdec' without an encoder (enc_layers={cfg.enc_layers}, "
         f"enc_frames={cfg.enc_frames})"),
        (encdec and cfg.tuning.mode == "lora_optq",
         "lora_optq on encdec: the reference's GPTQ replays "
         "params['embed'] and params['layers'] (core/gptq.py), which a "
         "whisper tree does not have, so it has no OPTQ backbone"),
        (encdec and cfg.kv_cache_dtype != "model",
         f"kv_cache_dtype={cfg.kv_cache_dtype!r} on encdec (the reference's "
         f"whisper cache ignores it and keeps the activation dtype)"),
        (encdec and cfg.swa_window is not None,
         f"swa_window={cfg.swa_window} on encdec (the reference's whisper "
         f"cache and decode step ignore it: a full cache, no ring)"),
        (fam == "ssm" and not cfg.slstm_every,
         f"family 'ssm' without slstm_every ({cfg.slstm_every!r}: the "
         f"reference's xlstm then has no group of blocks to stack)"),
        (fam == "hybrid" and cfg.ssm is None,
         "family 'hybrid' without an SSMConfig (ssm=None)"),
        (not recurrent and cfg.ssm is not None,
         f"an SSMConfig on {fam} (the reference reads cfg.ssm only in its "
         f"ssm and hybrid models)"),
        (fam != "hybrid" and cfg.attn_every is not None,
         f"attn_every={cfg.attn_every} on {fam} (only the reference's "
         f"zamba2 reads it)"),
        (fam != "ssm" and cfg.slstm_every is not None,
         f"slstm_every={cfg.slstm_every} on {fam} (only the reference's "
         f"xlstm reads it)"),
        (recurrent and moe,
         f"an MoEConfig on {fam} (the reference's {_MODEL.get(fam)} blocks "
         f"have no MoE)"),
        (recurrent and cfg.tuning.mode == "lora_optq",
         f"lora_optq on {fam}: the reference's GPTQ reads params['layers'] "
         f"(core/gptq.py), which the {_MODEL.get(fam)} tree does not have, "
         f"so it has no OPTQ backbone"),
        (fam == "ssm" and cfg.kv_cache_dtype != "model",
         f"kv_cache_dtype={cfg.kv_cache_dtype!r} on ssm (the reference's "
         f"xlstm has no KV cache)"),
        (fam == "hybrid" and cfg.kv_cache_dtype != "model",
         f"kv_cache_dtype={cfg.kv_cache_dtype!r} on hybrid (the reference's "
         f"zamba2 cache ignores it and keeps the activation dtype)"),
        (fam == "ssm" and cfg.swa_window is not None,
         f"swa_window={cfg.swa_window} on ssm (the reference's xlstm has "
         f"no attention and no KV cache)"),
        (fam == "ssm" and cfg.attn_impl != "dense",
         f"attn_impl={cfg.attn_impl!r} on ssm (the reference's xlstm has no "
         f"attention)"),
        (fam == "ssm" and cfg.qkv_bias,
         "qkv_bias on ssm (the reference's xlstm has no q/k/v biases)"),
        (fam == "hybrid" and cfg.norm_type == "layernorm",
         "norm_type='layernorm' on hybrid (the reference's Mamba2 gnorm "
         "has a gain and no bias, so its LayerNorm reads a missing leaf)"),
        (moe and cfg.moe.expert_sharding not in EXPERT_SHARDINGS,
         f"expert_sharding={cfg.moe.expert_sharding!r}" if moe else ""),
        (moe and cfg.tuning.mode == "lora_optq",
         "lora_optq on MoE: the reference's GPTQ replays only a dense block "
         "(core/gptq.py reads layer_p['mlp']), so it has no OPTQ backbone "
         "for an MoE model"),
        (cfg.kv_cache_dtype not in KV_CACHE_DTYPES,
         f"kv_cache_dtype={cfg.kv_cache_dtype!r}"),
        (cfg.attn_impl not in ops.ATTN_IMPLS, f"attn_impl={cfg.attn_impl!r}"),
        (not cfg.use_rope and not encdec,
         "learned positions (use_rope=False)"),
        (cfg.act not in ("silu", "gelu"), f"act={cfg.act!r}"),
        (cfg.norm_type not in ("rmsnorm", "layernorm"),
         f"norm_type={cfg.norm_type!r}"),
        (cfg.remat not in transformer.REMATS, f"remat={cfg.remat!r}"),
    ]
    bad = [why for flag, why in refused if flag]
    if mesh is not None and not bad:
        from repro_torch.dist import sharding
        bad = sharding.shard_problems(cfg, mesh.model_size)
        train = train or batch is not None
        if train and cfg.remat == "dots":
            bad.append(transformer.MESH_DOTS_REASON)
        if batch is not None and batch % mesh.data_size:
            bad.append(MESH_BATCH_REASON.format(batch=batch,
                                                data=mesh.data_size))
        if bad:
            verb = "trained" if train else "served"
            raise NotImplementedError(
                f"{cfg.name}: not {verb} on a ({mesh.data_size}, "
                f"{mesh.model_size}) mesh: {'; '.join(bad)}")
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


_MODEL = {"ssm": "xlstm", "hybrid": "zamba2"}


def module_class(cfg: ModelConfig):
    """The ``nn.Module`` class of ``cfg``'s family (storage only)."""
    return {"encdec": whisper.Whisper, "ssm": xlstm.XLSTM,
            "hybrid": zamba2.Zamba2}.get(cfg.family, transformer.Transformer)


def build(cfg: ModelConfig, device=None) -> ModelAPI:
    """The family's API on ``device`` (the card unless ``device="cpu"``):
    ``_build_encdec`` for an encoder-decoder, else the decoder's.  A
    vlm's prefill takes the batch's optional ``"image_embeds"`` (B, P, d):
    its rows take the first P cache positions.  With MoE blocks, as in the reference, there is no slotted
    decode, slotted prefill or slotted verify (None, with the reference's
    reasons in ``FamilyCaps``), and ``decode_verify`` is built but fenced
    off by ``verify_reason``."""
    check_supported(cfg)
    dev = _device.resolve(device)
    if cfg.family == "encdec":
        return _build_encdec(cfg, dev)
    if cfg.family in RECURRENT:
        return _build_recurrent(cfg, dev)
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
        init_cache=lambda b, s, device=dev: attention.init_cache(
            cfg, b, s, device),
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
                        prefix_key=PREFIXES["vlm"][0] if vlm else None,
                        prefix_positions=vlm,
                        slotted_reason=MOE_SLOTTED_REASON if moe else None,
                        verify_reason=MOE_VERIFY_REASON if moe else None),
    )


def _build_encdec(cfg: ModelConfig, dev: torch.device) -> ModelAPI:
    """Whisper's API (reference ``build``'s encdec branch): every prefill
    reads ``batch["frames"]`` (B, enc_frames, d), required; the cross K/V
    are position-free cache leaves, so frames take no decoder position.
    No slotted step and no verify, with the reference's reasons."""

    def init(seed: int = 0, transform=None) -> whisper.Whisper:
        return whisper.init(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev,
            transform=transform)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        forward=lambda m, tokens, frames: whisper.forward(m, frames, tokens,
                                                          cfg),
        loss_fn=lambda m, batch: whisper.loss_fn(m, batch, cfg),
        prefill=lambda m, batch: whisper.prefill(
            m, batch["frames"], batch["tokens"], cfg,
            last_pos=batch.get("last_pos")),
        decode_step=lambda m, c, t, pos: whisper.decode_step(m, c, t, pos,
                                                             cfg),
        init_cache=lambda b, s, device=dev: whisper.init_cache(cfg, b, s,
                                                               device),
        caps=FamilyCaps(positional=True, bucketable=True,
                        prefix_key=PREFIXES["encdec"][0],
                        prefix_required=True,
                        prefix_positions=False,
                        slotted_reason=ENCDEC_SLOTTED_REASON,
                        verify_reason=NO_VERIFY_REASON),
    )


def _build_recurrent(cfg: ModelConfig, dev: torch.device) -> ModelAPI:
    """xlstm's (ssm) or zamba2's (hybrid) API (reference ``build``'s ssm and
    hybrid branches): the prefill reads ``batch["tokens"]`` alone.  Their
    state integrates every input, so no prompt is bucketed; an ssm's
    decode ignores the position, a hybrid's pages its shared block's K/V
    by it.  No slotted step and no verify, with the reference's
    reasons."""
    mod = xlstm if cfg.family == "ssm" else zamba2

    def init(seed: int = 0, transform=None):
        return mod.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev, transform=transform)

    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=init,
        forward=lambda m, tokens: mod.forward(m, tokens, cfg),
        loss_fn=lambda m, batch: mod.loss_fn(m, batch, cfg),
        prefill=lambda m, batch: mod.prefill(m, batch["tokens"], cfg),
        decode_step=lambda m, c, t, pos: mod.decode_step(m, c, t, pos, cfg),
        init_cache=lambda b, s, device=dev: mod.init_cache(cfg, b, s,
                                                           device),
        caps=FamilyCaps(positional=cfg.family == "hybrid", bucketable=False,
                        slotted_reason=RECURRENT_SLOTTED_REASON,
                        verify_reason=NO_VERIFY_REASON),
    )
