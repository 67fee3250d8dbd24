"""Decoder-only transformer backbone, the dense, moe and vlm families (port
of ``repro/models/transformer.py``: ``init``, the training ``forward`` and
``loss_fn``, ``prefill``, ``decode_step`` and the speculative
``decode_verify``, each serving function with the reference's mixed-task
``task_stack``/``task_ids`` form; a vlm's patch-embedding prefix enters
``forward``, ``loss_fn`` and ``prefill`` and is only cache rows after).
A block's feed-forward is its ``mlp`` or, with ``cfg.moe``, its ``moe``
(``models/moe.py``), whose Switch aux loss the training forward sums over
layers into ``loss_fn``.

Layers are a ``ModuleList`` of per-layer blocks and run in a Python loop
(the reference stacks them and scans).  ``bridge.py`` converts between the
two layouts.

The same functions run a rank's shard of the model on a ``(data, model)``
mesh (``dist/sharding.py``) under ``context.use_mesh``: attention on the
rank's local heads (the shard's config), row-parallel sums and the
vocab-sharded lookup reduced in ``linear`` and ``common``, the logits
gathered here unless the run keeps them vocab-sharded.  Training on a
shard differentiates through the Megatron pair (``context.copy_to_model``
before each column-parallel group, ``reduce_from_model`` after each
row-parallel sum) and scores the vocab block where it lies
(``common.vocab_parallel_cross_entropy``).  Activations are
replicated over the model axis between blocks: the reference's
Megatron-SP layout hint (``constrain_tokens``) changes no result and has
no counterpart.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import context
from repro_torch.kernels import ops
from repro_torch.models import attention, common, linear, moe


class Block(nn.Module):
    """ln1, attn, ln2 and the feed-forward: ``mlp``, or ``moe`` when the
    config has one (the other is None)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = common.Norm(cfg, device=device)
        self.attn = attention.Attention(cfg, device=device)
        self.ln2 = common.Norm(cfg, device=device)
        self.mlp = common.MLP(cfg, device=device) if cfg.moe is None \
            else None
        self.moe = moe.MoE(cfg, device=device) if cfg.moe is not None \
            else None


class Transformer(nn.Module):
    """Parameters only; the forward functions are below.  Created with
    uninitialised storage — ``init`` fills it from a generator, ``bridge``
    from a reference tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.embed = common.Embed(cfg, device=device)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.Norm(cfg, device=device)
        self.lm_head = None if cfg.tie_embeddings else \
            linear.Linear(cfg.d_model, cfg.vocab_size, device=device)


def init(cfg: ModelConfig, generator: torch.Generator, device,
         transform=None) -> Transformer:
    """Random float32 weights from ``generator`` (which must live on
    ``device``): N(0, 1/in) linears, N(0, 0.02²) embedding, unit norms.

    Built one piece at a time: the skeleton on ``meta`` (no storage), then
    the token table, block 0, block 1, …, the final norm and the head made
    on ``device`` in that order, each piece's linears drawn in module order
    — the order of a walk over the whole model's ``modules()``, so the
    values do not depend on how the model is built.  ``transform(name,
    module)``, where given, is applied to each block and to the head
    (``name`` its module path, ``layers.3`` or ``lm_head``) after its draws
    and before the next piece exists: a quantizing policy there keeps the
    build's peak at the finished model plus one block's float32 weights
    (``core.policies.build``)."""
    model = Transformer(cfg, device="meta")
    model.embed = common.Embed(cfg, device=device)
    model.embed.reset_parameters(generator)

    def make(name: str, mod: nn.Module) -> nn.Module:
        for sub in mod.modules():
            if isinstance(sub, linear.Linear):
                sub.reset_parameters(generator)
        if transform is not None:
            transform(name, mod)
        return mod

    for i in range(cfg.n_layers):
        model.layers[i] = make(f"layers.{i}", Block(cfg, device=device))
    model.final_norm = common.Norm(cfg, device=device)
    if model.lm_head is not None:
        model.lm_head = make("lm_head", linear.Linear(
            cfg.d_model, cfg.vocab_size, device=device))
    return model


def _final_logits(model: Transformer, h: torch.Tensor, cfg: ModelConfig,
                  slots=None, draft_bits=None):
    """The head's float32 logits.  On a model-axis shard: the rank's vocab
    block under ``context.use_mesh(ctx, logitshard=True)`` — the
    shard-local samplers take it as it is —, else the whole row, gathered
    over the model axis."""
    h = common.norm_apply(model.final_norm, h, cfg)
    return common.gather_vocab(common.head_apply(
        model.lm_head, model.embed, h, cfg, slots=slots,
        draft_bits=draft_bits), model.embed)


# ModelConfig.remat values the port runs: "none" keeps every activation for
# the backward; "block" and "full" (the same in the reference) recompute
# each block's forward in the backward from its input; "dots" recomputes
# it too but keeps the outputs of its dense products (the reference's
# ``checkpoint_dots`` policy, ``dots_policy``)
REMATS = ("none", "block", "full", "dots")
MESH_DOTS_REASON = ("remat='dots' on a mesh is not ported (its selective "
                    "checkpoint would replay the row-parallel collectives "
                    "under its own policy): use 'none' or 'block'")
# the dispatched ops a dense product lowers to (the fp linears' and the
# router's ``ops.dot_f32``, the plain attention's einsums)
_DOTS = frozenset((torch.ops.aten.mm, torch.ops.aten.bmm,
                   torch.ops.aten.addmm, torch.ops.aten.baddbmm))


def dots_policy(ctx, func, *args, **kwargs):
    """remat="dots"'s selective-checkpoint policy: save the output of every
    dense product, recompute everything else.  A quantized linear (K1, K2
    and their forms) and K4 are recomputed: on the card they are launches
    the dispatcher never sees, and their plain versions on the CPU run
    inside ``ops.kernel_region`` — as the reference's kernel path, where
    ``_qmm`` is a custom VJP over a ``pallas_call``, not a ``dot_general``.
    Their outputs' allocations are recomputed too."""
    if func.overloadpacket in _DOTS and not ops.in_kernel():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    """The (forward, recompute) contexts of one "dots" checkpoint."""
    return create_selective_checkpoint_contexts(dots_policy)


def _ffn(layer: Block, h: torch.Tensor, cfg: ModelConfig, slots=None,
         draft_bits=None, ctx=None):
    """The block's feed-forward on ln2(h) → (out, aux): the MLP (aux None)
    or the MoE block (its aux loss, float32).  The MoE block serves one
    task's scales (nibble codes or bit-planes) and no draft read: the
    reference builds it no slotted step, and its verify is refused by
    ``FamilyCaps.verify_reason``.  ``ctx``: a model-axis shard in training,
    whose ln2 output passes through ``context.copy_to_model``."""
    hin = common.norm_apply(layer.ln2, h, cfg)
    if ctx is not None:
        hin = context.copy_to_model(hin, ctx)
    if layer.moe is None:
        return common.mlp_apply(layer.mlp, hin, cfg, slots=slots,
                                draft_bits=draft_bits), None
    if slots is not None:
        raise NotImplementedError(
            "MoE expert dispatch cannot thread per-slot scales (no slotted "
            "step)")
    if draft_bits is not None:
        raise NotImplementedError(
            "MoE expert dispatch is not supported in the verify step (no "
            "draft read)")
    return moe.apply(layer.moe, hin, cfg)


def _block_train(layer: Block, h: torch.Tensor, cfg: ModelConfig, rope,
                 ctx=None):
    """Pre-norm block over the full sequence (reference ``_block_train``)
    → (h, aux): the norms and the MLP by the config (RMSNorm or LayerNorm,
    SwiGLU or GELU), or the MoE block and its aux loss (None without).

    ``ctx``: a model-axis shard's mesh context, installed here — a remat
    recompute runs this in the backward, on autograd's thread on the card,
    where the caller's ``use_mesh`` is not — and each norm's output passes
    through ``context.copy_to_model``: one all-reduce of its gradient for
    the column-parallel group it feeds (q/k/v, gate/up)."""
    if ctx is None:
        h = h + attention.apply_train(
            layer.attn, common.norm_apply(layer.ln1, h, cfg), cfg, rope)
        m, aux = _ffn(layer, h, cfg)
        return h + m, aux
    with context.use_mesh(ctx):
        x = context.copy_to_model(common.norm_apply(layer.ln1, h, cfg), ctx)
        h = h + attention.apply_train(layer.attn, x, cfg, rope)
        m, aux = _ffn(layer, h, cfg, ctx=ctx)
        return h + m, aux


def _embed(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
           prefix_embeds: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings (B, S, d), with the vlm's prefix rows (B, P, d),
    cast to the activation dtype, before them: (B, P + S, d)."""
    h = common.embed_apply(model.embed, tokens, cfg)
    if prefix_embeds is None:
        return h
    return torch.cat([prefix_embeds.to(h.dtype), h], dim=1)


def forward(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence forward for training: tokens (B, S) → logits (B, P + S,
    V) float32 (reference ``forward``, off the mesh, without its aux loss:
    ``forward_aux``).  ``prefix_embeds`` (vlm): (B, P, d) precomputed patch
    embeddings placed before the token embeddings; the positions run over
    all P + S rows."""
    return forward_aux(model, tokens, cfg, prefix_embeds)[0]


def forward_aux(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
                prefix_embeds: torch.Tensor | None = None):
    """``forward``'s logits and the MoE blocks' aux loss summed over layers
    in layer order, float32 (the reference's ``(logits, aux)``; aux None
    without MoE).  Under ``cfg.remat`` "block" or "full" each block runs
    under ``torch.utils.checkpoint`` (non-reentrant), so the backward
    recomputes its forward — every quantized linear's kernel twice a step
    — and the aux comes out of the checkpoint with h.  Under "dots" the
    the same checkpoint keeps its dense products' outputs (``dots_policy``):
    the backward recomputes the rest, every quantized linear included.
    An MoE block's recompute routes as its forward did under either: the
    router's logits are the same product of the same input."""
    h, total = _trunk(model, tokens, cfg, prefix_embeds)
    return _final_logits(model, h, cfg), total


def _trunk(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
           prefix_embeds: torch.Tensor | None = None):
    """The embedding and every block under ``cfg.remat`` → (h, aux)."""
    if cfg.remat not in REMATS:
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported "
                                  f"(have {REMATS})")
    ctx = context.current() if model.embed.vocab_start is not None else None
    if ctx is not None and cfg.remat == "dots":
        raise NotImplementedError(MESH_DOTS_REASON)
    h = _embed(model, tokens, cfg, prefix_embeds)
    rope = common.rope_table(cfg, torch.arange(h.shape[1], device=h.device))
    total = None
    for layer in model.layers:
        if cfg.remat == "none":
            h, aux = _block_train(layer, h, cfg, rope, ctx)
        elif cfg.remat == "dots":
            h, aux = checkpoint(_block_train, layer, h, cfg, rope,
                                use_reentrant=False,
                                context_fn=_dots_contexts)
        else:
            h, aux = checkpoint(_block_train, layer, h, cfg, rope, ctx,
                                use_reentrant=False)
        if aux is not None:
            total = aux if total is None else total + aux
    return h, total


def loss_fn(model: Transformer, batch: dict, cfg: ModelConfig
            ) -> torch.Tensor:
    """Token-mean next-token cross entropy of ``batch`` ({"tokens",
    "labels", optional "mask" and "image_embeds"}: tensors on the model's
    device), plus ``router_aux_coef`` × the MoE aux loss where the config
    has MoE blocks.  With a vlm prefix only the text rows are scored: the
    last ``labels.shape[1]`` rows of the logits (on a shard, of the final
    norm's input: the prefix rows never reach the head).

    On a model-axis shard the batch is this rank's rows of the global
    batch and the loss is the global batch's token mean, equal on every
    rank: the head's logits stay the rank's vocab block (never gathered)
    and go through ``common.vocab_parallel_cross_entropy``, which also
    averages the MoE term (the aux loss of the rank's data block) over the
    data axis, as the reference's ``pmean``."""
    labels = batch["labels"]
    if model.embed.vocab_start is not None:
        ctx = context.require()
        h, aux = _trunk(model, batch["tokens"], cfg,
                        prefix_embeds=batch.get("image_embeds"))
        h = common.norm_apply(model.final_norm, h[:, h.shape[1]
                                                  - labels.shape[1]:], cfg)
        block = common.head_apply(model.lm_head, model.embed, h, cfg)
        return common.vocab_parallel_cross_entropy(
            block, labels, batch.get("mask"), ctx,
            aux=None if aux is None else cfg.moe.router_aux_coef * aux)
    logits, aux = forward_aux(model, batch["tokens"], cfg,
                              prefix_embeds=batch.get("image_embeds"))
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    ce = common.cross_entropy(logits, labels, batch.get("mask"))
    if aux is None:
        return ce
    return ce + cfg.moe.router_aux_coef * aux


def _layer_stack(tree, i: int):
    """Layer ``i``'s slice of a stacked-scale tree: every (L, T, N, G) leaf
    → its contiguous (T, N, G) view."""
    if isinstance(tree, dict):
        return {k: _layer_stack(v, i) for k, v in tree.items()}
    return tree[i]


def prefill(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: torch.Tensor | None = None,
            task_stack: dict | None = None,
            task_ids: torch.Tensor | None = None, last_pos: int | None = None):
    """Forward over the prompt (B, S), building the KV cache.

    prefix_embeds (vlm): (B, P, d) patch embeddings before the prompt; they
    take the cache's first P rows, and the sequence below is P + S long.

    task_stack/task_ids: the prompt's quantized linears read each batch
    row's scales from the resident stack (``scale_bank.ResidentStack.stack``,
    leaves (L, T, N, G)) instead of the live ``Linear.scale`` —
    ``task_ids: (B,) int32`` stack rows, repeated per token here.

    last_pos: index of the last REAL row of the (prefix +) prompt sequence
    when the prompt is right-padded to a bucket length — the head reads
    that row instead of the last one.  Padded rows sit causally after every
    real row, so they never influence it.

    Returns (last_logits (B, V) f32, cache): the cache's leaves stacked
    over layers, (L, B, C, …) at C = ``attention.cache_capacity(cfg, S)``
    (the window's ring holds the last C tokens), in the configured layout
    (``attention.prefill_cache_entry``).
    """
    h = _embed(model, tokens, cfg, prefix_embeds)
    b, s, _ = h.shape
    rope = common.rope_table(cfg, torch.arange(s, device=h.device))
    cap = attention.cache_capacity(cfg, s)
    slotted = task_stack is not None
    # quantized linears flatten (B, P + S, d) to B·(P + S) rows: one id per
    # row, so the prefix rows read the request's scales too
    tok_ids = task_ids.repeat_interleave(s) if slotted else None
    entries = []
    for i, layer in enumerate(model.layers):
        slots = (tok_ids, _layer_stack(task_stack["layers"], i)) \
            if slotted else None
        a, ck, cv = attention.apply_prefill(
            layer.attn, common.norm_apply(layer.ln1, h, cfg), cfg, rope, cap,
            slots=linear.slot_entry(slots, "attn"))
        h = h + a
        h = h + _ffn(layer, h, cfg, slots=linear.slot_entry(slots, "mlp"))[0]
        entries.append(attention.prefill_cache_entry(ck, cv, cfg))
    # the head sees only the last (real) token: one row per batch element
    head_slots = linear.slot_entry((task_ids, task_stack), "lm_head") \
        if slotted else None
    hl = h[:, -1:] if last_pos is None else h[:, last_pos:last_pos + 1]
    logits = _final_logits(model, hl, cfg, slots=head_slots)
    return logits[:, 0], {key: torch.stack([e[key] for e in entries])
                          for key in entries[0]}


def _decode_tokens(model: Transformer, cache: dict, tokens: torch.Tensor,
                   pos, cfg: ModelConfig, task_stack: dict | None = None,
                   task_ids: torch.Tensor | None = None, draft_bits=None):
    """Shared decode body: tokens (B, S) at positions pos..pos+S-1 (per
    slot when pos is (B,)), K/V written into ``cache`` in place (quantized
    under ``kv_cache_dtype="int8"``: ``attention.apply_decode_q8``).
    Returns (logits (B, S, V) f32, cache)."""
    h = common.embed_apply(model.embed, tokens, cfg)
    rope = attention._rope_decode(cfg, pos, h.shape[1], h.device)
    slotted = task_stack is not None
    if slotted and tokens.shape[1] > 1:
        # quantized linears flatten (B, S, d) row-major to M = B·S rows —
        # repeat each slot's task id per token to match
        task_ids = task_ids.repeat_interleave(tokens.shape[1])
    for i, layer in enumerate(model.layers):
        slots = (task_ids, _layer_stack(task_stack["layers"], i)) \
            if slotted else None
        hin = common.norm_apply(layer.ln1, h, cfg)
        attn_slots = linear.slot_entry(slots, "attn")
        if cfg.kv_cache_dtype == "int8":
            a, _ = attention.apply_decode_q8(
                layer.attn, hin, cfg, {k: v[i] for k, v in cache.items()},
                pos, rope, slots=attn_slots, draft_bits=draft_bits)
        else:
            a, _, _ = attention.apply_decode(
                layer.attn, hin, cfg, cache["k"][i], cache["v"][i], pos,
                rope, slots=attn_slots, draft_bits=draft_bits)
        h = h + a
        h = h + _ffn(layer, h, cfg, slots=linear.slot_entry(slots, "mlp"),
                     draft_bits=draft_bits)[0]
    head_slots = linear.slot_entry((task_ids, task_stack), "lm_head") \
        if slotted else None
    return _final_logits(model, h, cfg, slots=head_slots,
                         draft_bits=draft_bits), cache


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                pos, cfg: ModelConfig, task_stack: dict | None = None,
                task_ids: torch.Tensor | None = None,
                draft_bits: int | None = None):
    """One decode step: tokens (B, 1) at ``pos``, the next position — an
    int, or a (B,) tensor with each slot's own position (the slot pool).
    Writes the step's K/V into ``cache`` in place.

    task_stack/task_ids (mixed-task decode): ``task_ids: (B,) int32`` names
    the resident-stack row each slot reads; the quantized linears gather
    per-slot scales in the kernel instead of the pool draining for a scale
    swap.

    draft_bits: the self-speculative draft — every bit-plane linear reads
    only its top ``draft_bits`` planes under rescaled scales (the
    reference's draft API built from ``quant.bits = draft_bits``).

    Returns (logits (B, V) f32, cache).
    """
    logits, cache = _decode_tokens(model, cache, tokens, pos, cfg,
                                   task_stack, task_ids, draft_bits)
    return logits[:, 0], cache


def decode_verify(model: Transformer, cache: dict, tokens: torch.Tensor,
                  pos, cfg: ModelConfig, task_stack: dict | None = None,
                  task_ids: torch.Tensor | None = None):
    """Speculative verify: score S = k+1 tokens in ONE target pass.

    tokens (B, S) = [next-input, draft_1..draft_k]; row b's token s sits at
    absolute position pos[b] + s, writing cache rows pos[b]..pos[b]+S-1
    (the draft's provisional rows are overwritten with target K/V).  Row s
    of the returned logits is the target's next-token distribution after
    consuming tokens[:, :s+1].  Stale cache rows beyond the accepted prefix
    are never visible: the causal mask keys on absolute position.

    Returns (logits (B, S, V) f32, cache).
    """
    return _decode_tokens(model, cache, tokens, pos, cfg, task_stack,
                          task_ids)
