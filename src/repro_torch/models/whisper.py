"""Whisper-style encoder-decoder, the encdec family (port of
``repro/models/whisper.py``: ``init``, ``encode``, the training ``forward``
and ``loss_fn``, ``prefill``, ``init_cache`` and ``decode_step``).

The conv/log-mel frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings (B, enc_frames, d_model).  The backbone is
whole: a non-causal encoder over the frames, a causal decoder with
cross-attention over the encoder's output, LayerNorm and GELU, learned
positions (``enc.pos`` over the frames, ``dec.pos`` over ``max_seq``
decoder positions; RoPE only under ``cfg.use_rope``, whisper's config has
none), and the decoder's token table as the tied head.

The encoder's self-attention and every cross-attention are the plain
float32 attention whatever ``cfg.attn_impl`` says (the reference passes no
``impl`` there); the decoder's self-attention is ``attention.apply_*``'s,
K4 on the card in a decode step.

Decode state: the self-attention's {"k", "v"} (L, B, C, H, D), paged by
position, and the cross-attention's {"xk", "xv"} (L, B, enc_frames, H, D),
computed once from the encoder's output at prefill and position-free.

Module names follow the reference's tree (``enc.layers.3.attn.wq`` ↔
``/enc/layers/attn/wq``), so ``core.peqa.ref_path``, the bridge and the
ScaleBank need nothing new.

On a ``(data, model)`` mesh the same functions run a rank's shard
(``dist/sharding.py::shard_model``) under ``context.use_mesh``: both
stacks' attention on the rank's local heads, the cross-attention's q/k/v
column-parallel and every ``wo`` and ``down`` row-parallel (reduced in
``linear``), the vocab-sharded lookup, the head's logits gathered unless
the run keeps them vocab-sharded.  Training differentiates through the
Megatron pair: each LayerNorm's output through ``context.copy_to_model``,
and the encoder's output once, before every decoder layer's
column-parallel ``xattn.wk``/``wv`` reads it (one model-axis sum of its
gradient, not one a layer); the loss scores the vocab block where it lies
(``common.vocab_parallel_cross_entropy``).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import context
from repro_torch.kernels import ops
from repro_torch.models import attention, common, linear


class EncBlock(nn.Module):
    """ln1, attn, ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = common.Norm(cfg, device=device)
        self.attn = attention.Attention(cfg, device=device)
        self.ln2 = common.Norm(cfg, device=device)
        self.mlp = common.MLP(cfg, device=device)


class DecBlock(nn.Module):
    """ln1, attn (causal self-attention), ln2, xattn (cross-attention),
    ln3, mlp."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = common.Norm(cfg, device=device)
        self.attn = attention.Attention(cfg, device=device)
        self.ln2 = common.Norm(cfg, device=device)
        self.xattn = attention.cross_init(cfg, device=device)
        self.ln3 = common.Norm(cfg, device=device)
        self.mlp = common.MLP(cfg, device=device)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.pos = common.table(cfg, cfg.enc_frames, device)
        self.layers = nn.ModuleList(EncBlock(cfg, device=device)
                                    for _ in range(cfg.enc_layers))
        self.final_norm = common.Norm(cfg, device=device)


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.embed = common.Embed(cfg, device=device)
        self.pos = common.table(cfg, cfg.max_seq, device)
        self.layers = nn.ModuleList(DecBlock(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = common.Norm(cfg, device=device)


class Whisper(nn.Module):
    """Parameters only (``enc`` and ``dec``); the forward functions are
    below.  Created with uninitialised storage — ``init`` fills it from a
    generator, ``bridge`` from a reference tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.enc = Encoder(cfg, device=device)
        self.dec = Decoder(cfg, device=device)


def init(cfg: ModelConfig, generator: torch.Generator, device,
         transform=None) -> Whisper:
    """Random float32 weights from ``generator`` (on ``device``): N(0, 1/in)
    linears, N(0, 0.02²) tables, unit norms — built one piece at a time
    as ``transformer.init`` builds: the skeleton on ``meta``, then
    ``enc.pos``, encoder block 0, 1, …, the encoder's final norm, the token
    table, ``dec.pos``, decoder block 0, 1, … and the final norm, made on
    ``device`` in that order (the order of the modules), each block's
    linears drawn in module order.  ``transform(name, block)`` is applied to
    each block (``enc.layers.3``, ``dec.layers.3``) after its draws and
    before the next piece exists (``core.policies.build``)."""
    model = Whisper(cfg, device="meta")

    def make(name: str, mod: nn.Module) -> nn.Module:
        for sub in mod.modules():
            if isinstance(sub, linear.Linear):
                sub.reset_parameters(generator)
        if transform is not None:
            transform(name, mod)
        return mod

    enc, dec = model.enc, model.dec
    enc.pos = common.table(cfg, cfg.enc_frames, device)
    common.reset_table(enc.pos, generator)
    for i in range(cfg.enc_layers):
        enc.layers[i] = make(f"enc.layers.{i}", EncBlock(cfg, device=device))
    enc.final_norm = common.Norm(cfg, device=device)
    dec.embed = common.Embed(cfg, device=device)
    dec.embed.reset_parameters(generator)
    dec.pos = common.table(cfg, cfg.max_seq, device)
    common.reset_table(dec.pos, generator)
    for i in range(cfg.n_layers):
        dec.layers[i] = make(f"dec.layers.{i}", DecBlock(cfg, device=device))
    dec.final_norm = common.Norm(cfg, device=device)
    return model


def _checkpointed(cfg: ModelConfig, fn, *args, ctx=None):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) for
    ``cfg.remat`` "block" or "full" where a backward may follow: it
    recomputes the block.  "dots" runs as "none", as in the reference
    (whisper.py tests ``remat in ("block", "full")``).  ``ctx``: a
    model-axis shard's mesh context, re-entered around ``fn`` — the
    recompute runs in the backward, on autograd's thread on the card,
    where the caller's ``use_mesh`` is not."""
    if ctx is not None:
        fn = functools.partial(_in_mesh, ctx, fn)
    if cfg.remat not in ("block", "full") or not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def _in_mesh(ctx, fn, *args):
    with context.use_mesh(ctx):
        return fn(*args)


def _train_ctx(model: Whisper):
    """The mesh context of a model-axis shard in training (its norms'
    outputs pass through ``context.copy_to_model``), else None."""
    if model.dec.embed.vocab_start is None or not torch.is_grad_enabled():
        return None
    return context.require()


def _copied(x: torch.Tensor, ctx) -> torch.Tensor:
    return x if ctx is None else context.copy_to_model(x, ctx)


def _enc_block(layer: EncBlock, h: torch.Tensor, cfg: ModelConfig,
               ctx=None) -> torch.Tensor:
    b, t, _ = h.shape
    q, k, v = attention._qkv(
        layer.attn, _copied(common.norm_apply(layer.ln1, h, cfg), ctx), cfg)
    o = ops.attention(q, k, v, causal=False)
    h = h + linear.apply(layer.attn.wo,
                         o.reshape(b, t, cfg.n_heads * cfg.d_head))
    return h + common.mlp_apply(
        layer.mlp, _copied(common.norm_apply(layer.ln2, h, cfg), ctx), cfg)


def encode(model: Whisper, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames (B, T, d) stub embeddings → encoder states (B, T, d) in the
    activation dtype: the frames cast to it, then ``enc.pos`` added in it
    (the reference adds the table cast to the frames' own dtype, which
    promotes a bf16 model's encoder to float32 when the frames are float32:
    ROADMAP §3)."""
    enc = model.enc
    ctx = _train_ctx(model)
    h = frames.to(common.model_dtype(cfg))
    h = h + enc.pos.to(h.dtype)
    for layer in enc.layers:
        h = _checkpointed(cfg, _enc_block, layer, h, cfg, ctx, ctx=ctx)
    return common.norm_apply(enc.final_norm, h, cfg)


def _positions(dec: Decoder, pos, s: int, cfg: ModelConfig) -> torch.Tensor:
    """The learned rows of ``s`` tokens from ``pos`` — an int ((1, s, d),
    a slice) or a (B,) tensor ((B, s, d), gathered per row) — sliced before
    the cast to the activation dtype.  A position at or past ``max_seq``
    raises (the reference's slice would clamp it)."""
    if torch.is_tensor(pos) and pos.dim() == 1:
        last = int(pos.max()) + s - 1 if pos.numel() else -1
        rows = pos.to(dec.pos.device)[:, None] + torch.arange(
            s, device=dec.pos.device)[None, :]
    else:
        last = int(pos) + s - 1
        rows = None
    if last >= cfg.max_seq:
        raise ValueError(f"decoder position {last} is past the learned "
                         f"position table's max_seq={cfg.max_seq} rows")
    table = dec.pos[rows] if rows is not None \
        else dec.pos[int(pos):int(pos) + s][None]
    return table.to(common.model_dtype(cfg))


def _dec_embed(dec: Decoder, tokens: torch.Tensor, pos, cfg: ModelConfig
               ) -> torch.Tensor:
    h = common.embed_apply(dec.embed, tokens, cfg)
    return h + _positions(dec, pos, tokens.shape[1], cfg)


def _head_block(dec: Decoder, h: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Float32 logits of the final norm of h through the tied token table
    (whisper's head is tied whatever the config says, as the reference's):
    on a vocab shard the rank's vocab block, x's gradient summed over the
    model axis (``context.copy_to_model``)."""
    h = common.norm_apply(dec.final_norm, h, cfg)
    if dec.embed.vocab_start is not None:
        h = context.copy_to_model(h, context.require())
    return ops.dot_f32(h, dec.embed.emb.to(h.dtype))


def _head(dec: Decoder, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``_head_block``'s logits, on a vocab shard gathered over the model
    axis unless the run keeps them vocab-sharded (``context.logitshard``,
    as ``transformer._final_logits``)."""
    logits = _head_block(dec, h, cfg)
    if dec.embed.vocab_start is None or context.logitshard():
        return logits
    return context.require().all_gather(logits, "model", dim=-1)


def _rope(cfg: ModelConfig, s: int, device):
    """The decoder self-attention's rotary table for positions 0..S-1, or
    None under learned positions."""
    if not cfg.use_rope:
        return None
    return common.rope_table(cfg, torch.arange(s, device=device))


def _dec_block_train(layer: DecBlock, h: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig, rope, ctx=None) -> torch.Tensor:
    h = h + attention.apply_train(
        layer.attn, _copied(common.norm_apply(layer.ln1, h, cfg), ctx), cfg,
        rope)
    h = h + attention.cross_apply(
        layer.xattn, _copied(common.norm_apply(layer.ln2, h, cfg), ctx),
        enc_out, cfg)
    return h + common.mlp_apply(
        layer.mlp, _copied(common.norm_apply(layer.ln3, h, cfg), ctx), cfg)


def _trunk(model: Whisper, frames: torch.Tensor, tokens: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """The encoder and every decoder block → the decoder's last hidden
    states (B, S, d).  On a shard in training the encoder's output passes
    through ``context.copy_to_model`` once, for all the decoder layers'
    cross K/V."""
    ctx = _train_ctx(model)
    enc_out = _copied(encode(model, frames, cfg), ctx)
    dec = model.dec
    h = _dec_embed(dec, tokens, 0, cfg)
    rope = _rope(cfg, tokens.shape[1], h.device)
    for layer in dec.layers:
        h = _checkpointed(cfg, _dec_block_train, layer, h, enc_out, cfg,
                          rope, ctx, ctx=ctx)
    return h


def forward(model: Whisper, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced training forward: frames (B, T, d), tokens (B, S) →
    logits (B, S, V) float32.  Under ``cfg.remat`` "block" or "full" every
    block of both stacks runs under ``torch.utils.checkpoint``."""
    return _head(model.dec, _trunk(model, frames, tokens, cfg), cfg)


def loss_fn(model: Whisper, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token-mean next-token cross entropy of ``batch`` ({"frames",
    "tokens", "labels", optional "mask"}).  On a model-axis shard the
    batch is this rank's rows of the global batch and the loss the global
    batch's token mean, from the rank's vocab block of the logits
    (``common.vocab_parallel_cross_entropy``)."""
    if model.dec.embed.vocab_start is not None:
        h = _trunk(model, batch["frames"], batch["tokens"], cfg)
        return common.vocab_parallel_cross_entropy(
            _head_block(model.dec, h, cfg), batch["labels"],
            batch.get("mask"), context.require())
    logits = forward(model, batch["frames"], batch["tokens"], cfg)
    return common.cross_entropy(logits, batch["labels"], batch.get("mask"))


def prefill(model: Whisper, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, last_pos: int | None = None):
    """Encode the frames and run the decoder over the prompt (B, S).

    last_pos: index of the last REAL prompt token when the prompt is
    right-padded to a bucket length — the head reads that row (padded rows
    are causally invisible to it).

    Returns (last_logits (B, V) f32, cache): {"k", "v"} (L, B, S, H, D) and
    {"xk", "xv"} (L, B, enc_frames, H, D), the cross K/V computed once from
    the encoder's output, all in the activation dtype."""
    enc_out = encode(model, frames, cfg)
    dec = model.dec
    b, s = tokens.shape
    t = enc_out.shape[1]
    dh = cfg.d_head
    h = _dec_embed(dec, tokens, 0, cfg)
    rope = _rope(cfg, s, h.device)
    cap = attention.cache_capacity(cfg, s)
    entries = []
    for layer in dec.layers:
        a, ck, cv = attention.apply_prefill(
            layer.attn, common.norm_apply(layer.ln1, h, cfg), cfg, rope, cap)
        h = h + a
        hin = common.norm_apply(layer.ln2, h, cfg)
        xa = layer.xattn
        xk = linear.apply(xa.wk, enc_out).reshape(b, t, cfg.n_kv_heads, dh)
        xv = linear.apply(xa.wv, enc_out).reshape(b, t, cfg.n_kv_heads, dh)
        q = linear.apply(xa.wq, hin).reshape(b, s, cfg.n_heads, dh)
        o = ops.attention(q, xk, xv, causal=False)
        h = h + linear.apply(xa.wo, o.reshape(b, s, cfg.n_heads * dh))
        h = h + common.mlp_apply(layer.mlp,
                                 common.norm_apply(layer.ln3, h, cfg), cfg)
        entries.append({"k": ck, "v": cv, "xk": xk.to(h.dtype),
                        "xv": xv.to(h.dtype)})
    del enc_out
    hl = h[:, -1:] if last_pos is None else h[:, last_pos:last_pos + 1]
    logits = _head(dec, hl, cfg)
    return logits[:, 0], {key: torch.stack([e[key] for e in entries])
                          for key in entries[0]}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Zero-filled decode state: self K/V (L, B, seq_len, H, D) and cross
    K/V (L, B, enc_frames, H, D), in the activation dtype."""
    dtype = common.model_dtype(cfg)
    kv = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.d_head)
    xkv = (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.d_head)
    zeros = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    return {"k": zeros(kv), "v": zeros(kv), "xk": zeros(xkv),
            "xv": zeros(xkv)}


def decode_step(model: Whisper, cache: dict, tokens: torch.Tensor, pos,
                cfg: ModelConfig):
    """One decoder step against the frozen cross K/V and the growing self
    K/V: tokens (B, 1) at ``pos`` — an int, or a (B,) tensor of each slot's
    own position (the slot pool), whose learned rows are gathered per row.
    Writes the step's self K/V into ``cache`` in place.  Returns (logits
    (B, V) f32, cache)."""
    dec = model.dec
    b = tokens.shape[0]
    dh = cfg.d_head
    h = _dec_embed(dec, tokens, pos, cfg)
    rope = attention._rope_decode(cfg, pos, 1, h.device) if cfg.use_rope \
        else None
    for i, layer in enumerate(dec.layers):
        a, _, _ = attention.apply_decode(
            layer.attn, common.norm_apply(layer.ln1, h, cfg), cfg,
            cache["k"][i], cache["v"][i], pos, rope)
        h = h + a
        hin = common.norm_apply(layer.ln2, h, cfg)
        q = linear.apply(layer.xattn.wq, hin).reshape(b, 1, cfg.n_heads, dh)
        o = ops.attention(q, cache["xk"][i], cache["xv"][i], causal=False)
        h = h + linear.apply(layer.xattn.wo,
                             o.reshape(b, 1, cfg.n_heads * dh))
        h = h + common.mlp_apply(layer.mlp,
                                 common.norm_apply(layer.ln3, h, cfg), cfg)
    return _head(dec, h, cfg)[:, 0], cache
