"""Decoder-only transformer backbone, dense family (port of
``repro/models/transformer.py``: ``init``, ``prefill``, ``decode_step``).

Layers are a ``ModuleList`` of per-layer blocks and run in a Python loop
(the reference stacks them and scans).  ``bridge.py`` converts between the
two layouts.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, linear


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = common.Norm(cfg, device=device)
        self.attn = attention.Attention(cfg, device=device)
        self.ln2 = common.Norm(cfg, device=device)
        self.mlp = common.MLP(cfg, device=device)


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


def init(cfg: ModelConfig, generator: torch.Generator, device) -> Transformer:
    """Random float32 weights from ``generator`` (which must live on
    ``device``): N(0, 1/in) linears, N(0, 0.02²) embedding, unit norms."""
    model = Transformer(cfg, device=device)
    model.embed.reset_parameters(generator)
    for mod in model.modules():
        if isinstance(mod, linear.Linear):
            mod.reset_parameters(generator)
    return model


def _final_logits(model: Transformer, h: torch.Tensor, cfg: ModelConfig):
    h = common.norm_apply(model.final_norm, h, cfg)
    return common.head_apply(model.lm_head, model.embed, h, cfg)


def prefill(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig):
    """Forward over the prompt (B, S), building the KV cache.

    Returns (last_logits (B, V) f32, cache {"k", "v": (L, B, S, Hkv, D)}).
    """
    h = common.embed_apply(model.embed, tokens, cfg)
    rope = common.rope_table(cfg, torch.arange(h.shape[1], device=h.device))
    ks, vs = [], []
    for layer in model.layers:
        a, ck, cv = attention.apply_prefill(
            layer.attn, common.norm_apply(layer.ln1, h, cfg), cfg, rope)
        h = h + a
        h = h + common.mlp_apply(layer.mlp,
                                 common.norm_apply(layer.ln2, h, cfg), cfg)
        ks.append(ck)
        vs.append(cv)
    # the head sees only the last token: one row per batch element
    logits = _final_logits(model, h[:, -1:], cfg)
    return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                pos: int, cfg: ModelConfig):
    """One decode step: tokens (B, 1) at scalar position ``pos`` (the next
    position).  Writes the step's K/V into ``cache`` in place.

    Returns (logits (B, V) f32, cache).
    """
    h = common.embed_apply(model.embed, tokens, cfg)
    rope = attention._rope_decode(cfg, pos, h.shape[1], h.device)
    for i, layer in enumerate(model.layers):
        a, _, _ = attention.apply_decode(
            layer.attn, common.norm_apply(layer.ln1, h, cfg), cfg,
            cache["k"][i], cache["v"][i], pos, rope)
        h = h + a
        h = h + common.mlp_apply(layer.mlp,
                                 common.norm_apply(layer.ln2, h, cfg), cfg)
    return _final_logits(model, h, cfg)[:, 0], cache
