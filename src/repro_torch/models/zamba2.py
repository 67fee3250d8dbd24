"""Zamba2 hybrid: a Mamba2 backbone with ONE shared attention block applied
periodically, the hybrid family (port of ``repro/models/zamba2.py``:
``_layout``, ``init``, ``forward``, ``loss_fn``, ``init_cache``,
``prefill`` and ``decode_step``).

Layout: ``n_layers`` Mamba2 layers; after every ``attn_every`` of them the
shared transformer block runs, fed concat(h, e0) — the current hidden and
the embedding output, width 2·d_model — to its norm and q/k/v; its MLP
runs on h.  81 layers with attn_every=6 → 13 applications of the shared
block and 3 tail Mamba2 layers::

    [mamba ×6 → shared-attn] ×13 → [mamba ×3] → norm → head

The reference stacks the blocks (groups, attn_every, …) and scans; the
port numbers them, ``mamba_groups.g.i`` and ``mamba_tail.i``
(``core.peqa.layer_index`` reads both indices of the first).  Each
application has its own KV slot but ONE set of weights (``shared``).

Decode state: {"attn_k", "attn_v"} (n_groups, B, C, Hkv, D) in the
activation dtype, paged by position (a ring of ``swa_window`` slots under
a window), and the Mamba2 blocks' float32 {"ssm", "conv"} (n_groups,
attn_every, B, …) with ``ssm_tail`` / ``conv_tail`` (tail, B, …),
position-free.  The shared block's prefill attention is
``attention.apply_prefill`` under ``cfg.attn_impl`` (the plain float32
attention under "dense", K4 under "chunked"); its decode is
``attention.apply_decode`` (K4 on the card).  Under ``remat`` "block" or
"full" each Mamba2 block of a group AND each whole group run under
``torch.utils.checkpoint``, nested, as the reference checkpoints both; the
tail does not.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, linear, mamba2


def _layout(cfg: ModelConfig):
    """(every, n_groups, tail)."""
    every = cfg.attn_every or cfg.n_layers + 1
    n_groups = cfg.n_layers // every
    return every, n_groups, cfg.n_layers - n_groups * every


class Shared(nn.Module):
    """The shared block: ln1 over 2·d_model, attn (q/k/v over 2·d_model),
    ln2 and mlp over d_model."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d2 = 2 * cfg.d_model
        self.ln1 = common.Norm(cfg, device=device, d=d2)
        self.attn = attention.Attention(cfg, device=device, d_in=d2)
        self.ln2 = common.Norm(cfg, device=device)
        self.mlp = common.MLP(cfg, device=device)


class Zamba2(nn.Module):
    """Parameters only: ``embed``, ``mamba_groups`` (n_groups lists of
    attn_every Mamba2 blocks), ``shared``, ``final_norm``, ``mamba_tail``
    (None without a tail) and the untied ``lm_head`` (None when tied).
    Created with uninitialised storage — ``init`` fills it from a
    generator, ``bridge`` from a reference tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        every, n_groups, tail = _layout(cfg)
        self.embed = common.Embed(cfg, device=device)
        self.mamba_groups = nn.ModuleList(
            nn.ModuleList(mamba2.Mamba2(cfg, device=device)
                          for _ in range(every)) for _ in range(n_groups))
        self.shared = Shared(cfg, device=device)
        self.final_norm = common.Norm(cfg, device=device)
        self.mamba_tail = nn.ModuleList(
            mamba2.Mamba2(cfg, device=device) for _ in range(tail)) \
            if tail else None
        self.lm_head = None if cfg.tie_embeddings else \
            linear.Linear(cfg.d_model, cfg.vocab_size, device=device)


def init(cfg: ModelConfig, generator: torch.Generator, device,
         transform=None) -> Zamba2:
    """Random float32 weights from ``generator`` (on ``device``), built one
    piece at a time as ``transformer.init`` builds: the skeleton on
    ``meta``, then the token table, ``mamba_groups.0.0``, …, ``shared``,
    the final norm, ``mamba_tail.0``, … and the head, each block's random
    leaves (linears, the conv) drawn in module order.  ``transform(name,
    block)`` is applied to each block and to the head after its draws and
    before the next piece exists (``core.policies.build``)."""
    model = Zamba2(cfg, device="meta")
    model.embed = common.Embed(cfg, device=device)
    model.embed.reset_parameters(generator)

    def make(name: str, mod: nn.Module) -> nn.Module:
        common.reset_block(mod, generator)
        if transform is not None:
            transform(name, mod)
        return mod

    for g, group in enumerate(model.mamba_groups):
        for i in range(len(group)):
            group[i] = make(f"mamba_groups.{g}.{i}",
                            mamba2.Mamba2(cfg, device=device))
    model.shared = make("shared", Shared(cfg, device=device))
    model.final_norm = common.Norm(cfg, device=device)
    if model.mamba_tail is not None:
        for i in range(len(model.mamba_tail)):
            model.mamba_tail[i] = make(f"mamba_tail.{i}",
                                       mamba2.Mamba2(cfg, device=device))
    if model.lm_head is not None:
        model.lm_head = make("lm_head", linear.Linear(
            cfg.d_model, cfg.vocab_size, device=device))
    return model


def _rope(cfg: ModelConfig, s: int, device):
    return common.rope_table(cfg, torch.arange(s, device=device)) \
        if cfg.use_rope else None


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat in ("block", "full") and torch.is_grad_enabled()


def _attn_in(shared: Shared, h: torch.Tensor, e0: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    return common.norm_apply(shared.ln1, torch.cat([h, e0], dim=-1), cfg)


def _shared_mlp(shared: Shared, h: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    return h + common.mlp_apply(shared.mlp,
                                common.norm_apply(shared.ln2, h, cfg), cfg)


def _mamba_res(layer: mamba2.Mamba2, h: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    return h + mamba2.apply_train(layer, h, cfg)


def _group_train(group: nn.ModuleList, shared: Shared, h: torch.Tensor,
                 e0: torch.Tensor, cfg: ModelConfig, rope) -> torch.Tensor:
    for layer in group:
        h = checkpoint(_mamba_res, layer, h, cfg, use_reentrant=False) \
            if _remat(cfg) else _mamba_res(layer, h, cfg)
    h = h + attention.apply_train(shared.attn, _attn_in(shared, h, e0, cfg),
                                  cfg, rope)
    return _shared_mlp(shared, h, cfg)


def _head(model: Zamba2, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = common.norm_apply(model.final_norm, h, cfg)
    return common.head_apply(model.lm_head, model.embed, h, cfg)


def forward(model: Zamba2, tokens: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V) float32."""
    h = common.embed_apply(model.embed, tokens, cfg)
    e0 = h
    rope = _rope(cfg, tokens.shape[1], h.device)
    for group in model.mamba_groups:
        h = checkpoint(_group_train, group, model.shared, h, e0, cfg, rope,
                       use_reentrant=False) if _remat(cfg) \
            else _group_train(group, model.shared, h, e0, cfg, rope)
    for layer in model.mamba_tail or ():
        h = _mamba_res(layer, h, cfg)
    return _head(model, h, cfg)


def loss_fn(model: Zamba2, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    logits = forward(model, batch["tokens"], cfg)
    return common.cross_entropy(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Zero-filled decode state: the shared block's K/V (n_groups, B, C,
    Hkv, D) in the activation dtype, C = ``attention.cache_capacity``, and
    the Mamba2 states (``mamba2.init_state``) stacked (n_groups,
    attn_every, B, …), the tail's (tail, B, …)."""
    every, n_groups, tail = _layout(cfg)
    cap = attention.cache_capacity(cfg, seq_len)
    kv = (n_groups, batch, cap, cfg.n_kv_heads, cfg.d_head)
    dtype = common.model_dtype(cfg)
    st = mamba2.init_state(cfg, batch, n_groups * every, device)
    cache = {
        "attn_k": torch.zeros(kv, dtype=dtype, device=device),
        "attn_v": torch.zeros(kv, dtype=dtype, device=device),
        "ssm": st["ssm"].reshape(n_groups, every, *st["ssm"].shape[1:]),
        "conv": st["conv"].reshape(n_groups, every, *st["conv"].shape[1:]),
    }
    if tail:
        t = mamba2.init_state(cfg, batch, tail, device)
        cache["ssm_tail"], cache["conv_tail"] = t["ssm"], t["conv"]
    return cache


def _stack_states(states: list) -> dict:
    return {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")}


def prefill(model: Zamba2, tokens: torch.Tensor, cfg: ModelConfig):
    """The forward over the prompt (B, S) that also emits the decode state.
    Returns (last_logits (B, V) float32, cache as ``init_cache``'s at
    capacity ``cache_capacity(cfg, S)``)."""
    h = common.embed_apply(model.embed, tokens, cfg)
    e0 = h
    s = tokens.shape[1]
    cap = attention.cache_capacity(cfg, s)
    rope = _rope(cfg, s, h.device)
    shared = model.shared
    ks, vs, groups = [], [], []
    for group in model.mamba_groups:
        states = []
        for layer in group:
            out, st = mamba2.apply_train(layer, h, cfg, return_state=True)
            states.append(st)
            h = h + out
        groups.append(_stack_states(states))
        a, ck, cv = attention.apply_prefill(
            shared.attn, _attn_in(shared, h, e0, cfg), cfg, rope, cap)
        ks.append(ck)
        vs.append(cv)
        h = _shared_mlp(shared, h + a, cfg)
    cache = {"attn_k": torch.stack(ks), "attn_v": torch.stack(vs),
             **_stack_states(groups)}
    if model.mamba_tail is not None:
        states = []
        for layer in model.mamba_tail:
            out, st = mamba2.apply_train(layer, h, cfg, return_state=True)
            states.append(st)
            h = h + out
        tail = _stack_states(states)
        cache["ssm_tail"], cache["conv_tail"] = tail["ssm"], tail["conv"]
    return _head(model, h[:, -1:], cfg)[:, 0], cache


def _mamba_decode(layer, h, cfg, ssm_state, conv_state):
    """One Mamba2 decode step whose new states are written back into the
    cache views in place."""
    out, s_new, c_new = mamba2.apply_decode(layer, h, cfg, ssm_state,
                                            conv_state)
    ssm_state.copy_(s_new)
    conv_state.copy_(c_new)
    return h + out


def decode_step(model: Zamba2, cache: dict, tokens: torch.Tensor, pos,
                cfg: ModelConfig):
    """One step of tokens (B, 1) at ``pos`` — an int, or a (B,) tensor of
    each slot's own position (the slot pool): every state and the step's
    K/V row are written into ``cache`` in place.  Returns (logits (B, V)
    float32, cache)."""
    h = common.embed_apply(model.embed, tokens, cfg)
    e0 = h
    rope = attention._rope_decode(cfg, pos, 1, h.device) if cfg.use_rope \
        else None
    shared = model.shared
    for g, group in enumerate(model.mamba_groups):
        for i, layer in enumerate(group):
            h = _mamba_decode(layer, h, cfg, cache["ssm"][g, i],
                              cache["conv"][g, i])
        a, _, _ = attention.apply_decode(
            shared.attn, _attn_in(shared, h, e0, cfg), cfg,
            cache["attn_k"][g], cache["attn_v"][g], pos, rope)
        h = _shared_mlp(shared, h + a, cfg)
    for i, layer in enumerate(model.mamba_tail or ()):
        h = _mamba_decode(layer, h, cfg, cache["ssm_tail"][i],
                          cache["conv_tail"][i])
    return _head(model, h, cfg)[:, 0], cache
