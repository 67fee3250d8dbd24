"""Shared neural building blocks: norms, RoPE, MLPs, embeddings, the
training loss (port of ``repro/models/common.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import linear

# rows a norm of a decode step or verify reduces on the card (a verify of
# 8 slots × 4 tokens is the most), whatever rows the call has
NORM_DECODE_ROWS = 32


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.dtype not in dtypes:
        raise NotImplementedError(f"dtype {cfg.dtype!r} is not ported "
                                  f"(have {sorted(dtypes)})")
    return dtypes[cfg.dtype]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """The gain ``g``, and for ``norm_type="layernorm"`` the bias ``b``
    (reference ``norm_init``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(cfg.d_model, device=device))
        self.b = nn.Parameter(torch.zeros(cfg.d_model, device=device)) \
            if cfg.norm_type == "layernorm" else None


def _row_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim, keepdim.  On the card a call of at most
    ``NORM_DECODE_ROWS`` rows (every decode step and verify) reduces a
    (``NORM_DECODE_ROWS``, d) tensor padded with zero rows: PyTorch picks
    a reduction's launch layout, and with it the order of a row's sum,
    from the number of rows, so without the padding a row's mean would
    depend on how many rows share the call."""
    d = t.shape[-1]
    rows = t.numel() // d
    if not t.is_cuda or rows > NORM_DECODE_ROWS:
        return t.mean(-1, keepdim=True)
    flat = F.pad(t.reshape(rows, d), (0, 0, 0, NORM_DECODE_ROWS - rows))
    return flat.mean(-1, keepdim=True)[:rows].reshape(*t.shape[:-1], 1)


def norm_apply(p: Norm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm, or LayerNorm for ``norm_type="layernorm"`` — its mean and
    then its variance each a two-pass float32 row mean (``_row_mean``, so
    both keep a row's bits whatever the call's rows), as the reference
    computes them (not ``F.layer_norm``'s one-pass statistics)."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        xc = xf - _row_mean(xf)
        y = xc * torch.rsqrt(_row_mean(xc ** 2) + cfg.norm_eps)
        return (y * p.g + p.b).to(x.dtype)
    y = xf * torch.rsqrt(_row_mean(xf ** 2) + cfg.norm_eps)
    return (y * p.g).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    d = cfg.d_head
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    theta = torch.tensor(cfg.rope_theta, dtype=torch.float32, device=device)
    return 1.0 / theta ** exps


def rope_table(cfg: ModelConfig, positions: torch.Tensor):
    """cos and sin of the rotary angles at ``positions`` — (S,) shared by
    the batch, or a (B, S) table with one row per slot — each of shape
    positions.shape + (D/2,), float32.  Computed once per forward and
    shared by every layer's q and k (the reference recomputes them inside
    each ``apply_rope``; the arithmetic is the same)."""
    freqs = rope_freqs(cfg, device=positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs      # (..., D/2)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos, sin) -> torch.Tensor:
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x: (B, S, H, D); rope: ``rope_table`` at the S positions of x."""
    cos, sin = (t[None, :, None, :] for t in rope)
    return _rotate(x, cos, sin)


def apply_rope_slots(x: torch.Tensor, rope) -> torch.Tensor:
    """Per-slot RoPE for continuous decode: x (B, S, H, D); rope:
    ``rope_table`` of a (B, S) position table — token s of row b is at its
    own absolute position (slots admitted at different times sit at
    different depths)."""
    cos, sin = (t[:, :, None, :] for t in rope)
    return _rotate(x, cos, sin)


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """The feed-forward: SwiGLU (``up``, ``gate``, ``down``) for
    ``act="silu"``, else ``up`` and ``down`` around a GELU (reference
    ``mlp_init``), ``d_in → d_ff → d_in`` (``cfg.d_model`` and ``cfg.d_ff``
    unless given).  With ``n_experts`` every linear is an expert stack
    (``linear.Linear(n_experts=)``): an MoE block's experts, applied to
    (E, C, d_in) rows expert by expert."""

    def __init__(self, cfg: ModelConfig, device=None, *,
                 d_in: Optional[int] = None, d_ff: Optional[int] = None,
                 n_experts: Optional[int] = None):
        super().__init__()
        d_in = d_in or cfg.d_model
        d_ff = d_ff or cfg.d_ff
        kw = dict(n_experts=n_experts, device=device)
        self.up = linear.Linear(d_in, d_ff, **kw)
        self.down = linear.Linear(d_ff, d_in, **kw)
        self.gate = linear.Linear(d_in, d_ff, **kw) \
            if cfg.act == "silu" else None


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (not the erf
    form)."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: MLP, x: torch.Tensor, cfg: ModelConfig,
              slots=None, draft_bits=None) -> torch.Tensor:
    """slots: optional (task_ids, stacked-scale subtree) for the mixed-task
    forward; draft_bits: the speculative draft's plane read width — both
    threaded into each quantized linear (see linear.apply)."""
    ent = lambda name: linear.slot_entry(slots, name)
    up = linear.apply(p.up, x, slots=ent("up"), draft_bits=draft_bits)
    if p.gate is not None:
        gate = linear.apply(p.gate, x, slots=ent("gate"),
                            draft_bits=draft_bits)
        h = F.silu(gate) * up
    else:
        h = gelu(up)
    return linear.apply(p.down, h, slots=ent("down"), draft_bits=draft_bits)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def table_dtype(cfg: ModelConfig) -> torch.dtype:
    """The token table's storage dtype: float32 when the tuning mode
    trains it (``full``, ``qat``), as the reference keeps and updates it —
    a bf16 table would drop every Adam update under half its ulp —, else
    the activation dtype, since a frozen table is only ever read cast to it
    (lookup and tied head): the same forward at half the memory."""
    return torch.float32 if cfg.tuning.mode in ("full", "qat") \
        else model_dtype(cfg)


class Embed(nn.Module):
    """The token table, in ``table_dtype(cfg)``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.emb = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                            dtype=table_dtype(cfg),
                                            device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            w = torch.empty(self.emb.shape, device=self.emb.device)
            self.emb.copy_(w.normal_(0.0, 0.02, generator=generator))


def embed_apply(p: Embed, tokens: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    return p.emb[tokens].to(model_dtype(cfg))


def head_apply(lm_head: Optional[linear.Linear], p_embed: Embed,
               x: torch.Tensor, cfg: ModelConfig, slots=None,
               draft_bits=None) -> torch.Tensor:
    """Logits in float32 (the reference's preferred_element_type=f32) at
    every position of x: the tied head multiplies the activation-dtype
    operands exactly and sums in float32 (``ops.dot_f32``), serving and
    training alike; the untied head is ``lm_head`` through
    ``linear.apply``, then widened."""
    if cfg.tie_embeddings:
        return ops.dot_f32(x, p_embed.emb.to(x.dtype))
    return linear.apply(lm_head, x, slots=slots,
                        draft_bits=draft_bits).to(torch.float32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy (reference ``common.cross_entropy``);
    logits (..., V) float32, labels (...) integers, mask (...) optional.
    The gold logit is a gather: the same value as the reference's one-hot
    contraction, which it uses only so that a vocabulary sharded over
    devices reduces locally."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
