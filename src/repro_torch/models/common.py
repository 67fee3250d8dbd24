"""Shared neural building blocks: norms, RoPE, MLPs, embeddings, the
training loss (port of ``repro/models/common.py``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import context
from repro_torch.kernels import ops
from repro_torch.models import linear

# rows a norm of a decode step or verify reduces on the card (a verify of
# 8 slots × 4 tokens is the most), whatever rows the call has
NORM_DECODE_ROWS = 32


def reset_block(block: nn.Module, generator: torch.Generator) -> None:
    """Draw every random leaf of ``block`` from ``generator``, in module
    order: each submodule that has ``reset_parameters`` (the linears, a
    Mamba2 conv, an sLSTM's recurrent matrices); the other leaves are
    constants set when the block is made."""
    for sub in block.modules():
        if hasattr(sub, "reset_parameters"):
            sub.reset_parameters(generator)


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
    (reference ``norm_init(cfg, d)``), over ``d`` features (``cfg.d_model``
    unless given: zamba2's shared block normalises the 2·d_model concat).
    ``gain_only`` keeps ``g`` alone whatever the norm type (Mamba2's
    ``gnorm``, which the reference initialises as ``{"g": ones}``)."""

    def __init__(self, cfg: ModelConfig, device=None, *,
                 d: Optional[int] = None, gain_only: bool = False):
        super().__init__()
        d = d or cfg.d_model
        self.g = nn.Parameter(torch.ones(d, device=device))
        self.b = nn.Parameter(torch.zeros(d, device=device)) \
            if cfg.norm_type == "layernorm" and not gain_only else None


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


def table(cfg: ModelConfig, rows: int, device=None) -> nn.Parameter:
    """A (rows, d_model) table in ``table_dtype(cfg)``, storage
    uninitialised: the token table, or a learned-position table (the
    encdec's ``enc.pos`` over its frames and ``dec.pos`` over ``max_seq``
    positions, stored by the token table's rule: float32 where the mode
    trains them, else the activation dtype they are only ever read cast
    to)."""
    return nn.Parameter(torch.empty(rows, cfg.d_model, dtype=table_dtype(cfg),
                                    device=device))


@torch.no_grad()
def reset_table(t: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 0.02²) drawn in float32 from ``generator``, then stored in
    ``t``'s dtype (the reference's init of every table)."""
    w = torch.empty(t.shape, device=t.device)
    t.copy_(w.normal_(0.0, 0.02, generator=generator))


class Embed(nn.Module):
    """The token table, in ``table_dtype(cfg)``.  A model-axis shard
    (``dist/sharding.py::shard_model``) holds the rows of its vocab block,
    the first of them ``vocab_start``."""

    vocab_start: Optional[int] = None

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.emb = table(cfg, cfg.vocab_size, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_table(self.emb, generator)


def embed_apply(p: Embed, tokens: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """The rows of ``tokens``, in the activation dtype.  On a vocab shard a
    token outside the rank's block looks up a zero row and the rows are
    summed over the model axis: exact, since every rank but the token's
    owner adds zeros."""
    dtype = model_dtype(cfg)
    if p.vocab_start is None:
        return p.emb[tokens].to(dtype)
    n = p.emb.shape[0]
    local = tokens - p.vocab_start
    inside = ((local >= 0) & (local < n))[..., None]
    h = p.emb[local.clamp(0, n - 1)].to(dtype)
    h = torch.where(inside, h, torch.zeros((), dtype=dtype, device=h.device))
    return context.reduce_from_model(h, context.require())


def head_apply(lm_head: Optional[linear.Linear], p_embed: Embed,
               x: torch.Tensor, cfg: ModelConfig, slots=None,
               draft_bits=None) -> torch.Tensor:
    """Logits in float32 (the reference's preferred_element_type=f32) at
    every position of x: the tied head multiplies the activation-dtype
    operands exactly and sums in float32 (``ops.dot_f32``), serving and
    training alike; the untied head is ``lm_head`` through
    ``linear.apply``, then widened.  On a vocab shard these are the
    logits of the rank's vocab block (``transformer._final_logits``
    gathers them unless the run keeps them sharded), and in training x's
    gradient — a partial sum over the rank's vocab block — is summed over
    the model axis (``context.copy_to_model``)."""
    if p_embed.vocab_start is not None:
        x = context.copy_to_model(x, context.require())
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


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token −log softmax(logits)[label] over a vocab split across the
    model axis: three all-reduces forward (the row max, the row sum of
    exp, the gold logit from its owner), none backward (the block's
    softmax minus its part of the one-hot)."""

    @staticmethod
    def forward(fctx, block, labels, ctx, start):
        n = block.shape[-1]
        rmax = ctx.all_reduce(block.amax(dim=-1), "model", "max")
        shifted = block - rmax[..., None]
        sumexp = ctx.all_reduce(torch.exp(shifted).sum(dim=-1), "model")
        local = labels - start
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)[..., None]
        gold = torch.where(inside, shifted.gather(-1, idx)[..., 0],
                           torch.zeros((), dtype=block.dtype,
                                       device=block.device))
        gold = ctx.all_reduce(gold, "model")
        fctx.save_for_backward(shifted, sumexp, idx, inside)
        return torch.log(sumexp) - gold

    @staticmethod
    def backward(fctx, grad):
        shifted, sumexp, idx, inside = fctx.saved_tensors
        d = torch.exp(shifted)          # one block-sized buffer, in place
        d /= sumexp[..., None]
        d.scatter_add_(-1, idx, -inside.to(d.dtype)[..., None])
        d *= grad[..., None]
        return d, None, None, None


def vocab_parallel_cross_entropy(logits_block: torch.Tensor,
                                 labels: torch.Tensor,
                                 mask: Optional[torch.Tensor], ctx,
                                 aux: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """``cross_entropy`` of a rank's rows over the whole vocab, from its
    vocab block of the logits (..., V/M) — no rank ever holds a whole row
    — and over the whole global batch: the local sum of nll × mask divided
    by the mask's sum over the data axis, then summed over the data axis
    (the reference's token mean over the global batch, not a mean of the
    ranks' means).  Equal on every rank; its gradient reaches this rank's
    rows and vocab block only.  ``aux``, a term of the rank's data block
    (the MoE loss), is averaged over the data axis in the same sum."""
    start, _ = ctx.vocab_range(logits_block.shape[-1] * ctx.model_size)
    nll = _VocabParallelNLL.apply(logits_block.to(torch.float32),
                                  labels.long(), ctx, start)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(torch.float32)
    count = ctx.all_reduce(mask.sum(), "data")
    local = (nll * mask).sum() / count.clamp_min(1.0)
    if aux is not None:
        local = local + aux / ctx.data_size
    return context.reduce_sum(local, ctx, "data")
