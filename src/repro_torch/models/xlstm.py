"""xLSTM: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar
memory, recurrent) blocks, the ssm family (port of
``repro/models/xlstm.py``: ``_mlstm_gates``, ``mlstm_apply_train`` /
``_decode``, ``slstm_apply_train`` / ``_decode``, ``_layout``, ``init``,
``forward``, ``loss_fn``, ``init_cache``, ``prefill`` and
``decode_step``).

Block pattern: every ``slstm_every``-th layer is an sLSTM, the rest are
mLSTM, grouped [sLSTM, mLSTM × (slstm_every − 1)]; the reference stacks
them two deep and scans, the port numbers them — ``slstm.g`` and
``mlstm.g.i`` ↔ the reference's ``slstm`` (n_groups, …) and ``mlstm``
(n_groups, n_m, …) leaves (``core.peqa.layer_index`` reads both indices).

mLSTM cell (per head, state C ∈ R^{hd×hd}, normaliser n ∈ R^{hd})::

    f_t = σ(f̃_t)   i_t = exp(clip(ĩ_t, ±ICLIP))
    C_t = f_t C_{t-1} + i_t v_t kᵀ_t        n_t = f_t n_{t-1} + i_t k_t
    y_t = (C_t q_t) / max(|n_t · q_t|, 1)

Training and prefill run ``mamba2.ssd_chunked`` with x → [v; 1], B → k,
C → q, dt → i, log-decay → logσ(f̃): the ones row carries the normaliser.
The state is (B, H, hd + 1, hd) float32.

sLSTM keeps the exact stabilised recurrence (the running max m starting
at −1e9) with block-diagonal per-head recurrent matrices ``sr.r`` (4, H,
hd, hd), gates in the order z, i, f, o — a loop over time here (the
reference's ``lax.scan``).  Everything but the quantized linears is XLA in
the reference, so plain PyTorch here; the linears are K2 or K1 on the
card.  Under ``remat`` "block" or "full" each mLSTM block runs under
``torch.utils.checkpoint``, and the sLSTM does not, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, linear, mamba2

ICLIP = 8.0  # input-gate exp clip
STATE_KEYS = ("s_c", "s_n", "s_m", "s_h")   # the sLSTM's (c, n, m, h)


def _dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model      # mLSTM proj factor 2
    return d_inner, d_inner // cfg.n_heads


def _layout(cfg: ModelConfig):
    """(every, n_groups, n_m): groups of one sLSTM and n_m mLSTM blocks.
    Raises unless ``slstm_every`` divides ``n_layers`` (the reference
    asserts it)."""
    every = cfg.slstm_every or (cfg.n_layers + 1)
    n_groups = cfg.n_layers // every
    if cfg.n_layers - n_groups * every:
        raise ValueError("xlstm: n_layers must divide by slstm_every")
    return every, n_groups, every - 1


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """ln, wq, wk, wv, gate (the output gate) d → 2d, the scalar gates gi
    and gf d → H, down 2d → d."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        d_inner, _ = _dims(cfg)
        self.ln = common.Norm(cfg, device=device)
        for name in ("wq", "wk", "wv", "gate"):
            setattr(self, name, linear.Linear(d, d_inner, device=device))
        self.gi = linear.Linear(d, cfg.n_heads, device=device)
        self.gf = linear.Linear(d, cfg.n_heads, device=device)
        self.down = linear.Linear(d_inner, d, device=device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: max then min (half the gradient at a bound)."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _mlstm_gates(p: MLSTM, u: torch.Tensor, cfg: ModelConfig):
    """q and k scaled by hd^-½, v (B, S, H, hd), the output gate σ (B, S,
    2d), ig = exp(clip(ĩ, ±ICLIP)) and logf = logσ(f̃) (B, S, H), all
    float32."""
    b, s, _ = u.shape
    _, hd = _dims(cfg)
    h = cfg.n_heads

    def proj(lin):
        return linear.apply(lin, u).reshape(b, s, h, hd).to(torch.float32)
    q = proj(p.wq) * hd ** -0.5
    k = proj(p.wk) * hd ** -0.5
    v = proj(p.wv)
    og = torch.sigmoid(linear.apply(p.gate, u).to(torch.float32))
    i_raw = linear.apply(p.gi, u).to(torch.float32)
    f_raw = linear.apply(p.gf, u).to(torch.float32)
    ig = torch.exp(_clip(i_raw, -ICLIP, ICLIP))
    logf = F.logsigmoid(f_raw)
    return q, k, v, og, ig, logf


def _normalised(y_aug: torch.Tensor, hd: int) -> torch.Tensor:
    """y / max(|n·q|, 1): the numerator rows over the normaliser row."""
    y, nq = y_aug[..., :hd], y_aug[..., hd]
    one = torch.ones((), dtype=nq.dtype, device=nq.device)
    return y / torch.maximum(torch.abs(nq), one)[..., None]


def mlstm_apply_train(p: MLSTM, u_res: torch.Tensor, cfg: ModelConfig,
                      state: Optional[torch.Tensor] = None,
                      return_state: bool = False):
    """u_res: (B, S, d) residual-stream input → the block's output (B, S,
    d) in its dtype; with ``return_state`` also the state (B, H, hd + 1,
    hd) float32."""
    b, s, _ = u_res.shape
    d_inner, hd = _dims(cfg)
    u = common.norm_apply(p.ln, u_res, cfg)
    q, k, v, og, ig, logf = _mlstm_gates(p, u, cfg)
    v_aug = torch.cat([v, torch.ones(*v.shape[:-1], 1, device=v.device)],
                      dim=-1)                                  # (B,S,H,hd+1)
    s0 = state if state is not None else \
        torch.zeros(b, cfg.n_heads, hd + 1, hd, device=u.device)
    y_aug, s_last = mamba2.ssd_chunked(v_aug, k, q, logf, ig, s0,
                                       cfg.ssm.chunk if cfg.ssm else 128)
    y = _normalised(y_aug, hd)
    y = (y.reshape(b, s, d_inner) * og).to(u_res.dtype)
    out = linear.apply(p.down, y)
    if return_state:
        return out, s_last
    return out


def mlstm_apply_decode(p: MLSTM, u_res: torch.Tensor, cfg: ModelConfig,
                       state: torch.Tensor):
    """One step: u_res (B, 1, d); state (B, H, hd + 1, hd).  Returns (out,
    the new state)."""
    b = u_res.shape[0]
    d_inner, hd = _dims(cfg)
    u = common.norm_apply(p.ln, u_res, cfg)
    q, k, v, og, ig, logf = _mlstm_gates(p, u, cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                         # (B,H,hd)
    ig, logf, og = ig[:, 0], logf[:, 0], og[:, 0]
    f = torch.exp(logf)[..., None, None]
    v_aug = torch.cat([v, torch.ones(b, cfg.n_heads, 1, device=v.device)],
                      dim=-1)
    s_new = f * state + ig[..., None, None] * torch.einsum(
        "bhv,bhk->bhvk", v_aug, k)
    y = _normalised(torch.einsum("bhvk,bhk->bhv", s_new, q), hd)
    y = y.reshape(b, 1, d_inner) * og[:, None]
    out = linear.apply(p.down, y.to(u_res.dtype))
    return out, s_new


# ---------------------------------------------------------------------------
# sLSTM (exact stabilised recurrence, block-diagonal recurrent weights)
# ---------------------------------------------------------------------------

class Recurrent(nn.Module):
    """``r`` (4, H, hd, hd): the block-diagonal recurrent matrices of the
    z, i, f and o gates, float32, N(0, 1/hd)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        h = cfg.n_heads
        hd = cfg.d_model // h
        self.r = nn.Parameter(torch.empty(4, h, hd, hd, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        r = torch.empty(self.r.shape, device=self.r.device)
        self.r.copy_(r.normal_(generator=generator)
                     * self.r.shape[-1] ** -0.5)


class GateBias(nn.Module):
    """``b`` (4, d): the gates' biases, zero-initialised."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.b = nn.Parameter(torch.zeros(4, cfg.d_model, device=device))


class SLSTM(nn.Module):
    """ln, sw (d → 4d: the z, i, f, o pre-activations), sr, sb, down."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln = common.Norm(cfg, device=device)
        self.sw = linear.Linear(d, 4 * d, device=device)
        self.sr = Recurrent(cfg, device=device)
        self.sb = GateBias(cfg, device=device)
        self.down = linear.Linear(d, d, device=device)


def slstm_zero_state(cfg: ModelConfig, batch: int, device) -> tuple:
    """(c, n, m, h), each (B, H, hd) float32; m starts at −1e9."""
    h = cfg.n_heads
    shape = (batch, h, cfg.d_model // h)
    z = torch.zeros(shape, device=device)
    return (z, z, torch.full(shape, -1e9, device=device), z)


def slstm_apply_train(p: SLSTM, u_res: torch.Tensor, cfg: ModelConfig,
                      state: Optional[tuple] = None,
                      return_state: bool = False):
    """The recurrence over the S steps of u_res (B, S, d), one step at a
    time, from ``state`` (c, n, m, h) or zeros.  Returns the block's output
    (B, S, d) in u_res's dtype, and with ``return_state`` the last (c, n,
    m, h)."""
    b, s, d = u_res.shape
    h = cfg.n_heads
    hd = d // h
    u = common.norm_apply(p.ln, u_res, cfg)
    wx = linear.apply(p.sw, u).to(torch.float32).reshape(b, s, 4, h, hd) \
        + p.sb.b.reshape(4, h, hd)
    r = p.sr.r
    c, n, m, hprev = state if state is not None else \
        slstm_zero_state(cfg, b, u.device)
    tiny = torch.full((), 1e-6, device=u.device)
    ys = []
    for t in range(s):
        rec = torch.einsum("ghij,bhj->bghi", r, hprev)          # (B,4,H,hd)
        pre = wx[:, t] + rec
        zt = torch.tanh(pre[:, 0])
        it_ = pre[:, 1]
        ft_ = F.logsigmoid(pre[:, 2])
        ot = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(ft_ + m, it_)
        i_s = torch.exp(it_ - m_new)
        f_s = torch.exp(ft_ + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        hprev = ot * c / torch.maximum(torch.abs(n), tiny)
        m = m_new
        ys.append(hprev)
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(u_res.dtype)
    out = linear.apply(p.down, y)
    if return_state:
        return out, (c, n, m, hprev)
    return out


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class XLSTM(nn.Module):
    """Parameters only: ``embed``, ``slstm`` (n_groups blocks), ``mlstm``
    (n_groups lists of n_m blocks), ``final_norm`` and the untied
    ``lm_head`` (None when tied).  Created with uninitialised storage —
    ``init`` fills it from a generator, ``bridge`` from a reference
    tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _, n_groups, n_m = _layout(cfg)
        self.embed = common.Embed(cfg, device=device)
        self.slstm = nn.ModuleList(SLSTM(cfg, device=device)
                                   for _ in range(n_groups))
        self.mlstm = nn.ModuleList(
            nn.ModuleList(MLSTM(cfg, device=device) for _ in range(n_m))
            for _ in range(n_groups))
        self.final_norm = common.Norm(cfg, device=device)
        self.lm_head = None if cfg.tie_embeddings else \
            linear.Linear(cfg.d_model, cfg.vocab_size, device=device)


def init(cfg: ModelConfig, generator: torch.Generator, device,
         transform=None) -> XLSTM:
    """Random float32 weights from ``generator`` (on ``device``), built one
    piece at a time as ``transformer.init`` builds: the skeleton on
    ``meta``, then the token table, ``slstm.0``, ``slstm.1``, …,
    ``mlstm.0.0``, ``mlstm.0.1``, …, the final norm and the head, each
    block's random leaves (linears, ``sr.r``) drawn in module order.
    ``transform(name, block)`` is applied to each block and to the head
    after its draws and before the next piece exists
    (``core.policies.build``)."""
    model = XLSTM(cfg, device="meta")
    model.embed = common.Embed(cfg, device=device)
    model.embed.reset_parameters(generator)

    def make(name: str, mod: nn.Module) -> nn.Module:
        common.reset_block(mod, generator)
        if transform is not None:
            transform(name, mod)
        return mod

    for g in range(len(model.slstm)):
        model.slstm[g] = make(f"slstm.{g}", SLSTM(cfg, device=device))
    for g, group in enumerate(model.mlstm):
        for i in range(len(group)):
            group[i] = make(f"mlstm.{g}.{i}", MLSTM(cfg, device=device))
    model.final_norm = common.Norm(cfg, device=device)
    if model.lm_head is not None:
        model.lm_head = make("lm_head", linear.Linear(
            cfg.d_model, cfg.vocab_size, device=device))
    return model


def _mlstm_res(layer: MLSTM, h: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    return h + mlstm_apply_train(layer, h, cfg)


def _head(model: XLSTM, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = common.norm_apply(model.final_norm, h, cfg)
    return common.head_apply(model.lm_head, model.embed, h, cfg)


def forward(model: XLSTM, tokens: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V) float32."""
    h = common.embed_apply(model.embed, tokens, cfg)
    remat = cfg.remat in ("block", "full") and torch.is_grad_enabled()
    for sl, group in zip(model.slstm, model.mlstm):
        h = h + slstm_apply_train(sl, h, cfg)
        for layer in group:
            h = checkpoint(_mlstm_res, layer, h, cfg, use_reentrant=False) \
                if remat else _mlstm_res(layer, h, cfg)
    return _head(model, h, cfg)


def loss_fn(model: XLSTM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    logits = forward(model, batch["tokens"], cfg)
    return common.cross_entropy(logits, batch["labels"], batch.get("mask"))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """The recurrent state, float32 and position-free (``seq_len`` is
    unused): the sLSTMs' {"s_c", "s_n", "s_m" (−1e9), "s_h"} (n_groups, B,
    H, hd) and the mLSTMs' "m_S" (n_groups, n_m, B, H, hd + 1, hd)."""
    _, n_groups, n_m = _layout(cfg)
    _, hd = _dims(cfg)
    h = cfg.n_heads
    shape = (n_groups, batch, h, cfg.d_model // h)
    cache = {k: torch.zeros(shape, device=device) for k in STATE_KEYS}
    cache["s_m"].fill_(-1e9)
    cache["m_S"] = torch.zeros(n_groups, n_m, batch, h, hd + 1, hd,
                               device=device)
    return cache


def decode_step(model: XLSTM, cache: dict, tokens: torch.Tensor, pos,
                cfg: ModelConfig):
    """One step of tokens (B, 1); ``pos`` is ignored (the state is
    position-free).  Writes the new state into ``cache`` in place.
    Returns (logits (B, V) float32, cache)."""
    del pos
    h = common.embed_apply(model.embed, tokens, cfg)
    for g, (sl, group) in enumerate(zip(model.slstm, model.mlstm)):
        out, state = slstm_apply_train(
            sl, h, cfg, state=tuple(cache[k][g] for k in STATE_KEYS),
            return_state=True)
        for k, t in zip(STATE_KEYS, state):
            cache[k][g].copy_(t)
        h = h + out
        for i, layer in enumerate(group):
            out, s_new = mlstm_apply_decode(layer, h, cfg, cache["m_S"][g, i])
            cache["m_S"][g, i].copy_(s_new)
            h = h + out
    return _head(model, h, cfg)[:, 0], cache


def prefill(model: XLSTM, tokens: torch.Tensor, cfg: ModelConfig):
    """The forward over the prompt (B, S) that also returns the recurrent
    state after it.  Returns (last_logits (B, V) float32, cache as
    ``init_cache``'s)."""
    h = common.embed_apply(model.embed, tokens, cfg)
    sstates, mstates = [], []
    for sl, group in zip(model.slstm, model.mlstm):
        out, state = slstm_apply_train(sl, h, cfg, return_state=True)
        sstates.append(state)
        h = h + out
        row = []
        for layer in group:
            out, s_last = mlstm_apply_train(layer, h, cfg, return_state=True)
            row.append(s_last)
            h = h + out
        mstates.append(torch.stack(row))
    cache = {k: torch.stack([st[j] for st in sstates])
             for j, k in enumerate(STATE_KEYS)}
    cache["m_S"] = torch.stack(mstates)
    return _head(model, h[:, -1:], cfg)[:, 0], cache
