"""Mamba2 (SSD) block — the chunked scan for training and prefill, an O(1)
recurrent state for decode (port of ``repro/models/mamba2.py``: ``init``,
``init_state``, ``_conv1d_causal``, ``_gates``, ``_expand_groups``,
``ssd_chunked``, ``apply_train`` and ``apply_decode``).

Recurrence per head h (A a scalar per head, Mamba2's simplification)::

    S_t = exp(A_h · dt_t) · S_{t-1} + dt_t · x_t ⊗ B_t          (d_head, d_state)
    y_t = S_t · C_t + D_h · x_t

Training and prefill use the SSD chunked form in log space
(``ssd_chunked``, shared with xLSTM's mLSTM): within a chunk of length c
the output is an attention-like quadratic form (C Bᵀ ⊙ decay mask) X,
across chunks the state is carried — by a Python loop over the chunks here
(the reference's ``lax.scan``).  Everything here is XLA in the reference,
not Pallas, so it is plain PyTorch on every device; the projections
(``zproj``, ``xproj``, ``bproj``, ``cproj``, ``dtproj``, ``out_proj``) are
quantized linears, K2 or K1 on the card.  The state and the conv window are
float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, linear


def dims(cfg: ModelConfig):
    """(d_inner, n_heads) of ``cfg``'s Mamba2 block."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    return d_inner, d_inner // ssm.head_dim


class Conv(nn.Module):
    """The depthwise causal conv's ``w`` (d_inner, d_conv) and ``b``
    (d_inner,), float32."""

    def __init__(self, channels: int, width: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(channels, width, device=device))
        self.b = nn.Parameter(torch.zeros(channels, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1/d_conv) weights and a zero bias (the reference's init)."""
        w = torch.empty(self.w.shape, device=self.w.device)
        self.w.copy_(w.normal_(generator=generator) * self.w.shape[-1] ** -0.5)
        self.b.zero_()


class Mamba2(nn.Module):
    """One Mamba2 block's parameters, under the reference's leaf names: the
    split projections, ``conv``, ``A_log`` (log of 1..16 spread over the
    heads), ``ssm_D`` (ones), ``dt_bias`` (−2: softplus ≈ 0.12), ``gnorm``
    (a gain over d_inner) and ``out_proj``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        ssm = cfg.ssm
        d = cfg.d_model
        d_inner, n_heads = dims(cfg)
        self.zproj = linear.Linear(d, d_inner, device=device)
        self.xproj = linear.Linear(d, d_inner, device=device)
        self.bproj = linear.Linear(d, ssm.n_groups * ssm.d_state,
                                   device=device)
        self.cproj = linear.Linear(d, ssm.n_groups * ssm.d_state,
                                   device=device)
        self.dtproj = linear.Linear(d, n_heads, device=device)
        self.conv = Conv(d_inner, ssm.d_conv, device=device)
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, n_heads, device=device)))
        self.ssm_D = nn.Parameter(torch.ones(n_heads, device=device))
        self.dt_bias = nn.Parameter(torch.full((n_heads,), -2.0,
                                               device=device))
        self.gnorm = common.Norm(cfg, device=device, d=d_inner,
                                 gain_only=True)
        self.out_proj = linear.Linear(d_inner, d, device=device)


def init_state(cfg: ModelConfig, batch: int, n_layers: int, device
               ) -> dict:
    """Zero float32 states of ``n_layers`` blocks: {"ssm": (L, B, H, hd,
    st), "conv": (L, B, d_conv − 1, d_inner)}."""
    ssm = cfg.ssm
    d_inner, n_heads = dims(cfg)
    return {
        "ssm": torch.zeros(n_layers, batch, n_heads, ssm.head_dim,
                           ssm.d_state, device=device),
        "conv": torch.zeros(n_layers, batch, ssm.d_conv - 1, d_inner,
                            device=device),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it, x·σ(x) (``F.silu``
    rounds differently: float32 states drift past the parity tests'
    1e-4)."""
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (``F.softplus``'s log1p(exp)
    differs in the last bits, which the recurrence carries)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Depthwise causal conv in x's dtype: x (B, S, C), w (C, W), b (C);
    the taps summed in order, as the reference's Python ``sum``."""
    wdt = w.to(x.dtype)
    width = w.shape[-1]
    s = x.shape[1]
    xpad = F.pad(x, (0, 0, width - 1, 0))
    out = xpad[:, 0:s] * wdt[:, 0]
    for i in range(1, width):
        out = out + xpad[:, i:i + s] * wdt[:, i]
    return out + b.to(x.dtype)


def _gates(p: Mamba2, u: torch.Tensor, cfg: ModelConfig):
    """z, x (B, S, d_inner), B and C (B, S, G, st) in u's dtype, and dt =
    softplus(dt_raw + dt_bias) (B, S, H) in float32."""
    ssm = cfg.ssm
    b, s, _ = u.shape
    z = linear.apply(p.zproj, u)
    x = linear.apply(p.xproj, u)
    bb = linear.apply(p.bproj, u).reshape(b, s, ssm.n_groups, ssm.d_state)
    cc = linear.apply(p.cproj, u).reshape(b, s, ssm.n_groups, ssm.d_state)
    dt_raw = linear.apply(p.dtproj, u)
    dt = softplus(dt_raw.to(torch.float32) + p.dt_bias)
    return z, x, bb, cc, dt


def _expand_groups(t: torch.Tensor, n_heads: int, n_groups: int
                   ) -> torch.Tensor:
    """(B, S, G, N) → (B, S, H, N), each group repeated across its heads."""
    return torch.repeat_interleave(t, n_heads // n_groups, dim=2)


def ssd_chunked(xh, bh, ch_, la, dt, s0, chunk: int):
    """Chunked linear-recurrence scan (shared by Mamba2 and mLSTM), float32.

    Recurrence  S_t = exp(la_t)·S_{t-1} + dt_t · x_t ⊗ B_t,   y_t = S_t·C_t.
    xh (B,S,H,hd), bh/ch_ (B,S,H,st), la/dt (B,S,H), s0 (B,H,hd,st).
    Returns (y (B,S,H,hd), S_last).  S must be a multiple of
    min(chunk, S) (``ValueError`` otherwise: the reference asserts it and
    pads nothing).
    """
    bsz, s, n_heads, hd = xh.shape
    ch = min(chunk, s)
    if s % ch:
        raise ValueError(f"seq {s} % chunk {ch} != 0")
    mask = torch.tril(torch.ones(ch, ch, dtype=torch.bool, device=xh.device))
    zero = torch.zeros((), dtype=la.dtype, device=la.device)
    S, ys = s0, []
    for c0 in range(0, s, ch):
        part = slice(c0, c0 + ch)
        xc, bc, cc_, lac, dtc = (t[:, part] for t in (xh, bh, ch_, la, dt))
        cum = torch.cumsum(lac, dim=1)                          # (B,ch,H)
        # inter-chunk: y_prev_t = C_t · (exp(cum_t) S_prev)
        y_inter = torch.einsum("bths,bhds,bth->bthd", cc_, S,
                               torch.exp(cum))
        # intra-chunk quadratic form.  The decay exponent is ≤ 0 exactly on
        # the causal (j ≤ i) region; clamp BEFORE exp so the masked j > i
        # entries cannot overflow to inf (0·inf in the backward of `where`
        # would poison every gradient upstream)
        scores = torch.einsum("bihs,bjhs->bhij", cc_, bc)       # (B,H,ch,ch)
        cum_t = cum.transpose(1, 2)
        dexp = cum_t[..., :, None] - cum_t[..., None, :]        # (B,H,i,j)
        decay = torch.exp(torch.minimum(dexp, zero))
        g = torch.where(mask, scores * decay, zero)
        g = g * dtc.transpose(1, 2)[:, :, None, :]              # · dt_j
        y_intra = torch.einsum("bhij,bjhd->bihd", g, xc)
        # state update
        wgt = torch.exp(cum[:, -1:, :] - cum) * dtc             # (B,ch,H)
        S = (torch.exp(cum[:, -1])[..., None, None] * S
             + torch.einsum("bth,bthd,bths->bhds", wgt, xc, bc))
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1), S


def apply_train(p: Mamba2, u: torch.Tensor, cfg: ModelConfig,
                state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full-sequence SSD: u (B, S, d_model) → (B, S, d_model) in u's dtype;
    with ``return_state`` also {"ssm": S_last (B, H, hd, st), "conv": the
    last d_conv − 1 PRE-conv ``xproj`` rows (B, d_conv − 1, d_inner),
    left-padded with zeros when S is shorter}, both float32 — the decode
    step's rolling window."""
    ssm = cfg.ssm
    bsz, s, _ = u.shape
    d_inner, n_heads = dims(cfg)
    hd, st = ssm.head_dim, ssm.d_state

    z, x_raw, bb, cc, dt = _gates(p, u, cfg)
    x = silu(_conv1d_causal(x_raw, p.conv.w, p.conv.b))
    xh = x.reshape(bsz, s, n_heads, hd).to(torch.float32)
    bh = _expand_groups(bb, n_heads, ssm.n_groups).to(torch.float32)
    chd = _expand_groups(cc, n_heads, ssm.n_groups).to(torch.float32)
    a = -torch.exp(p.A_log)                                     # (H,) < 0
    la = dt * a                                                 # log-decay

    s0 = torch.zeros(bsz, n_heads, hd, st, device=u.device) \
        if state is None else state
    y, s_last = ssd_chunked(xh, bh, chd, la, dt, s0, ssm.chunk)
    y = y + xh * p.ssm_D[None, None, :, None]
    y = y.reshape(bsz, s, d_inner).to(u.dtype)
    y = y * silu(z)
    y = common.norm_apply(p.gnorm, y, cfg)
    out = linear.apply(p.out_proj, y)
    if return_state:
        tail = ssm.d_conv - 1
        conv_tail = x_raw[:, -tail:] if s >= tail \
            else F.pad(x_raw, (0, 0, tail - s, 0))
        return out, {"ssm": s_last, "conv": conv_tail.to(torch.float32)}
    return out


def apply_decode(p: Mamba2, u: torch.Tensor, cfg: ModelConfig,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token step: u (B, 1, d); ssm_state (B, H, hd, st); conv_state
    (B, d_conv − 1, d_inner).  Returns (out (B, 1, d), the new ssm state,
    the new conv window), the states float32 and new tensors (the caller
    writes them back)."""
    ssm = cfg.ssm
    bsz = u.shape[0]
    d_inner, n_heads = dims(cfg)
    hd = ssm.head_dim

    z, x, bb, cc, dt = _gates(p, u, cfg)                        # S = 1
    # conv over the rolling window
    xw = torch.cat([conv_state.to(x.dtype), x], dim=1)
    w = p.conv.w.to(x.dtype)
    xc = torch.einsum("bwc,cw->bc", xw, w) + p.conv.b.to(x.dtype)
    xc = silu(xc)                                               # (B, d_inner)
    new_conv = xw[:, 1:].to(torch.float32)

    xh = xc.reshape(bsz, n_heads, hd).to(torch.float32)
    bh = _expand_groups(bb, n_heads, ssm.n_groups)[:, 0].to(torch.float32)
    chd = _expand_groups(cc, n_heads, ssm.n_groups)[:, 0].to(torch.float32)
    dt0 = dt[:, 0]                                              # (B, H)
    a = -torch.exp(p.A_log)
    decay = torch.exp(dt0 * a)
    s_new = (decay[..., None, None] * ssm_state
             + torch.einsum("bh,bhd,bhs->bhds", dt0, xh, bh))
    y = torch.einsum("bhds,bhs->bhd", s_new, chd) \
        + xh * p.ssm_D[None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(u.dtype)
    y = y * silu(z)
    y = common.norm_apply(p.gnorm, y, cfg)
    out = linear.apply(p.out_proj, y)
    return out, s_new, new_conv
