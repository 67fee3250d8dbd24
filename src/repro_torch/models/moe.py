"""Mixture-of-Experts block: token-choice top-k, sort-based capacity
dispatch (port of ``repro/models/moe.py`` off the mesh: ``init``,
``_route``, ``_sort_dispatch``, ``_moe_math`` at ``model_axis=None`` and
``apply``'s branch without a mesh context).

Covers both MoE configurations:
  * mixtral-8x7b      — 8 experts, top-2, no shared experts;
  * deepseek-moe-16b  — 64 fine-grained routed experts, top-6, and 2
                        shared experts (one dense MLP of 2 · d_ff_expert,
                        always applied).

The router is float32 and never quantized (``core.peqa.EXCLUDE`` names
it).  Each token's K assignments are sorted by expert (a stable sort), and
each expert takes at most ``cap`` of them — the rest are dropped, in token
order.  Every expert then runs on a (cap, d) block of gathered rows, empty
slots zero rows, so all E experts share one shape and each linear is ONE
launch over an expert axis (``ops.quant_matmul_experts``: K1 at cap ≤ 32
rows, else K2).  The combine sums each token's K weighted rows in k order,
in float32, from a (T, K, d) view — not a scatter with atomics, whose
order (and so whose bits) would change from run to run on the card.  The
gather's and the combine's backwards are likewise ordered sums and
assignments (``_Dispatch``, ``_Combine``): a step's gradients do not
depend on the run.  The Switch aux loss is E · Σ_e f_e · p_e.

Capacity is per call: a token's output depends on the other rows of the
call (the batch, idle slots' rows, a prefill's bucket padding), as in the
reference.

On a ``(data, model)`` mesh a rank runs its shard of the block
(``dist/sharding.py::shard_model`` marks it ``mesh_shard``), the
reference's ``shard_map`` body: every model rank routes and sort-dispatches
the same replicated rows (its data block's) over the GLOBAL E, so the
capacity and the aux loss are its data block's.  Under
``expert_sharding="expert"`` a rank holds experts [lo, lo + E/M) and
keeps only their slots and assignments; under ``"tensor"`` it holds every
expert's d_ff/M slice.  Either way its routed output is a partial sum; the
shared MLP's partial sum (its ``down`` marked ``tp_partial``) is added to
it, and the two are reduced ONCE over the model axis in the activation
dtype, as the reference's ``psum`` of ``y.astype(xt.dtype)`` is.  The aux
loss is the same on every model rank; its gradient enters at 1/M a rank
(``_ModelShare``), so the model-axis sums of the MoE input's gradient
(``context.copy_to_model``) and of the router's (a partial leaf,
``sharding.leaf_kind``) count it once.  ``seq_sharded`` is not ported:
the port keeps activations replicated over the model axis between
blocks, and the reference's all-gather plus ``psum_scatter`` gives the
values of the one all-reduce.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import context
from repro_torch.models import common, linear


def experts_key(cfg: ModelConfig) -> str:
    """The experts' module name, as the reference keys them:
    ``experts_ep`` under ``expert_sharding="expert"``, else ``experts``."""
    return "experts_ep" if cfg.moe.expert_sharding == "expert" else "experts"


class MoE(nn.Module):
    """``router`` (its ``w`` (E, d) float32), the stacked experts under
    ``experts_key(cfg)`` (an expert-stack ``common.MLP``: every leaf (E,
    …)) and, with ``n_shared_experts``, ``shared``: a dense MLP of
    ``d_ff_expert · n_shared_experts`` (reference ``moe.init``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        mc = cfg.moe
        d_ff = mc.d_ff_expert or cfg.d_ff
        self.router = linear.Linear(cfg.d_model, mc.n_experts, device=device)
        self.add_module(experts_key(cfg), common.MLP(
            cfg, device, d_ff=d_ff, n_experts=mc.n_experts))
        self.shared = common.MLP(cfg, device, d_ff=d_ff * mc.n_shared_experts) \
            if mc.n_shared_experts else None


def expert_mlp(p: MoE) -> common.MLP:
    """The block's stacked experts, under either key."""
    return p.experts_ep if "experts_ep" in p._modules else p.experts


def capacity(t: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots an expert takes for T rows: the reference's
    ``max(min(int(t * k / e * capacity_factor), t), 1)``, in the same
    float order (T counts every row of the call, idle and padded ones
    included)."""
    return max(min(int(t * k / e * capacity_factor), t), 1)


def route(xt: torch.Tensor, router_w: torch.Tensor, k: int):
    """xt (T, d) → (gate_idx (T, K) int64, gate_vals (T, K) float32, probs
    (T, E) float32): float32 logits (TF32 off), softmax, top-k.  The top k
    are the first k of a stable descending sort, so a tie takes the lower
    expert first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
    order)."""
    logits = xt.to(torch.float32) @ router_w.to(torch.float32).T
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_idx, gate_vals, probs


def sort_dispatch(gate_idx: torch.Tensor, e: int, cap: int):
    """Assignment → (expert, slot) through a stable sort (reference
    ``_sort_dispatch``).  Returns (token_for_slot (E·cap,) with the
    sentinel T for an empty slot, pos (T, K) the slot within the expert,
    keep (T, K) bool).  An assignment past its expert's ``cap`` is dropped;
    the dropped ones all write the discarded slot E·cap."""
    t, k = gate_idx.shape
    dev = gate_idx.device
    tk = t * k
    flat_e = gate_idx.reshape(tk)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e, sorted_t = flat_e[order], flat_t[order]
    # per-expert counts without bincount (which reads its input's maximum
    # on the host): integer adds, the same in any order
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(tk, device=dev) - seg_start[sorted_e]
    keep_sorted = pos_sorted < cap
    slot = torch.where(keep_sorted, sorted_e * cap + pos_sorted,
                       torch.full_like(sorted_e, e * cap))
    token_for_slot = torch.full((e * cap + 1,), t, dtype=torch.int64,
                                device=dev)
    token_for_slot[slot] = sorted_t
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    return token_for_slot[:-1], pos.reshape(t, k), keep.reshape(t, k)


class _Dispatch(torch.autograd.Function):
    """xin (E·cap, d) = [xt; 0][token_for_slot], the gather of rows into
    expert slots.  Its backward sums each token's slot gradients in
    ascending slot order — the order of the reference's scatter-add — as
    K ordered adds (``tok_slots`` (T, K): a token's slots ascending, the
    zero row E·cap for a dropped one), not as a scatter with atomics."""

    @staticmethod
    def forward(ctx, xt, token_for_slot, tok_slots):
        ctx.save_for_backward(tok_slots)
        xpad = torch.cat([xt, xt.new_zeros((1, xt.shape[1]))])
        return xpad[token_for_slot]

    @staticmethod
    def backward(ctx, dxin):
        (tok_slots,) = ctx.saved_tensors
        dpad = torch.cat([dxin, dxin.new_zeros((1, dxin.shape[1]))])
        dx = torch.zeros((tok_slots.shape[0], dxin.shape[1]),
                         dtype=dxin.dtype, device=dxin.device)
        for j in range(tok_slots.shape[1]):
            dx = dx + dpad[tok_slots[:, j]]
        return dx, None, None


class _Combine(torch.autograd.Function):
    """y (T, d) float32 = Σ_k w[t, k] · xout[idx[t, k]], the K terms added
    in k order onto zeros (the reference's scatter-add of T·K rows, whose
    updates for one token come in k order).  xout (E·cap, d) in the
    activation dtype, idx (T·K) clipped into it, w (T·K) float32 (the gate
    value, 0 for a dropped assignment), keep (T·K).  Backward: each kept
    assignment's slot gets dy·w — one slot per kept assignment, so an
    assignment, not a sum (a dropped one adds ±0 in the reference) —, and
    w gets Σ_d dy·xout."""

    @staticmethod
    def forward(ctx, xout, idx, w, keep, k):
        ctx.save_for_backward(xout, idx, w, keep)
        ctx.k = k
        contrib = xout[idx].to(torch.float32) * w[:, None]
        contrib = contrib.reshape(-1, k, xout.shape[1])
        y = torch.zeros((contrib.shape[0], xout.shape[1]),
                        dtype=torch.float32, device=xout.device)
        for j in range(k):
            y = y + contrib[:, j]
        return y

    @staticmethod
    def backward(ctx, dy):
        xout, idx, w, keep = ctx.saved_tensors
        k = ctx.k
        dy = dy.to(torch.float32)
        dtok = dy.repeat_interleave(k, dim=0)                   # (T·K, d)
        dxout = dw = None
        if ctx.needs_input_grad[0]:
            rows = xout.shape[0]
            dst = torch.where(keep, idx, torch.full_like(idx, rows))
            dxout = torch.zeros((rows + 1, xout.shape[1]), dtype=xout.dtype,
                                device=xout.device)
            dxout[dst] = (dtok * w[:, None]).to(xout.dtype)
            dxout = dxout[:rows]
        if ctx.needs_input_grad[2]:
            dw = (dtok * xout[idx].to(torch.float32)).sum(-1)
        return dxout, None, dw, None, None


class _ModelShare(torch.autograd.Function):
    """The identity forward, the gradient over the model axis' size
    backward: a replicated term that enters each model rank's partial
    gradients at 1/M, so their model-axis sum holds it once."""

    @staticmethod
    def forward(fctx, t, m):
        fctx.m = m
        return t.clone()

    @staticmethod
    def backward(fctx, grad):
        return grad / fctx.m, None


def moe_math(p: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """The routed experts on xt (T, d) → (y (T, d) in xt's dtype, aux
    float32 scalar) (reference ``_moe_math``).  On an expert-parallel
    shard (E/M experts in the stack) only the rank's experts' slots and
    assignments are kept, and y is the rank's partial sum; on a "tensor"
    shard every expert's output is its d_ff slice's partial sum."""
    mc = cfg.moe
    t, d = xt.shape
    e, k = mc.n_experts, mc.top_k
    cap = capacity(t, k, e, mc.capacity_factor)
    gate_idx, gate_vals, probs = route(xt, p.router.w, k)
    token_for_slot, pos, keep = sort_dispatch(gate_idx, e, cap)
    experts = expert_mlp(p)
    e_local = experts.up.n_experts
    local_idx = gate_idx
    if e_local < e:                      # experts [lo, lo + e_local)
        lo = p.mesh_shard[0] * e_local
        token_for_slot = token_for_slot[lo * cap:(lo + e_local) * cap]
        keep = keep & (gate_idx >= lo) & (gate_idx < lo + e_local)
        local_idx = (gate_idx - lo).clamp(0, e_local - 1)
    slots = local_idx * cap + pos
    # a token's slots ascending, the zero row for a dropped or another
    # rank's assignment
    tok_slots = torch.where(keep, slots, torch.full_like(slots,
                                                         e_local * cap))
    tok_slots = torch.sort(tok_slots, dim=1).values
    xin = _Dispatch.apply(xt, token_for_slot, tok_slots).reshape(
        e_local, cap, d)
    xout = common.mlp_apply(experts, xin, cfg)        # (E_local, cap, d)
    idx = slots.reshape(-1).clamp(0, e_local * cap - 1)
    w = (gate_vals * keep).reshape(-1).to(torch.float32)
    y = _Combine.apply(xout.reshape(e_local * cap, d), idx, w,
                       keep.reshape(-1), k)
    frac_tokens = F.one_hot(gate_idx, e).to(torch.float32).sum(1).mean(0)
    aux = e * torch.sum(frac_tokens * probs.mean(0))
    return y.to(xt.dtype), aux


def apply(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → (out (B, S, d), aux scalar): the routed experts over
    the B·S rows, then the shared MLP's output added in the activation
    dtype (reference ``apply``).  On a model-axis shard (under
    ``context.use_mesh``) the sum of the two partial outputs is reduced
    once over the model axis, in x's dtype, and the aux loss's gradient
    enters at 1/M."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    y, aux = moe_math(p, xt, cfg)
    if p.shared is not None:
        y = y + common.mlp_apply(p.shared, xt, cfg)
    shard = getattr(p, "mesh_shard", None)
    if shard is not None:
        y = context.reduce_from_model(y, context.require())
        if torch.is_grad_enabled() and aux.requires_grad:
            aux = _ModelShare.apply(aux, shard[1])
    return y.reshape(b, s, d), aux
