"""QLinear — the single fully-connected primitive, in every storage mode
(port of ``repro/models/linear.py``: fp, PEQA, QAT and LoRA storage, the
optional bias, ``slot_entry`` and the mixed-task ``apply(..., slots=)``).

A ``Linear`` holds its tensors under the reference's leaf names, and its
storage mode is which of them exist:

  fp       : w (out, in) float32 [, b (out,) float32]
  peqa     : qw (a buffer: the codes are frozen) — (out, in/8) int32 nibble
             words, or (bits, out, in/32) int32 bit-planes —,
             scale (out, G), zero (out, G) float32 [, b]
  qat      : w, scale, zero float32 [, b] — fake-quantized on the fly with
             a straight-through rounding
  (+ lora) : lora_a (r, in), lora_b (out, r) float32, beside either w or
             qw/scale/zero

The bias (the reference's ``init(bias=True)``: q/k/v of qwen2 and
starcoder2) is zero-initialised and never quantized.

An expert linear (``n_experts=E``: an MoE block's stacked experts, the
reference's ``mlp_init`` under ``jax.vmap``) holds every leaf with a
leading expert axis — w (E, out, in), qw (E, out, in/8) nibble words or
(E, bits, out, in/32) bit-planes, scale and zero (E, out, G) — and
``apply`` takes x (E, C, in) → (E, C, out), expert e's rows through expert
e's weight.  It has no bias and no adapter (LoRA targets the attention
projections only), and serves one task's scales at the codes' full
precision: no slots, no draft read.

On a ``(data, model)`` mesh a rank holds its shard of each linear
(``dist/sharding.py::shard_model``), marked ``tp``: a column-parallel
linear (``"col"``) holds its output rows and needs nothing more; a
row-parallel one (``"row"``: wo, down) holds its input columns of ``qw``
and the whole ``scale``/``zero`` (its block of G > 1 groups is
``tp_groups``), so its product is a partial sum that ``apply`` all-reduces
over the model axis before the bias.  In training that rank's gradients of
the whole ``scale``/``zero`` are partial sums over its input columns (zero
outside its block of groups): ``dist/sharding.py::leaf_kind`` names them
model-partial, and the train step sums them over the model axis.  Under
``ModelConfig.bf16_reduce`` the cut marks it ``tp_reduce_bf16`` and that
sum runs in the activation dtype — half the bytes of float32 —, as the
reference's bf16 dot outputs make its collectives bf16; off the mesh the
flag changes nothing (every product is rounded to the activation dtype as
it is).

Inside an MoE block the cut marks a row-parallel linear ``tp_partial``
(the shared experts' ``down``): its product stays the rank's partial sum,
rounded to x's dtype, because the block adds it to the routed experts'
partial sum and reduces the two once (``models/moe.py``).  An expert
stack's ``down`` under ``expert_sharding="tensor"`` is row-parallel the
same way (its block of G > 1 groups is ``tp_groups``); an ``experts_ep``
stack holds E/M whole experts (``tp = "expert"``).  Neither reduces: an
expert product never does.

``core/peqa.py`` turns fp into peqa in place (``set_quantized``),
``core/qat.py`` fp into qat (``set_fake_quant``) and ``core/lora.py`` adds
the adapter (``set_lora``); model code only ever calls ``apply``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.quant import QuantSpec
from repro_torch.dist import context
from repro_torch.kernels import ops

class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = False, n_experts: Optional[int] = None,
                 device=None):
        super().__init__()
        if n_experts is not None and bias:
            raise ValueError("an expert linear has no bias")
        self.in_features = in_features
        self.out_features = out_features
        self.n_experts = n_experts
        self.spec: Optional[QuantSpec] = None
        lead = () if n_experts is None else (n_experts,)
        self.w = nn.Parameter(torch.empty(*lead, out_features, in_features,
                                          device=device))
        self.b = nn.Parameter(torch.empty(out_features, device=device)) \
            if bias else None

    @property
    def quantized(self) -> bool:
        return "qw" in self._buffers

    @property
    def fake_quant(self) -> bool:
        """QAT storage: the fp weight with learned ``scale``/``zero``."""
        return "w" in self._parameters and "scale" in self._parameters

    @property
    def has_lora(self) -> bool:
        return "lora_a" in self._parameters

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1/in_features) weights and a zero bias (the reference's
        init)."""
        with torch.no_grad():
            self.w.normal_(0.0, self.in_features ** -0.5, generator=generator)
            if self.b is not None:
                self.b.zero_()

    def set_quantized(self, qw: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, spec: QuantSpec) -> None:
        """Replace ``w`` by its PEQA form (in place: the fp weight is freed)."""
        if "w" in self._parameters:
            del self._parameters["w"]
        self.register_buffer("qw", qw)
        self.scale = nn.Parameter(scale)
        self.zero = nn.Parameter(zero, requires_grad=False)
        self.spec = spec

    def set_fake_quant(self, scale: torch.Tensor, zero: torch.Tensor,
                       spec: QuantSpec) -> None:
        """Attach QAT's ``scale`` and ``zero`` beside ``w`` (in place)."""
        self.scale = nn.Parameter(scale)
        self.zero = nn.Parameter(zero)
        self.spec = spec

    def set_lora(self, lora_a: torch.Tensor, lora_b: torch.Tensor) -> None:
        """Attach the adapter: ``lora_a`` (r, in), ``lora_b`` (out, r)."""
        if self.n_experts is not None:
            raise NotImplementedError("LoRA on an expert linear is not "
                                      "ported")
        self.lora_a = nn.Parameter(lora_a)
        self.lora_b = nn.Parameter(lora_b)

    def drop_lora(self) -> None:
        del self._parameters["lora_a"], self._parameters["lora_b"]

    def set_dense(self, w: torch.Tensor) -> None:
        """Replace the PEQA form by the float weight ``w`` (in place)."""
        for name in ("scale", "zero"):
            del self._parameters[name]
        del self._buffers["qw"]
        self.w = nn.Parameter(w)
        self.spec = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x)


def slot_entry(slots, name: str):
    """Narrow a ``(task_ids, stack_subtree)`` pair to one child module.

    Returns None when there are no slots or the stacked-scale subtree has no
    entry for ``name`` (unquantized / EXCLUDE'd module) — the caller then
    takes the plain single-task path.
    """
    if slots is None:
        return None
    task_ids, subtree = slots
    if not isinstance(subtree, dict) or name not in subtree:
        return None
    return task_ids, subtree[name]


def apply(p: Linear, x: torch.Tensor, slots=None,
          draft_bits: Optional[int] = None) -> torch.Tensor:
    """y = x Wᵀ (+ LoRA) (+ b) in x's dtype, storage-mode dispatched.

    slots: optional ``(task_ids (M,), {"scale": (T, out, G), "zero": …})``
    for the mixed-task forward — each of the M rows of x (flattened
    leading dims) reads the scale row its slot's task owns.  Ignored for
    the fp and qat storage modes.

    draft_bits: the self-speculative draft's read width p — a bit-plane
    linear reads the top p planes of its own buffer under scales rescaled
    by 2^(b−p) (``core.quant.draft_scales``, applied as the kernel reads
    them: the live scales, never a stale copy).  Ignored for the fp storage
    mode, as the reference's draft rescales only PEQA linears.

    The fp product is the reference's einsum with a float32 output
    (``ops.dot_f32``: bf16 operands on the card's tensor cores), rounded to
    x's dtype; QAT's is the same product of x and the fake-quantized weight
    (``fake_quant``, in x's dtype).  The LoRA delta (``lora_delta``) is
    added after the product, on every route, and the bias after that, in
    y's dtype (``bias_add``).  The delta's scale is 1: the reference's
    ``apply`` takes ``lora_scale=1.0`` and no call site passes another
    (its ``merge_lora`` multiplies by ``lora_alpha`` all the same).

    A row-parallel shard's product is all-reduced over the model axis
    (``row_reduce``) before it is rounded to x's dtype and before the
    delta and the bias."""
    if p.n_experts is not None:
        return _apply_experts(p, x, slots, draft_bits)
    row = getattr(p, "tp", None) == "row"
    if p.quantized:
        groups = getattr(p, "tp_groups", None) if row else None
        if slots is not None and isinstance(slots[1], dict) \
                and "scale" in slots[1]:
            task_ids, stack = slots
            y = ops.quant_matmul_slotted(x, p.qw,
                                         _groups(stack["scale"], groups),
                                         _groups(stack["zero"], groups),
                                         task_ids, p.spec,
                                         draft_bits=draft_bits)
        else:
            y = ops.quant_matmul(x, p.qw, _groups(p.scale, groups),
                                 _groups(p.zero, groups), p.spec,
                                 draft_bits=draft_bits)
    elif p.fake_quant:
        w = fake_quant(p.w.to(x.dtype), p.scale, p.zero, p.spec)
        y = ops.dot_f32(x, w)
    else:
        y = ops.dot_f32(x, p.w.to(x.dtype))
    if row and not getattr(p, "tp_partial", False):
        y = row_reduce(y, x.dtype if p.tp_reduce_bf16 else torch.float32)
    y = y.to(x.dtype)
    if p.has_lora:
        y = y + lora_delta(x, p.lora_a, p.lora_b)
    return y if p.b is None else bias_add(y, p.b)


def _groups(t: torch.Tensor, groups) -> torch.Tensor:
    """A row-parallel shard's block of the (…, N, G) scales or zeros, G > 1
    groups (contiguous: the kernels take contiguous operands)."""
    if groups is None:
        return t
    return t[..., groups[0]:groups[1]].contiguous()


def row_reduce(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel partial product summed over the model axis in
    ``dtype`` (the activation dtype under ``bf16_reduce``, else float32);
    ``y`` is the caller's own, reduced in place where it has that dtype
    and no graph is recorded.  In training the sum is Megatron's g
    (``context.reduce_from_model``): its gradient is the same on every
    rank."""
    return context.reduce_from_model(y.to(dtype), context.require())


def _apply_experts(p: Linear, x: torch.Tensor, slots, draft_bits
                   ) -> torch.Tensor:
    """An expert linear's y (E, C, out) = x (E, C, in) · W[e]ᵀ per expert, in
    x's dtype: the reference's ``apply`` under ``jax.vmap`` — the quantized
    product through ``ops.quant_matmul_experts``, the fp and QAT products
    through ``ops.dot_f32_experts``; nibble codes or bit-planes, as the
    spec says.  Forward of one task only (no slots, no draft: the
    reference's MoE has no slotted or verify step).  A row-parallel shard
    of the stack (``expert_sharding="tensor"``) reads its block of G > 1
    groups; its product is a partial sum the MoE block reduces."""
    if slots is not None:
        raise NotImplementedError(
            "an expert linear has no slotted step: MoE expert dispatch "
            "cannot thread per-slot scales")
    if draft_bits is not None:
        raise NotImplementedError(
            "an expert linear has no draft read: MoE expert dispatch is not "
            "supported in the verify step")
    if p.quantized:
        groups = getattr(p, "tp_groups", None)
        return ops.quant_matmul_experts(x, p.qw, _groups(p.scale, groups),
                                        _groups(p.zero, groups), p.spec)
    w = p.w.to(x.dtype)
    if p.fake_quant:
        w = fake_quant(w, p.scale, p.zero, p.spec)
    return ops.dot_f32_experts(x, w).to(x.dtype)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient, computed as the reference
    writes it, x + stop_gradient(round(x) − x), in x's dtype (in bf16 this
    is not always ``torch.round(x)``'s bits)."""
    return x + (torch.round(x) - x).detach()


def fake_quant(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               spec: QuantSpec) -> torch.Tensor:
    """QAT's quantize-dequantize of w (…, n, m) in w's dtype (the
    reference's ``_fake_quant``, under ``jax.vmap`` for an expert stack's
    leading axis): s·(clip(ste_round(w/s) + z, 0, levels) − z) per group,
    with s and z cast to w's dtype.  The clip is max then min, as
    ``jnp.clip``, whose gradient at a bound is one half (``torch.clamp``'s
    is one)."""
    *lead, n, m = w.shape
    g = scale.shape[-1]
    wg = w.reshape(*lead, n, g, m // g)
    s = scale[..., None].to(w.dtype)
    z = zero[..., None].to(w.dtype)
    q = ste_round(wg / s) + z
    lo = torch.zeros((), dtype=w.dtype, device=w.device)
    hi = torch.full((), spec.levels, dtype=w.dtype, device=w.device)
    q = torch.minimum(torch.maximum(q, lo), hi)
    return (s * (q - z)).reshape(*lead, n, m)


def lora_delta(x: torch.Tensor, lora_a: torch.Tensor,
               lora_b: torch.Tensor) -> torch.Tensor:
    """(x·Aᵀ)·Bᵀ in x's dtype, rounded where the reference rounds: A and B
    cast to x's dtype, the first product rounded to it (its einsum names
    no output type), the second summed in float32 and then rounded."""
    t = ops.dot_f32(x, lora_a.to(x.dtype)).to(x.dtype)
    return ops.dot_f32(t, lora_b.to(x.dtype)).to(x.dtype)


def bias_add(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y + b in y's dtype (the reference's ``y + p["b"].astype(y.dtype)``)."""
    return y + b.to(y.dtype)
