"""Path-based partition rules and the cut of a rank's shard (port of
``repro/dist/sharding.py``).

``spec_for_path(path, ndim)`` decides where every leaf lives on the
``(data, model)`` mesh, keyed on the leaf name and its parent module name
(the reference's rules, copied): a spec is a tuple with one entry a dim —
None (replicated), ``"model"``, or a tuple of data axes —, trailing Nones
trimmed, as the reference's ``PartitionSpec``.  The rules are relative to
the trailing dims, so the same rule places a per-layer tensor of the port
and the reference's layer-stacked leaf.

  * Column-parallel linears (wq/wk/wv/up/gate) shard the OUTPUT dim: codes
    ``qw``, ``scale`` and ``zero`` on dim −2 (a bit-plane ``qw`` (bits, N,
    K/32) too), so each model rank holds the scales of exactly the rows it
    owns and a task swap touches only local bytes.
  * Row-parallel linears (wo/down/out_proj) shard the INPUT dim of ``w``
    and ``qw`` (the last dim, nibble words or plane words); their
    ``scale``/``zero`` (out, G) stay whole, and their outputs are partial
    sums that ``models/linear.py`` all-reduces over the model axis.
  * Embeddings and the untied head shard the vocab; norms replicate.
  * An MoE block's router replicates.  Its expert stacks shard as the
    config's ``expert_sharding`` says: ``experts_ep`` ("expert") on the
    expert dim E of every leaf — each rank holds E/M whole experts, a
    bit-plane ``qw`` (E, bits, N, K/32) with all its planes —, ``experts``
    ("tensor") on each expert's d_ff: up/gate column-parallel, down
    row-parallel, by the rules above.  The shared experts are a dense
    Megatron MLP.  Unlike the reference's rule, which puts a plane
    stack's model axis on its bits dim, the port's places it on E
    (``spec_for_path(..., planes=True)``).
  * KV heads fewer than the model ranks (granite-34b's one, MQA): where
    the model axis M is a multiple of n_kv_heads, ``kv_share`` = M/n_kv
    consecutive model ranks hold the same KV head whole — rank r the head
    ``r // kv_share``, exactly the one its n_heads/M query heads group
    onto —, so ``wk``/``wv``'s output rows (codes, scales, zeros, a
    ``qkv_bias``) are cut into n_kv blocks, not M (a ``KVGroup`` entry in
    the spec), and the cache's KV-head dim likewise.  The reference cuts
    the rows over M and shards the cache's head_dim instead, leaving GSPMD
    to sum partial QKᵀ products over D; the port computes each rank's
    attention locally over whole heads (K4), so it keeps the head whole:
    the same values, another layout (ROADMAP §3).

The reference hands these specs to GSPMD.  The port cuts each rank's
local module from the whole quantized model (``shard_model``): the shard
is never quantized on its own — per-channel RTN of a row-parallel input
slice would give other scales —, and ``unshard`` puts the shards back
together bit for bit.  Attention runs on the rank's n_heads/M query and
n_kv/M KV heads (``shard_config``).

In training every leaf's gradient is one of three kinds on the model axis
(``leaf_kind``): ``"sharded"`` — the rank's block, complete —,
``"partial"`` — a row-parallel linear's whole ``scale``/``zero``, whose
gradient on a rank is the partial sum over its input columns; a grouped
``wk``/``wv`` leaf, whose gradient covers only the rank's query heads'
share of its KV head — and
``"replicated"`` — equal on every model rank (norm gains, row-parallel
biases).  The train step sums the partial ones over the model axis, the
gradient norm and the int8 codec reduce over the sharded ones; the
optimizer moments take their parameter's block (``moment_specs``).  The
router's gradient is partial too: the combine's gate term covers only the
rank's experts (or d_ff slice), and the MoE block lets its aux term in at
1/M a model rank (``models/moe.py``), so one model-axis sum gives the
whole gradient.

``shard_problems`` refuses what this slice does not shard, with a reason:
a head, d_ff or vocab count the model axis does not divide, a KV-head count
that neither divides it nor is divided by it, an expert count ("expert") or an expert's or the shared experts'
d_ff ("tensor", shared) it does not divide, and a local input extent that
breaks a kernel's operand layout (the nibble word ``K % 8``, the plane
word ``K % 32``, whole groups).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.peqa import ref_path
from repro_torch.core.quant import PACK, PLANE_PACK

MODEL_AXIS = "model"

# linears that shard the contraction (input) dim — their outputs are the
# partial sums reduced once a block (Megatron layout)
ROW_PARALLEL = ("wo", "down", "out_proj")
# modules that stay replicated wholesale (routers, sLSTM recurrences, the
# xLSTM scalar-gate projections)
REPLICATED_MODULES = ("router", "sr", "sb", "gi", "gf", "sw")
# per-head SSM vectors: the trailing heads dim
HEAD_VECTOR_LEAVES = ("A_log", "ssm_D", "dt_bias")
_LINEAR_LEAVES = ("w", "qw", "scale", "zero", "b")
# the linears whose output rows are KV heads (self- and cross-attention)
KV_LINEARS = ("wk", "wv")


@dataclasses.dataclass(frozen=True)
class KVGroup:
    """A spec entry: the dim is cut over the model axis into M/``share``
    blocks, each held by ``share`` consecutive model ranks (a KV head
    shared by the ranks whose query heads group onto it)."""
    share: int


def kv_share(cfg: ModelConfig, model_size: int) -> int:
    """How many model ranks hold each KV head: M/n_kv_heads where the KV
    heads are fewer than the model ranks and divide them, else 1."""
    n = cfg.n_kv_heads
    return model_size // n if n < model_size and model_size % n == 0 else 1


def model_block(ax, model_size: int, model_rank: int):
    """(blocks, this rank's block) of a dim under spec entry ``ax``, or
    None where ``ax`` does not cut the model axis."""
    if ax == MODEL_AXIS:
        return model_size, model_rank
    if isinstance(ax, KVGroup):
        return model_size // ax.share, model_rank // ax.share
    return None


def _mk(ndim: int, axis_at: int, axis=MODEL_AXIS) -> tuple:
    """A spec with ``axis`` (the model axis, or a ``KVGroup`` of it) at
    ``axis_at``, trailing Nones trimmed."""
    if axis_at < 0 or axis_at >= ndim:
        return ()
    return (None,) * axis_at + (axis,)


def _is_norm(name: str) -> bool:
    return name.startswith("ln") or "norm" in name


def spec_for_path(path: str, ndim: int, planes: bool = False,
                  kv_share: int = 1) -> tuple:
    """The spec of the leaf at ``path`` (the reference's key path, with or
    without its leading slash) with ``ndim`` dims; ``planes``: the leaf is
    a bit-plane ``qw``, whose trailing dims are (bits, N, K/32) — which
    its ndim alone cannot tell apart from a nibble stack with a layer dim
    (``param_specs`` reads it from a module's linears); ``kv_share`` > 1:
    the config's KV heads are fewer than the model ranks (``kv_share(cfg,
    M)``), so a ``wk``/``wv`` leaf's output dim takes ``KVGroup(kv_share)``
    instead of the model axis."""
    parts = [p for p in path.split("/") if p]
    leaf = parts[-1] if parts else ""
    parent = parts[-2] if len(parts) >= 2 else ""

    if any(p in REPLICATED_MODULES for p in parts):
        return ()
    if "experts_ep" in parts:
        # expert-parallel: the expert dim of every leaf, just before the
        # leaf's own trailing dims (1 for b/g, 3 for a bit-plane qw, 2 for
        # the rest)
        trailing = 1 if leaf in ("b", "g") else \
            3 if planes and leaf == "qw" else 2
        return _mk(ndim, ndim - trailing - 1)
    if leaf == "emb":                       # (vocab, d): vocab-sharded
        return _mk(ndim, ndim - 2)
    if leaf in ("pos", "lora_a") or leaf == "g" or (leaf == "b"
                                                    and _is_norm(parent)):
        return ()
    if leaf in HEAD_VECTOR_LEAVES:          # (…, n_heads)
        return _mk(ndim, ndim - 1)
    if leaf == "lora_b":                    # (…, out, r): the out dim
        return _mk(ndim, ndim - 2)
    if leaf in _LINEAR_LEAVES:
        if parent in ROW_PARALLEL:
            if leaf in ("w", "qw"):         # (…, out, in): the input dim
                return _mk(ndim, ndim - 1)
            return ()                       # scale/zero/b: per output row
        axis = KVGroup(kv_share) if kv_share > 1 and parent in KV_LINEARS \
            else MODEL_AXIS
        if leaf == "b":                     # a column bias: the output
            return _mk(ndim, ndim - 1, axis)
        return _mk(ndim, ndim - 2, axis)    # w/qw/scale/zero: the output
    return ()


SHARDED, PARTIAL, REPLICATED = "sharded", "partial", "replicated"


def leaf_kind(path: str, ndim: int, kv_share: int = 1) -> str:
    """What a rank holds of the gradient of the leaf at ``path`` on the
    model axis: ``SHARDED`` (its block), ``PARTIAL`` (a row-parallel
    scale or zero: a partial sum over its input columns; an MoE router's
    weight: its experts' or d_ff slice's share; a grouped ``wk``/``wv``
    leaf: its query heads' share of its KV head's) or ``REPLICATED`` (the
    whole gradient, equal on every model rank)."""
    spec = spec_for_path(path, ndim, kv_share=kv_share)
    if any(isinstance(ax, KVGroup) for ax in spec):
        return PARTIAL
    if MODEL_AXIS in spec:
        return SHARDED
    parts = [p for p in path.split("/") if p]
    if len(parts) >= 2 and parts[-1] in ("scale", "zero") \
            and parts[-2] in ROW_PARALLEL:
        return PARTIAL
    if "router" in parts:
        return PARTIAL
    return REPLICATED


def shard_kv_share(model) -> int:
    """The ``kv_share`` a shard was cut with (``shard_model`` records it;
    1 for a whole model or a mapping)."""
    return getattr(model, "kv_share", 1)


def _share_of(tree, kv_share: int) -> int:
    """A module's own ``kv_share``, else (a flat mapping) ``kv_share``."""
    return shard_kv_share(tree) if isinstance(tree, nn.Module) else kv_share


def leaf_kinds(model: nn.Module) -> Dict[str, str]:
    """{parameter name: ``leaf_kind``} of ``model``'s parameters."""
    share = shard_kv_share(model)
    return {name: leaf_kind(ref_path(name), t.dim(), share)
            for name, t in model.named_parameters()}


def moment_specs(model: nn.Module, mv: Mapping) -> Dict[str, tuple]:
    """The spec of each optimizer moment pair (``MaskedAdamW``'s ``mv``):
    both moments take their parameter's spec (the reference's
    ``state_specs``; a shared KV head's from the shard's ``kv_share``)."""
    share = shard_kv_share(model)
    params = dict(model.named_parameters())
    out = {}
    for name in mv:
        spec = spec_for_path(ref_path(name), params[name].dim(),
                             kv_share=share)
        out[name] = (spec, spec)
    return out


def plane_codes(model: nn.Module) -> set:
    """The names of ``model``'s bit-plane ``qw`` buffers."""
    return {f"{name}.qw" if name else "qw"
            for name, mod in model.named_modules()
            if "qw" in mod._buffers and mod.spec.plane}


def _leaves(tree) -> Iterable[tuple]:
    """(reference path, name, tensor or array, bit-plane codes?) of a
    module's parameters and buffers, or of a flat {path: array}
    mapping (nibble codes)."""
    if isinstance(tree, nn.Module):
        planes = plane_codes(tree)
        for name, t in (*tree.named_parameters(), *tree.named_buffers()):
            yield ref_path(name), name, t, name in planes
        return
    for path, t in tree.items():
        yield path, path, t, False


def param_specs(tree) -> Dict[str, tuple]:
    """{name: spec} of every leaf of ``tree``: a module (keyed by its
    tensor names, each bit-plane ``qw`` known from its linear, a shared KV
    head from the shard's ``kv_share``) or a flat {path: array}
    mapping."""
    share = shard_kv_share(tree)
    return {name: spec_for_path(path, len(tuple(t.shape)), planes, share)
            for path, name, t, planes in _leaves(tree)}


def stacked_scale_specs(tree) -> dict:
    """The specs of a ``ResidentStack`` stack (nested, or flat by path):
    a task dim inserted before the trailing (out, G) pair lands
    replicated, since the rules are trailing-relative — column-parallel
    scales shard their out dim as the live leaf does, row-parallel ones
    stay whole, so a row install moves the same per-rank bytes as a swap
    and needs no collective."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}
        last = prefix.split("/")[-1]
        if last not in ("scale", "zero"):
            raise ValueError(f"stacked scale tree has non-scale leaf "
                             f"{prefix!r}")
        return spec_for_path(prefix, len(tuple(node.shape)))
    return walk(tree, "")


def cache_specs(ctx, cache: Mapping, batch: int, batch_sharded: bool,
                n_kv_heads: int = 0, batch_dims: Optional[Mapping] = None,
                kv_share: int = 1) -> Dict[str, tuple]:
    """The spec of every cache leaf (the reference's rule): the batch dim
    over the data axes where sharded, the KV-head dim over the model axis
    where it divides — else head_dim, the reference's fallback.  With
    ``kv_share`` > 1 (fewer KV heads than model ranks) the KV-head dim
    takes ``KVGroup(kv_share)`` instead: the port's layout, each rank's
    cache holding its KV head whole (the module docstring).

    ``batch_dims`` ({key: dim}, ``train.serve.cache_dims``' first half)
    pins each leaf's batch dim structurally; without it the batch dim is
    the first dim whose extent equals ``batch``, which misfires when that
    extent collides with a stack extent (batch == n_layers)."""
    msize = ctx.model_size

    def spec(shape, bdim):
        nd = len(shape)
        parts = [None] * nd
        placed = False
        for dim in range(nd):
            is_batch = (dim == bdim) if bdim is not None \
                else (not placed and shape[dim] == batch)
            if batch_sharded and not placed and is_batch:
                parts[dim] = tuple(ctx.data_axes)
                placed = True
            elif (n_kv_heads and dim >= 2 and shape[dim] == n_kv_heads
                  and not any(model_block(p, msize, 0) for p in parts)):
                if n_kv_heads % msize == 0:
                    parts[dim] = ctx.model_axis
                elif kv_share > 1:
                    parts[dim] = KVGroup(kv_share)
        if not any(model_block(p, msize, 0) for p in parts) and nd >= 3 \
                and shape[-1] % msize == 0:
            parts[-1] = ctx.model_axis
        return tuple(parts)

    return {k: spec(tuple(v.shape), None if batch_dims is None
                    else batch_dims[k]) for k, v in cache.items()}


def _axis_total(ax, sizes: Mapping) -> int:
    total = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        total *= sizes[a]
    return total


def validate_for_mesh(tree, mesh, kv_share: int = 1) -> List[str]:
    """Every sharded dim of ``tree`` (a module or a flat {path: array})
    must divide its mesh axes; returns the problems (empty: coherent).
    ``mesh``: a ``MeshContext`` or a {axis: size} mapping; a grouped KV
    dim must divide its blocks (``kv_share``: a flat mapping's; a module
    gives its own)."""
    sizes = dict(getattr(mesh, "axis_sizes", mesh))
    share = _share_of(tree, kv_share)
    problems: List[str] = []
    for path, _, leaf, planes in _leaves(tree):
        shape = tuple(leaf.shape)
        for dim, ax in enumerate(spec_for_path(path, len(shape), planes,
                                               share)):
            if ax is None:
                continue
            if isinstance(ax, KVGroup):
                total = sizes.get(MODEL_AXIS, 1) // ax.share
                if shape[dim] % total:
                    problems.append(f"{path}: dim {dim} = {shape[dim]} not "
                                    f"divisible by {total} (model / "
                                    f"{ax.share})")
                continue
            missing = [a for a in (ax if isinstance(ax, tuple) else (ax,))
                       if a not in sizes]
            if missing:
                problems.append(f"{path}: axis {missing[0]!r} not in mesh "
                                f"{tuple(sizes)}")
                break
            total = _axis_total(ax, sizes)
            if shape[dim] % total:
                problems.append(f"{path}: dim {dim} = {shape[dim]} not "
                                f"divisible by {total} ({ax})")
    return problems


# ---------------------------------------------------------------------------
# The cut
# ---------------------------------------------------------------------------

def shard_problems(cfg: ModelConfig, model_size: int) -> List[str]:
    """Why ``cfg`` cannot be cut over a model axis of ``model_size`` in this
    slice (empty: it can)."""
    m = model_size
    mc = cfg.moe
    out = []
    counts = [("n_heads", cfg.n_heads), ("vocab_size", cfg.vocab_size)]
    if cfg.n_kv_heads % m and m % cfg.n_kv_heads:
        out.append(f"n_kv_heads={cfg.n_kv_heads} neither divides nor is "
                   f"divided by the model axis ({m}): a rank holds whole KV "
                   f"heads, or one KV head that model ranks share")
    # the input extents of the row-parallel linears, each cut over m
    rows = [("wo", cfg.n_heads * cfg.d_head)]
    if mc is None:
        counts.append(("d_ff", cfg.d_ff))
        rows.append(("down", cfg.d_ff))
    else:
        d_ff = mc.d_ff_expert or cfg.d_ff
        if mc.expert_sharding == "expert":
            counts.append(("n_experts", mc.n_experts))
        else:
            counts.append(("d_ff_expert", d_ff))
            rows.append(("an expert's down", d_ff))
        if mc.n_shared_experts:
            counts.append(("the shared experts' d_ff",
                           d_ff * mc.n_shared_experts))
            rows.append(("the shared down", d_ff * mc.n_shared_experts))
    for what, n in counts:
        if n % m:
            out.append(f"{what}={n} is not divisible by the model axis ({m})"
                       + (": expert parallelism gives each rank whole "
                          "experts" if what == "n_experts" else ""))
    if out:
        return out
    spec = cfg.quant.spec()
    if cfg.tuning.mode not in ("peqa", "peqa_z"):
        return out
    word = PLANE_PACK if spec.plane else PACK
    for name, whole in rows:
        k = whole // m
        if k % word:
            out.append(f"{name}'s local input extent {k} is not a whole "
                       f"number of {word}-code words")
        if spec.group_size is not None and k % spec.group_size:
            out.append(f"{name}'s local input extent {k} is not a whole "
                       f"number of groups of {spec.group_size}")
    return out


def shard_config(cfg: ModelConfig, model_size: int) -> ModelConfig:
    """The config a rank's shard runs under: its local query and KV heads
    (one KV head where ``kv_share`` ranks share it), the head width pinned
    (the vocab, d_ff and d_model stay the whole model's: the shard's
    tensors carry their own extents)."""
    return cfg.replace(n_heads=cfg.n_heads // model_size,
                       n_kv_heads=max(cfg.n_kv_heads // model_size, 1),
                       head_dim=cfg.d_head)


def local_slice(t: torch.Tensor, spec: Sequence, ctx) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (model-axis dims only:
    parameters are never batch-sharded), contiguous, a new tensor."""
    out = t
    for dim, ax in enumerate(spec):
        block = model_block(ax, ctx.model_size, ctx.model_rank)
        if block is not None:
            n = t.shape[dim] // block[0]
            out = out.narrow(dim, block[1] * n, n)
    return out.contiguous().clone()


def local_shape(shape: Sequence[int], spec: Sequence, sizes: Mapping
                ) -> tuple:
    """The block of a ``shape`` leaf one rank holds under ``spec`` (each
    sharded extent over its axes' product, rounded up as the reference's
    padded shards are)."""
    out = []
    for dim, extent in enumerate(shape):
        ax = spec[dim] if dim < len(spec) else None
        k = 1 if ax is None else sizes[MODEL_AXIS] // ax.share \
            if isinstance(ax, KVGroup) else _axis_total(ax, sizes)
        out.append(-(-extent // k))
    return tuple(out)


def local_scales(scales: Mapping[str, np.ndarray], ctx, kv_share: int = 1
                 ) -> Dict[str, np.ndarray]:
    """A host scale set (bank paths, layer-stacked) cut to this rank's
    block: column-parallel rows sliced (a grouped ``wk``/``wv``'s to its
    KV head's, ``kv_share`` > 1), row-parallel scales whole, an
    ``experts_ep`` stack's (L, E, N, G) scales narrowed to its experts."""
    out = {}
    for path, arr in scales.items():
        arr = np.asarray(arr)
        spec = spec_for_path(path, arr.ndim, kv_share=kv_share)
        for dim, ax in enumerate(spec):
            block = model_block(ax, ctx.model_size, ctx.model_rank)
            if block is not None:
                n = arr.shape[dim] // block[0]
                arr = np.take(arr, range(block[1] * n, (block[1] + 1) * n),
                              axis=dim)
        out[path] = np.ascontiguousarray(arr)
    return out


def _new_param(t: torch.Tensor, like: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=like.requires_grad)


def shard_model(model: nn.Module, cfg: ModelConfig, ctx) -> nn.Module:
    """This rank's shard of the WHOLE ``model`` (a dense, vlm or MoE
    ``Transformer``, or an encdec ``Whisper``: each stack's attention and
    MLP cut alike, the cross-attention's q/k/v column-parallel and its
    ``wo`` row-parallel, the learned positions and every norm whole): a
    module with the same tensor names, each tensor its ``spec_for_path``
    block (contiguous copies: the shard shares no storage with ``model``,
    so a task swap on it leaves the whole model as it was).  Every linear
    is marked ``tp``: ``"col"`` or ``"row"`` (a row-parallel linear also
    ``tp_reduce_bf16``, ``cfg.bf16_reduce``, and with G > 1 groups
    ``tp_groups``, its block of them; inside an MoE block ``tp_partial``:
    the block reduces its routed and shared sums together), ``"kv"`` for a
    ``wk``/``wv`` that holds its KV head whole (``kv_share`` > 1, recorded
    on the shard as ``kv_share``), ``"expert"`` for an ``experts_ep``
    stack of E/M whole experts, None for the router; each MoE block is
    marked ``mesh_shard`` as the model is; the token table keeps
    ``vocab_start``.  ``ctx`` needs only ``model_size`` and ``model_rank``
    (``context.coords`` will do)."""
    from repro_torch.models import common, linear, registry
    probs = shard_problems(cfg, ctx.model_size)
    if probs:
        raise NotImplementedError(f"{cfg.name}: cannot shard over a model "
                                  f"axis of {ctx.model_size}: "
                                  f"{'; '.join(probs)}")
    share = kv_share(cfg, ctx.model_size)
    local = registry.module_class(cfg)(shard_config(cfg, ctx.model_size),
                                       device="meta")
    shard = (ctx.model_rank, ctx.model_size)
    for layer in getattr(local, "layers", ()):
        if layer.moe is None:
            continue
        layer.moe.mesh_shard = shard
        if "experts_ep" in layer.moe._modules:      # E/M whole experts
            mc = cfg.moe
            layer.moe.experts_ep = common.MLP(
                cfg, "meta", d_ff=mc.d_ff_expert or cfg.d_ff,
                n_experts=mc.n_experts // ctx.model_size)
    whole = dict(model.named_modules())
    with torch.no_grad():
        for name, mod in local.named_modules():
            src = whole[name]
            if isinstance(mod, linear.Linear):
                _shard_linear(mod, src, name, ctx, cfg.bf16_reduce, share)
                continue
            for pname, prm in list(src._parameters.items()):
                if prm is None:
                    continue
                path = ref_path(f"{name}.{pname}" if name else pname)
                mod._parameters[pname] = _new_param(
                    local_slice(prm.detach(), spec_for_path(path, prm.dim()),
                                ctx), prm)
            if isinstance(mod, common.Embed):
                mod.vocab_start = ctx.model_rank * (
                    src.emb.shape[0] // ctx.model_size)
                mod.vocab_size = src.emb.shape[0]
    left = [n for n, t in (*local.named_parameters(), *local.named_buffers())
            if t.is_meta]
    if left:
        raise ValueError(f"shard_model: tensors left uncut: {left}")
    local.mesh_shard = shard
    local.kv_share = share
    return local


def _shard_linear(mod, src, name: str, ctx, bf16_reduce: bool,
                  share: int = 1) -> None:
    """Fill the local ``Linear`` ``mod`` from the whole one ``src``; a
    row-parallel one reduces in the activation dtype under
    ``bf16_reduce``, or not at all inside an MoE block; with ``share`` > 1
    a ``wk``/``wv`` keeps its rank's KV head whole."""
    parts = name.split(".")
    replicated = any(p in REPLICATED_MODULES for p in parts)
    ep = "experts_ep" in parts
    row = parts[-1] in ROW_PARALLEL and not (replicated or ep)
    grouped = share > 1 and parts[-1] in KV_LINEARS
    m = ctx.model_size

    def cut(leaf: str, t: torch.Tensor) -> torch.Tensor:
        path = ref_path(f"{name}.{leaf}")
        planes = leaf == "qw" and src.spec is not None and src.spec.plane
        return local_slice(t.detach(), spec_for_path(path, t.dim(), planes,
                                                     share), ctx)

    if src.has_lora or src.fake_quant:
        raise NotImplementedError(
            f"{name}: LoRA and QAT linears are not sharded in this slice")
    if src.n_experts is not None:
        mod.n_experts = src.n_experts // m if ep else src.n_experts
    split = not (replicated or ep)
    mod.in_features = src.in_features // m if row else src.in_features
    mod.out_features = src.out_features * share // m if grouped else \
        src.out_features // m if split and not row else src.out_features
    if src.quantized:
        del mod._parameters["w"]
        mod.set_quantized(cut("qw", src.qw), cut("scale", src.scale),
                          cut("zero", src.zero), src.spec)
        mod.scale.requires_grad_(src.scale.requires_grad)
        mod.zero.requires_grad_(src.zero.requires_grad)
        g = src.scale.shape[-1]
        if row and g > 1:
            mod.tp_groups = (ctx.model_rank * g // m,
                             (ctx.model_rank + 1) * g // m)
    else:
        mod.w = _new_param(cut("w", src.w), src.w)
    mod.b = None if src.b is None else _new_param(cut("b", src.b), src.b)
    mod.tp = None if replicated else "expert" if ep else \
        "row" if row else "kv" if grouped else "col"
    if row:
        mod.tp_reduce_bf16 = bool(bf16_reduce)
        if "moe" in parts:
            mod.tp_partial = True


def unshard(shards: Sequence, kv_share: int = 1
            ) -> Dict[str, torch.Tensor]:
    """The whole model's tensors ({name: tensor}) put back together from
    the ``shards`` of model ranks 0..M−1 — modules, or {name: tensor}
    mappings keyed by their parameter names (trained leaves, or one
    moment of each optimizer pair, for checkpoints) —: each sharded tensor
    concatenated along its spec's dim (a grouped KV leaf from one rank of
    each group, ``kv_share`` — for mappings; modules give their own —,
    held equal within it), each replicated one taken from rank 0 (and held
    equal on every rank)."""
    out = {}
    tensors = [dict((*s.named_parameters(), *s.named_buffers()))
               if isinstance(s, nn.Module) else dict(s) for s in shards]
    planes = plane_codes(shards[0]) if isinstance(shards[0], nn.Module) \
        else set()
    share = _share_of(shards[0], kv_share)
    m = len(shards)
    for name, t0 in tensors[0].items():
        spec = spec_for_path(ref_path(name), t0.dim(), name in planes, share)
        parts = [t[name].detach() for t in tensors]
        dims = [(d, ax) for d, ax in enumerate(spec)
                if model_block(ax, m, 0) is not None]
        if dims:
            dim, ax = dims[0]
            step = ax.share if isinstance(ax, KVGroup) else 1
            for r in range(m):
                if not torch.equal(parts[r], parts[r - r % step]):
                    raise ValueError(f"{name}: KV head block differs on "
                                     f"model rank {r}")
            out[name] = torch.cat(parts[::step], dim=dim)
            continue
        for r, p in enumerate(parts[1:], 1):
            if not torch.equal(p, parts[0]):
                raise ValueError(f"{name}: replicated tensor differs on "
                                 f"model rank {r}")
        out[name] = parts[0]
    return out
