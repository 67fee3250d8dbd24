"""The train step (port of ``repro/train/step.py``): loss → grads →
(int8-compressed) → masked AdamW update, off a mesh or on one.

The step runs eagerly: the loss, ``backward()`` (the quantized linears'
analytic backward, ``kernels/ops.py``), optional int8 compression, then the
masked update in place under ``no_grad``.  The batch (numpy or tensors) is
moved to the model's device.  Metrics are 0-d tensors: ``loss``,
``grad_norm`` and ``lr`` — read them (a host sync) only when logging.

On a ``(data, model)`` mesh (``mesh=ctx``, ``dist/context.py``) the state
is the rank's shard (``train/state.py``) and the step is the reference's
jitted step over its shardings with every collective explicit:

  * the rank's rows of the GLOBAL batch (``ctx.local_rows``; a batch the
    data axis does not divide is refused, as the reference's ``P(data)``
    would) through the shard config's ``loss_fn`` under ``use_mesh``: the
    global token-mean loss, equal on every rank — with MoE blocks plus
    the aux loss of each data block averaged over the data axis, as the
    reference's ``pmean``;
  * ``backward()`` outside ``use_mesh`` (the backward never reads it);
  * the model-partial gradients (row-parallel scales and zeros, grouped
    ``wk``/``wv`` leaves, ``sharding.leaf_kind``) summed over the model
    axis in one flat bucket,
    then every trainable gradient over the data axis in one;
  * the int8 codec and the update on the global gradient: the norm and
    each sharded leaf's max |g| reduced over the model axis.

Each step equals the unsharded step on the same global batch up to the
order of float32 sums.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.dist import backend, context, sharding
from repro_torch.models import registry
from repro_torch.optim.adamw import MaskedAdamW
from repro_torch.optim.compression import compress_tree


def to_device(batch: dict, device) -> dict:
    """numpy or tensor batch → tensors on ``device``: integer keys (tokens,
    labels) as int64, the mask as float32, and every other floating key (a
    vlm's ``image_embeds``) in its own dtype."""
    out = {}
    for key, val in batch.items():
        t = torch.as_tensor(np.asarray(val)) if not torch.is_tensor(val) \
            else val
        dtype = torch.float32 if key == "mask" else \
            t.dtype if t.is_floating_point() else torch.int64
        out[key] = t.to(device=device, dtype=dtype, non_blocking=True)
    return out


def _local_batch(batch: dict, ctx, device) -> dict:
    """This rank's rows of a global ``batch``, on ``device``."""
    b = int(np.shape(batch["tokens"])[0])
    if b % ctx.data_size:
        raise NotImplementedError(registry.MESH_BATCH_REASON.format(
            batch=b, data=ctx.data_size))
    rows = ctx.local_rows(b)
    return to_device({k: v[rows] for k, v in batch.items()}, device)


def _mesh_api(api, cfg: ModelConfig, ctx):
    """The API a rank's shard runs under (the shard config's, on the
    context's device), after the mesh refusals."""
    registry.check_supported(cfg, mesh=ctx, train=True)
    return registry.build(sharding.shard_config(cfg, ctx.model_size),
                          device=backend.device(ctx.device))


def _check_shard(model, ctx) -> None:
    if getattr(model, "mesh_shard", None) != (ctx.model_rank, ctx.model_size):
        raise ValueError("on a mesh the state holds this rank's shard: "
                         "pass train.state.shard_state(state, ctx, cfg)")


def _bucket_sum(grads: Dict[str, torch.Tensor], names: List[str], ctx,
                axis: str) -> None:
    """``grads[names]`` summed over ``axis`` in one float32 all-reduce, in
    place in the dict."""
    if not names:
        return
    flat = torch.cat([grads[n].reshape(-1).to(torch.float32)
                      for n in names])
    flat = ctx.all_reduce(flat, axis)
    for n, part in zip(names, flat.split([grads[n].numel()
                                          for n in names])):
        grads[n] = part.view_as(grads[n]).to(grads[n].dtype)


def mesh_collectives(model, cfg: ModelConfig, mask, compress: bool = False
                     ) -> Dict[str, int]:
    """The all-reduces one mesh step issues on each axis (it issues no
    other kind), from the rank's shard ``model`` and the mask:

      * model axis: the forward's row-parallel sums — 2 a block (attention
        and the feed-forward; an MoE block's is one, as a dense MLP's: its
        routed and shared partial sums are reduced together), 2 an encoder
        block and 3 a decoder block of an encdec (self-attention, the
        cross-attention, the MLP) — and the lookup's one; under remat
        "block" ("full") the recompute's, one less a block — torch's
        checkpoint stops its recompute once the tensors the backward needs
        are back, so each block's last sum (after ``down``) is not re-run
        —; the backward's ``copy_to_model`` gradients, one for each norm
        that feeds a column-parallel group (2 a block, 3 a decoder block)
        and the head's (an encdec also the encoder output's, once for all
        the cross K/V), less each stack's first norm's when nothing before
        it trains (a frozen table or position table and gain: PEQA); the
        cross entropy's 3 (an MoE model's aux loss rides the loss's
        data-axis sum); the partial bucket where a trained leaf is
        model-partial (a row-parallel scale or zero, a grouped
        ``wk``/``wv`` leaf; under ``full`` an MoE router); the norm's 1;
        and under int8 compression the max bucket where a trained leaf is
        model-sharded;
      * data axis: the token count, the loss and the gradient bucket."""
    kinds = sharding.leaf_kinds(model)
    trained = [k for k in kinds if mask.get(k)]
    starts = lambda *names: int(any(k.startswith(names) for k in trained))
    has = lambda kind: int(any(kinds[k] == kind for k in trained))
    remat = cfg.remat in ("block", "full")
    if cfg.family == "encdec":
        ne, nd = cfg.enc_layers, cfg.n_layers
        forward = 2 * ne + 3 * nd + 1
        backward = 2 * ne + 3 * nd + starts("enc.") + 1 \
            - (1 - starts("enc.pos", "enc.layers.0.ln1.")) \
            - (1 - starts("dec.embed.", "dec.pos", "dec.layers.0.ln1."))
        recompute = (ne + 2 * nd) if remat else 0
    else:
        n = cfg.n_layers
        forward = 2 * n + 1
        backward = 2 * n + starts("embed.", "layers.0.ln1.")
        recompute = n if remat else 0
    return {"model": forward + recompute + backward + 3
            + has(sharding.PARTIAL) + 1
            + (has(sharding.SHARDED) if compress else 0),
            "data": 3}


def _loss(api, model, batch, mesh):
    """The batch's loss: off the mesh ``api.loss_fn``; on it (``api`` the
    shard config's) the global batch's from this rank's rows, under
    ``use_mesh``."""
    if mesh is None:
        return api.loss_fn(model, to_device(batch, api.device))
    _check_shard(model, mesh)
    with context.use_mesh(mesh):
        return api.loss_fn(model, _local_batch(batch, mesh, api.device))


def _kv_blocks(model, ctx) -> Dict[str, tuple]:
    """{name: (dim, blocks, this rank's block)} of the shard's grouped KV
    parameters that ``kv_share`` ranks share and that are cut into more
    than one block (n_kv_heads > 1)."""
    out = {}
    for name, spec in sharding.param_specs(model).items():
        for dim, ax in enumerate(spec):
            if isinstance(ax, sharding.KVGroup):
                blocks, mine = sharding.model_block(ax, ctx.model_size,
                                                    ctx.model_rank)
                if blocks > 1:
                    out[name] = (dim, blocks, mine)
    return out


def _reduce_grads(grads: Dict[str, torch.Tensor], model, mask, ctx
                  ) -> Dict[str, int]:
    """A rank's trainable gradients made the global gradient's blocks, in
    the dict: the model-partial ones summed over the model axis, then all
    over the data axis, one bucket each.  A grouped KV leaf cut into more
    than one block enters the model bucket as the whole leaf, zero outside
    its block, so each block sums over its own ranks only.  Returns the
    model-sharded names (for the norm and the int8 codec), each with the
    number of model ranks that hold the same block: 1, or ``kv_share``
    for such a grouped leaf."""
    kinds = sharding.leaf_kinds(model)
    live = [n for n, g in grads.items() if mask.get(n) and g is not None]
    partial = [n for n in live if kinds[n] == sharding.PARTIAL]
    grouped = {n: b for n, b in _kv_blocks(model, ctx).items()
               if n in partial}
    for n, (dim, blocks, mine) in grouped.items():
        g = grads[n]
        shape = list(g.shape)
        shape[dim] *= blocks
        whole = g.new_zeros(shape)
        whole.narrow(dim, mine * g.shape[dim], g.shape[dim]).copy_(g)
        grads[n] = whole
    _bucket_sum(grads, partial, ctx, "model")
    share = sharding.shard_kv_share(model)
    for n, (dim, blocks, mine) in grouped.items():
        n_rows = grads[n].shape[dim] // blocks
        grads[n] = grads[n].narrow(dim, mine * n_rows, n_rows).contiguous()
    _bucket_sum(grads, live, ctx, "data")
    out = {n: 1 for n in live if kinds[n] == sharding.SHARDED}
    out.update({n: share for n in grouped})
    return out


def build_train_step(api, cfg: ModelConfig, tcfg: TrainConfig, mask,
                     optimizer: MaskedAdamW, mesh=None):
    """(state, batch) → (state, metrics), updating ``state`` in place;
    ``mesh``: a ``MeshContext``, the state this rank's shard."""
    compress = tcfg.optim.grad_compression == "int8"
    local = api if mesh is None else _mesh_api(api, cfg, mesh)

    def step_fn(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = _loss(local, model, batch, mesh)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        sharded = {} if mesh is None \
            else _reduce_grads(grads, model, mask, mesh)
        if compress:
            grads = compress_tree(grads, mask, ctx=mesh, sharded=sharded)
        gnorm = optimizer.update(grads, state["opt"], params, mask,
                                 ctx=mesh, sharded=sharded)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "lr": optimizer.schedule(state["opt"]["count"])}
        return state, metrics

    return step_fn


def build_eval_step(api, cfg: ModelConfig, mesh=None):
    """(model, batch) → the batch's mean loss, without gradients; on a
    mesh (``mesh=ctx``, the model the rank's shard) the global batch's,
    equal on every rank."""
    local = api if mesh is None else _mesh_api(api, cfg, mesh)

    @torch.no_grad()
    def eval_fn(model, batch):
        return _loss(local, model, batch, mesh)

    return eval_fn
