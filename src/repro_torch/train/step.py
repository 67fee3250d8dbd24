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
  * the model-partial gradients (row-parallel scales and zeros,
    ``sharding.leaf_kind``) summed over the model axis in one flat bucket,
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

      * model axis: the forward's 2L row-parallel sums (an MoE block's
        feed-forward is one, as a dense MLP's: its routed and shared
        partial sums are reduced together) and the lookup's one; under
        remat "block" ("full") the recompute's L — torch's
        checkpoint stops its recompute once the tensors the backward needs
        are back, so each block's last sum (after ``down``) is not re-run
        —; the backward's ``copy_to_model`` gradients, 2L + 1 (ln1, ln2,
        the head), less block 0's ln1 when nothing before it trains (a
        frozen table and gain: PEQA); the cross entropy's 3 (an MoE
        model's aux loss rides the loss's data-axis sum); the partial
        bucket where a trained leaf is model-partial (a row-parallel
        scale or zero; under ``full`` an MoE router); the norm's 1; and
        under int8 compression the max bucket where a trained leaf is
        model-sharded;
      * data axis: the token count, the loss and the gradient bucket."""
    n = cfg.n_layers
    kinds = sharding.leaf_kinds(model)
    trained = [k for k in kinds if mask.get(k)]
    first = any(k.startswith(("embed.", "layers.0.ln1.")) for k in trained)
    has = lambda kind: int(any(kinds[k] == kind for k in trained))
    recompute = n if cfg.remat in ("block", "full") else 0
    return {"model": 2 * n + 1 + recompute + 2 * n + int(first) + 3
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


def _reduce_grads(grads: Dict[str, torch.Tensor], model, mask, ctx) -> set:
    """A rank's trainable gradients made the global gradient's blocks, in
    the dict: the model-partial ones summed over the model axis, then all
    over the data axis, one bucket each.  Returns the names of the
    model-sharded ones (for the norm and the int8 codec)."""
    kinds = sharding.leaf_kinds(model)
    live = [n for n, g in grads.items() if mask.get(n) and g is not None]
    _bucket_sum(grads, [n for n in live if kinds[n] == sharding.PARTIAL],
                ctx, "model")
    _bucket_sum(grads, live, ctx, "data")
    return {n for n in live if kinds[n] == sharding.SHARDED}


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
        sharded = set() if mesh is None \
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
