"""Train state and its cut over a mesh (port of ``repro/train/state.py``).

The state is a plain dict: ``{"params": the model (an nn.Module, updated
in place), "opt": the masked-AdamW state, "step": int}`` —
``bridge.state_to_tree`` gives the reference's tree of it.

On a ``(data, model)`` mesh each rank's state holds its shard: the model
cut by ``dist/sharding.py::shard_model`` and each optimizer moment its
parameter's block (``state_specs``, the reference's: the moments mirror
their parameter's spec).  ``shard_state`` cuts a whole state;
``whole_tree`` puts the reference's tree of the WHOLE state back together
from the shards (an all-gather over the model axis, for a checkpoint), and
``load_shard`` loads a whole tree into a rank's state, cutting its blocks,
so a checkpoint crosses between meshes and off them.  A KV head that model
ranks share (``sharding.kv_share``) is cut and gathered by its groups.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import bridge
from repro_torch.core.peqa import ref_path
from repro_torch.dist import sharding


def make_state(model: nn.Module, opt_state: dict, step: int = 0) -> dict:
    return {"params": model, "opt": opt_state, "step": int(step)}


def state_specs(state: dict) -> dict:
    """The spec of every leaf of ``state`` (the reference's
    ``state_specs``): the parameters' and buffers' by their paths, each
    moment pair its parameter's, the count and the step replicated."""
    return {"params": sharding.param_specs(state["params"]),
            "opt": {"mv": sharding.moment_specs(state["params"],
                                                state["opt"]["mv"]),
                    "count": ()},
            "step": ()}


def shard_state(state: dict, ctx, cfg) -> dict:
    """This rank's shard of a WHOLE state (model, moments, count, step):
    ``shard_model``'s cut of the model (of config ``cfg``) and each
    moment's block, new tensors on the model's device."""
    shard = sharding.shard_model(state["params"], cfg, ctx)
    specs = sharding.moment_specs(shard, state["opt"]["mv"])
    mv = {name: tuple(sharding.local_slice(t, spec, ctx)
                      for t, spec in zip(pair, specs[name]))
          for name, pair in state["opt"]["mv"].items()}
    return {"params": shard,
            "opt": {"mv": mv, "count": state["opt"]["count"].clone()},
            "step": int(state["step"])}


def _gather(spec: tuple, t: torch.Tensor, ctx) -> torch.Tensor:
    """The whole tensor of a rank's block ``t`` under ``spec`` (a grouped
    KV leaf from one rank of each group of ``share``: the whole leaf
    itself where there is one KV head)."""
    for dim, ax in enumerate(spec):
        block = sharding.model_block(ax, ctx.model_size, ctx.model_rank)
        if block is None:
            continue
        if block[0] == 1:
            return t
        parts = ctx.all_gather(t, "model", dim=dim).chunk(ctx.model_size,
                                                          dim=dim)
        return torch.cat(parts[::ctx.model_size // block[0]], dim=dim)
    return t


@torch.no_grad()
def whole_tree(state: dict, ctx) -> dict:
    """The reference's state tree of the whole model from this rank's
    shard: every model-sharded tensor and moment gathered over the model
    axis (a collective: every rank calls it)."""
    model = state["params"]
    specs = sharding.param_specs(model)
    named = [(n, _gather(specs[n], t, ctx))
             for n, t in (*model.named_parameters(), *model.named_buffers())]
    mv = {n: tuple(_gather(specs[n], t, ctx) for t in pair)
          for n, pair in state["opt"]["mv"].items()}
    return {"params": bridge.tensors_to_tree(named),
            "opt": bridge.names_opt_tree([n for n, _ in named],
                                         {"mv": mv,
                                          "count": state["opt"]["count"]}),
            "step": np.asarray(int(state["step"]), np.int32)}


def load_shard(state: dict, tree: dict, ctx) -> dict:
    """A whole state tree (a checkpoint) loaded into this rank's shard
    ``state`` in place, each tensor cut to the rank's block (a bit-plane
    expert stack's by its planes' rule, read from the shard's linears)."""
    planes = sharding.plane_codes(state["params"])
    share = sharding.shard_kv_share(state["params"])

    def cut(name, t):
        return sharding.local_slice(
            t, sharding.spec_for_path(ref_path(name), t.dim(),
                                      name in planes, share), ctx)
    return bridge.load_state(state, tree, cut)
