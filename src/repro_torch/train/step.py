"""The train step (port of ``repro/train/step.py``, off the mesh):
loss → grads → (int8-compressed) → masked AdamW update.

The step runs eagerly: the loss, ``backward()`` (the quantized linears'
analytic backward, ``kernels/ops.py``), optional int8 compression, then the
masked update in place under ``no_grad``.  The batch (numpy or tensors) is
moved to the model's device.  Metrics are 0-d tensors: ``loss``,
``grad_norm`` and ``lr`` — read them (a host sync) only when logging.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh is not ported yet (one device only)")


def build_train_step(api, cfg: ModelConfig, tcfg: TrainConfig, mask,
                     optimizer: MaskedAdamW, mesh=None):
    """(state, batch) → (state, metrics), updating ``state`` in place."""
    _no_mesh(mesh)
    compress = tcfg.optim.grad_compression == "int8"

    def step_fn(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = api.loss_fn(model, to_device(batch, api.device))
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        if compress:
            grads = compress_tree(grads, mask)
        gnorm = optimizer.update(grads, state["opt"], params, mask)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "lr": optimizer.schedule(state["opt"]["count"])}
        return state, metrics

    return step_fn


def build_eval_step(api, cfg: ModelConfig, mesh=None):
    """(model, batch) → the batch's mean loss, without gradients."""
    _no_mesh(mesh)

    @torch.no_grad()
    def eval_fn(model, batch):
        return api.loss_fn(model, to_device(batch, api.device))

    return eval_fn
