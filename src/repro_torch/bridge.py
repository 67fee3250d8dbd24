"""Parameter bridge between the reference's trees and the port's modules.

A reference tree is a nested dict of numpy arrays whose layer leaves are
stacked, ``tree["layers"]["attn"]["wq"]["qw"]`` of shape (L, n, m/8).  The
port's ``Transformer`` numbers its layers instead: ``layers.3.attn.wq.qw``.
A tensor's reference path is its name without the layer index
(``/layers/attn/wq/qw``, ``core.peqa.ref_path``), so the ``EXCLUDE`` and
mask rules carry over.  ScaleBank keys are the reference's key-path form,
the same path WITHOUT the leading slash (``layers/attn/wq/scale``,
``core.scale_bank.bank_path``), and a task's scales stay stacked over
layers, (L, N, G) — so a reference bank's ``tasks[name]`` dicts and npz
files go into the port's ``ScaleBank`` unchanged, and back.

Packed codes are ``uint32`` in the reference and the same bits as ``int32``
here.  The token table is stored in the activation dtype here (see
``models.common.Embed``), so a bf16 model's round trip rounds ``emb``; every
other leaf round-trips exactly.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.peqa import layer_index, ref_path
from repro_torch.models import transformer
from repro_torch.models.linear import Linear


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


@torch.no_grad()
def to_module(tree: dict, cfg: ModelConfig, *, device=None
              ) -> transformer.Transformer:
    """Reference param tree → the port's model on ``device`` (the card
    unless ``device="cpu"``).  Every leaf must find its tensor and every
    tensor its leaf."""
    dev = _device.resolve(device)
    flat = _flatten(tree)
    model = transformer.Transformer(cfg, device=dev)

    def leaf(name: str) -> np.ndarray:
        path = ref_path(name)
        if path not in flat:
            raise KeyError(f"reference tree has no leaf {path} for {name}")
        arr = flat[path]
        i = layer_index(name)
        return arr if i is None else arr[i]

    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and ref_path(f"{name}.qw") in flat:
            mod.set_quantized(*(_to_torch(leaf(f"{name}.{k}")).to(dev)
                                for k in ("qw", "scale", "zero")),
                              cfg.quant.spec())
    used = set()
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        src = _to_torch(leaf(name))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: reference leaf {tuple(src.shape)} != "
                             f"module tensor {tuple(t.shape)}")
        t.copy_(src)
        used.add(ref_path(name))
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"reference leaves the port's model has no tensor "
                       f"for: {extra}")
    return model


def to_tree(model: torch.nn.Module) -> dict:
    """The port's model → reference-layout nested dict of numpy arrays
    (layer leaves stacked, codes as uint32, floats as float32)."""
    groups = defaultdict(dict)
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        arr = t.detach().cpu()
        arr = arr.numpy().view(np.uint32) if arr.dtype == torch.int32 \
            else arr.to(torch.float32).numpy()
        groups[ref_path(name)][layer_index(name)] = arr
    tree: dict = {}
    for path, by_layer in groups.items():
        if None in by_layer:
            val = by_layer[None]
        else:
            val = np.stack([by_layer[i] for i in sorted(by_layer)])
        node = tree
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return tree
