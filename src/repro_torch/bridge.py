"""Parameter bridge between the reference's trees and the port's modules.

A reference tree is a nested dict of numpy arrays whose layer leaves are
stacked, ``tree["layers"]["attn"]["wq"]["qw"]`` of shape (L, n, m/8).  The
port's ``Transformer`` numbers its layers instead: ``layers.3.attn.wq.qw``
(and a ``Whisper`` its two stacks': ``enc.layers.3.attn.wq.qw`` ↔
``tree["enc"]["layers"]…``).
A tensor's reference path is its name without the layer index
(``/layers/attn/wq/qw``, ``core.peqa.ref_path``), so the ``EXCLUDE`` and
mask rules carry over.  A stack two deep numbers both levels: xlstm's
``mlstm.2.1.wq.qw`` ↔ ``tree["mlstm"]["wq"]["qw"][2, 1]`` of a (n_groups,
n_m, …) leaf, zamba2's ``mamba_groups.g.i`` likewise; its unstacked
``shared`` block has no index.  ScaleBank keys are the reference's key-path form,
the same path WITHOUT the leading slash (``layers/attn/wq/scale``,
``core.scale_bank.bank_path``), and a task's scales stay stacked over
layers, (L, N, G) — so a reference bank's ``tasks[name]`` dicts and npz
files go into the port's ``ScaleBank`` unchanged, and back.

A linear's storage follows from the leaves present, as in the reference:
``qw`` makes it quantized, ``scale`` beside ``w`` QAT's fake-quantized
form, and ``lora_a``/``lora_b`` (stacked (L, r, in) and (L, out, r)) add an
adapter to either.

Packed codes are ``uint32`` in the reference and the same bits as ``int32``
here.  A frozen token table (``peqa``, ``peqa_z``, ``lora``, ``lora_optq``) is
stored in the activation dtype here (``models.common.table_dtype``), so a
bf16 model's round trip rounds ``emb``; a trained one (``full``, ``qat``)
is float32, as the reference's, and every other leaf — biases, LayerNorm
gains and biases, an untied ``lm_head``, adapters, QAT's scales — round-
trips exactly.

The train state crosses too (``state_to_tree`` / ``load_state``): the
reference's state is ``{"params": tree, "opt": {"mv": …, "count"}, "step"}``
where ``mv`` mirrors the parameter tree with a (mom, vel) pair of stacked
moments at every trainable leaf and an empty pair, ``((), ())``, at every
other (the reference's ``(EMPTY, EMPTY)``); the port's optimizer keeps
(mom, vel) per trainable tensor name (``optim.adamw.MaskedAdamW``).
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.peqa import layer_index, ref_path, stack_indexed
from repro_torch.models import registry
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


def _tensors(model: torch.nn.Module) -> list:
    return list(model.named_parameters()) + list(model.named_buffers())


def _node(tree: dict, name: str):
    """The entry of a reference tree at the port's tensor ``name``'s path
    (a stacked leaf, or the optimizer's pair of stacked moments)."""
    node = tree
    for k in ref_path(name).strip("/").split("/"):
        if not isinstance(node, dict) or k not in node:
            raise KeyError(f"reference tree has no leaf {ref_path(name)} "
                           f"for {name}")
        node = node[k]
    return node


def _layer(arr, name: str) -> np.ndarray:
    """``name``'s layer slice of a stacked reference array (indexed along
    one axis, or two in a nested stack)."""
    arr = np.asarray(arr)
    i = layer_index(name)
    return arr if i is None else arr[i]


@torch.no_grad()
def to_module(tree: dict, cfg: ModelConfig, *, device=None
              ) -> torch.nn.Module:
    """Reference param tree → the port's model on ``device`` (the card
    unless ``device="cpu"``).  Every leaf must find its tensor and every
    tensor its leaf."""
    dev = _device.resolve(device)
    flat = _flatten(tree)
    model = registry.module_class(cfg)(cfg, device=dev)
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear):
            continue
        leaf = lambda k: _to_torch(_layer(_node(tree, f"{name}.{k}"),
                                          name)).to(dev)
        has = lambda k: ref_path(f"{name}.{k}") in flat
        if has("qw"):
            mod.set_quantized(leaf("qw"), leaf("scale"), leaf("zero"),
                              cfg.quant.spec())
        elif has("scale"):
            mod.set_fake_quant(leaf("scale"), leaf("zero"), cfg.quant.spec())
        if has("lora_a"):
            mod.set_lora(leaf("lora_a"), leaf("lora_b"))
    extra = sorted(set(flat) - {ref_path(n) for n, _ in _tensors(model)})
    if extra:
        raise KeyError(f"reference leaves the port's model has no tensor "
                       f"for: {extra}")
    return load_params(model, tree)


def to_tree(model: torch.nn.Module) -> dict:
    """The port's model → reference-layout nested dict of numpy arrays
    (layer leaves stacked, codes as uint32, floats as float32)."""
    return tensors_to_tree(_tensors(model))


def tensors_to_tree(named) -> dict:
    """``to_tree`` of (name, tensor) pairs: a model's tensors, or a whole
    model's put together from its shards."""
    groups = defaultdict(dict)
    for name, t in named:
        arr = t.detach().cpu()
        arr = arr.numpy().view(np.uint32) if arr.dtype == torch.int32 \
            else arr.to(torch.float32).numpy()
        groups[ref_path(name)][layer_index(name)] = arr
    return _nest({path: _stacked(groups, path) for path in groups})


def _stacked(groups: dict, path: str) -> np.ndarray:
    return stack_indexed(groups[path])


def _nest(flat: dict) -> dict:
    """{"/a/b": leaf} → {"a": {"b": leaf}}."""
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return tree


def opt_to_tree(model: torch.nn.Module, opt_state: dict) -> dict:
    """The port's masked-AdamW state → the reference's ``{"mv": tree,
    "count": int32}`` (moments stacked over layers, float32)."""
    return names_opt_tree([n for n, _ in _tensors(model)], opt_state)


def names_opt_tree(names, opt_state: dict) -> dict:
    """``opt_to_tree`` over a model's tensor ``names``."""
    moms, vels = defaultdict(dict), defaultdict(dict)
    for name in names:
        pair = opt_state["mv"].get(name)
        if pair is not None:
            path, i = ref_path(name), layer_index(name)
            moms[path][i], vels[path][i] = (
                t.detach().cpu().to(torch.float32).numpy() for t in pair)
    mv = {}
    for path in {ref_path(n) for n in names}:
        mv[path] = (_stacked(moms, path), _stacked(vels, path)) \
            if path in moms else ((), ())
    return {"mv": _nest(mv),
            "count": np.asarray(int(opt_state["count"]), np.int32)}


@torch.no_grad()
def opt_from_tree(model: torch.nn.Module, tree: dict, opt_state: dict,
                  cut=None) -> dict:
    """The reference's ``{"mv", "count"}`` → ``opt_state`` in place (its
    trainable names must be the tree's non-empty leaves); ``cut(name, t)``
    takes a rank's block of each whole moment (``load_state``)."""
    for name, pair in opt_state["mv"].items():
        src = _node(tree["mv"], name)
        if len(src) != 2 or isinstance(src[0], (tuple, list)):
            raise KeyError(f"reference optimizer state has no moments for "
                           f"{name}")
        for dst, arr in zip(pair, src):
            t = torch.from_numpy(np.array(_layer(arr, name)))
            dst.copy_(t if cut is None else cut(name, t))
    opt_state["count"] = torch.tensor(int(np.asarray(tree["count"])),
                                      dtype=torch.int32)
    return opt_state


@torch.no_grad()
def load_params(model: torch.nn.Module, tree: dict, cut=None
                ) -> torch.nn.Module:
    """Copy a reference parameter tree into ``model``'s tensors in place
    (the same storage modes: every tensor must find its leaf);
    ``cut(name, t)`` takes a rank's block of each whole leaf."""
    for name, t in _tensors(model):
        src = _to_torch(_layer(_node(tree, name), name))
        if cut is not None:
            src = cut(name, src)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: reference leaf {tuple(src.shape)} != "
                             f"module tensor {tuple(t.shape)}")
        t.copy_(src)
    return model


def state_to_tree(state: dict) -> dict:
    """The port's train state (``train.state.make_state``) → the
    reference's state tree of numpy arrays, as its checkpoints hold it."""
    return {"params": to_tree(state["params"]),
            "opt": opt_to_tree(state["params"], state["opt"]),
            "step": np.asarray(int(state["step"]), np.int32)}


def load_state(state: dict, tree: dict, cut=None) -> dict:
    """A reference state tree → the port's train state, in place;
    ``cut(name, t)``: a mesh rank's block of each whole tensor
    (``train.state.load_shard``)."""
    load_params(state["params"], tree["params"], cut)
    opt_from_tree(state["params"], tree["opt"], state["opt"], cut)
    state["step"] = int(np.asarray(tree["step"]))
    return state
