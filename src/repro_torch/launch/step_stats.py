"""What one rank's step computes, moves and sends, counted from its shard
(the port's stand-in for ``repro/launch/hlo_stats.py``).

The reference parses XLA's optimized HLO of a compiled step into three
per-device totals: dot FLOPs, HBM bytes and collective bytes by kind.  The
port compiles no HLO, so this module counts the same three from the
rank's shard on ``meta`` (``launch/dryrun.py``): shapes, never values.

  * ``dot_flops`` — 2·M·N·K over the rank's linears at the tokens each
    one sees (an expert stack at its capacity, whisper's encoder and
    cross K/V at the frames, zamba2's shared block once an application,
    the head at the positions it scores), plus attention's two products
    (QKᵀ and PV at the rank's heads, dense: every query against every
    key the cache holds).  A training step counts its forward, the
    recompute under remat "block" / "full", and a backward of two
    products a forward one.  Not counted: the recurrent scans (Mamba2's
    SSD, the mLSTM's chunked form, the sLSTM) and every elementwise op —
    the reference's count holds only XLA's dots too.
  * ``hbm_bytes`` — the rank's weights read once a pass (forward,
    recompute, backward), AdamW's traffic in training (the parameter,
    its gradient and two float32 moments read, the three written), the
    cache a prefill writes, and the cache a decode step reads whole and
    writes at one position.  Activations are not counted: the least a
    fused step moves.
  * ``collectives`` — every collective one step issues, by kind and axis
    with its bytes (the payload a rank contributes, as ``context``'s
    record counts it).  A training step's counts are
    ``train.step.model_axis_terms``' (``mesh_collectives``); a prefill's
    (``api.prefill`` under ``use_mesh``) and a decode step's
    (``Engine.decode_collectives``: its sampler and the data-axis gather
    of the tokens included) are counted here with the same terms.  The
    byte sizes are exact for the dense family; the other families take
    every sum of the forward and its recompute at the block's (tokens,
    d_model) width, save whisper's encoder sums (frames) and Mamba2's
    norm sums (one float32 a token).

The runtime counterpart of the collective counts is the record
``dist/context.py`` keeps of every call (``collective_stats``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.peqa import ref_path
from repro_torch.dist import sharding
from repro_torch.models import common, linear, moe
from repro_torch.train import step as step_mod


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_bytes(cfg: ModelConfig) -> int:
    return getattr(torch, cfg.dtype).itemsize


def tokens(cfg: ModelConfig, shape: ShapeConfig, data: int):
    """(rows, positions) one rank runs of ``shape``: the global batch over
    the data axis where it divides (else every row), and the sequence
    (one position for a decode step)."""
    b = shape.global_batch
    rows = b // data if b % data == 0 else b
    return rows, 1 if shape.kind == "decode" else shape.seq_len


def param_bytes(shard, mask: Mapping[str, bool]) -> Dict[str, int]:
    """The rank's parameter and code bytes by ``sharding.leaf_kind``
    (``sharded``, ``partial``, ``replicated``), and ``trained``: the
    masked ones."""
    share = sharding.shard_kv_share(shard)
    out = {sharding.SHARDED: 0, sharding.PARTIAL: 0,
           sharding.REPLICATED: 0, "trained": 0}
    for name, t in (*shard.named_parameters(), *shard.named_buffers()):
        out[sharding.leaf_kind(ref_path(name), t.dim(), share)] += \
            _nbytes(t)
        if mask.get(name):
            out["trained"] += _nbytes(t)
    return out


def moment_bytes(shard, mask: Mapping[str, bool]) -> int:
    """AdamW's two float32 moments of every trained parameter."""
    return sum(2 * 4 * p.numel() for n, p in shard.named_parameters()
               if mask.get(n))


def _linear_tokens(name: str, lin, cfg: ModelConfig, rows: int, seq: int,
                   kind: str) -> int:
    """The tokens that pass through the linear at ``name`` in one forward
    (an expert stack: each expert's capacity)."""
    t = rows * seq
    parts = name.split(".")
    if parts[0] == "lm_head":
        return t if kind == "train" else rows
    if lin.n_experts is not None:
        mc = cfg.moe
        return moe.capacity(t, mc.top_k, mc.n_experts, mc.capacity_factor)
    if parts[0] == "enc" or (len(parts) > 1 and parts[-2] == "xattn"
                             and parts[-1] in ("wk", "wv")):
        return 0 if kind == "decode" else rows * cfg.enc_frames
    if parts[0] == "shared":                   # zamba2's shared block
        return t * (cfg.n_layers // (cfg.attn_every or cfg.n_layers + 1))
    return t


def _attention_flops(cfg: ModelConfig, m: int, rows: int, seq: int,
                     shape: ShapeConfig) -> float:
    """QKᵀ and PV of one forward at the rank's heads (dense)."""
    h, dh = cfg.n_heads // m, cfg.d_head
    if shape.kind == "decode":
        keys = shape.seq_len if cfg.swa_window is None \
            else min(shape.seq_len, cfg.swa_window)
        q = 1
    else:
        keys = q = seq

    def prod(n_layers, sq, sk):
        return n_layers * 2 * (2.0 * rows * h * sq * sk * dh)
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "encdec":
        f = cfg.enc_frames
        enc = 0.0 if shape.kind == "decode" else prod(cfg.enc_layers, f, f)
        return enc + prod(cfg.n_layers, q, keys) + prod(cfg.n_layers, q, f)
    if cfg.family == "hybrid":
        return prod(cfg.n_layers // (cfg.attn_every or cfg.n_layers + 1),
                    q, keys)
    return prod(cfg.n_layers, q, keys)


def forward_flops(shard, cfg: ModelConfig, m: int, shape: ShapeConfig,
                  data: int) -> float:
    """Dot FLOPs of one forward of the rank's shard over ``shape``."""
    rows, seq = tokens(cfg, shape, data)
    total = 0.0
    for name, lin in shard.named_modules():
        if not isinstance(lin, linear.Linear):
            continue
        n_tok = _linear_tokens(name, lin, cfg, rows, seq, shape.kind)
        experts = lin.n_experts or 1
        total += 2.0 * experts * n_tok * lin.out_features * lin.in_features
        if lin.has_lora:
            r = lin.lora_a.shape[0]
            total += 2.0 * n_tok * r * (lin.lora_a.shape[-1]
                                        + lin.lora_b.shape[0])
    if cfg.tie_embeddings:                      # the head is the table's
        emb = next(mod.emb for mod in shard.modules()
                   if isinstance(mod, common.Embed))
        total += 2.0 * (rows * seq if shape.kind == "train" else rows) \
            * emb.shape[0] * emb.shape[1]
    return total + _attention_flops(cfg, m, rows, seq, shape)


def dot_flops(shard, cfg: ModelConfig, m: int, shape: ShapeConfig,
              data: int) -> float:
    """One step's dot FLOPs on the rank: a forward; in training also the
    recompute (remat "block" / "full") and a backward of twice the
    forward's products."""
    fwd = forward_flops(shard, cfg, m, shape, data)
    if shape.kind != "train":
        return fwd
    return fwd * (3 + (cfg.remat in ("block", "full")))


def cache_traffic(whole: Mapping, specs: Mapping, seq_dims: Mapping,
                  sizes: Mapping) -> tuple:
    """(bytes of the rank's cache, bytes a decode step writes in it) from
    the whole cache on ``meta``, each leaf's spec (``cache_specs``) and its
    sequence dim (−1: a state written whole)."""
    total = written = 0
    for k, v in whole.items():
        local = sharding.local_shape(v.shape, specs[k], sizes)
        n = 1
        for e in local:
            n *= e
        b = n * v.element_size()
        total += b
        sd = seq_dims[k]
        written += b if sd < 0 else b // local[sd]
    return total, written


def hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, weights: int,
              trained: int, moments: int, cache: int = 0,
              cache_written: int = 0) -> int:
    """One step's HBM traffic on the rank (module docstring)."""
    if shape.kind == "train":
        reads = 2 + (cfg.remat in ("block", "full"))
        return weights * reads + 3 * trained + 2 * moments
    if shape.kind == "prefill":
        return weights + cache
    return weights + cache + cache_written


def _entry(kind: str, axis: str, count: int, nbytes: int) -> dict:
    return {"kind": kind, "axis": axis, "count": int(count),
            "bytes": int(count) * int(nbytes)}


def _forward_sums(cfg: ModelConfig, forward: int, rows: int, seq: int,
                  red: int, act: int, encoder: bool) -> List[dict]:
    """The forward's model-axis sums: the lookup (activation dtype), the
    row-parallel sums (``red`` bytes a value), whisper's encoder sums at
    its frames, Mamba2's norm sums at one float32 a token."""
    d, t = cfg.d_model, rows * seq
    out = [_entry("all_reduce", "model", 1, t * d * act)]
    sums = forward - 1
    if cfg.family == "encdec":
        enc = 2 * cfg.enc_layers
        sums -= enc
        if encoder:
            out.append(_entry("all_reduce", "model", enc,
                              rows * cfg.enc_frames * d * red))
    if cfg.family == "hybrid":
        out.append(_entry("all_reduce", "model", cfg.n_layers, t * 4))
        sums -= cfg.n_layers
    out.append(_entry("all_reduce", "model", sums, t * d * red))
    return out


def collectives(shard, cfg: ModelConfig, mask: Mapping[str, bool],
                shape: ShapeConfig, data: int, model: int,
                logitshard: bool = False) -> List[dict]:
    """One step's collectives on the rank: ``{kind, axis, count,
    bytes}`` entries (module docstring)."""
    rows, seq = tokens(cfg, shape, data)
    act = _dtype_bytes(cfg)
    red = act if cfg.bf16_reduce else 4
    terms = step_mod.model_axis_terms(shard, cfg, mask)
    out = _forward_sums(cfg, terms["forward"], rows, seq, red, act,
                        encoder=shape.kind != "decode")
    t, d = rows * seq, cfg.d_model
    if shape.kind == "train":
        trained = [p for n, p in shard.named_parameters() if mask.get(n)]
        kinds = sharding.leaf_kinds(shard)
        partial = sum(p.numel() for n, p in shard.named_parameters()
                      if mask.get(n) and kinds[n] == sharding.PARTIAL)
        out += [_entry("all_reduce", "model", terms["recompute"],
                       t * d * red),
                _entry("all_reduce", "model", terms["backward"],
                       t * d * act),
                _entry("all_reduce", "model", terms["cross_entropy"], t * 4),
                _entry("all_reduce", "model", terms["partial"],
                       partial * 4),
                _entry("all_reduce", "model", terms["norm"], 4),
                _entry("all_reduce", "data", 2, 4),
                _entry("all_reduce", "data", 1,
                       4 * sum(p.numel() for p in trained))]
        return [e for e in out if e["count"]]
    v = cfg.vocab_size
    if shape.kind == "decode" and logitshard:
        out += [_entry("all_reduce", "model", 1, rows * 4),
                _entry("all_reduce", "model", 1, rows * 8)]
    else:
        out.append(_entry("all_gather", "model", 1, rows * (v // model) * 4))
    if shape.kind == "decode":
        out.append(_entry("all_gather", "data", 1, rows * 8))
    return [e for e in out if e["count"]]


def collective_stats(entries: List[dict]) -> dict:
    """{kind: {"count", "bytes"}} and ``total_bytes`` of ``collectives``'
    entries (the shape of ``context.collective_stats`` and the
    reference's ``hlo_stats.collective_stats``), and ``by_axis``."""
    out: dict = {}
    axis: dict = {}
    for e in entries:
        s = out.setdefault(e["kind"], {"count": 0, "bytes": 0})
        s["count"] += e["count"]
        s["bytes"] += e["bytes"]
        a = axis.setdefault(e["axis"], {"count": 0, "bytes": 0})
        a["count"] += e["count"]
        a["bytes"] += e["bytes"]
    out["by_axis"] = axis
    out["total_bytes"] = sum(e["bytes"] for e in entries)
    return out
