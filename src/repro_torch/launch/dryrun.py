"""Dry run: every (architecture × input shape) cut for the production
meshes on ``meta`` tensors, and what one rank holds, computes and sends
(port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k [--multi-pod | --both-meshes] [--all] \
        [--tuning peqa|full|lora|lora_optq|qat|peqa_z|all] [--out dir]

The reference lowers and compiles each cell with XLA on 256 or 512 host
devices and reads the compiled program's memory, FLOPs and collectives.
The port has no compiler to ask, so it builds the whole model on ``meta``
(``policies.transform``, the reference's ``jax.eval_shape``: shapes and
dtypes, no value drawn or read, nothing allocated — mixtral-8x7b whole is
187 GB of float32), cuts model rank 0's shard with ``shard_model`` and
counts (``launch/step_stats.py``, the stand-in for ``hlo_stats``):

  * parameter bytes by leaf kind (sharded, partial, replicated), AdamW's
    moment bytes for the trained leaves (train), the cache's bytes at the
    shape's batch over the data axis (prefill and decode,
    ``sharding.cache_specs``);
  * dot FLOPs, HBM bytes, and the collectives of one step by kind and
    axis, with their bytes.

What the port does not serve or train on a mesh is recorded, not raised:
``refusals`` (``registry.check_supported``: ``shard_problems`` and the
family's refusals) and ``sharding_problems`` (``validate_for_mesh`` of the
whole tree).  A refused cell has ``ok: false`` and no counts.

The meshes are ``launch/mesh.py::production_shape``'s: (16, 16), and the
multi-pod (2, 16, 16) taken as data 32 × model 16 (the port's mesh is
2-D).  ``--all`` runs every cell on both; ``--tuning all`` every tuning
mode.  Records are JSON, one a cell under ``--out``, and a run resumes
past the cells it finds there; ``launch/roofline.py`` reads them.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback
from typing import Optional, Sequence

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.dist import context, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import step_stats
from repro_torch.models import registry
from repro_torch.train.serve import cache_dims, cache_model_dims


def apply_variant(cfg, variant: str):
    """'+'-joined levers of the reference's dry run that change a count
    here: bf16r (bf16 row-parallel sums), kv8 (the int8 KV cache),
    padheads (n_heads padded to a multiple of 16), logitshard (decode
    logits kept vocab-sharded: the sampler's collectives, not the
    gather)."""
    for tok in [t for t in variant.split("+") if t]:
        if tok == "bf16r":
            cfg = cfg.replace(bf16_reduce=True)
        elif tok == "kv8":
            cfg = cfg.replace(kv_cache_dtype="int8")
        elif tok == "padheads":
            padded = -(-cfg.n_heads // 16) * 16
            cfg = cfg.replace(n_heads=padded, head_dim=cfg.d_head)
        elif tok != "logitshard":
            raise ValueError(f"unknown variant token {tok!r}")
    return cfg


def mesh_shape(multi_pod: bool = False) -> tuple:
    """(data, model) of a production mesh: the reference's (16, 16), or
    its (2, 16, 16) with the pod axis folded into data."""
    shape, _ = mesh_mod.production_shape(multi_pod=multi_pod)
    return (shape[0] * shape[1], shape[2]) if multi_pod else shape


def cell_config(arch: str, tuning_mode: str = "peqa", remat: str = "block",
                variant: str = ""):
    cfg = configs.get_config(arch).replace(
        tuning=TuningConfig(mode=tuning_mode), remat=remat)
    return apply_variant(cfg, variant)


@functools.lru_cache(maxsize=8)
def meta_model(cfg):
    """(whole policy model on ``meta``, trainable mask) of ``cfg``."""
    model = registry.module_class(cfg)(cfg, device="meta")
    model = policies.transform(model, cfg, device="meta")
    return model, policies.make_mask(model, cfg)


@functools.lru_cache(maxsize=8)
def meta_shard(cfg, data: int, model: int):
    """Model rank 0's shard of ``meta_model(cfg)`` on a (data, model)
    mesh."""
    return sharding.shard_model(meta_model(cfg)[0], cfg,
                                context.coords(data, model))


def refusals(cfg, shape: ShapeConfig, data: int, model: int) -> list:
    """Why the port does not run ``shape`` of ``cfg`` on the mesh (empty:
    it does)."""
    train = shape.kind == "train"
    try:
        registry.check_supported(
            cfg, mesh=context.coords(data, model), train=train,
            batch=shape.global_batch if train else None)
    except NotImplementedError as e:
        return [str(e)]
    return []


def _cache(cfg, shape: ShapeConfig, data: int, model: int, share: int):
    """(the rank's cache bytes, the bytes a decode step writes) at the
    shape's global batch and length."""
    api = registry.build(cfg, device="cpu")
    local = registry.build(sharding.shard_config(cfg, model), device="cpu")
    b, s = shape.global_batch, shape.seq_len
    ctx = context.coords(data, model)
    whole = api.init_cache(b, s, device="meta")
    bdims, sdims = cache_dims(api.init_cache, 2, 8)
    specs = sharding.cache_specs(
        ctx, whole, b, ctx.batch_axes(b) is not None,
        n_kv_heads=cfg.n_kv_heads, batch_dims=bdims, kv_share=share,
        model_dims=cache_model_dims(api.init_cache, local.init_cache))
    return step_stats.cache_traffic(whole, specs, sdims, ctx.axis_sizes)


def cell_record(cfg, shape: ShapeConfig, data: int, model: int,
                logitshard: bool = False) -> dict:
    """What model rank 0 of a (data, model) mesh holds, computes and
    sends in one step of ``shape`` under ``cfg`` (the module docstring);
    a refused cell: ``ok`` False and its ``refusals``."""
    whole, mask = meta_model(cfg)
    record = {}
    problems = sharding.validate_for_mesh(whole, {"data": data,
                                                  "model": model})
    if problems:
        record["sharding_problems"] = problems[:20]
    refused = refusals(cfg, shape, data, model)
    if refused:
        return {**record, "ok": False, "refusals": refused}
    shard = meta_shard(cfg, data, model)
    params = step_stats.param_bytes(shard, mask)
    weights = sum(params[k] for k in (sharding.SHARDED, sharding.PARTIAL,
                                      sharding.REPLICATED))
    moments = step_stats.moment_bytes(shard, mask) \
        if shape.kind == "train" else 0
    cache = written = 0
    if shape.kind != "train":
        cache, written = _cache(cfg, shape, data, model, shard.kv_share)
        written = written if shape.kind == "decode" else 0
    entries = step_stats.collectives(shard, cfg, mask, shape, data, model,
                                     logitshard=logitshard)
    return {**record, "ok": True, "kv_share": shard.kv_share,
            "param_bytes": params, "moment_bytes": moments,
            "cache_bytes": cache, "cache_written_bytes": written,
            "dot_flops": step_stats.dot_flops(shard, cfg, model, shape,
                                              data),
            "hbm_bytes": step_stats.hbm_bytes(cfg, shape, weights,
                                              params["trained"], moments,
                                              cache, written),
            "memory": {"argument_bytes": weights + moments + cache},
            "collectives": {**step_stats.collective_stats(entries),
                            "entries": entries}}


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                tuning_mode: str = "peqa", remat: str = "block",
                variant: str = "") -> dict:
    """Cut and count one cell on a production mesh; returns its
    record."""
    t0 = time.perf_counter()
    shape = configs.SHAPES_BY_NAME[shape_name]
    cfg = cell_config(arch, tuning_mode, remat, variant)
    data, model = mesh_shape(multi_pod)
    record = {"arch": arch, "shape": shape_name, "kind": shape.kind,
              "multi_pod": multi_pod, "mesh": [data, model],
              "devices": data * model, "variant": variant,
              "tuning": tuning_mode, "remat": remat}
    record.update(cell_record(cfg, shape, data, model,
                              logitshard="logitshard" in variant))
    record["cut_s"] = time.perf_counter() - t0
    return record


def cell_key(arch: str, shape: str, multi_pod: bool, tuning: str,
             variant: str = "") -> str:
    tagp = f"-{variant.replace('+', '_')}" if variant else ""
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}__{tuning}" \
        + tagp


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every arch × shape on both production meshes")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tuning", default="peqa",
                    choices=[*policies.MODES, "all"])
    ap.add_argument("--remat", default="block")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--variant", default="",
                    help="'+'-joined: bf16r, kv8, padheads, logitshard")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")
    return args


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the cells the flags name; returns their records (a cached cell
    read back from ``--out``)."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    cells = configs.all_cells() if args.all else [
        (args.arch, configs.SHAPES_BY_NAME[args.shape])]
    meshes = [False, True] if args.all or args.both_meshes \
        else [args.multi_pod]
    modes = policies.MODES if args.tuning == "all" else (args.tuning,)
    records = []
    for mode in modes:
        for arch, shape in cells:
            for mp in meshes:
                key = cell_key(arch, shape.name, mp, mode, args.variant)
                path = os.path.join(args.out, key + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        records.append(json.load(f))
                    print(f"[dryrun] {key}: cached")
                    continue
                try:
                    rec = dryrun_cell(arch, shape.name, multi_pod=mp,
                                      tuning_mode=mode, remat=args.remat,
                                      variant=args.variant)
                except Exception as e:  # noqa: BLE001 — record, go on
                    rec = {"arch": arch, "shape": shape.name,
                           "multi_pod": mp, "tuning": mode, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
                if rec.get("ok"):
                    print(f"[dryrun] {key}: ok  "
                          f"flops={rec['dot_flops']:.3g} "
                          f"hbm={rec['hbm_bytes']:.3g}B "
                          f"coll={rec['collectives']['total_bytes']:.3g}B",
                          flush=True)
                else:
                    why = rec.get("error") or "; ".join(rec["refusals"])
                    print(f"[dryrun] {key}: refused: {why[:160]}",
                          flush=True)
    return records


if __name__ == "__main__":
    main()
