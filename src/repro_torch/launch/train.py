"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        [--tiny] --mode peqa --bits 4 --steps 200 --ckpt-dir /tmp/run1 \
        [--device cpu] [--mesh D,M]

Builds the arch (the reduced config with ``--tiny``) under the tuning
``--mode`` from seed ``--seed`` (``policies.build``: a quantizing arm is
built layer by layer), trains it on a seeded synthetic corpus with eval on
its held-out tenth, and checkpoints to ``--ckpt-dir``: a second run on the
same directory resumes from the newest valid checkpoint.  A vlm's or an
encdec's batches carry seeded image embeddings or encoder frames
(``data.pipeline.Prefixed``: the stubs of the frontends neither package
has).  It runs on the card unless ``--device cpu``.

``--mesh D,M`` trains on a (data, model) mesh of D×M ranks, which the
launcher spawns on ``--device`` (``dist/backend.py``'s rule: gloo on the
CPU; NCCL, a rank a card, where the machine has D×M cards; else every rank
on ``cuda:0`` under gloo).  Every rank builds the whole model from the
seed, keeps its shard (``train.state.shard_state``) and takes its rows of
each global batch, which comes from the same seed on every rank; rank 0
logs, and the checkpoints hold the whole state in the reference's format
(a run on a mesh resumes off it, and the reverse).  ``--mesh debug`` is
the reference's debug mesh, ``make_debug_mesh(2, max(n // 2, 1))``, over
n = 4 ranks: (2, 2).  ``--mesh pod`` and ``--mesh multipod`` (the
reference's TPU pod shapes, 256 and 512 devices) are refused.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch import configs
from repro_torch.configs.base import (OptimConfig, QuantConfig, TrainConfig,
                                      TuningConfig)
from repro_torch.core import policies
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train import loop as loop_mod
from repro_torch.train import step as step_mod
from repro_torch.train.state import make_state, shard_state

MESHES = ("none", "debug", "pod", "multipod")
# the ranks --mesh debug spawns (the reference's debug mesh over its
# devices: (2, n // 2))
DEBUG_RANKS = 4


def mesh_shape(text: str) -> Optional[tuple]:
    """``--mesh`` → (D, M), or None for ``none``; ``pod`` and ``multipod``
    are refused with their device counts."""
    if text == "none":
        return None
    if text == "debug":
        return 2, max(DEBUG_RANKS // 2, 1)
    if text in ("pod", "multipod"):
        shape, axes = mesh_mod.production_shape(multi_pod=text == "multipod")
        raise SystemExit(
            f"--mesh {text} is the reference's TPU {text} mesh {shape} "
            f"{axes}: {math.prod(shape)} devices; this launcher spawns its "
            f"ranks on one host (--mesh debug or --mesh D,M)")
    try:
        shape = tuple(int(x) for x in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit(f"--mesh takes {', '.join(MESHES)} or 'D,M' (two "
                         f"positive integers), got {text!r}")
    return shape


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mode", default="peqa", choices=list(policies.MODES))
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8"])
    ap.add_argument("--mesh", default="none",
                    help=f"{', '.join(MESHES)}, or 'D,M': a data×model mesh "
                         f"of D·M ranks spawned on --device")
    args = ap.parse_args(argv)
    args.mesh_shape = mesh_shape(args.mesh)
    return args


def model_config(args):
    cfg = configs.get_config(args.arch)
    if args.tiny:
        cfg = configs.make_tiny(cfg)
    return cfg.replace(
        tuning=TuningConfig(mode=args.mode),
        quant=QuantConfig(bits=args.bits, group_size=args.group_size))


def run(args, ctx=None, log=None):
    """Build, train and evaluate as ``args`` say, off the mesh or as the
    rank of ``ctx`` (its device the rank's); returns (state, history)."""
    log = log or (lambda msg: print(msg, flush=True))
    cfg = model_config(args)
    device = args.device if ctx is None else ctx.device
    api = registry.build(cfg, device=device)

    log(f"[launch] arch={cfg.name} mode={args.mode} bits={args.bits} "
        f"device={api.device}")
    model, mask = policies.build(api, args.seed)
    n_train = policies.trainable_count(model, mask)
    n_total = n_train + policies.frozen_count(model, mask)
    log(f"[launch] params={n_total:,} trainable={n_train:,} "
        f"({100 * n_train / n_total:.3f}%)")

    tcfg = TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        optim=OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          grad_compression=args.grad_compression))
    toks = synthetic.corpus(cfg.vocab_size, max(args.steps, 100) * args.batch
                            * args.seq // 4 + 50000, seed=args.seed)
    train_toks, val_toks = synthetic.split(toks)
    data = pipeline.Prefixed(pipeline.PackedLM(train_toks, args.batch,
                                               args.seq, seed=args.seed),
                             cfg, args.seed)

    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    if ctx is not None:
        state = shard_state(state, ctx, cfg)
        del model
        log(f"[launch] mesh {(ctx.data_size, ctx.model_size)}: a rank holds "
            f"{sum(p.numel() for p in state['params'].parameters()):,} "
            f"parameters")
    ts = step_mod.build_train_step(api, cfg, tcfg, mask, opt, mesh=ctx)
    es = step_mod.build_eval_step(api, cfg, mesh=ctx)

    def eval_fn(params):
        losses = [float(es(params, pipeline.with_prefix(b, cfg,
                                                         (args.seed, 1, i))))
                  for i, b in enumerate(pipeline.eval_batches(
                      val_toks, args.batch, args.seq))]
        return float(np.mean(losses)) if losses else float("nan")

    state, hist = loop_mod.train(state, ts, data, tcfg, log=log,
                                 ckpt_dir=args.ckpt_dir, eval_fn=eval_fn,
                                 mesh=ctx)
    final = hist[-1]["loss"] if hist else math.nan
    log(f"[launch] done; final loss={final:.4f}")
    return state, hist


def mesh_rank(rank: int, argv, out: str) -> None:
    """One rank of ``--mesh``: its context on its own device, then ``run``;
    rank 0 logs and writes the history to ``out``."""
    from repro_torch.dist import backend
    args = parse_args(argv)
    ctx = mesh_mod.make_debug_mesh(*args.mesh_shape)
    log = (lambda msg: print(msg, flush=True)) if rank == 0 \
        else (lambda msg: None)
    log(f"[launch] rank 0: {backend.summary()}")
    _, hist = run(args, ctx, log)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(hist, f)


def run_mesh(args, argv):
    """``--mesh``: refuse what the mesh does not train, then spawn the
    ranks on ``--device`` and wait for them; returns (None, rank 0's
    history)."""
    import tempfile

    from torch.multiprocessing import ProcessExitedException

    from repro_torch.dist import backend, context
    d, m = args.mesh_shape
    device = args.device or "cuda"
    try:
        registry.check_supported(model_config(args),
                                 mesh=context.coords(d, m), batch=args.batch)
    except NotImplementedError as e:
        raise SystemExit(f"[launch] {e}") from None
    print(f"[launch] mesh {(d, m)}: {backend.describe(device, d * m)}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="repro_train_") as tmp:
        out = os.path.join(tmp, "history.json")
        try:
            backend.spawn(mesh_rank, d * m, device, list(argv), out,
                          threads=1 if device == "cpu" else None)
        except ProcessExitedException as e:
            raise SystemExit(f"[launch] a mesh rank failed: {e}") from None
        with open(out) as f:
            return None, json.load(f)


def main(argv: Optional[Sequence[str]] = None):
    """Train as the flags say; returns (final state, logged history) — on a
    mesh (None, rank 0's history): the state lives in the ranks."""
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.mesh_shape is not None:
        return run_mesh(args, argv)
    return run(args)


if __name__ == "__main__":
    main()
