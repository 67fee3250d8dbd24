"""Training launcher (port of ``repro/launch/train.py``, one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        [--tiny] --mode peqa --bits 4 --steps 200 --ckpt-dir /tmp/run1 \
        [--device cpu]

Builds the arch (the reduced config with ``--tiny``) under the tuning
``--mode`` from seed ``--seed`` (``policies.build``: a quantizing arm is
built layer by layer), trains it on a seeded synthetic corpus with eval on
its held-out tenth, and checkpoints to ``--ckpt-dir``: a second run on the
same directory resumes from the newest valid checkpoint.  It runs on the
card unless ``--device cpu``.

Not ported: ``--mesh`` other than ``none`` (``debug``, ``pod`` and
``multipod`` are refused, and ``train/state.py::shard_state`` is not
ported: ROADMAP queue 6, item 9).
"""
from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch import configs
from repro_torch.configs.base import (OptimConfig, QuantConfig, TrainConfig,
                                      TuningConfig)
from repro_torch.core import policies
from repro_torch.data import pipeline, synthetic
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train import loop as loop_mod
from repro_torch.train import step as step_mod
from repro_torch.train.state import make_state

MESHES = ("none", "debug", "pod", "multipod")


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
    ap.add_argument("--mesh", default="none", choices=list(MESHES))
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise SystemExit(
            f"training on a device mesh (--mesh {args.mesh}) is not ported "
            f"yet (several GPUs: ROADMAP queue 6, item 9); use --mesh none")
    return args


def main(argv: Optional[Sequence[str]] = None):
    """Train as the flags say; returns (final state, logged history)."""
    args = parse_args(argv)
    cfg = configs.get_config(args.arch)
    if args.tiny:
        cfg = configs.make_tiny(cfg)
    cfg = cfg.replace(
        tuning=TuningConfig(mode=args.mode),
        quant=QuantConfig(bits=args.bits, group_size=args.group_size))
    api = registry.build(cfg, device=args.device)

    print(f"[launch] arch={cfg.name} mode={args.mode} bits={args.bits} "
          f"device={api.device}", flush=True)
    model, mask = policies.build(api, args.seed)
    n_train = policies.trainable_count(model, mask)
    n_total = n_train + policies.frozen_count(model, mask)
    print(f"[launch] params={n_total:,} trainable={n_train:,} "
          f"({100 * n_train / n_total:.3f}%)", flush=True)

    tcfg = TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        optim=OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          grad_compression=args.grad_compression))
    toks = synthetic.corpus(cfg.vocab_size, max(args.steps, 100) * args.batch
                            * args.seq // 4 + 50000, seed=args.seed)
    train_toks, val_toks = synthetic.split(toks)
    data = pipeline.PackedLM(train_toks, args.batch, args.seq, seed=args.seed)

    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step_mod.build_train_step(api, cfg, tcfg, mask, opt)
    es = step_mod.build_eval_step(api, cfg)

    def eval_fn(params):
        losses = [float(es(params, b)) for b in
                  pipeline.eval_batches(val_toks, args.batch, args.seq)]
        return float(np.mean(losses)) if losses else float("nan")

    state, hist = loop_mod.train(state, ts, data, tcfg,
                                 ckpt_dir=args.ckpt_dir, eval_fn=eval_fn)
    final = hist[-1]["loss"] if hist else math.nan
    print(f"[launch] done; final loss={final:.4f}", flush=True)
    return state, hist


if __name__ == "__main__":
    main()
