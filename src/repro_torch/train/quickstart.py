"""Quickstart on the port: PEQA's four steps (port of
``examples/quickstart.py``).

  1. build a small LM and "pretrain" it briefly in ``full`` mode (it stands
     in for the released fp16 checkpoint),
  2. RTN-quantize it — the PEQA decomposition (paper Eq. 1),
  3. fine-tune ONLY the quantization scales with masked AdamW, through the
     quantized matmul's analytic backward (paper Eq. 2),
  4. show what PEQA promises: a tiny trainable count, a tiny optimizer
     state, an integer backbone bit-identical after tuning, perplexity
     recovered.

    PYTHONPATH=src python -m repro_torch.train.quickstart [--device cpu]

It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import copy
import math

import torch

from repro_torch import configs
from repro_torch.configs.base import (OptimConfig, QuantConfig, TrainConfig,
                                      TuningConfig)
from repro_torch.core import policies
from repro_torch.data import pipeline, synthetic
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train import loop, step
from repro_torch.train.state import make_state


def code_buffers(model) -> dict:
    """A copy of every quantized linear's code words, by buffer name."""
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith(".qw")}


def run(device=None, fp_steps: int = 200, peqa_steps: int = 150,
        n_tokens: int = 80_000, log=print) -> dict:
    """Steps 1–4; returns what they showed (perplexities, counts, bytes,
    whether the codes are bit-identical)."""
    cfg = configs.paper_lm(n_layers=2, d_model=128, n_heads=4, d_ff=256,
                           vocab=256)
    api = registry.build(cfg, device=device)
    toks = synthetic.corpus(cfg.vocab_size, n_tokens, seed=0)
    train_toks, val_toks = synthetic.split(toks)
    data = pipeline.PackedLM(train_toks, 8, 64)
    quiet = lambda msg: None        # noqa: E731 — the loop's log line

    def ppl(a, model) -> float:
        return loop.eval_perplexity(model, step.build_eval_step(a, a.cfg),
                                    pipeline.eval_batches(val_toks, 8, 64))

    # --- 1. a small pre-trained LM ---------------------------------------
    tcfg = TrainConfig(steps=fp_steps, batch_size=8, seq_len=64,
                       log_every=50, ckpt_every=10 ** 9,
                       optim=OptimConfig(lr=2e-3))
    model, mask = policies.build(api, 0)
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(api, cfg, tcfg, mask, opt)
    state, _ = loop.train(state, ts, data, tcfg, log=quiet)
    out = {"fp_ppl": ppl(api, state["params"])}
    log(f"fp16-equivalent model ppl: {out['fp_ppl']:.3f}")

    # --- 2. PEQA decomposition: integer backbone + scales -----------------
    qcfg = cfg.replace(tuning=TuningConfig(mode="peqa"),
                       quant=QuantConfig(bits=2, n_grid=8))
    qapi = registry.build(qcfg, device=device)
    qmodel, qmask = policies.prepare(copy.deepcopy(state["params"]), qcfg,
                                     device=qapi.device)
    out["trainable"] = policies.trainable_count(qmodel, qmask)
    out["total"] = out["trainable"] + policies.frozen_count(qmodel, qmask)
    out["quantized_ppl"] = ppl(qapi, qmodel)
    log(f"quantized to 2-bit: ppl {out['quantized_ppl']:.3f} (damaged by "
        f"RTN)")
    log(f"trainable scales: {out['trainable']:,} of {out['total']:,} stored "
        f"values ({100 * out['trainable'] / out['total']:.2f}%)")
    codes_before = code_buffers(qmodel)

    # --- 3. fine-tune the scales only ------------------------------------
    qt = TrainConfig(steps=peqa_steps, batch_size=8, seq_len=64,
                     log_every=50, ckpt_every=10 ** 9,
                     optim=OptimConfig(lr=3e-3))
    qopt = make_optimizer(qt.optim, qt.steps)
    qstate = make_state(qmodel, qopt.init(dict(qmodel.named_parameters()),
                                          qmask))
    out["state_bytes"] = qopt.state_bytes(qstate["opt"])
    out["full_state_bytes"] = 2 * 4 * out["total"]
    log(f"optimizer state: {out['state_bytes']:,} bytes (vs "
        f"{out['full_state_bytes']:,} for full fine-tuning)")
    qts = step.build_train_step(qapi, qcfg, qt, qmask, qopt)
    qstate, hist = loop.train(qstate, qts, data, qt, log=quiet)
    out["losses"] = [h["loss"] for h in hist]

    # --- 4. the PEQA claims, verified -------------------------------------
    out["tuned_ppl"] = ppl(qapi, qstate["params"])
    log(f"PEQA-tuned 2-bit model ppl: {out['tuned_ppl']:.3f} (restored "
        f"toward fp)")
    after = code_buffers(qstate["params"])
    out["codes_frozen"] = after.keys() == codes_before.keys() and all(
        torch.equal(after[n], codes_before[n]) for n in after)
    log(f"integer backbone bit-identical after tuning: "
        f"{out['codes_frozen']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--fp-steps", type=int, default=200)
    ap.add_argument("--peqa-steps", type=int, default=150)
    args = ap.parse_args()
    out = run(args.device, args.fp_steps, args.peqa_steps)
    if not (out["codes_frozen"] and math.isfinite(out["tuned_ppl"])):
        raise SystemExit("quickstart: the PEQA claims did not hold")


if __name__ == "__main__":
    main()
