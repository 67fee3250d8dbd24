"""End-to-end driver on the port: pretrain, then PEQA instruction-tune a
llama3.2-family model with checkpoint / restart, watchdog, eval and
task-scale export (port of ``examples/instruction_tune.py``).

The default is a ~20M-parameter llama3.2-1b reduction (4 layers, d 384,
vocab 4096, float32); ``--full-100m`` selects the ~100M variant (same code
path, more patience).

  1. pretrain in ``full`` mode on a synthetic corpus; print the fp
     perplexities on its held-out tenth and on the instruction corpus's;
  2. RTN-quantize at ``--bits`` (8-point shrink search) and print the
     instruction perplexity — the quantization damage;
  3. PEQA-tune the scales on the instruction corpus, checkpointing every
     100 steps (keeping 2) and evaluating; a second run on the same
     ``--ckpt-dir`` resumes from the newest valid checkpoint;
  4. export the tuned scales to ``<scale-bank>/instruction-v1.npz``.

    PYTHONPATH=src python -m repro_torch.train.instruction_tune \
        [--full-100m] [--steps 300] [--ckpt-dir DIR] [--device cpu]

It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import copy
import math
import os
import tempfile

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import (OptimConfig, QuantConfig, TrainConfig,
                                      TuningConfig)
from repro_torch.core import policies
from repro_torch.core.scale_bank import ScaleBank, extract_scales
from repro_torch.data import pipeline, synthetic
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train import loop, step
from repro_torch.train.quickstart import code_buffers
from repro_torch.train.state import make_state

TASK = "instruction-v1"
RESUMED = "[train] resumed from checkpoint step "


def model_config(full_100m: bool = False):
    """The example's llama3.2-family reduction (float32)."""
    base = configs.get_config("llama3.2-1b")
    if full_100m:
        return base.replace(name="llama3.2-100m", n_layers=8, d_model=768,
                            n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
                            vocab_size=8192, dtype="float32")
    return base.replace(name="llama3.2-20m", n_layers=4, d_model=384,
                        n_heads=6, n_kv_heads=2, head_dim=64, d_ff=1024,
                        vocab_size=4096, dtype="float32")


def peqa_config(bits: int, full_100m: bool = False):
    """``model_config`` in PEQA at ``bits`` (RTN with an 8-point grid)."""
    return model_config(full_100m).replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=bits, n_grid=8))


def run(device=None, *, full_100m: bool = False, steps: int = 300,
        pretrain_steps: int = 300, bits: int = 3, ckpt_dir: str,
        scale_bank: str, n_pretrain_tokens: int = 400_000,
        n_instruction_tokens: int = 200_000, seq: int = 128, batch: int = 8,
        log=print) -> dict:
    """Steps 1–4; returns the four perplexities (``fp_ppl``,
    ``fp_instruction_ppl``, ``rtn_ppl``, ``tuned_ppl``), the trainable
    count, the optimizer-state bytes, whether the codes are bit-identical
    after tuning (to those the first tuning step read: a resumed run's come
    from its checkpoint), the exported scale bytes, whether the exported npz
    reloads equal to the model's scales, and the step the tuning resumed
    from (None for a fresh run)."""
    cfg = model_config(full_100m)
    toks = synthetic.corpus(cfg.vocab_size, n_pretrain_tokens, seed=0)
    pre_train, pre_val = synthetic.split(toks)
    # "instruction" corpus: a different seed → different successor structure
    itoks = synthetic.corpus(cfg.vocab_size, n_instruction_tokens, seed=42)
    ins_train, ins_val = synthetic.split(itoks)

    def ppl(a, model, val) -> float:
        return loop.eval_perplexity(model, step.build_eval_step(a, a.cfg),
                                    pipeline.eval_batches(val, batch, seq))

    # ------------------------------------------------------------ pretrain
    tcfg = TrainConfig(steps=pretrain_steps, batch_size=batch, seq_len=seq,
                       log_every=50, ckpt_every=10 ** 9,
                       optim=OptimConfig(lr=1e-3, warmup_steps=20))
    pcfg = cfg.replace(tuning=TuningConfig(mode="full"))
    papi = registry.build(pcfg, device=device)
    model, mask = policies.build(papi, 0)
    out = {"model": cfg.name, "params": sum(
        t.numel() for t in model.parameters())}
    log(f"[eg] model {cfg.name}: {out['params'] / 1e6:.1f}M params")
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(papi, pcfg, tcfg, mask, opt)
    data = pipeline.PackedLM(pre_train, batch, seq, seed=0)
    state, _ = loop.train(state, ts, data, tcfg, log=log)
    fp = state["params"]
    out["fp_ppl"] = ppl(papi, fp, pre_val)
    out["fp_instruction_ppl"] = ppl(papi, fp, ins_val)
    log(f"[eg] pretrained ppl={out['fp_ppl']:.3f} "
        f"(instruction-domain ppl={out['fp_instruction_ppl']:.3f})")

    # ------------------------------------------- PEQA instruction-tuning
    qcfg = peqa_config(bits, full_100m)
    qapi = registry.build(qcfg, device=device)
    qmodel, qmask = policies.prepare(copy.deepcopy(fp), qcfg,
                                     device=qapi.device)
    del state, fp
    out["rtn_ppl"] = ppl(qapi, qmodel, ins_val)
    log(f"[eg] RTN {bits}-bit instruction ppl={out['rtn_ppl']:.3f} "
        f"(quantization damage)")
    itcfg = TrainConfig(steps=steps, batch_size=batch, seq_len=seq,
                        log_every=50, ckpt_every=100, keep_ckpts=2,
                        optim=OptimConfig(lr=3e-3, warmup_steps=20))
    qopt = make_optimizer(itcfg.optim, itcfg.steps)
    qstate = make_state(qmodel, qopt.init(dict(qmodel.named_parameters()),
                                          qmask))
    out["trainable"] = policies.trainable_count(qmodel, qmask)
    out["state_bytes"] = qopt.state_bytes(qstate["opt"])
    log(f"[eg] trainable={out['trainable']:,} "
        f"opt_state={out['state_bytes']:,}B")
    qts = step.build_train_step(qapi, qcfg, itcfg, qmask, qopt)
    # the codes the first tuning step reads: the RTN codes, or a resumed
    # run's from its checkpoint
    codes_before = {}

    def tune_step(state, batch):
        if not codes_before:
            codes_before.update(code_buffers(state["params"]))
        return qts(state, batch)
    idata = pipeline.PackedLM(ins_train, batch, seq, seed=1)
    es = step.build_eval_step(qapi, qcfg)

    def eval_fn(params):
        ls = [float(es(params, b))
              for b in pipeline.eval_batches(ins_val, batch, seq)]
        return float(np.mean(ls))

    out["resumed_from"] = None

    def tune_log(msg: str) -> None:
        if msg.startswith(RESUMED):
            out["resumed_from"] = int(msg[len(RESUMED):])
        log(msg)

    qstate, hist = loop.train(qstate, tune_step, idata, itcfg,
                              ckpt_dir=ckpt_dir, eval_fn=eval_fn,
                              log=tune_log)
    tuned = qstate["params"]
    if not codes_before:                # resumed at the last step: no step
        codes_before.update(code_buffers(tuned))
    out["losses"] = [h["loss"] for h in hist]
    out["tuned_ppl"] = ppl(qapi, tuned, ins_val)
    log(f"[eg] PEQA-tuned instruction ppl={out['tuned_ppl']:.3f}")
    after = code_buffers(tuned)
    out["codes_frozen"] = after.keys() == codes_before.keys() and all(
        torch.equal(after[n], codes_before[n]) for n in after)
    log(f"[eg] integer backbone bit-identical after tuning: "
        f"{out['codes_frozen']}")

    # -------------------------------------------------- export task scales
    bank = ScaleBank(scale_bank)
    bank.add(TASK, tuned)
    out["scale_bytes"] = bank.nbytes(TASK)
    path = os.path.join(scale_bank, f"{TASK}.npz")
    log(f"[eg] exported task scales: {out['scale_bytes']:,} B → {path}")
    reloaded = ScaleBank(scale_bank).tasks[TASK]
    mine = extract_scales(tuned)
    out["export_reloads_equal"] = reloaded.keys() == mine.keys() and all(
        np.array_equal(reloaded[k], mine[k]) for k in mine)
    return out


def main() -> None:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tmp, "peqa_instruction_run"))
    ap.add_argument("--scale-bank",
                    default=os.path.join(tmp, "peqa_scale_bank"))
    args = ap.parse_args()
    out = run(args.device, full_100m=args.full_100m, steps=args.steps,
              pretrain_steps=args.pretrain_steps, bits=args.bits,
              ckpt_dir=args.ckpt_dir, scale_bank=args.scale_bank)
    if not (out["codes_frozen"] and out["export_reloads_equal"]
            and math.isfinite(out["tuned_ppl"])):
        raise SystemExit("instruction_tune: the PEQA claims did not hold")


if __name__ == "__main__":
    main()
