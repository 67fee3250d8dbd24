"""Multi-task serving from ONE quantized backbone on the port (port of
``examples/serve_multitask.py``; paper §3.3).

Two PEQA "tasks" (scale sets) are tuned on different corpora, stored in a
``ScaleBank`` and served from a single integer backbone with scale hot
swaps — the Table 1 "fast task switching + fast inference" cell.  The
tasks must give different continuations of the same prompt.

    PYTHONPATH=src python -m repro_torch.train.serve_multitask [--device cpu]

It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.configs.base import QuantConfig, TuningConfig
from repro_torch.core import policies
from repro_torch.core.scale_bank import ScaleBank
from repro_torch.launch.serve import tune_tasks
from repro_torch.models import registry
from repro_torch.train.serve import Engine

# each task's corpus: its seed, a different bigram structure
TASKS = (("taskA", 0), ("taskB", 99))


def model_config():
    """The example's ``paper_lm`` (2 layers, d 128, 4 heads, float32) in
    PEQA at 4 bits on a 4-point grid."""
    return configs.paper_lm(n_layers=2, d_model=128, n_heads=4, d_ff=256,
                            vocab=256).replace(
        tuning=TuningConfig(mode="peqa"), quant=QuantConfig(bits=4, n_grid=4))


def run(device=None, steps: int = 120, n_tokens: int = 60_000,
        log=print) -> dict:
    """Tune the two tasks, serve taskA, taskB, taskA from one engine;
    returns each switch's seconds and continuation, each task's scale
    bytes, and whether the tasks' continuations differ."""
    cfg = model_config()
    api = registry.build(cfg, device=device)
    backbone, mask = policies.build(api, 0)
    bank = ScaleBank()
    # ``steps`` PEQA steps of 8 × 64 a task at lr 3e-3 (10 warm-up), the
    # corpus seed also ordering its batches; the backbone's own scales are
    # restored after each task
    log("[serve] tuning taskA and taskB scales…")
    tune_tasks(api, backbone, mask, [task for task, _ in TASKS], steps, bank,
               log=log, seeds=[(seed, seed) for _, seed in TASKS],
               n_tokens=n_tokens, warmup=10)
    out = {"scale_bytes": {task: bank.nbytes(task) for task, _ in TASKS},
           "switches": []}

    # ---- serve both tasks from one engine --------------------------------
    engine = Engine(api, backbone, bank=bank, device=device)
    prompt = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    conts = {}
    for task in ("taskA", "taskB", "taskA"):
        dt = engine.switch_task(task)
        gen = engine.generate(prompt, n_new=12)[:, 8:].cpu().numpy()
        conts.setdefault(task, gen)
        out["switches"].append({"task": task, "switch_s": dt,
                                "generated": gen[0].tolist()})
        log(f"[serve] {task}: switch={dt * 1e3:.2f}ms "
            f"generated={gen[0]}")
    # per-task outputs must differ (different scales steer the same backbone)
    out["tasks_differ"] = not np.array_equal(conts["taskA"], conts["taskB"])
    log(f"[serve] tasks produce different continuations: "
        f"{out['tasks_differ']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()
    if not run(args.device, args.steps)["tasks_differ"]:
        raise SystemExit("serve_multitask: the tasks gave the same "
                         "continuation")


if __name__ == "__main__":
    main()
