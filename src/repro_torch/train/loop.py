"""Training loop with checkpoint/restart, watchdog and metrics logging (port
of ``repro/train/loop.py``).

Fault-tolerance behavior (exercised in tests/test_torch_ckpt.py):
  * on start, restores the newest VALID checkpoint (torn writes skipped) and
    resumes with bit-identical batches (the pipeline is a pure function of
    step);
  * checkpoints every ``ckpt_every`` steps (async off the main thread);
  * a watchdog thread flags steps exceeding ``watchdog_timeout_s`` —
    straggler detection at node scale; here it aborts the process cleanly so
    the cluster launcher restarts from the last checkpoint.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager


class Watchdog:
    def __init__(self, timeout_s: float, on_hang: Optional[Callable] = None):
        self.timeout = timeout_s
        self.on_hang = on_hang or (lambda dt: print(f"[watchdog] step hung {dt:.1f}s"))
        self.slowest = 0.0
        self._deadline = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.05):
            d = self._deadline
            if d is not None and time.monotonic() > d:
                self.on_hang(time.monotonic() - (d - self.timeout))
                self._deadline = None

    def step_begin(self):
        self._t0 = time.monotonic()
        self._deadline = self._t0 + self.timeout

    def step_end(self):
        self._deadline = None
        self.slowest = max(self.slowest, time.monotonic() - self._t0)

    def close(self):
        self._stop.set()
        self._thread.join()


def train(state, train_step, data, tcfg, *, ckpt_dir: Optional[str] = None,
          eval_fn: Optional[Callable] = None, log: Optional[Callable] = None,
          on_metrics: Optional[Callable] = None):
    """Run (or resume) training. Returns (final_state, history).

    ``state`` is ``train.state.make_state``'s (updated in place); a
    checkpoint holds ``bridge.state_to_tree(state)``, the reference's
    layout, and a restore loads it back into ``state``."""
    log = log or (lambda msg: print(msg, flush=True))
    history = []
    mgr = CheckpointManager(ckpt_dir, keep=tcfg.keep_ckpts,
                            async_save=True) if ckpt_dir else None

    start_step = 0
    if mgr is not None:
        # the state's tree is used for structure only
        restored, extra = mgr.restore(bridge.state_to_tree(state))
        if restored is not None:
            state = bridge.load_state(state, restored)
            start_step = int(extra["step"])
            log(f"[train] resumed from checkpoint step {start_step}")

    wd = Watchdog(tcfg.watchdog_timeout_s)
    try:
        for step in range(start_step, tcfg.steps):
            batch = data.batch_at(step)
            wd.step_begin()
            state, metrics = train_step(state, batch)
            wd.step_end()
            if (step + 1) % tcfg.log_every == 0 or step == start_step:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                history.append(m)
                if on_metrics:
                    on_metrics(m)
                log(f"[train] step {step + 1}/{tcfg.steps} "
                    f"loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} "
                    f"lr={m['lr']:.2e}")
            if eval_fn and (step + 1) % tcfg.eval_every == 0:
                ev = eval_fn(state["params"])
                log(f"[train] step {step + 1} eval_loss={ev:.4f} "
                    f"ppl={math.exp(min(ev, 20)):.2f}")
            if mgr and (step + 1) % tcfg.ckpt_every == 0:
                mgr.save(step + 1, bridge.state_to_tree(state))
        if mgr:
            mgr.save(tcfg.steps, bridge.state_to_tree(state))
            mgr.wait()
    finally:
        wd.close()
    return state, history


def eval_perplexity(params, eval_step, batches) -> float:
    """exp of the mean loss of ``eval_step(params, batch)`` over
    ``batches`` (``params`` is the model)."""
    losses = []
    for b in batches:
        losses.append(float(eval_step(params, b)))
    return float(np.exp(np.mean(losses)))
