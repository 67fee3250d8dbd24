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

On a ``(data, model)`` mesh (``mesh=ctx``, the state the rank's shard)
every rank restores the WHOLE checkpoint and cuts its shard
(``train.state.load_shard``); at a save every rank takes part in gathering
the whole state over the model axis (``train.state.whole_tree``), rank
(0, 0) alone writes it in the reference's format, and every rank waits on
a barrier — so a checkpoint written on a mesh restores off it, and the
reverse.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch import bridge
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.train import state as state_mod


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


class _Saver:
    """A checkpoint of the train state: the state's own tree off a mesh;
    on one, the whole state gathered on every rank and written by rank
    (0, 0), every rank waiting until the tree is handed over."""

    def __init__(self, mgr: CheckpointManager, mesh):
        self.mgr, self.mesh = mgr, mesh
        self.writer = mesh is None or (mesh.data_rank == 0
                                       and mesh.model_rank == 0)

    def restore(self, state):
        # the state's tree is used for structure only
        restored, extra = self.mgr.restore(bridge.state_to_tree(state))
        if restored is None:
            return state, None
        if self.mesh is None:
            return bridge.load_state(state, restored), extra
        return state_mod.load_shard(state, restored, self.mesh), extra

    def save(self, step: int, state, final: bool = False) -> None:
        tree = bridge.state_to_tree(state) if self.mesh is None \
            else state_mod.whole_tree(state, self.mesh)
        if self.writer:
            self.mgr.save(step, tree)
            if final:
                self.mgr.wait()
        if self.mesh is not None:
            self.mesh.barrier()


def train(state, train_step, data, tcfg, *, ckpt_dir: Optional[str] = None,
          eval_fn: Optional[Callable] = None, log: Optional[Callable] = None,
          on_metrics: Optional[Callable] = None, mesh=None):
    """Run (or resume) training. Returns (final_state, history).

    ``state`` is ``train.state.make_state``'s (updated in place); a
    checkpoint holds ``bridge.state_to_tree(state)``, the reference's
    layout, and a restore loads it back into ``state``.  ``mesh``: the
    rank's ``MeshContext`` (``state`` its shard, ``train_step`` built on
    it), whose checkpoints hold the whole state."""
    log = log or (lambda msg: print(msg, flush=True))
    history = []
    saver = _Saver(CheckpointManager(ckpt_dir, keep=tcfg.keep_ckpts,
                                     async_save=True), mesh) \
        if ckpt_dir else None

    start_step = 0
    if saver is not None:
        state, extra = saver.restore(state)
        if extra is not None:
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
            if saver and (step + 1) % tcfg.ckpt_every == 0:
                saver.save(step + 1, state)
        if saver:
            saver.save(tcfg.steps, state, final=True)
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
