"""Batched decode engine and PEQA multi-task serving (port of
``repro/train/serve.py::Engine``, off-mesh).

One quantized integer backbone, per-task scales from a ``ScaleBank``:

  * ``generate`` — the lockstep baseline: one batch, one prefill, then one
    decode step per token until the LAST sequence finishes.
  * continuous batching — a slot pool (``open_pool``): the cache batch dim
    is a fixed pool of slots, each with its own position, activity bit and
    task row.  ``admit`` prefills one prompt (right-padded to a power-of-two
    bucket) and writes its KV rows into a free slot; ``step`` decodes every
    slot at its own position; finished sequences are evicted at once, so
    their slot is refilled on the next step.  ``serve`` is the scheduler:
    arrival-ordered admission on a virtual clock, a bounded wait queue,
    shedding, EOS/budget eviction, the tiered bank's prefetch, and one of
    two mixed-task policies — ``drain`` (one live scale set: a request for
    another task waits until the pool drains, then the scales are copied
    in) or ``resident`` (up to ``resident_tasks`` tasks' scales stay on the
    device stacked (T, N, G); every quantized linear reads each row's task
    in the kernel — K5 for decode, K2 per task for the prefill — so
    admission never waits on a task).

Not ported: the mesh arguments (``ctx``, ``logitshard``), the deprecated
keyword form of ``serve`` (it takes a ``ServeConfig``), and
``scheduler="speculative"``, which needs the bit-plane slice.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.core.scale_bank import ResidentStack, ScaleBank
from repro_torch.dist import sampling
from repro_torch.models.attention import CACHE_BATCH_DIM, CACHE_SEQ_DIM
from repro_torch.models.registry import ModelAPI
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.metrics import (REJECTED, SERVED, SHED, RequestMetrics,
                                       ServeReport)
from repro_torch.serve.request import Request

__all__ = ["Engine", "Request", "RequestMetrics", "ServeConfig",
           "ServeReport", "SlotPool"]


class SlotPool:
    """A fixed pool of ``n_slots`` sequence slots.

    Device state: the cache (batch dim = slot dim).  Host mirrors, one value
    per slot — the scheduler state: ``pos`` (next absolute position =
    tokens written so far), ``active``, ``tok`` (last sampled token, the
    next decode input), ``tid`` (resident-stack row) and per-slot metadata.
    """

    def __init__(self, engine: "Engine", n_slots: int, cache_len: int):
        if n_slots < 1 or cache_len < 1:
            raise ValueError(f"need n_slots >= 1 and cache_len >= 1, got "
                             f"({n_slots}, {cache_len})")
        if engine.api.caps is None:
            raise NotImplementedError(
                f"continuous batching needs a family capability record "
                f"(ModelAPI.caps) describing the decode-state protocol; "
                f"family {engine.api.cfg.family!r} does not provide one")
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.cache = engine.api.init_cache(n_slots, cache_len)
        self.pos = np.zeros((n_slots,), np.int64)
        self.active = np.zeros((n_slots,), bool)
        self.tok = np.zeros((n_slots,), np.int64)
        self.tid = np.zeros((n_slots,), np.int32)   # resident-stack row
        self.slotted = False           # decode through the stacked-scale step
        self.meta: List[Optional[dict]] = [None] * n_slots
        self.task: List[Optional[str]] = [None] * n_slots
        # distinct prefill shapes admitted (what bucketing bounds)
        self._prefill_keys: set = set()
        # device copies of (tok, pos, active, tid) between scheduling
        # events: a step with no admit/evict reuses the previous step's
        # outputs instead of uploading the host mirrors again
        self._dev = None
        self.steps = 0                 # pool steps (idle clock jumps too)
        self.decoded = 0               # useful tokens decoded
        self.bubble_slot_steps = 0     # slot-steps spent on FINISHED seqs
        self.idle_slot_steps = 0       # inactive slot-steps while work waited
        # subset of idle_slot_steps: slots empty ONLY because an admissible
        # request targets a task the scheduler cannot co-run
        self.task_drain_idle_slot_steps = 0

    def free_slot(self) -> Optional[int]:
        idx = np.flatnonzero(~self.active)
        return int(idx[0]) if idx.size else None

    def n_active(self) -> int:
        return int(self.active.sum())


class Engine:
    def __init__(self, api: ModelAPI, model: nn.Module,
                 bank: Optional[ScaleBank] = None, *, device=None):
        """Serve ``model`` on ``device`` (the card unless ``device="cpu"``);
        the model is moved there if it is elsewhere.  ``bank`` holds the
        task scale sets ``switch_task`` and ``serve`` draw on."""
        self.device = _device.resolve(device)
        if self.device != api.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"model API's {api.device}")
        self.api = api
        self.model = model.to(self.device)
        self.bank = bank
        self.current_task: Optional[str] = None
        # device-resident stacked scales for the resident scheduler; built
        # lazily by serve(scheduler="resident"/"auto")
        self.resident: Optional[ResidentStack] = None

    @staticmethod
    def _bucket_len(s: int, cap: int) -> int:
        """Smallest power of two >= s, clamped to the pool capacity."""
        return min(1 << (s - 1).bit_length(), cap)

    # ------------------------------------------------------------- task swap
    def switch_task(self, name: str) -> float:
        """Copy task ``name``'s scales into the live model; returns the wall
        seconds of the swap (on the card, until the copies have landed)."""
        if self.bank is None:
            raise ValueError("no ScaleBank attached")
        t0 = time.perf_counter()
        self.bank.switch(self.model, name)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.current_task = name
        return time.perf_counter() - t0

    # ------------------------------------------------------------- generate
    @torch.inference_mode()
    def generate(self, tokens, n_new: int,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        """Greedy decode (LOCKSTEP). tokens (B, S) → (B, S + n_new) int64.

        ``cache_len`` is validated, not clamped: the deepest cache write is
        position prompt+n_new-2 (the final sampled token's KV is never
        written), so prompt+n_new-1 slots suffice and fewer raise.
        """
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        b, s = tokens.shape
        total = s + n_new
        if cache_len is None:
            cache_len = total
        elif cache_len <= 0:
            raise ValueError(
                f"cache_len={cache_len} must be positive (omit it for the "
                f"default prompt+n_new={total})")
        elif cache_len < total - 1:
            raise ValueError(
                f"cache_len={cache_len} < prompt+n_new-1={total - 1}: a "
                f"dense cache cannot hold the generation")
        sample = sampling.shard_argmax(None, b)
        logits, pcache = self.api.prefill(self.model, {"tokens": tokens})
        # re-home the prompt-sized prefill cache into one with headroom
        cache = self.api.init_cache(b, cache_len)
        for key in cache:
            cache[key][:, :, :s] = pcache[key]
        del pcache
        out = [tokens]
        tok = sample(logits)[:, None]
        for i in range(n_new):
            out.append(tok)
            if i == n_new - 1:
                break
            logits, cache = self.api.decode_step(self.model, cache, tok, s + i)
            tok = sample(logits)[:, None]
        return torch.cat(out, dim=1)

    # ------------------------------------------------- continuous batching
    def open_pool(self, n_slots: int, cache_len: int) -> SlotPool:
        """Allocate the slot pool."""
        return SlotPool(self, n_slots, cache_len)

    @staticmethod
    def _admit_write(pool: SlotPool, pcache: dict, slot: int) -> None:
        """Place a batch-1 prefill cache into slot ``slot`` of the pool, in
        place, along the cache's batch and position dims."""
        for key, dst in pool.cache.items():
            src = pcache[key]
            dst.narrow(CACHE_BATCH_DIM, slot, 1).narrow(
                CACHE_SEQ_DIM, 0, src.shape[CACHE_SEQ_DIM]).copy_(src)

    @staticmethod
    def _check_admit_shapes(pool: SlotPool, pcache: dict) -> None:
        """The prefill cache must be batch-1, fit the pool capacity, and
        differ from the pool only on the batch and position dims."""
        bd, sd = CACHE_BATCH_DIM, CACHE_SEQ_DIM
        for key, dst in pool.cache.items():
            src = pcache[key]
            if src.shape[bd] != 1:
                raise ValueError(f"admit needs a batch-1 prefill cache, got "
                                 f"batch {src.shape[bd]} in {tuple(src.shape)}")
            if src.shape[sd] > dst.shape[sd]:
                raise ValueError(
                    f"prompt cache seq extent {src.shape[sd]} exceeds the "
                    f"pool capacity {dst.shape[sd]}")
            for d in range(dst.dim()):
                if d not in (bd, sd) and dst.shape[d] != src.shape[d]:
                    raise ValueError(
                        f"cache leaf {tuple(src.shape)} does not fit pool "
                        f"leaf {tuple(dst.shape)}: dim {d} differs (only "
                        f"batch dim {bd} and seq dim {sd} may)")

    def _check_task_rows(self, rows) -> None:
        """Host-side validation of resident-stack rows before they reach
        the device (the kernel only clamps them)."""
        rows = np.asarray(rows)
        cap = self.resident.capacity if self.resident is not None else 0
        if rows.size and (rows.min() < 0 or rows.max() >= cap):
            raise ValueError(f"task rows {rows.tolist()} outside the "
                             f"resident stack of {cap} rows")

    @torch.no_grad()
    def admit(self, pool: SlotPool, request: Request,
              rid: Optional[int] = None,
              task_row: Optional[int] = None,
              bucket: bool = True) -> int:
        """Prefill ``request`` and install it into a free slot.  Returns the
        slot index.  The first generated token is sampled here, from the
        prefill logits, as the lockstep path does.

        task_row: resident-stack row holding this request's scales — the
        prefill reads them through ``prefill_slotted`` and never consults
        the live scales.  ``None`` = prefill with the live scales.

        bucket: right-pad the prompt to a power-of-two length so mixed
        traffic runs O(log max_len) prefill shapes; the padded rows are
        causally invisible and the head reads the last real row
        (``last_pos``), so token streams are unchanged.
        """
        slot = pool.free_slot()
        if slot is None:
            raise RuntimeError("admit: no free slot (evict first)")
        toks = np.asarray(request.tokens, np.int64).reshape(-1)
        s = int(toks.shape[0])
        n_new = int(request.n_new)
        if s < 1 or n_new < 1:
            raise ValueError(f"need prompt >= 1 and n_new >= 1 tokens, got "
                             f"({s}, {n_new})")
        if s + n_new - 1 > pool.cache_len:
            raise ValueError(
                f"request needs {s + n_new - 1} cache slots, pool has "
                f"{pool.cache_len}")
        if (task_row is None and request.task is not None
                and self.bank is not None
                and request.task != self.current_task):
            raise ValueError(
                f"request targets task {request.task!r} but the engine "
                f"serves {self.current_task!r}; switch_task first (the "
                f"scheduler drains the pool before switching)")
        bucket = bucket and self.api.caps.bucketable
        s_pad = self._bucket_len(s, pool.cache_len) if bucket else s
        if s_pad != s:
            toks = np.pad(toks, (0, s_pad - s))   # masked filler rows
        batch = {"tokens": torch.as_tensor(toks, device=self.device)[None]}
        if s_pad != s:
            batch["last_pos"] = s - 1
        pool._prefill_keys.add((s_pad, s_pad != s))
        if task_row is not None:
            self._check_task_rows([task_row])
            tid = torch.full((1,), task_row, dtype=torch.int32,
                             device=self.device)
            logits, pcache = self.api.prefill_slotted(
                self.model, self.resident.stack, batch, tid)
        else:
            logits, pcache = self.api.prefill(self.model, batch)
        self._check_admit_shapes(pool, pcache)
        t0 = int(sampling.shard_argmax(None, 1)(logits)[0])
        self._admit_write(pool, pcache, slot)
        pool.pos[slot] = s
        pool.active[slot] = True
        pool.tok[slot] = t0
        pool.task[slot] = request.task or self.current_task
        pool.meta[slot] = {"rid": rid, "request": request, "out": [t0]}
        pool.decoded += 1
        pool._dev = None                   # host mirrors changed: re-upload
        return slot

    def _slot_done(self, pool: SlotPool, slot: int) -> bool:
        meta = pool.meta[slot]
        req = meta["request"]
        out = meta["out"]
        return (len(out) >= req.n_new
                or (req.eos_id is not None and out[-1] == req.eos_id))

    def evict(self, pool: SlotPool, slot: int) -> List[int]:
        """Free a slot mid-loop; returns the tokens it generated.  The KV
        rows are NOT cleared — every cache position is rewritten before it
        becomes visible (decode writes position p before attending to it),
        so stale rows never leak into a later sequence."""
        if not pool.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        out = pool.meta[slot]["out"]
        pool.active[slot] = False
        pool.meta[slot] = None
        pool.task[slot] = None
        pool.tok[slot] = 0
        pool._dev = None                   # host mirrors changed: re-upload
        return out

    def _pool_inputs(self, pool: SlotPool):
        """(tok (n, 1), pos (n,), active (n,), tid (n,)) on the device for
        the decode step — the previous step's device copies when no
        scheduling event touched the host mirrors, one upload otherwise
        (task rows validated on the host first)."""
        if pool._dev is not None:
            return pool._dev
        if pool.slotted:
            self._check_task_rows(pool.tid)
        dev = self.device
        return (torch.as_tensor(pool.tok.reshape(-1, 1), device=dev),
                torch.as_tensor(pool.pos, device=dev),
                torch.as_tensor(pool.active, device=dev),
                torch.as_tensor(pool.tid, device=dev))

    @torch.no_grad()
    def step(self, pool: SlotPool) -> np.ndarray:
        """One decode step over the whole pool: every slot advances by one
        token at its OWN position; inactive slots compute masked garbage
        (the price of one fixed batch shape) and emit the pad token 0.
        Returns the (n_slots,) sampled tokens; the host mirrors and outputs
        of active slots are updated."""
        if pool.n_active() == 0:
            raise ValueError("step: no active slot (admit first)")
        tok, pos, act, tid = self._pool_inputs(pool)
        if pool.slotted:
            logits, pool.cache = self.api.decode_step_slotted(
                self.model, self.resident.stack, pool.cache, tok, pos, tid)
        else:
            logits, pool.cache = self.api.decode_step(self.model, pool.cache,
                                                      tok, pos)
        t = sampling.shard_argmax_masked(None, pool.n_slots)(logits, act)
        nxt = t.cpu().numpy()              # the step's one host sync
        pool._dev = (t[:, None], pos + act.to(pos.dtype), act, tid)
        pool.steps += 1
        for slot in np.flatnonzero(pool.active):
            meta = pool.meta[slot]
            if self._slot_done(pool, slot):
                # never happens through serve() — eviction is immediate —
                # but counted for hand-driven pools, whose host mirrors now
                # disagree with the device copies' blind position advance
                pool.bubble_slot_steps += 1
                pool._dev = None
                continue
            pool.pos[slot] += 1
            pool.tok[slot] = int(nxt[slot])
            meta["out"].append(int(nxt[slot]))
            pool.decoded += 1
        pool.idle_slot_steps += pool.n_slots - pool.n_active()
        return nxt

    def _resident_supported(self, requests: Sequence[Request]) -> bool:
        """Can the RESIDENT scheduler run this workload?  Needs a ScaleBank,
        a family with slotted decode and prefill, and every request tasked
        (an empty workload is vacuously tasked)."""
        return (self.bank is not None
                and self.api.decode_step_slotted is not None
                and self.api.prefill_slotted is not None
                and all(r.task is not None for r in requests))

    def _ensure_resident(self, resident_tasks: int) -> ResidentStack:
        cap = max(2, min(int(resident_tasks), len(self.bank.tasks)))
        if self.resident is None or self.resident.capacity != cap:
            self.resident = ResidentStack(self.bank, self.model, cap,
                                          device=self.device)
        return self.resident

    @torch.no_grad()
    def serve(self, requests: Sequence[Request],
              config: ServeConfig) -> ServeReport:
        """Continuously-batched serving of a request stream.

        The loop is event-driven: a request enters the bounded wait queue
        when the clock reaches its arrival (``arrival_s`` against the
        virtual clock — ``step_s`` per decode step, ``admit_cost_s`` per
        prefill — or ``arrival_step`` against the pool step counter), is
        admitted FIFO into a free slot, and leaves as exactly one of
        served, rejected (its arrival overflowed ``queue_bound``; newest
        first) or shed (its queue wait exceeded ``shed_after_s``).  Each
        gets a ``RequestMetrics`` row in ``report.requests``.

        ``config.scheduler``:
          * ``"drain"`` — a request for another task than the live one waits
            until the pool drains; then the scales are swapped once.  The
            wait is metered as ``task_drain_idle_slot_steps``.
          * ``"resident"`` — up to ``resident_tasks`` tasks' scales stay on
            the device (``ResidentStack``, LRU over rows); prefill and
            decode read each request's row, so admission never waits on a
            task and no scale moves at admit.  Rows are bit-equal to the
            drain path's, so the two emit the same tokens.  The only wait
            left is a stack full of pinned (in-flight) rows, metered the
            same way.
          * ``"auto"`` — ``resident`` when supported (a bank, a slotted
            family, every request tasked), ``drain`` otherwise.
          * ``"speculative"`` — not ported yet (raises).

        Requesting ``"resident"`` on an unsupported workload raises;
        ``report.scheduler`` records the policy that ran.
        """
        if not isinstance(config, ServeConfig):
            raise TypeError(f"serve needs a ServeConfig, got "
                            f"{type(config).__name__}")
        cfg = config
        if cfg.scheduler == "speculative":
            raise NotImplementedError(
                "scheduler='speculative' is not ported yet: it needs the "
                "bit-plane codes and the multi-token verify step (slice 4)")
        requests = list(requests)
        use_resident = (cfg.scheduler != "drain"
                        and self._resident_supported(requests))
        if cfg.scheduler == "resident" and not use_resident:
            caps = self.api.caps
            missing = ("no ScaleBank attached" if self.bank is None
                       else (caps.slotted_reason
                             if caps is not None and caps.slotted_reason
                             else "family has no slotted decode step")
                       if self.api.decode_step_slotted is None
                       else "not every request names a task")
            raise ValueError(f"scheduler='resident' unsupported here: "
                             f"{missing}")
        sched_name = "resident" if use_resident else "drain"
        step_s, admit_cost = cfg.step_s, cfg.admit_cost_s
        metrics = [RequestMetrics(rid=i, task=r.task,
                                  arrival_s=r.arrival_time(step_s),
                                  n_prompt=r.n_prompt,
                                  n_budget=int(r.n_new))
                   for i, r in enumerate(requests)]
        if not requests:
            return ServeReport(requests=[], scheduler=sched_name,
                               config=cfg)
        eff_cache_len = cfg.cache_len
        if eff_cache_len is None:
            eff_cache_len = max(r.n_prompt + int(r.n_new) for r in requests)
        if use_resident:
            resident = self._ensure_resident(cfg.resident_tasks)
            installs0 = resident.installs
        # requests sit in ``arrivals`` until the clock reaches them, then
        # move through the bounded wait queue
        arrivals = deque(sorted(range(len(requests)),
                                key=lambda i: (metrics[i].arrival_s, i)))
        waitq: deque = deque()
        pool = self.open_pool(cfg.n_slots, eff_cache_len)
        pool.slotted = use_resident
        switches = 0
        peak_queue = 0
        now = 0.0                       # virtual seconds
        eps = 1e-9
        # tiered-bank bookkeeping: real loads and installs run at issue
        # time; the virtual clock charges each move's cost (disk_load_s on
        # one serialized disk lane, install_s per row write) and a request
        # pays only the remainder the prefetcher failed to hide
        bank = self.bank
        tiering = bank is not None
        if tiering and cfg.host_cache_tasks is not None:
            bank.host_capacity = cfg.host_cache_tasks
        stats0 = bank.stats.as_dict() if tiering else {}
        vhost_ready: dict = {}      # task -> virtual host-resident time
        vdev_ready: dict = {}       # task -> virtual resident-row-ready time
        disk_lane = 0.0             # virtual disk busy-until
        pf_cost: dict = {}          # task -> unattributed prefetch spend
        tier_hits = {"device": 0, "host": 0, "disk": 0}
        prefetch_issued = 0
        prefetch_hidden = 0.0
        t0 = time.perf_counter()

        def due(rid: int) -> bool:
            r = requests[rid]
            if r.arrival_s is not None:
                return metrics[rid].arrival_s <= now + eps
            return r.arrival_step <= pool.steps

        def steps_until_due() -> int:
            """Idle decode steps to jump so the earliest arrival is due."""
            rid = arrivals[0]
            r = requests[rid]
            if r.arrival_s is not None:
                return max(1, math.ceil(
                    (metrics[rid].arrival_s - now - eps) / step_s))
            return max(1, r.arrival_step - pool.steps)

        def finish_slot(slot: int) -> None:
            meta = pool.meta[slot]
            m = metrics[meta["rid"]]
            m.tokens = [int(t) for t in self.evict(pool, slot)]
            m.status = SERVED
            m.finish_s = now

        def host_was_ready(t: str) -> bool:
            """Payload host-resident AND virtually landed by ``now``?"""
            return (bank.loaded(t)
                    and vhost_ready.get(t, 0.0) <= now + eps)

        def host_ready(t: str) -> float:
            """Virtual time ``t``'s payload is host-resident, issuing the
            real disk load (and its lane slot) when it is not."""
            nonlocal disk_lane
            if bank.loaded(t):
                return max(0.0, vhost_ready.get(t, 0.0))
            bank.prefetch(t)    # an unknown/quarantined task surfaces as
            # KeyError at the ensure/switch below, not here
            start = max(now, disk_lane)
            disk_lane = start + cfg.disk_load_s
            vhost_ready[t] = disk_lane
            return disk_lane

        def attribute_swap(m, tier: str, wait: float) -> None:
            """Meter one admit's tier and charged swap remainder, crediting
            the prefetcher for whatever it hid."""
            nonlocal now, prefetch_hidden
            spent = pf_cost.pop(m.task, 0.0)
            prefetch_hidden += max(0.0, spent - wait)
            tier_hits[tier] += 1
            m.scale_tier = tier
            m.swap_wait_s = wait
            now += wait

        def prefetch_tick() -> None:
            """Warm the next ``prefetch_depth`` distinct upcoming tasks
            (wait queue first, then pending arrivals): disk → host on the
            virtual lane, then host → device once the payload has landed
            (resident scheduler only)."""
            nonlocal disk_lane, prefetch_issued
            if not tiering or cfg.prefetch_depth == 0:
                return
            upcoming: List[str] = []
            for rid in (*waitq, *arrivals):
                t = requests[rid].task
                if t is not None and t not in upcoming:
                    upcoming.append(t)
                if len(upcoming) >= cfg.prefetch_depth:
                    break
            for t in upcoming:
                if t not in bank.tasks:     # unknown or quarantined
                    continue
                if not bank.loaded(t):
                    if not bank.prefetch(t):
                        continue            # quarantined on this very load
                    start = max(now, disk_lane)
                    disk_lane = start + cfg.disk_load_s
                    vhost_ready[t] = disk_lane
                    pf_cost[t] = pf_cost.get(t, 0.0) + cfg.disk_load_s
                    prefetch_issued += 1
                if (use_resident and t not in resident.names
                        and vhost_ready.get(t, 0.0) <= now + eps):
                    # pin in-flight tasks AND the other upcoming ones, so a
                    # deep prefetch window never thrashes its own rows
                    pinned = {pool.task[s]
                              for s in np.flatnonzero(pool.active)}
                    pinned |= set(upcoming) - {t}
                    if resident.ensure(t, pinned=pinned) is not None:
                        vdev_ready[t] = now + cfg.install_s
                        pf_cost[t] = pf_cost.get(t, 0.0) + cfg.install_s
                        prefetch_issued += 1

        while arrivals or waitq or pool.n_active():
            # 1. arrivals whose time has come enter the wait queue
            while arrivals and due(arrivals[0]):
                waitq.append(arrivals.popleft())
            # 2. FIFO admission, shedding stale requests at consideration
            blocked_by_task = False
            while waitq:
                rid = waitq[0]
                m = metrics[rid]
                if (cfg.shed_after_s is not None
                        and now - m.arrival_s > cfg.shed_after_s + eps):
                    waitq.popleft()
                    m.status = SHED
                    continue
                if pool.free_slot() is None:
                    break
                req = requests[rid]
                if use_resident:
                    t = req.task
                    pinned = {pool.task[s]
                              for s in np.flatnonzero(pool.active)}
                    if t in resident.names:
                        # row already installed; charge only an install
                        # still virtually in flight
                        wait = max(0.0, vdev_ready.get(t, 0.0) - now)
                        tier = "device" if wait <= eps else "host"
                        row = resident.ensure(t, pinned=pinned)  # LRU touch
                    else:
                        was_host = host_was_ready(t)
                        hr = host_ready(t)
                        row = resident.ensure(t, pinned=pinned)
                        if row is not None:
                            wait = max(0.0, hr - now) + cfg.install_s
                            tier = "host" if was_host else "disk"
                            vdev_ready[t] = now + wait
                    if row is None:         # every row pinned by in-flight
                        blocked_by_task = True
                        break
                    waitq.popleft()
                    attribute_swap(m, tier, wait)
                    m.admit_s = now
                    now += admit_cost
                    slot = self.admit(pool, req, rid=rid, task_row=row,
                                      bucket=cfg.bucket_prompts)
                    m.first_token_s = now
                    pool.tid[slot] = row
                    pool._dev = None
                else:
                    tier = None
                    wait = 0.0
                    if (req.task is not None and self.bank is not None
                            and req.task != self.current_task):
                        if pool.n_active():
                            blocked_by_task = True
                            break           # drain, then swap scales once
                        was_host = host_was_ready(req.task)
                        hr = host_ready(req.task)
                        wait = max(0.0, hr - now) + cfg.install_s
                        tier = "host" if was_host else "disk"
                        self.switch_task(req.task)
                        switches += 1
                    elif req.task is not None and tiering:
                        tier = "device"     # scales already live — no swap
                    waitq.popleft()
                    if tier is not None:
                        attribute_swap(m, tier, wait)
                    m.admit_s = now
                    now += admit_cost
                    slot = self.admit(pool, req, rid=rid,
                                      bucket=cfg.bucket_prompts)
                    m.first_token_s = now
                if self._slot_done(pool, slot):
                    finish_slot(slot)
            # 3. backpressure: arrivals past the queue bound are rejected,
            #    newest first
            if cfg.queue_bound is not None:
                while len(waitq) > cfg.queue_bound:
                    metrics[waitq.pop()].status = REJECTED
            peak_queue = max(peak_queue, len(waitq))
            # 3b. warm upcoming tasks' tiers while the pool decodes (or the
            #     clock jumps)
            prefetch_tick()
            # 4. advance: decode if anything is live, else jump the clock
            #    to the next arrival
            if pool.n_active() == 0:
                if not arrivals:
                    if waitq:
                        # unreachable by construction: with an idle pool the
                        # admission loop admits — fail loudly, never spin
                        raise RuntimeError(
                            f"serve: wait queue stuck with an idle pool "
                            f"({len(waitq)} waiting)")
                    break
                k = steps_until_due()
                pool.steps += k
                pool.idle_slot_steps += k * pool.n_slots
                now += k * step_s
                continue
            n_act = pool.n_active()
            self.step(pool)
            now += step_s
            if blocked_by_task:
                # the free slots this step could have hosted the blocked
                # request — the drain tax the resident scheduler deletes
                pool.task_drain_idle_slot_steps += pool.n_slots - n_act
            for slot in np.flatnonzero(pool.active):
                if self._slot_done(pool, slot):
                    finish_slot(slot)
        return ServeReport(
            requests=metrics, steps=pool.steps, decoded=pool.decoded,
            bubble_slot_steps=pool.bubble_slot_steps,
            idle_slot_steps=pool.idle_slot_steps,
            switches=switches, wall_s=time.perf_counter() - t0,
            task_drain_idle_slot_steps=pool.task_drain_idle_slot_steps,
            resident_installs=(resident.installs - installs0
                               if use_resident else 0),
            prefill_compiles=len(pool._prefill_keys),
            tier_device_hits=tier_hits["device"],
            tier_host_hits=tier_hits["host"],
            tier_disk_loads=tier_hits["disk"],
            prefetch_issued=prefetch_issued,
            prefetch_hidden_s=prefetch_hidden,
            bank_disk_loads=(bank.stats.disk_loads - stats0["disk_loads"]
                             if tiering else 0),
            bank_host_evictions=(
                bank.stats.host_evictions - stats0["host_evictions"]
                if tiering else 0),
            scheduler=sched_name, peak_queue_depth=peak_queue, config=cfg)
