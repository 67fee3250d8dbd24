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
  * self-speculative decoding (``scheduler="speculative"``, ``spec_step``)
    on a bit-plane backbone: each pool step is a round of ``spec_k`` draft
    steps that read the top ``draft_bits`` planes of the target's own
    codes, then one target verify of the k+1 tokens; the emitted tokens
    are the target's greedy tokens.

On a ``(data, model)`` mesh (``ctx``, ``dist/context.py``) every rank runs
an engine over its shard of the model (``dist/sharding.py::shard_model``):
the model axis splits heads, d_ff and the vocab (the collectives are
explicit, ``models/linear.py`` and ``models/common.py``); the data axis
splits the lockstep batch, or the slot pool, wherever it divides.  Every
rank runs the same scheduler on the same host state; the tokens a step
samples are gathered over the data axis, so every rank's ``ServeReport``
is the same (but for its wall clock).  Under ``logitshard`` the decode
logits stay vocab-sharded and the shard-local samplers
(``dist/sampling.py``) pick the tokens with scalar collectives; without it
the logits are gathered over the model axis first.
``decode_collectives`` / ``continuous_decode_collectives`` return one
decode step's collective record (the reference's ``decode_hlo`` /
``continuous_decode_hlo``).

Not ported: the deprecated keyword form of ``serve`` (it takes a
``ServeConfig``).
"""
from __future__ import annotations

import contextlib
import math
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.core.scale_bank import ResidentStack, ScaleBank
from repro_torch.dist import backend, context, sampling, sharding
from repro_torch.models import registry
from repro_torch.models.registry import NO_VERIFY_REASON, ModelAPI
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.metrics import (REJECTED, SERVED, SHED, RequestMetrics,
                                       ServeReport)
from repro_torch.serve.request import Request

__all__ = ["Engine", "Request", "RequestMetrics", "ServeConfig",
           "ServeReport", "SlotPool", "cache_dims"]


def cache_dims(init_cache, batch: int = 2, seq_len: int = 8):
    """(batch_dims, seq_dims): for every leaf of ``init_cache``'s cache, the
    index of its batch dim and of its sequence(-capacity) dim, −1 for a
    leaf without one (whisper's cross K/V have no sequence dim).  Derived
    from the structure, as the reference's ``cache_batch_dims`` /
    ``cache_seq_dims`` derive it: the cache is made on the ``meta`` device
    (no storage) at two batch sizes and at two lengths, and the first dim
    whose extent moves is the one.  A ring clamps its capacity to the
    window, so the lengths must lie below it."""
    base = init_cache(batch, seq_len, device="meta")
    wider = init_cache(batch + 1, seq_len, device="meta")
    longer = init_cache(batch, seq_len + 1, device="meta")

    def moved(a, b):
        return next((i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                     if x != y), -1)
    return ({k: moved(base[k], wider[k]) for k in base},
            {k: moved(base[k], longer[k]) for k in base})


class SlotPool:
    """A fixed pool of ``n_slots`` sequence slots.

    Device state: the cache (batch dim = slot dim).  Host mirrors, one value
    per slot — the scheduler state: ``pos`` (next absolute position =
    tokens written so far), ``active``, ``tok`` (last sampled token, the
    next decode input), ``tid`` (resident-stack row) and per-slot metadata.

    On a mesh whose data axis divides ``n_slots`` the cache holds the
    rank's block of slots, ``rows``; the host mirrors stay whole.
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
        self.rows = slice(0, n_slots) if engine.ctx is None \
            else engine.ctx.local_rows(n_slots)
        self.cache = engine.api.init_cache(self.rows.stop - self.rows.start,
                                           cache_len)
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
        self.draft_steps = 0           # speculative draft steps executed
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
                 bank: Optional[ScaleBank] = None, *, device=None,
                 ctx: Optional[context.MeshContext] = None,
                 logitshard: bool = False):
        """Serve ``model`` on ``device`` (the card unless ``device="cpu"``);
        the model is moved there if it is elsewhere.  ``bank`` holds the
        task scale sets ``switch_task`` and ``serve`` draw on.

        ``ctx``: serve on a mesh.  ``api`` is the whole model's and
        ``model`` the rank's shard (``sharding.shard_model``), which must
        already lie on the context's device (``device``, if given, must be
        that one): a shard elsewhere is refused, not moved.
        ``logitshard`` keeps the decode logits vocab-sharded (the vocab
        must divide the model axis)."""
        self.ctx = ctx
        self.logitshard = bool(logitshard and ctx is not None)
        if ctx is not None:
            cfg = api.cfg
            if self.logitshard and cfg.vocab_size % ctx.model_size:
                raise ValueError(
                    f"logitshard needs vocab {cfg.vocab_size} divisible by "
                    f"the model axis ({ctx.model_size})")
            registry.check_supported(cfg, mesh=ctx)
            if getattr(model, "mesh_shard", None) != (ctx.model_rank,
                                                      ctx.model_size):
                raise ValueError(
                    "on a mesh the engine serves this rank's shard of the "
                    "model: pass sharding.shard_model(model, cfg, ctx)")
            dev = backend.device(ctx.device)
            if device is not None and backend.device(device) != dev:
                raise ValueError(f"engine device {device} differs from the "
                                 f"mesh context's {dev}")
            where = {str(t.device) for t in (*model.parameters(),
                                             *model.buffers())}
            if where != {str(dev)}:
                raise ValueError(
                    f"the rank's shard lies on {', '.join(sorted(where))}, "
                    f"the mesh context on {dev}: cut the shard from a model "
                    f"on {dev}, or make the context there")
            device = dev
            api = registry.build(sharding.shard_config(cfg, ctx.model_size),
                                 device=device)
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
        self._dims = None

    def _mesh(self):
        """The scope every model call runs in: the mesh context (and the
        logits layout) on a mesh, nothing off it."""
        if self.ctx is None:
            return contextlib.nullcontext()
        return context.use_mesh(self.ctx, logitshard=self.logitshard)

    def _argmax(self, batch: int):
        """The greedy sampler of the logits the model functions return:
        shard-local under ``logitshard``, else over whole rows."""
        return sampling.shard_argmax(self.ctx if self.logitshard else None,
                                     batch)

    def _rows(self, batch: int) -> slice:
        """This rank's rows of a ``batch``-row lockstep batch or pool."""
        return slice(0, batch) if self.ctx is None \
            else self.ctx.local_rows(batch)

    def _gather_rows(self, t: torch.Tensor, batch: int) -> torch.Tensor:
        """The whole batch's rows of ``t`` (this rank's ``_rows(batch)``)
        on every rank: gathered over the data axis where it split them."""
        if self.ctx is None or self.ctx.batch_axes(batch) is None:
            return t
        return self.ctx.all_gather(t, "data", dim=0)

    def _cache_dims(self):
        """This API's (batch_dims, seq_dims) (``cache_dims``), memoised.  A
        ring's probe lengths stay below its window, ``min(8, window − 1)``
        (the reference's ``Engine._cache_dims``)."""
        if self._dims is None:
            w = self.api.cfg.swa_window
            sl = 8 if w is None else max(1, min(8, w - 1))
            self._dims = cache_dims(self.api.init_cache, 2, sl)
        return self._dims

    def _has_seq_leaf(self) -> bool:
        """Does ANY cache leaf carry a position (seq) dim?  False for a
        purely recurrent family (xlstm: ``init_cache`` ignores
        ``seq_len``), where a pool's capacity and a cache's growth mean
        nothing and must not refuse a request (the reference's
        ``Engine._has_seq_leaf``)."""
        return any(sd >= 0 for sd in self._cache_dims()[1].values())

    def _prefix_rows(self, prefix) -> int:
        """Decoder cache rows a request prefix occupies (0 when the family
        keeps its prefix out of the decoder's positions)."""
        caps = self.api.caps
        if prefix is None or caps is None or not caps.prefix_positions:
            return 0
        return int(np.shape(prefix)[-2])

    def _check_prefix(self, prefix) -> None:
        """Validate a request prefix against the capability record."""
        caps = self.api.caps
        key = None if caps is None else caps.prefix_key
        if prefix is not None and key is None:
            raise ValueError(
                f"family {self.api.cfg.family!r} takes no per-request "
                f"prefix state (FamilyCaps.prefix_key is None)")
        if prefix is None and caps is not None and caps.prefix_required:
            raise ValueError(
                f"family {self.api.cfg.family!r} requires prefix state "
                f"{key!r} on every request (encoder inputs)")

    def _prefix_tensor(self, prefix) -> torch.Tensor:
        """A prefix (numpy or tensor) as a float32 tensor on the device."""
        return torch.as_tensor(prefix, device=self.device).to(torch.float32)

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
        self.bank.switch(self.model, name, ctx=self.ctx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.current_task = name
        return time.perf_counter() - t0

    # ------------------------------------------------------------- generate
    @torch.inference_mode()
    def generate(self, tokens, n_new: int, cache_len: Optional[int] = None,
                 prefix=None) -> torch.Tensor:
        """Greedy decode (LOCKSTEP). tokens (B, S) → (B, S + n_new) int64.

        ``prefix``: (B, P, d) per-row prefix state, fed to the prefill
        under the family's ``FamilyCaps.prefix_key`` (a vlm's image
        embeddings take the cache's first P positions, so the prompt's
        tokens start at position P).

        ``cache_len`` is validated, not clamped: the deepest cache write is
        position prefix+prompt+n_new-2 (the final sampled token's KV is
        never written), so prefix+prompt+n_new-1 slots suffice and fewer
        raise.  A sliding window's ring cache wraps, so any positive value
        is legal there.

        On a mesh ``tokens`` (and ``prefix``) are the whole batch on every
        rank: each rank decodes its data block of rows where the batch
        divides the data axis, and every rank returns the whole result.
        """
        with self._mesh():
            return self._generate(tokens, n_new, cache_len, prefix)

    def _generate(self, tokens, n_new, cache_len, prefix):
        self._check_prefix(prefix)
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        b, s = tokens.shape
        s_eff = s + self._prefix_rows(prefix)   # decoder positions consumed
        total = s_eff + n_new
        if cache_len is None:
            cache_len = total
        elif cache_len <= 0:
            raise ValueError(
                f"cache_len={cache_len} must be positive (omit it for the "
                f"default prompt+n_new={total})")
        elif (cache_len < total - 1 and self.api.cfg.swa_window is None
              and self._has_seq_leaf()):
            raise ValueError(
                f"cache_len={cache_len} < prompt+n_new-1={total - 1}: a "
                f"dense cache cannot hold the generation")
        rows = self._rows(b)
        whole_b, b = b, rows.stop - rows.start
        tokens = tokens[rows]
        sample = self._argmax(whole_b)
        batch = {"tokens": tokens}
        if prefix is not None:
            batch[self.api.caps.prefix_key] = \
                self._prefix_tensor(prefix)[rows]
        logits, pcache = self.api.prefill(self.model, batch)
        # re-home the prompt-sized prefill cache into one with headroom
        # (a ring's prefill cache is already in ring layout: it occupies
        # the first slots of a ring of at least its capacity)
        cache = self.api.init_cache(b, cache_len)
        sdims = self._cache_dims()[1]
        for key, dst in cache.items():
            src, sd = pcache[key], sdims[key]
            if sd < 0 and src.shape != dst.shape:
                raise ValueError(
                    f"cannot grow cache leaf {tuple(src.shape)} into "
                    f"{tuple(dst.shape)}: it has no seq dim ({sd}, inferred "
                    f"structurally), so only the seq dim of a leaf may grow")
            (dst if sd < 0 else dst.narrow(sd, 0, src.shape[sd])).copy_(src)
        del pcache
        out = [tokens]
        tok = sample(logits)[:, None]
        for i in range(n_new):
            out.append(tok)
            if i == n_new - 1:
                break
            logits, cache = self.api.decode_step(self.model, cache, tok,
                                                 s_eff + i)
            tok = sample(logits)[:, None]
        return self._gather_rows(torch.cat(out, dim=1), whole_b)

    @torch.inference_mode()
    def prefill_logits(self, tokens, prefix=None) -> torch.Tensor:
        """The prefill's last-position logits (B, V) float32 of the whole
        batch, on every rank (gathered over the data and model axes on a
        mesh): what ``generate`` samples its first token from.
        ``prefix``: (B, P, d) per-row prefix state, as ``generate``'s."""
        self._check_prefix(prefix)
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        b = tokens.shape[0]
        rows = self._rows(b)

        def batch():
            out = {"tokens": tokens[rows]}
            if prefix is not None:
                out[self.api.caps.prefix_key] = \
                    self._prefix_tensor(prefix)[rows]
            return out
        if self.ctx is None:
            return self.api.prefill(self.model, batch())[0]
        with context.use_mesh(self.ctx):          # whole rows: gathered
            logits, _ = self.api.prefill(self.model, batch())
            return self._gather_rows(logits, b)

    @torch.inference_mode()
    def decode_collectives(self, b: int, cache_len: int) -> List[dict]:
        """The collective record of one lockstep decode step of ``b`` rows
        against a ``cache_len`` cache, its sampler included (the
        reference's ``decode_hlo``, scanned for collectives): run on a
        scratch cache, on every rank at once."""
        if self.ctx is None:
            raise ValueError("decode_collectives needs a mesh context")
        rows = self._rows(b)
        n = rows.stop - rows.start
        cache = self.api.init_cache(n, cache_len)
        tok = torch.zeros((n, 1), dtype=torch.int64, device=self.device)
        with self._mesh(), self.ctx.recording() as rec:
            logits, _ = self.api.decode_step(self.model, cache, tok, 0)
            self._gather_rows(self._argmax(b)(logits), b)
        return rec

    @torch.inference_mode()
    def continuous_decode_collectives(self, n_slots: int, cache_len: int
                                      ) -> List[dict]:
        """The collective record of one pool step of ``n_slots`` slots (the
        reference's ``continuous_decode_hlo``): a scratch pool, every slot
        active at position 0, decoded and sampled as ``step`` does."""
        if self.ctx is None:
            raise ValueError("continuous_decode_collectives needs a mesh "
                             "context")
        pool = self.open_pool(n_slots, cache_len)
        pool.active[:] = True
        tok, pos, act, tid = self._pool_inputs(pool)
        with self._mesh(), self.ctx.recording() as rec:
            self._pool_decode(pool, tok, pos, act, tid)
        return rec

    # ------------------------------------------------- continuous batching
    def open_pool(self, n_slots: int, cache_len: int) -> SlotPool:
        """Allocate the slot pool."""
        return SlotPool(self, n_slots, cache_len)

    def _admit_write(self, pool: SlotPool, pcache: dict, slot: int) -> None:
        """Place a batch-1 prefill cache into slot ``slot`` of the pool, in
        place: along each leaf's batch dim, at the start of its position
        dim; a position-free leaf (whisper's cross K/V) as one whole batch
        row."""
        bdims, sdims = self._cache_dims()
        for key, dst in pool.cache.items():
            src, sd = pcache[key], sdims[key]
            row = dst.narrow(bdims[key], slot, 1)
            (row if sd < 0 else row.narrow(sd, 0, src.shape[sd])).copy_(src)

    def _check_admit_shapes(self, pool: SlotPool, pcache: dict) -> None:
        """The prefill cache must be batch-1, fit the pool capacity, and
        differ from the pool only on the batch and position dims (a
        position-free leaf only on the batch dim)."""
        bdims, sdims = self._cache_dims()
        for key, dst in pool.cache.items():
            src, bd, sd = pcache[key], bdims[key], sdims[key]
            if src.shape[bd] != 1:
                raise ValueError(f"admit needs a batch-1 prefill cache, got "
                                 f"batch {src.shape[bd]} in {tuple(src.shape)}")
            if sd >= 0 and src.shape[sd] > dst.shape[sd]:
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
        (``last_pos``), so token streams are unchanged.  Off under a
        sliding window: padded rows would wrap onto the ring's committed
        slots.  A ring wraps, so its requests are not held to the pool's
        capacity.
        """
        with self._mesh():
            return self._admit(pool, request, rid, task_row, bucket)

    def _admit(self, pool, request, rid, task_row, bucket) -> int:
        slot = pool.free_slot()
        if slot is None:
            raise RuntimeError("admit: no free slot (evict first)")
        toks = np.asarray(request.tokens, np.int64).reshape(-1)
        s = int(toks.shape[0])
        n_new = int(request.n_new)
        if s < 1 or n_new < 1:
            raise ValueError(f"need prompt >= 1 and n_new >= 1 tokens, got "
                             f"({s}, {n_new})")
        prefix = request.prefix
        self._check_prefix(prefix)
        p_rows = self._prefix_rows(prefix)  # decoder positions the prefix eats
        s_eff = s + p_rows
        has_seq = self._has_seq_leaf()
        swa = self.api.cfg.swa_window is not None
        if has_seq and not swa and s_eff + n_new - 1 > pool.cache_len:
            raise ValueError(
                f"request needs {s_eff + n_new - 1} cache slots, pool has "
                f"{pool.cache_len}")
        if (task_row is None and request.task is not None
                and self.bank is not None
                and request.task != self.current_task):
            raise ValueError(
                f"request targets task {request.task!r} but the engine "
                f"serves {self.current_task!r}; switch_task first (the "
                f"scheduler drains the pool before switching)")
        caps = self.api.caps
        bucket = bucket and caps.bucketable and has_seq and not swa
        s_pad = self._bucket_len(s, pool.cache_len - p_rows) if bucket \
            else s
        if s_pad != s:
            toks = np.pad(toks, (0, s_pad - s))   # masked filler rows
        if task_row is not None:
            self._check_task_rows([task_row])
        # on a mesh that splits the pool only the data ranks holding the
        # slot prefill it; the first token then comes from them
        local = slot - pool.rows.start
        owner = 0 <= local < pool.rows.stop - pool.rows.start
        if owner:
            batch = {"tokens": torch.as_tensor(toks,
                                               device=self.device)[None]}
            if prefix is not None:
                batch[caps.prefix_key] = self._prefix_tensor(prefix)[None]
            if s_pad != s:
                batch["last_pos"] = p_rows + s - 1
            if task_row is not None:
                tid = torch.full((1,), task_row, dtype=torch.int32,
                                 device=self.device)
                logits, pcache = self.api.prefill_slotted(
                    self.model, self.resident.stack, batch, tid)
            else:
                logits, pcache = self.api.prefill(self.model, batch)
            self._check_admit_shapes(pool, pcache)
            first = self._argmax(1)(logits)
        # the pool is touched only once the prefill has succeeded (a
        # recurrent family's prompt whose length its chunked scan refuses
        # raises above)
        pool._prefill_keys.add((s_pad, p_rows, s_pad != s))
        if pool.rows.stop - pool.rows.start < pool.n_slots:
            held = pool.rows.stop - pool.rows.start
            first = self.ctx.broadcast(
                first if owner else torch.zeros(1, dtype=torch.int64,
                                                device=self.device),
                "data", slot // held)
        t0 = int(first[0])
        if owner:
            self._admit_write(pool, pcache, local)
        pool.pos[slot] = s_eff
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
        the decode step, n the slots this rank holds — the previous step's
        device copies when no scheduling event touched the host mirrors,
        one upload otherwise (task rows validated on the host first)."""
        if pool._dev is not None:
            return pool._dev
        if pool.slotted:
            self._check_task_rows(pool.tid)
        dev, r = self.device, pool.rows
        return (torch.as_tensor(pool.tok[r].reshape(-1, 1), device=dev),
                torch.as_tensor(pool.pos[r], device=dev),
                torch.as_tensor(pool.active[r], device=dev),
                torch.as_tensor(pool.tid[r], device=dev))

    def _pool_decode(self, pool: SlotPool, tok, pos, act, tid):
        """The device part of a pool step: decode the rank's slots and
        sample them; returns (this rank's tokens, the whole pool's)."""
        if pool.slotted:
            logits, pool.cache = self.api.decode_step_slotted(
                self.model, self.resident.stack, pool.cache, tok, pos, tid)
        else:
            logits, pool.cache = self.api.decode_step(self.model, pool.cache,
                                                      tok, pos)
        t = sampling.shard_argmax_masked(
            self.ctx if self.logitshard else None, pool.n_slots)(logits, act)
        return t, self._gather_rows(t, pool.n_slots)

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
        with self._mesh():
            t, whole = self._pool_decode(pool, tok, pos, act, tid)
        nxt = whole.cpu().numpy()          # the step's one host sync
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

    # ----------------------------------------------------- speculative decode
    def _spec_supported(self) -> Optional[str]:
        """None when the self-speculative scheduler can run, else the reason
        it cannot.  The gates are the assumptions the round's KV
        bookkeeping rests on: a dense (non-ring) cache whose row index IS
        the absolute position (stale rows past the accepted prefix stay
        causally invisible and are rewritten before any query reaches
        them), a full-precision KV store, and a bit-plane backbone (the
        draft is a prefix READ of the same codes)."""
        cfg = self.api.cfg
        caps = self.api.caps
        if caps is not None and caps.verify_reason is not None:
            return caps.verify_reason
        if self.api.decode_verify is None:
            return NO_VERIFY_REASON
        if cfg.moe is not None:
            return "MoE expert dispatch is not supported in the verify step"
        if cfg.swa_window is not None:
            return ("sliding-window ring cache: rejected draft rows would "
                    "alias committed slots")
        if cfg.kv_cache_dtype != "model":
            return ("quantized KV cache: verify re-quantization drifts "
                    "from the greedy trajectory")
        if cfg.quant.layout != "plane":
            return ("draft needs bit-plane packed codes "
                    "(QuantConfig(layout='plane'))")
        return None

    def _resolve_draft_bits(self, cfg: ServeConfig) -> int:
        bits = self.api.cfg.quant.bits
        db = bits - 1 if cfg.draft_bits is None else int(cfg.draft_bits)
        if not 1 <= db < bits:
            raise ValueError(
                f"draft_bits={db} must be in [1, {bits - 1}] for a "
                f"{bits}-bit backbone (the draft reads a strict prefix of "
                f"the bit-planes)")
        return db

    def _spec_round(self, pool: SlotPool, tok, pos, act, tid, spec_k: int,
                    draft_bits: int):
        """One speculative round on the device: ``spec_k`` greedy draft
        steps through the ``draft_bits``-bit plane prefix, then ONE target
        verify over the k+1 tokens [next-input, d_1..d_k].

        The draft view is the decode step with ``draft_bits``: every plane
        linear reads the top planes of its own buffer and rescales the live
        scales (or the resident stack's rows) as the kernel reads them —
        no copy of the codes, and no draft scales that a task switch or a
        row install could leave stale.

        Cache discipline: draft step j writes PROVISIONAL draft K/V at row
        pos+j and attends rows ≤ pos+j; the verify overwrites rows
        pos..pos+k with target K/V.  After acceptance the host advances pos
        by a+1 ≤ k+1, so the stale suffix rows sit above every live
        position and the causal mask hides them until a later round
        rewrites them.  Argmax and acceptance stay on the device.

        Returns ``(g (B, k+1), acc (B,))``: row b of ``g`` = the target's
        greedy tokens, ``acc`` = the accepted draft count (the host emits
        ``g[:acc+1]``)."""
        model, api = self.model, self.api
        stack = self.resident.stack if pool.slotted else None
        argmax = self._argmax(pool.n_slots)
        seq = [tok]
        t = tok
        for j in range(spec_k):
            if pool.slotted:
                lg, pool.cache = api.decode_step_slotted(
                    model, stack, pool.cache, t, pos + j, tid,
                    draft_bits=draft_bits)
            else:
                lg, pool.cache = api.decode_step(model, pool.cache, t,
                                                 pos + j,
                                                 draft_bits=draft_bits)
            t = argmax(lg)[:, None]
            seq.append(t)
        seq = torch.cat(seq, dim=1)                       # (B, k+1)
        if pool.slotted:
            logits, pool.cache = api.decode_verify_slotted(
                model, stack, pool.cache, seq, pos, tid)
        else:
            logits, pool.cache = api.decode_verify(model, pool.cache, seq,
                                                   pos)
        b, s1, v = logits.shape
        g = argmax(logits.reshape(b * s1, v)).reshape(b, s1)  # (B, k+1)
        g = torch.where(act[:, None], g, 0)
        match = (seq[:, 1:] == g[:, :-1]).to(torch.int64)
        acc = torch.where(act, torch.cumprod(match, dim=1).sum(dim=1), 0)
        return g, acc

    @torch.no_grad()
    def spec_step(self, pool: SlotPool, spec_k: int,
                  draft_bits: int) -> np.ndarray:
        """One speculative round over the pool.  Every active slot proposes
        ``spec_k`` draft tokens and commits 1..spec_k+1 target tokens
        (capped by its remaining budget and EOS).  ``pool.steps`` counts
        ONE target step per round; ``pool.draft_steps`` accrues the draft
        work.  Returns the (n_slots, spec_k+1) greedy target tokens."""
        if pool.n_active() == 0:
            raise ValueError("spec_step: no active slot (admit first)")
        tok, pos, act, tid = self._pool_inputs(pool)
        with self._mesh():
            g, acc = self._spec_round(pool, tok, pos, act, tid, spec_k,
                                      draft_bits)
            both = self._gather_rows(torch.cat([g, acc[:, None]], dim=1),
                                     pool.n_slots)
        both = both.cpu().numpy()          # the round's one host sync
        g, acc = both[:, :-1], both[:, -1]
        pool.steps += 1
        pool.draft_steps += spec_k
        pool._dev = None          # per-slot advance is data-dependent
        for slot in np.flatnonzero(pool.active):
            meta = pool.meta[slot]
            req = meta["request"]
            out = meta["out"]
            if self._slot_done(pool, slot):
                pool.bubble_slot_steps += 1
                continue
            take = min(int(acc[slot]) + 1, int(req.n_new) - len(out))
            toks = [int(x) for x in g[slot, :take]]
            if req.eos_id is not None and req.eos_id in toks:
                toks = toks[:toks.index(req.eos_id) + 1]
                take = len(toks)
            meta["draft_proposed"] = meta.get("draft_proposed", 0) + spec_k
            meta["draft_accepted"] = (meta.get("draft_accepted", 0)
                                      + int(acc[slot]))
            out.extend(toks)
            pool.pos[slot] += take
            pool.tok[slot] = toks[-1]
            pool.decoded += take
        pool.idle_slot_steps += pool.n_slots - pool.n_active()
        return g

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
                                          device=self.device, ctx=self.ctx)
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
          * ``"speculative"`` — each pool step is a self-speculative round
            (``spec_step``): ``config.spec_k`` draft tokens from the
            ``config.draft_bits``-bit plane prefix of the shared backbone,
            then one multi-token target verify.  The emitted tokens are
            the target's greedy tokens; only the step count changes.  The
            task policy composes like ``"auto"``.  Needs a bit-plane
            backbone and a family with ``decode_verify``
            (``_spec_supported``).

        Requesting ``"resident"`` on an unsupported workload raises;
        ``report.scheduler`` records the policy that ran.
        """
        if not isinstance(config, ServeConfig):
            raise TypeError(f"serve needs a ServeConfig, got "
                            f"{type(config).__name__}")
        cfg = config
        requests = list(requests)
        use_spec = cfg.scheduler == "speculative"
        if use_spec:
            reason = self._spec_supported()
            if reason is not None:
                raise ValueError(
                    f"scheduler='speculative' unsupported here: {reason}")
            spec_bits = self._resolve_draft_bits(cfg)
        use_resident = (cfg.scheduler != "drain"
                        and self._resident_supported(requests)
                        and not (use_spec
                                 and self.api.decode_verify_slotted is None))
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
        sched_name = ("speculative" if use_spec
                      else "resident" if use_resident else "drain")
        step_s, admit_cost = cfg.step_s, cfg.admit_cost_s
        if use_spec:
            # one round = spec_k draft steps + one verify.  A draft step's
            # weight traffic is draft_bits/bits of a target step's (a
            # prefix read of the same planes), and the verify streams the
            # weights once regardless of k
            round_s = step_s * (1.0 + cfg.spec_k * spec_bits
                                / self.api.cfg.quant.bits)
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
            # prefix rows (vlm image tokens) share the slot's cache capacity
            eff_cache_len = max(self._prefix_rows(r.prefix) + r.n_prompt
                                + int(r.n_new) for r in requests)
        if use_spec:
            # rollback headroom: a round starting at the final needed
            # position still writes spec_k provisional rows past it —
            # without the margin the cache write's clamp would shift those
            # writes onto committed rows
            eff_cache_len += cfg.spec_k
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
            m.draft_proposed = meta.get("draft_proposed", 0)
            m.draft_accepted = meta.get("draft_accepted", 0)
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
            if use_spec:
                self.spec_step(pool, cfg.spec_k, spec_bits)
                now += round_s
            else:
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
            draft_steps=pool.draft_steps,
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
