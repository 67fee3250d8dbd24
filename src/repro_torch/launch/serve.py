"""Serving launcher: one PEQA backbone, many tasks, batched greedy decode
(port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --bits 4 --tasks taskA,taskB --n-new 24 [--device cpu]

Tunes a small scale set per task on distinct synthetic corpora, then serves
round-robin across tasks with scale hot-swaps (paper Table 1's PEQA row).
It runs on the card unless ``--device cpu``.  ``--tiny`` is on and cannot
be turned off (``store_true`` with ``default=True``, as in the reference):
the CLI always serves the reduced config; a full-width run goes through
``build_model``, ``tune_tasks`` and ``run_continuous`` directly.

``--continuous`` serves an arrival-simulating mixed-length, mixed-task
stream through ``Engine.serve`` (``--traffic`` steps / poisson / trace,
``--scheduler`` auto / resident / drain / speculative) and exits non-zero
if any request is dropped, any bubble step is observed, or the resident
scheduler idles a slot-step on task drain.  ``--scheduler speculative``
(needs ``--layout plane``) then replays the stream greedily and fails on
any token mismatch or on no fewer target steps.  ``--family-smoke`` serves
an untasked stream for the arch's family and fails unless every request's
tokens equal lockstep ``generate``'s.

``--mesh D,M`` serves on a (data, model) mesh of D×M ranks, which the
launcher spawns itself on ``--device`` (``dist/backend.py``'s rule): a
``cpu`` device runs them under gloo; a ``cuda`` device under NCCL, a rank
a card, when the machine has D×M cards, and otherwise every rank on
``cuda:0`` under gloo (printed as such).  The tasks are tuned once, in
the launching process, into a bank directory the ranks open; every rank
builds the model from the seed and serves its shard.  The decode logits
stay vocab-sharded unless ``--no-logitshard``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mesh 1,2 --continuous

``REPRO_FAKE_DEVICES`` (the reference's fake host devices for a mesh in
one process) has no meaning for processes and is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import (OptimConfig, QuantConfig, TrainConfig,
                                      TuningConfig)
from repro_torch.core import policies
from repro_torch.core.scale_bank import ScaleBank
from repro_torch.data import pipeline, synthetic
from repro_torch.models import registry
from repro_torch.optim.adamw import make_optimizer
from repro_torch.serve import Request, ServeConfig, driver, traffic
from repro_torch.train import loop, step
from repro_torch.train.serve import Engine
from repro_torch.train.state import make_state

FAKE_DEVICES_REFUSAL = (
    "REPRO_FAKE_DEVICES fakes several devices inside one process; the "
    "port's mesh is one process a rank: unset it and run --device cpu "
    "--mesh D,M (or --mesh D,M on the card)")
# the reference's per-task tuning: 8 × 64 tokens a step at lr 3e-3
TUNE_BATCH, TUNE_SEQ, TUNE_LR, TUNE_WARMUP = 8, 64, 3e-3, 8
TUNE_CORPUS = 60_000


def place_prompt(prompt, ctx=None):
    """This rank's rows of the lockstep prompt, on its device: its data
    block where the batch divides the data axis, else every row (the
    reference homes the prompt batch-sharded).  Off the mesh (``ctx``
    None) the prompt itself."""
    if ctx is None:
        return prompt
    t = torch.as_tensor(np.asarray(prompt), device=ctx.device)
    return t[ctx.local_rows(t.shape[0])]


def mixed_workload(tasks, batch, n_new, n_requests, vocab, stagger=2):
    """Arrival-simulating request stream: mixed lengths (n_new/2, n_new,
    2*n_new cycling), mixed tasks (round-robin per arrival wave), prompts
    of 8 tokens, arrivals staggered ``stagger`` decode steps apart."""
    lengths = [max(2, n_new // 2), n_new, 2 * n_new]
    reqs = []
    for i in range(n_requests):
        prompt = (np.arange(8, dtype=np.int32) * (i + 1)) % vocab
        reqs.append(Request(
            tokens=prompt, n_new=lengths[i % len(lengths)],
            task=tasks[(i // batch) % len(tasks)],
            arrival_step=(i // batch) * stagger))
    return reqs


def family_workload(cfg, seed: int = 11):
    """Mixed-length staggered stream for ONE family, prefix state included.

    SSM/hybrid prompt lengths are multiples of the tiny ``SSMConfig.chunk``
    (the chunked scan refuses a ragged length); encdec requests carry
    synthesized encoder frames and vlm requests image embeddings — the
    per-request prefix state the slot protocol admits once per slot.
    """
    rng = np.random.default_rng(seed)
    shapes = ((8, 4, 0), (16, 7, 0), (8, 3, 1), (24, 5, 3), (16, 6, 6)) \
        if cfg.family in ("ssm", "hybrid") else \
        ((6, 4, 0), (5, 9, 0), (7, 3, 1), (6, 6, 2), (4, 12, 3))
    reqs = []
    for s, n_new, arrival in shapes:
        prefix = None
        if cfg.family == "encdec":
            prefix = rng.normal(size=(cfg.enc_frames, cfg.d_model)
                                ).astype(np.float32)
        elif cfg.family == "vlm":
            prefix = rng.normal(size=(cfg.n_img_tokens, cfg.d_model)
                                ).astype(np.float32)
        reqs.append(Request(
            tokens=rng.integers(0, cfg.vocab_size, size=s).astype(np.int32),
            n_new=n_new, arrival_step=arrival, prefix=prefix))
    return reqs


def run_family_smoke(engine, cfg, args, log: Callable = print) -> bool:
    """Untasked continuous serving for ANY registered family, gated on
    token-for-token equality with per-request lockstep ``generate`` and on
    no bubble slot-step.  No tuning, no scale bank."""
    reqs = family_workload(cfg, seed=args.seed + 11)
    rep = engine.serve(reqs, ServeConfig(n_slots=2))
    ok = rep.bubble_slot_steps == 0
    if not ok:
        log(f"[serve] FAIL: {rep.bubble_slot_steps} bubble slot-steps")
    for i, r in enumerate(reqs):
        pref = None if r.prefix is None else r.prefix[None]
        ref = engine.generate(r.tokens[None], n_new=r.n_new, prefix=pref)
        want = [int(t) for t in ref[0, len(r.tokens):].tolist()]
        match = rep.tokens[i] == want
        log(f"[serve] req{i:02d} n_prompt={r.n_prompt} n_new={r.n_new} "
            f"prefix={'-' if r.prefix is None else r.prefix.shape} "
            f"tokens==lockstep: {match}")
        if not match:
            ok = False
    log(f"[serve] family-smoke {cfg.family} ({cfg.name}): "
        f"steps={rep.steps} bubbles={rep.bubble_slot_steps} "
        f"prefill_compiles={rep.prefill_compiles} "
        f"{'OK' if ok else 'FAILED'}")
    return ok


def continuous_requests(cfg, args, tasks, log: Callable = print) -> list:
    """``--continuous``' request stream: 3 × ``--batch`` requests, from
    ``mixed_workload`` (``--traffic steps``) or ``traffic.make``; a vlm's
    or an encdec's each with its own seeded prefix state
    (``with_prefixes``)."""
    if args.traffic == "steps":
        return with_prefixes(cfg, mixed_workload(
            tasks, args.batch, args.n_new, n_requests=3 * args.batch,
            vocab=cfg.vocab_size), args.seed)
    reqs, meta = traffic.make(
        args.traffic, vocab=cfg.vocab_size, seed=args.seed,
        tasks=tuple(tasks), rate=args.rate,
        n_requests=3 * args.batch, trace_path=args.trace or None,
        n_new=(max(2, args.n_new // 2), args.n_new, 2 * args.n_new))
    log(f"[serve] traffic: {meta}")
    return with_prefixes(cfg, reqs, args.seed)


def with_prefixes(cfg, reqs: list, seed: int) -> list:
    """``reqs`` with a (P, d) prefix state each where the family takes one
    (image embeddings, encoder frames: ``pipeline.family_prefix``), drawn
    from (``seed``, the request's index); the others as they are."""
    out = []
    for i, r in enumerate(reqs):
        got = pipeline.family_prefix(cfg, 1, (seed, i))
        out.append(r if got is None
                   else dataclasses.replace(r, prefix=got[1][0]))
    return out


def serve_config(args) -> ServeConfig:
    return ServeConfig(n_slots=args.batch, scheduler=args.scheduler,
                       spec_k=args.spec_k, draft_bits=args.draft_bits,
                       prefetch_depth=args.prefetch_depth,
                       host_cache_tasks=args.host_cache or None,
                       disk_load_s=args.disk_load_s,
                       install_s=args.install_s)


def run_continuous(engine, cfg, args, tasks, log: Callable = print,
                   out: Optional[dict] = None) -> bool:
    """Serve ``continuous_requests`` through ``driver.run`` and gate it:
    nothing dropped, no bubble, every budget met, no task-drain idle
    slot-step under resident; speculative replayed greedily must give the
    same tokens in fewer target steps.  ``out`` (optional) receives the
    run's ``report``, ``summary`` and, speculative, the ``greedy`` replay's
    report."""
    reqs = continuous_requests(cfg, args, tasks, log)
    config = serve_config(args)
    rep, summary = driver.run(engine, reqs, config)
    if out is not None:
        out.update(requests=reqs, report=rep, summary=summary)
    dropped = [i for i, t in enumerate(rep.tokens) if t is None]
    for i, (r, m) in enumerate(zip(reqs, rep.requests)):
        toks = m.tokens
        got = len(toks) if toks is not None else 0
        log(f"[serve] req{i:02d} task={r.task} n_new={r.n_new} "
            f"arrival={m.arrival_s:g}s {m.status} got={got} "
            f"ttft={m.ttft_s:g} sample={toks[:4] if toks else []}")
    log(f"[serve] continuous[{rep.scheduler}]: {rep.decoded} tokens in "
        f"{rep.steps} steps ({args.batch} slots) "
        f"tok/s={summary['tok_s_wall']:.0f} "
        f"bubble_slot_steps={rep.bubble_slot_steps} "
        f"idle_slot_steps={rep.idle_slot_steps} "
        f"task_drain_idle_slot_steps={rep.task_drain_idle_slot_steps} "
        f"switches={rep.switches} installs={rep.resident_installs}")
    slo = summary["slo"]
    log("[serve] slo: " + " ".join(
        f"{k}_p50={slo[k]['p50']:g} {k}_p99={slo[k]['p99']:g}"
        for k in ("ttft_s", "tpot_s", "e2e_s")))
    if rep.tier_device_hits + rep.tier_host_hits + rep.tier_disk_loads:
        log(f"[serve] tiers: device={rep.tier_device_hits} "
            f"host={rep.tier_host_hits} disk={rep.tier_disk_loads} "
            f"prefetch_issued={rep.prefetch_issued} "
            f"hidden={rep.prefetch_hidden_s:g}s "
            f"swap_wait_total={rep.swap_wait_total_s:g}s "
            f"bank_loads={rep.bank_disk_loads} "
            f"bank_evictions={rep.bank_host_evictions}")
    ok = not dropped and rep.bubble_slot_steps == 0 and all(
        toks is not None and len(toks) == r.n_new
        for r, toks in zip(reqs, rep.tokens))
    if rep.scheduler == "resident" and rep.task_drain_idle_slot_steps != 0:
        log(f"[serve] FAIL: resident scheduler idled "
            f"{rep.task_drain_idle_slot_steps} slot-steps on task drain")
        ok = False
    if rep.scheduler == "speculative":
        # replay the exact stream through the greedy scheduler: speculative
        # decoding must be token-for-token identical (the draft only picks
        # WHICH tokens get verified) and spend fewer target steps
        greedy = engine.serve(
            reqs, dataclasses.replace(config, scheduler="auto"))
        if out is not None:
            out["greedy"] = greedy
        if rep.tokens != greedy.tokens:
            log("[serve] FAIL: speculative tokens diverge from greedy")
            ok = False
        elif rep.steps >= greedy.steps:
            log(f"[serve] FAIL: speculative spent {rep.steps} target "
                f"steps vs greedy {greedy.steps}")
            ok = False
        else:
            log(f"[serve] speculative == greedy over {greedy.decoded} "
                f"tokens: target steps {rep.steps} vs {greedy.steps} "
                f"({greedy.steps / rep.steps:.2f}x), "
                f"acceptance={rep.acceptance_rate:.2f} "
                f"draft_steps={rep.draft_steps}")
    log(f"[serve] continuous {'OK' if ok else 'FAILED'}")
    return ok


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--layout", default="nibble", choices=("nibble", "plane"),
                    help="code packing: 'nibble' is 8 codes/uint32; 'plane' "
                         "stores b bit-planes so a lower-bit draft is a "
                         "buffer-prefix read (required for --scheduler "
                         "speculative)")
    ap.add_argument("--tasks", default="taskA,taskB")
    ap.add_argument("--tune-steps", type=int, default=100)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="'D,M' data×model mesh: spawn D·M ranks on "
                         "--device and serve sharded")
    ap.add_argument("--no-logitshard", action="store_true",
                    help="mesh mode: gather the decode logits over the "
                         "model axis instead of the shard-local sampler")
    ap.add_argument("--continuous", action="store_true",
                    help="serve an arrival-simulating mixed-length, "
                         "mixed-task stream through the continuously-"
                         "batched engine; exits 1 on dropped requests or "
                         "bubble steps (and, under the resident "
                         "scheduler, on ANY task-drain idle slot-step)")
    ap.add_argument("--traffic", default="steps",
                    choices=("steps",) + traffic.KINDS,
                    help="--continuous arrival process: 'steps' is the "
                         "staggered decode-step workload; 'poisson' draws "
                         "seeded arrivals at --rate req/s; 'trace' replays "
                         "--trace (or a canned burst trace)")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="poisson traffic: requests per virtual second")
    ap.add_argument("--seed", type=int, default=0,
                    help="traffic seed (arrivals, prompts, budgets)")
    ap.add_argument("--trace", default="",
                    help="trace traffic: JSON trace file to replay")
    ap.add_argument("--scheduler", default="auto",
                    choices=("auto", "resident", "drain", "speculative"),
                    help="mixed-task policy for --continuous: 'resident' "
                         "keeps stacked per-task scales on the device and "
                         "decodes mixed-task slots drain-free; 'drain' "
                         "waits the pool out before each scale swap; "
                         "'auto' picks resident when supported; "
                         "'speculative' drafts --spec-k tokens from the "
                         "--draft-bits bit-plane prefix and verifies them "
                         "in one target step (token-identical to greedy)")
    ap.add_argument("--family-smoke", action="store_true",
                    help="skip tuning and serve an untasked mixed-length "
                         "stream for THIS arch's family; exits 1 if any "
                         "request's tokens diverge from lockstep generate "
                         "or any bubble slot-step is observed")
    ap.add_argument("--spec-k", type=int, default=2,
                    help="speculative: draft tokens proposed per round")
    ap.add_argument("--draft-bits", type=int, default=None,
                    help="speculative: draft plane-prefix width "
                         "(default bits-1)")
    ap.add_argument("--bank-root", default="",
                    help="persist tuned task scales as npz files here and "
                         "serve through the TIERED bank (re-opened lazily, "
                         "tasks promoted disk→host→device on demand)")
    ap.add_argument("--host-cache", type=int, default=0,
                    help="tiered bank: max deserialized scale sets held in "
                         "the host LRU tier (0 = unbounded)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="continuous serving: distinct upcoming tasks the "
                         "admission loop warms ahead (0 disables prefetch)")
    ap.add_argument("--disk-load-s", type=float, default=0.0,
                    help="virtual seconds one disk→host task load costs")
    ap.add_argument("--install-s", type=float, default=0.0,
                    help="virtual seconds one host→device install costs")
    args = ap.parse_args(argv)
    if os.environ.get("REPRO_FAKE_DEVICES"):
        raise SystemExit(FAKE_DEVICES_REFUSAL)
    args.mesh_shape = mesh_shape(args.mesh) if args.mesh else None
    return args


def mesh_shape(text: str) -> tuple:
    """``--mesh D,M`` → (D, M), positive."""
    try:
        shape = tuple(int(x) for x in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit(f"--mesh takes 'D,M' (two positive integers), got "
                         f"{text!r}")
    return shape


def model_config(args):
    """The served config: the arch (tiny, as ``--tiny`` forces), PEQA at
    ``--bits`` with a 4-point grid, ``--layout`` and the KV cache dtype."""
    cfg = configs.get_config(args.arch)
    if args.tiny:
        cfg = configs.make_tiny(cfg)
    return cfg.replace(tuning=TuningConfig(mode="peqa"),
                       quant=QuantConfig(bits=args.bits, n_grid=4,
                                         layout=args.layout),
                       kv_cache_dtype="int8" if args.kv_int8 else "model")


def build_model(args):
    """(cfg, api, backbone, mask): the config's PEQA backbone from seed 0,
    built layer by layer on ``--device``."""
    cfg = model_config(args)
    api = registry.build(cfg, device=args.device)
    backbone, mask = policies.build(api, 0)
    return cfg, api, backbone, mask


def tune_tasks(api, backbone, mask, tasks: Sequence[str], steps: int,
               bank: ScaleBank, log: Callable = print, *,
               seeds: Optional[Sequence[tuple]] = None,
               n_tokens: int = TUNE_CORPUS,
               warmup: int = TUNE_WARMUP) -> dict:
    """Tune each task's scales from the backbone's on its own synthetic
    corpus (``steps`` PEQA steps of 8 × 64 at lr 3e-3 after ``warmup``
    steps; ``seeds``: each task's (corpus seed, batch-order seed), by
    default the CLI's (17·(i + 1), i) for task i) and ``bank.add`` them.
    The backbone is trained in place and its trainable tensors restored
    after each task, so every task starts from the same scales and the
    backbone leaves unchanged.  Returns {task: [loss of each logged
    step]}."""
    cfg = api.cfg
    if seeds is None:
        seeds = [(17 * (i + 1), i) for i in range(len(tasks))]
    saved = {n: p.detach().clone() for n, p in backbone.named_parameters()
             if mask[n]}
    losses = {}
    for task, (corpus_seed, order_seed) in zip(tasks, seeds):
        toks = synthetic.corpus(cfg.vocab_size, n_tokens, seed=corpus_seed)
        train_toks, _ = synthetic.split(toks)
        tcfg = TrainConfig(steps=steps, batch_size=TUNE_BATCH,
                           seq_len=TUNE_SEQ, log_every=10 ** 9,
                           ckpt_every=10 ** 9,
                           optim=OptimConfig(lr=TUNE_LR,
                                             warmup_steps=warmup))
        data = pipeline.Prefixed(pipeline.PackedLM(
            train_toks, TUNE_BATCH, TUNE_SEQ, seed=order_seed), cfg,
            order_seed)
        opt = make_optimizer(tcfg.optim, tcfg.steps)
        state = make_state(backbone, opt.init(
            dict(backbone.named_parameters()), mask))
        ts = step.build_train_step(api, cfg, tcfg, mask, opt)
        state, hist = loop.train(state, ts, data, tcfg, log=lambda m: None)
        losses[task] = [h["loss"] for h in hist]
        bank.add(task, state["params"])
        with torch.no_grad():
            for n, p in backbone.named_parameters():
                if n in saved:
                    p.copy_(saved[n])
        del state, opt, ts
        log(f"[serve] tuned {task}: scale payload {bank.nbytes(task):,} B")
    return losses


def open_tiered(root: str, host_cache: int, log: Callable = print
                ) -> ScaleBank:
    """Re-open a bank directory lazily (the index scan loads no payload),
    so disk→host→device promotion and the prefetcher run."""
    bank = ScaleBank(root=root, host_capacity=host_cache or None)
    log(f"[serve] tiered bank: {len(bank.tasks)} tasks indexed at "
        f"{root!r}, {bank.stats.payload_bytes_loaded} payload bytes loaded")
    return bank


def serve_lockstep(engine, args, tasks, ctx=None, log: Callable = print
                   ) -> None:
    """The round-robin lockstep loop: each task twice, ``--batch`` × 8
    prompt tokens and ``--n-new`` new ones."""
    prompt = np.tile(np.arange(8, dtype=np.int32), (args.batch, 1))
    got = pipeline.family_prefix(engine.api.cfg, args.batch, args.seed)
    prefix = None if got is None else got[1]
    if ctx is not None:
        log(f"[serve] rank rows: {tuple(place_prompt(prompt, ctx).shape)} "
            f"of {prompt.shape}")
    for task in tasks * 2:
        dt = engine.switch_task(task)
        t0 = time.perf_counter()
        out = engine.generate(prompt, n_new=args.n_new, prefix=prefix)
        gen_t = time.perf_counter() - t0
        log(f"[serve] {task}: switch={dt * 1e3:.2f}ms "
            f"gen={gen_t * 1e3:.0f}ms "
            f"tok/s={args.batch * args.n_new / gen_t:.0f} "
            f"sample={out[0, 8:16].tolist()}")


def mesh_rank(rank: int, argv, bank_root: str) -> None:
    """One rank of ``--mesh``: the mesh context, the model from the seed on
    the rank's device, its shard, the tuned bank from ``bank_root``, then
    the run; rank 0 logs.  A failed gate exits non-zero on every rank."""
    import torch.distributed as dist

    from repro_torch.dist import backend, sharding
    from repro_torch.launch import mesh as mesh_mod
    args = parse_args(argv)
    d, m = args.mesh_shape
    # the rank's own device: where backend.init placed it
    ctx = mesh_mod.make_debug_mesh(d, m)
    dev = ctx.device
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"[serve] rank 0: {backend.summary()}")
    args.device = str(dev)
    cfg, api, backbone, _ = build_model(args)
    bank = ScaleBank(root=bank_root, host_capacity=args.host_cache or None)
    tasks = args.tasks.split(",")
    local = sharding.shard_model(backbone, cfg, ctx)
    del backbone
    log(f"[serve] mesh {(d, m)}: a swap moves "
        f"{bank.local_nbytes(tasks[0], ctx, local.kv_share):,} B a rank of "
        f"{bank.nbytes(tasks[0]):,} B")
    engine = Engine(api, local, bank=bank, ctx=ctx,
                    logitshard=not args.no_logitshard)
    if args.continuous:
        ok = run_continuous(engine, cfg, args, tasks, log=log)
        flag = ctx.all_reduce(torch.tensor([int(ok)], device=dev), "data",
                              "min")
        flag = ctx.all_reduce(flag, "model", "min")
        dist.barrier()
        if not int(flag[0]):
            raise SystemExit(1)
        return
    serve_lockstep(engine, args, tasks, ctx=ctx, log=log)


def serve_mesh(args, argv) -> None:
    """``--mesh``: tune the tasks here into a bank directory, then spawn the
    ranks on ``--device`` and wait for them; exits non-zero if any rank
    fails."""
    import shutil
    import tempfile

    from torch.multiprocessing import ProcessExitedException

    from repro_torch.dist import backend
    if args.family_smoke:
        raise SystemExit("--family-smoke runs off the mesh (the other "
                         "families shard in a later slice): drop --mesh")
    d, m = args.mesh_shape
    device = args.device or "cuda"
    cfg = model_config(args)
    from repro_torch.dist import context
    try:
        registry.check_supported(cfg, mesh=context.coords(d, m))
    except NotImplementedError as e:
        raise SystemExit(f"[serve] {e}") from None
    print(f"[serve] mesh {(d, m)}: {backend.describe(device, d * m)}")
    root = args.bank_root or tempfile.mkdtemp(prefix="repro_bank_")
    try:
        _, api, backbone, mask = build_model(args)
        bank = ScaleBank(root=root)
        tune_tasks(api, backbone, mask, args.tasks.split(","),
                   args.tune_steps, bank)
        del api, backbone, mask, bank
        try:
            backend.spawn(mesh_rank, d * m, device, list(argv), root,
                          threads=1 if device == "cpu" else None)
        except ProcessExitedException as e:
            raise SystemExit(f"[serve] a mesh rank failed: {e}") from None
    finally:
        if not args.bank_root:
            shutil.rmtree(root, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.mesh_shape is not None:
        serve_mesh(args, argv)
        if args.continuous:
            raise SystemExit(0)          # every rank passed its gates
        return
    cfg, api, backbone, mask = build_model(args)
    if args.family_smoke:
        engine = Engine(api, backbone, device=args.device)
        raise SystemExit(0 if run_family_smoke(engine, cfg, args) else 1)
    tasks = args.tasks.split(",")
    bank = ScaleBank(root=args.bank_root or None)
    tune_tasks(api, backbone, mask, tasks, args.tune_steps, bank)
    if args.bank_root:
        bank = open_tiered(args.bank_root, args.host_cache)
    engine = Engine(api, backbone, bank=bank, device=args.device)
    if args.continuous:
        ok = run_continuous(engine, cfg, args, tasks)
        raise SystemExit(0 if ok else 1)
    serve_lockstep(engine, args, tasks)


if __name__ == "__main__":
    main()
