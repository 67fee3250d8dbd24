#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout
around this file; it imports nothing of JAX.  Phases, each printing one JSON
line:

  1. device  — the card, its power limit, the kernel build from
               src/repro_torch/kernels/csrc (one nvcc per source, all at
               once) and each kernel's registers, spills and shared memory
               (K5's instantiations listed apart from K1's);
  2. kernels — K1 (quant_gemv, M = 4), K2 (quant_matmul, M = 1024) and K5
               (quant_gemv_tasks, M = 8 rows over T = 4 tasks, ids
               0,1,2,3,0,1,2,3) against their plain versions at the main
               path's shapes, bf16, per-channel and group 128: error within
               ``quant_matmul.error_bound``, and every K5 row bit-equal to
               K1's under that row's task; kernel / plain / library time
               (CUDA events; weights rotated through > 2× the L2 so each
               launch reads them from HBM), and the least time the card
               could take;
  3. main    — llama3.2-1b at full width from a seeded generator, PEQA
               4-bit per-channel RTN (n_grid 20), Engine.generate with
               B = 4, a 256-token prompt and 32 new tokens; the launch
               counters must show 16 × 7 K2 launches for the prefill and
               16 × 7 K1 launches per decode step;
     profile — device kernel time (torch.profiler) against wall time for one
               prefill and one decode step: the device's busy share;
  4. step    — one main-path step's launches of each kernel over the
               model's own 112 linears (K1 at M = 4, K2 at M = 1024, K5 at
               M = 8 with T = 4), kernel / plain / library time against the
               summed bound;
  5. serve   — the same full model serving 16 requests of 4 tasks (a
               4-task ScaleBank: the base scales and three random scalings
               of them) through Engine.serve with 8 slots, under the drain
               and then the resident scheduler: identical tokens, resident
               drain-free and in fewer steps, K1 never launched under
               resident and K5 launched 112 times per decode step plus its
               prefill launches;
  6. check   — the same path at 2 layers, once through the kernels and once
               through the plain versions on the card: prefill logits within
               2⁻⁵ of their largest magnitude, and the greedy tokens that
               agree; likewise the slotted prefill (both its routes) and a
               slotted decode step over mixed tasks.

Then the card's name and power limit, the ``kernels`` summary line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed phase raises
and exits non-zero before the summary lines.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12           # CUDA cores: the kernels multiply in float32
BF16_FLOPS = 989e12         # tensor cores: the library yardstick's rate

SEED = 0
BATCH, PROMPT, NEW = 4, 256, 32
GEMV_M, GEMM_M = BATCH, BATCH * PROMPT
# K5 at the serve phase's decode shape: 8 slots over 4 resident tasks
TASKS_M, N_TASKS = 8, 4
TASK_IDS = [i % N_TASKS for i in range(TASKS_M)]
# serve phase: 16 requests cycling through the tasks; prompts of 20 tokens
# (bucketed to 32 rows: K5) and of 100 and 256 (K2 per task)
SERVE_SLOTS, SERVE_REQUESTS = 8, 16
SERVE_PROMPTS, SERVE_NEW = (20, 100, 256), (16, 32, 48)
SHAPES = ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192))
L2_BYTES = 50 * 2 ** 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """Per kernel instantiation: registers, spill bytes, shared memory."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.search(r"kernelI(.*)EEvP", m.group(1))
            cur = {"fn": args.group(1) if args else m.group(1)}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                cur["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
            if m:
                cur["regs"], cur["smem"] = int(m.group(1)), int(m.group(2))
    return rows


def timed(fn, argsets, iters: int) -> float:
    """Device ms per call: ``iters`` calls cycling through ``argsets`` are
    captured in one CUDA graph (so the host's launch cost is not timed) and
    replayed between two CUDA events, after a warm-up pass and replay."""
    import torch
    for args in argsets:                 # warm-up: builds, loads, allocates
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound_ms(m: int, n: int, k: int, groups: int, scale_sets: int = 1
             ) -> tuple:
    """Least time for one y = x·Ŵᵀ: each input read once (the codes, x, and
    ``scale_sets`` scale and zero rows — the tasks K5's rows use), the
    output written once, at HBM rate; 2·M·N·K float32 operations at the
    CUDA-core rate.  Returns (ms, "bytes" | "operations", ms at the bf16
    rate)."""
    nbytes = (m * k * 2 + n * k // 2 + scale_sets * 2 * n * groups * 4
              + m * n * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = 2 * m * n * k
    t_ops = ops / F32_FLOPS * 1e3
    t_bf16 = max(t_bytes, ops / BF16_FLOPS * 1e3)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", t_bf16
    return t_ops, "operations", t_bf16


def check_close(name, got, plain, bound) -> float:
    import torch
    err = (got.float() - plain.float()).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    bad = err > bound
    if bad.any():
        i = int(torch.argmax((err - bound).flatten()))
        fail(f"{name}: {int(bad.sum())} outputs beyond the error bound; worst "
             f"|err| {err.flatten()[i].item():.3e} > {bound.flatten()[i].item():.3e}")
    return err.max().item()


def phase_device(torch) -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    total = time.perf_counter() - t0
    info = {
        "phase": "device", "gpu": nvidia_smi(),
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": _build.nvcc(),
        "build_s": round(total, 3),
        "build": {k: {"nvcc_s": round(v["seconds"], 3),
                      "ptxas": ptxas_summary(v["ptxas"])}
                  for k, v in built.items()},
    }
    # K1 and K5 share quant_gemv.cu: K5's instantiations carry TASKS = true
    # (``Lb1E`` in the mangled template arguments)
    rows = info["build"]["quant_gemv"]["ptxas"]
    info["build"]["quant_gemv"]["ptxas"] = [r for r in rows
                                            if "Lb1E" not in r["fn"]]
    info["build"]["quant_gemv_tasks"] = {
        "source": "quant_gemv", "ptxas": [r for r in rows
                                          if "Lb1E" in r["fn"]]}
    if rows and not info["build"]["quant_gemv_tasks"]["ptxas"]:
        fail("no K5 instantiation in the quant_gemv build")
    emit(info)
    return info


def quantized_operands(torch, n, k, group, gen):
    """A realistic quantized layer: RTN codes of N(0, 1/K) weights."""
    from repro_torch.core.quant import QuantSpec, pack_codes, rtn_quantize
    w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
    q, s, z = rtn_quantize(w, QuantSpec(bits=4, group_size=group), n_grid=20)
    return pack_codes(q), s.contiguous(), z.contiguous()


def task_stacks(torch, s, z, n_tasks, gen):
    """(T, N, G) scale and zero stacks: task 0 is (s, z), the others scale
    every s by a factor in [0.9, 1.1] (the serve phase's random tasks)."""
    ss = [s] + [s * (0.9 + 0.2 * torch.rand(s.shape, generator=gen,
                                            device=s.device))
                for _ in range(n_tasks - 1)]
    return (torch.stack(ss).contiguous(),
            torch.stack([z] * n_tasks).contiguous())


def plain_tasks(qm, tasks):
    """K5's plain version over a known task list: the same dots and
    selects as ``quant_matmul_tasks_plain`` without its host read of the
    distinct ids, so a CUDA graph can capture it for timing."""
    import torch

    def run(x, qw, ss, zs, ids):
        y = None
        for t in tasks:
            yt = qm.quant_matmul_plain(x, qw, ss[t], zs[t])
            y = yt if y is None else torch.where((ids == t)[:, None], yt, y)
        return y
    return run


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.ref import dequant_ref
    from repro_torch.core.quant import QuantSpec

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"quant_gemv": 0.0, "quant_matmul": 0.0, "quant_gemv_tasks": 0.0}
    for (n, k) in SHAPES:
        for group in (None, 128):
            qw, s, z = quantized_operands(torch, n, k, group, gen)
            g = s.shape[1]
            w16 = dequant_ref(qw, s, z, (n, k), QuantSpec(), torch.bfloat16)
            for name, fn, m in (("quant_gemv", qm.quant_gemv, GEMV_M),
                                ("quant_matmul", qm.quant_matmul, GEMM_M)):
                x = torch.randn(m, k, generator=gen, device="cuda"
                                ).to(torch.bfloat16)
                got = fn(x, qw, s, z)
                plain = qm.quant_matmul_plain(x, qw, s, z)
                torch.cuda.synchronize()
                err = check_close(f"{name} M={m} N={n} K={k} group={group}",
                                  got, plain, qm.error_bound(x, qw, s, z, plain))
                worst[name] = max(worst[name], err)
                # rotate weight copies through > 2x the L2 cache so every
                # launch streams its weights from HBM, as the model's does
                copies = max(2, math.ceil(2 * L2_BYTES / (n * k // 2)))
                sets = [(x, qw.clone(), s.clone(), z.clone())
                        for _ in range(copies)]
                lib_copies = max(2, math.ceil(2 * L2_BYTES / (n * k * 2)))
                lib_sets = [(x, w16.clone()) for _ in range(lib_copies)]
                iters = 200 if m == GEMV_M else 20
                ms = timed(fn, sets, iters)
                plain_ms = timed(qm.quant_matmul_plain, sets,
                                 max(10, iters // 4))
                lib_ms = timed(lambda a, b: torch.matmul(a, b.T), lib_sets,
                               iters)
                b_ms, b_by, b_bf16 = bound_ms(m, n, k, g)
                emit({"phase": "kernels", "kernel": name, "M": m, "N": n,
                      "K": k, "group": group, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_bf16_ms": b_bf16})
                del sets, lib_sets
            worst["quant_gemv_tasks"] = max(
                worst["quant_gemv_tasks"],
                kernel_k5(torch, qm, n, k, group, qw, s, z, gen))
            del qw, s, z, w16
            torch.cuda.empty_cache()
    return worst


def kernel_k5(torch, qm, n, k, group, qw, s, z, gen) -> float:
    """K5 at the serve decode shape: within the bound of its plain version,
    and every row bit-equal to K1's under that row's task."""
    ss, zs = task_stacks(torch, s, z, N_TASKS, gen)
    ids = torch.tensor(TASK_IDS, dtype=torch.int32, device="cuda")
    x = torch.randn(TASKS_M, k, generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    got = qm.quant_gemv_tasks(x, qw, ss, zs, ids)
    plain = qm.quant_matmul_tasks_plain(x, qw, ss, zs, ids)
    torch.cuda.synchronize()
    what = f"quant_gemv_tasks M={TASKS_M} T={N_TASKS} N={n} K={k} group={group}"
    err = check_close(what, got, plain,
                      qm.error_bound(x, qw, ss, zs, plain, task_ids=ids))
    for t in range(N_TASKS):
        rows = (ids == t).nonzero().flatten()
        k1 = qm.quant_gemv(x, qw, ss[t], zs[t])
        if not torch.equal(got[rows], k1[rows]):
            fail(f"{what}: rows of task {t} differ from K1 under its scales")
    copies = max(2, math.ceil(2 * L2_BYTES / (n * k // 2)))
    sets = [(x, qw.clone(), ss.clone(), zs.clone(), ids)
            for _ in range(copies)]
    ms = timed(qm.quant_gemv_tasks, sets, 200)
    # yardstick: K1 at the same M under one task's scales
    k1_ms = timed(qm.quant_gemv, [(a[0], a[1], a[2][0], a[3][0])
                                  for a in sets], 200)
    plain_ms = timed(plain_tasks(qm, range(N_TASKS)), sets, 20)
    b_ms, b_by, b_bf16 = bound_ms(TASKS_M, n, k, s.shape[1],
                                  scale_sets=len(set(TASK_IDS)))
    emit({"phase": "kernels", "kernel": "quant_gemv_tasks", "M": TASKS_M,
          "T": N_TASKS, "N": n, "K": k, "group": group, "max_abs_err": err,
          "rows_bitwise_k1": True, "ms": ms, "k1_same_m_ms": k1_ms,
          "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
          "bound_by": b_by, "bound_bf16_ms": b_bf16})
    return err


def phase_main(torch) -> dict:
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    from repro_torch.core import policies
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models import registry
    from repro_torch.train.serve import Engine

    cfg = configs.get_config("llama3.2-1b").replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20))
    api = registry.build(cfg)
    t0 = time.perf_counter()
    model = api.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, mask = policies.prepare(model, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    engine = Engine(api, model)
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    engine.generate(prompt, 2)                       # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    qm.quant_gemv.launches = 0
    qm.quant_matmul.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompt, NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"quant_gemv": qm.quant_gemv.launches,
                "quant_matmul": qm.quant_matmul.launches}
    peak = torch.cuda.max_memory_allocated()

    n_lin = cfg.n_layers * 7
    steps = NEW - 1                  # the last token needs no decode step
    if launches["quant_matmul"] != n_lin:
        fail(f"prefill launched K2 {launches['quant_matmul']} times, "
             f"expected {n_lin}")
    if launches["quant_gemv"] != n_lin * steps:
        fail(f"decode launched K1 {launches['quant_gemv']} times, expected "
             f"{n_lin} x {steps} steps")
    if tuple(out.shape) != (BATCH, PROMPT + NEW):
        fail(f"generate returned {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT].cpu(), prompt):
        fail("generate changed the prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail("generated token ids outside the vocabulary")

    # the prefill alone, for the split of the wall time
    with torch.inference_mode():
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = api.prefill(engine.model,
                                    {"tokens": prompt.to("cuda")})
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
    if not torch.isfinite(logits).all():
        fail("non-finite prefill logits")
    prefill_s = sorted(pre)[1]
    res = {"phase": "main", "model": cfg.name, "layers": cfg.n_layers,
           "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
           "init_s": init_s, "quantize_s": quant_s,
           "generate_s": total_s, "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_step": (total_s - prefill_s) * 1e3 / steps,
           "tokens_per_s": BATCH * NEW / total_s,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "trainable_scales": sum(int(p.numel()) for name, p
                                   in engine.model.named_parameters()
                                   if mask[name])}
    emit(res)
    return {"res": res, "model": engine.model, "cfg": cfg, "api": api,
            "prompt": prompt}


def device_ms(torch, fn) -> tuple:
    """(device kernel ms, top kernels) of one call of ``fn`` under the
    profiler's CUDA tracing; the ms is None when it records no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()]
    total = sum(t for _, t in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return (total or None), [{"kernel": k[:80], "ms": t / 1e3} for k, t in top]


def phase_profile(torch, main_path) -> dict:
    """Where one prefill's and one decode step's time goes: device kernel
    time (profiler) against the wall time of the same call."""
    api, model, prompt = main_path["api"], main_path["model"], main_path["prompt"]
    res = {"phase": "profile"}
    with torch.inference_mode():
        tokens = prompt.to("cuda")
        logits, pcache = api.prefill(model, {"tokens": tokens})
        cache = api.init_cache(BATCH, PROMPT + 8)
        for key in cache:
            cache[key][:, :, :PROMPT] = pcache[key]
        nxt = torch.argmax(logits, -1)[:, None]
        calls = {
            "prefill": lambda: api.prefill(model, {"tokens": tokens}),
            "decode_step": lambda: api.decode_step(model, cache, nxt, PROMPT),
        }
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            dev, top = device_ms(torch, fn)
            res[name] = {"wall_ms": wall, "device_ms": dev,
                         "device_busy_share": dev / wall if dev else None,
                         "top": top}
    emit(res)
    return res


def phase_step(torch, model) -> dict:
    """One main-path step's launches of each kernel, over the model's own
    linears in model order (486 MB of codes: cold in L2 by size)."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.ref import dequant_ref
    from repro_torch.models.linear import Linear

    lins = [m for m in model.modules() if isinstance(m, Linear) and m.quantized]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    xs = {}
    out = {}
    for name, fn, m, reps in (("quant_gemv", qm.quant_gemv, GEMV_M, 20),
                              ("quant_matmul", qm.quant_matmul, GEMM_M, 3)):
        for lin in lins:
            k = lin.in_features
            if (m, k) not in xs:
                xs[(m, k)] = torch.randn(m, k, generator=gen, device="cuda"
                                         ).to(torch.bfloat16)
        ops = [(xs[(m, l.in_features)], l.qw, l.scale.detach(),
                l.zero.detach()) for l in lins]

        def run(f=fn, ops=ops):
            for a in ops:
                f(*a)

        def run_plain(ops=ops):
            for a in ops:
                qm.quant_matmul_plain(*a)

        ms = timed(run, [()], reps)
        plain_ms = timed(run_plain, [()], max(2, reps // 4))
        w16 = [dequant_ref(l.qw, l.scale.detach(), l.zero.detach(),
                           (l.out_features, l.in_features), l.spec,
                           torch.bfloat16) for l in lins]
        lib = [(a[0], w) for a, w in zip(ops, w16)]

        def run_lib(lib=lib):
            for a, w in lib:
                torch.matmul(a, w.T)

        lib_ms = timed(run_lib, [()], reps)
        del w16, lib
        torch.cuda.empty_cache()
        b = [bound_ms(m, l.out_features, l.in_features, l.scale.shape[1])
             for l in lins]
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": sum(t for t, _, _ in b),
                     "bound_by": b[0][1],
                     "bound_bf16_ms": sum(t for _, _, t in b),
                     "launches": len(lins)}
        emit({"phase": "step", "kernel": name, "M": m, **out[name]})
    out["quant_gemv_tasks"] = step_k5(torch, qm, lins, gen)
    return out


def step_k5(torch, qm, lins, gen) -> dict:
    """One resident decode step's K5 launches: the model's 112 linears at
    M = 8 slots over T = 4 task stacks.  No single PyTorch call applies
    per-row task scales, so there is no library time."""
    ids = torch.tensor(TASK_IDS, dtype=torch.int32, device="cuda")
    xs = {k: torch.randn(TASKS_M, k, generator=gen, device="cuda"
                         ).to(torch.bfloat16)
          for k in {l.in_features for l in lins}}
    ops = [(xs[l.in_features], l.qw,
            *task_stacks(torch, l.scale.detach(), l.zero.detach(), N_TASKS,
                         gen), ids) for l in lins]
    plain = plain_tasks(qm, range(N_TASKS))

    def run():
        for a in ops:
            qm.quant_gemv_tasks(*a)

    def run_k1():
        for a in ops:
            qm.quant_gemv(a[0], a[1], a[2][0], a[3][0])

    def run_plain():
        for a in ops:
            plain(*a)

    ms = timed(run, [()], 20)
    k1_ms = timed(run_k1, [()], 20)         # yardstick: K1 at the same M
    plain_ms = timed(run_plain, [()], 2)
    b = [bound_ms(TASKS_M, l.out_features, l.in_features, l.scale.shape[1],
                  scale_sets=len(set(TASK_IDS))) for l in lins]
    res = {"ms": ms, "k1_same_m_ms": k1_ms, "plain_ms": plain_ms,
           "library_ms": None,
           "bound_ms": sum(t for t, _, _ in b), "bound_by": b[0][1],
           "bound_bf16_ms": sum(t for _, _, t in b), "launches": len(lins)}
    emit({"phase": "step", "kernel": "quant_gemv_tasks", "M": TASKS_M,
          "T": N_TASKS, **res})
    del ops
    torch.cuda.empty_cache()
    return res


def serve_requests(vocab: int) -> list:
    """16 requests cycling through the 4 tasks, arriving every 2 decode
    steps; prompt lengths 20, 100, 256 and budgets 16, 32, 48 in turn."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 3)
    return [Request(
        tokens=rng.integers(0, vocab, SERVE_PROMPTS[i % 3]),
        n_new=SERVE_NEW[(i + 1) % 3], task=f"t{i % N_TASKS}",
        arrival_step=2 * i) for i in range(SERVE_REQUESTS)]


def profile_serve_step(torch, engine, step, reqs, slotted) -> dict:
    """Wall and device time of one decode step of a full pool (8 slots,
    20-token prompts; the resident pool's slots over the 4 tasks)."""
    from repro_torch.serve import Request
    pool = engine.open_pool(SERVE_SLOTS, max(r.n_prompt + r.n_new
                                             for r in reqs))
    pool.slotted = slotted
    for i in range(SERVE_SLOTS):
        r = reqs[3 * (i % 6)]                    # the 20-token prompts
        if slotted:
            row = engine.resident.ensure(r.task)
            pool.tid[engine.admit(pool, r, task_row=row)] = row
        else:                                    # the live task's scales
            engine.admit(pool, Request(tokens=r.tokens, n_new=r.n_new))
    step(pool)                                   # warm
    t0 = time.perf_counter()
    step(pool)
    wall = (time.perf_counter() - t0) * 1e3
    dev, top = device_ms(torch, lambda: step(pool))
    return {"wall_ms": wall, "device_ms": dev,
            "device_busy_share": dev / wall if dev else None, "top": top}


def phase_serve(torch, main_path) -> dict:
    """Drain vs resident on the full model: same tokens; resident through
    K5 (decode and short prefills) and K2 per task (long prefills), never
    K1.  Each run starts with the launch counters at 0."""
    import numpy as np
    from repro_torch.core.scale_bank import ScaleBank
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.serve import ServeConfig
    from repro_torch.train.serve import Engine

    api, model, cfg = main_path["api"], main_path["model"], main_path["cfg"]
    bank = ScaleBank()
    bank.add("t0", model)
    rng = np.random.default_rng(SEED)
    for t in range(1, N_TASKS):
        bank.tasks[f"t{t}"] = {
            k: (v * rng.uniform(0.9, 1.1, v.shape)).astype(v.dtype)
            for k, v in bank.tasks["t0"].items()}
    reqs = serve_requests(cfg.vocab_size)
    n_lin = cfg.n_layers * 7
    short = sum(r.n_prompt <= 32 for r in reqs)    # prefills of <= 32 rows
    kernels = (qm.quant_gemv, qm.quant_matmul, qm.quant_gemv_tasks)
    res, reports = {"phase": "serve", "requests": len(reqs),
                    "slots": SERVE_SLOTS, "tasks": N_TASKS}, {}
    for sched in ("drain", "resident"):
        engine = Engine(api, model, bank=bank)
        calls = {"n": 0, "s": 0.0}
        step = engine.step

        def counted(pool, _step=step, _calls=calls):
            t0 = time.perf_counter()
            out = _step(pool)                 # ends in a host sync
            _calls["s"] += time.perf_counter() - t0
            _calls["n"] += 1
            return out
        engine.step = counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        rep = engine.serve(reqs, ServeConfig(
            n_slots=SERVE_SLOTS, scheduler=sched, resident_tasks=N_TASKS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        reports[sched] = rep
        res[sched] = {
            "steps": rep.steps, "step_calls": calls["n"],
            "switches": rep.switches,
            "task_drain_idle_slot_steps": rep.task_drain_idle_slot_steps,
            "resident_installs": rep.resident_installs,
            "prefill_compiles": rep.prefill_compiles, "decoded": rep.decoded,
            "wall_s": wall, "decode_ms_per_step": calls["s"] * 1e3 / calls["n"],
            "tokens_per_s": rep.decoded / wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}
        for i, (r, toks) in enumerate(zip(reqs, rep.tokens)):
            if toks is None or len(toks) != r.n_new:
                fail(f"{sched}: request {i} served {toks and len(toks)} of "
                     f"{r.n_new} tokens")
            if min(toks) < 0 or max(toks) >= cfg.vocab_size:
                fail(f"{sched}: request {i} has token ids outside the "
                     f"vocabulary")
        # decode steps go through the GEMV of the scheduler, prefills of
        # <= 32 rows too; longer prefills through K2 (one task each)
        gemv = "quant_gemv_tasks" if sched == "resident" else "quant_gemv"
        other = "quant_gemv" if sched == "resident" else "quant_gemv_tasks"
        want = {gemv: n_lin * (calls["n"] + short), other: 0,
                "quant_matmul": n_lin * (len(reqs) - short)}
        if launches != want:
            fail(f"{sched}: kernel launches {launches}, expected {want}")
        res[sched]["profile_step"] = profile_serve_step(
            torch, engine, step, reqs, sched == "resident")
    engine.switch_task("t0")                  # the model's own scales back
    dr, rr = reports["drain"], reports["resident"]
    if rr.tokens != dr.tokens:
        diff = sum(a != b for a, b in zip(rr.tokens, dr.tokens))
        fail(f"resident and drain tokens differ in {diff} of {len(reqs)} "
             f"requests")
    if rr.task_drain_idle_slot_steps != 0 or dr.task_drain_idle_slot_steps <= 0:
        fail(f"task-drain idle slot-steps: resident "
             f"{rr.task_drain_idle_slot_steps} (want 0), drain "
             f"{dr.task_drain_idle_slot_steps} (want > 0)")
    if not rr.steps < dr.steps:
        fail(f"resident took {rr.steps} steps, drain {dr.steps}")
    if rr.switches != 0:
        fail(f"resident made {rr.switches} scale switches")
    res["tokens_equal"] = True
    emit(res)
    return res


def phase_check(torch, cfg) -> dict:
    """2 layers at full width: kernels vs plain versions on the card."""
    from repro_torch.core import policies
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train.serve import Engine

    cfg2 = cfg.replace(n_layers=2)
    api = registry.build(cfg2)
    model, _ = policies.prepare(api.init(SEED), cfg2)
    engine = Engine(api, model)
    gen = torch.Generator().manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg2.vocab_size, (BATCH, PROMPT), generator=gen)
    runs = {}
    for impl in ("cuda", "torch"):
        with ops.force_impl(impl), torch.inference_mode():
            logits, _ = api.prefill(model, {"tokens": prompt.to("cuda")})
            toks = engine.generate(prompt, NEW)
        runs[impl] = (logits.float(), toks[:, PROMPT:])
    lk, tk = runs["cuda"]
    lp, tp = runs["torch"]
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail("non-finite logits in the 2-layer check")
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    tol = 2.0 ** -5 * scale
    if diff > tol:
        fail(f"2-layer prefill logits: kernels vs plain differ by {diff:.3e}"
             f" > {tol:.3e}")
    agree = (tk == tp).float().mean().item()
    prefix = [int((tk[b] != tp[b]).nonzero()[0]) if (tk[b] != tp[b]).any()
              else NEW for b in range(BATCH)]
    res = {"phase": "check", "layers": 2, "logits_max_abs_diff": diff,
           "logits_max_abs": scale, "tolerance": tol,
           "greedy_tokens_equal_share": agree,
           "greedy_equal_prefix_per_row": prefix,
           "slotted": check_slotted(torch, api, model, cfg2)}
    emit(res)
    return res


def check_slotted(torch, api, model, cfg) -> dict:
    """The slotted prefill (20 tokens: K5; 100 tokens: K2 per task) and a
    mixed-task decode step of 8 slots, kernels against plain versions."""
    import numpy as np
    from repro_torch.core.scale_bank import ResidentStack, ScaleBank
    from repro_torch.kernels import ops

    bank = ScaleBank()
    bank.add("t0", model)
    rng = np.random.default_rng(SEED + 4)
    for t in range(1, N_TASKS):
        bank.tasks[f"t{t}"] = {
            k: (v * rng.uniform(0.9, 1.1, v.shape)).astype(v.dtype)
            for k, v in bank.tasks["t0"].items()}
    stack = ResidentStack(bank, model, N_TASKS,
                          warm=[f"t{t}" for t in range(N_TASKS)]).stack
    gen = torch.Generator().manual_seed(SEED + 5)
    ids = torch.tensor(TASK_IDS, dtype=torch.int32, device="cuda")
    pos = torch.arange(TASKS_M, device="cuda") * 7 + 3
    toks = torch.randint(0, cfg.vocab_size, (TASKS_M, 1), generator=gen
                         ).to("cuda")
    out = {}
    for name, s in (("prefill_k5", 20), ("prefill_k2", 100), ("decode", 0)):
        logits = {}
        for impl in ("cuda", "torch"):
            with ops.force_impl(impl), torch.inference_mode():
                if s:
                    prompt = torch.randint(0, cfg.vocab_size, (1, s),
                                           generator=torch.Generator()
                                           .manual_seed(s)).to("cuda")
                    lg, _ = api.prefill_slotted(model, stack,
                                                {"tokens": prompt}, ids[2:3])
                else:
                    cache = api.init_cache(TASKS_M, 64)
                    for key in cache:
                        cache[key].normal_(generator=torch.Generator(
                            device="cuda").manual_seed(SEED))
                    lg, _ = api.decode_step_slotted(model, stack, cache, toks,
                                                    pos, ids)
            logits[impl] = lg.float()
        lk, lp = logits["cuda"], logits["torch"]
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            fail(f"non-finite logits in the 2-layer slotted {name}")
        diff = (lk - lp).abs().max().item()
        tol = 2.0 ** -5 * lp.abs().max().item()
        if diff > tol:
            fail(f"2-layer slotted {name}: kernels vs plain differ by "
                 f"{diff:.3e} > {tol:.3e}")
        out[name] = {"max_abs_diff": diff, "tolerance": tol}
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no repro_torch package under {src}: run from the repository")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    dev = phase_device(torch)
    worst_err = phase_kernels(torch)
    main_path = phase_main(torch)
    phase_profile(torch, main_path)
    with torch.inference_mode():
        step = phase_step(torch, main_path["model"])
    serve = phase_serve(torch, main_path)
    phase_check(torch, main_path["cfg"])
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        fail("the port loaded JAX or the JAX package")

    source = "src/repro_torch/kernels/csrc/{}.cu"
    replaces = {
        "quant_gemv": "src/repro/kernels/quant_matmul.py:290",
        "quant_matmul": "src/repro/kernels/quant_matmul.py:170",
        "quant_gemv_tasks": "src/repro/kernels/quant_matmul.py:364",
    }
    # each kernel's launches on the path that runs it: K1 and K2 on the
    # lockstep main path, K5 on the resident serve path
    launches = dict(main_path["res"]["launches"])
    launches["quant_gemv_tasks"] = \
        serve["resident"]["launches"]["quant_gemv_tasks"]
    kernels = []
    for name in ("quant_gemv", "quant_matmul", "quant_gemv_tasks"):
        st = step[name]
        if launches[name] < 1:
            fail(f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": source.format("quant_gemv" if name == "quant_gemv_tasks"
                                    else name),
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": worst_err[name],
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": st["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(dev["gpu"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
