#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout
around this file; it imports nothing of JAX.  Phases, each printing one JSON
line:

  1. device  — the card, its power limit, the kernel build from
               src/repro_torch/kernels/csrc (one nvcc per source, all at
               once) and each kernel's registers, spills and shared memory;
  2. kernels — K1 (quant_gemv, M = 4) and K2 (quant_matmul, M = 1024)
               against their plain version at the main path's shapes, bf16,
               per-channel and group 128: error within
               ``quant_matmul.error_bound``, kernel / plain / library time
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
               model's own 112 linears (K1 at M = 4, K2 at M = 1024),
               kernel / plain / library time against the summed bound;
  5. check   — the same path at 2 layers, once through the kernels and once
               through the plain versions on the card: prefill logits within
               2⁻⁵ of their largest magnitude, and the greedy tokens that
               agree.

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


def bound_ms(m: int, n: int, k: int, groups: int) -> tuple:
    """Least time for one y = x·Ŵᵀ: each input read once, the output
    written once, at HBM rate; 2·M·N·K float32 operations at the CUDA-core
    rate.  Returns (ms, "bytes" | "operations", ms at the bf16 rate)."""
    nbytes = m * k * 2 + n * k // 2 + 2 * n * groups * 4 + m * n * 2
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
    emit(info)
    return info


def quantized_operands(torch, n, k, group, gen):
    """A realistic quantized layer: RTN codes of N(0, 1/K) weights."""
    from repro_torch.core.quant import QuantSpec, pack_codes, rtn_quantize
    w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
    q, s, z = rtn_quantize(w, QuantSpec(bits=4, group_size=group), n_grid=20)
    return pack_codes(q), s.contiguous(), z.contiguous()


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.ref import dequant_ref
    from repro_torch.core.quant import QuantSpec

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"quant_gemv": 0.0, "quant_matmul": 0.0}
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
            del qw, s, z, w16
            torch.cuda.empty_cache()
    return worst


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
    return out


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
           "greedy_equal_prefix_per_row": prefix}
    emit(res)
    return res


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
    phase_check(torch, main_path["cfg"])
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        fail("the port loaded JAX or the JAX package")

    source = "src/repro_torch/kernels/csrc/{}.cu"
    replaces = {
        "quant_gemv": "src/repro/kernels/quant_matmul.py:290",
        "quant_matmul": "src/repro/kernels/quant_matmul.py:170",
    }
    kernels = []
    for name in ("quant_gemv", "quant_matmul"):
        st = step[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source.format(name),
            "replaces": replaces[name],
            "launches": main_path["res"]["launches"][name],
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
