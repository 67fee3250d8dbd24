"""Lockstep decoding's wall and device time, repeated, and the device work
one decode step launches.

    python src/repro_torch/train/lockstep_probe.py [--label NAME]

Needs the card.  Runs the lockstep path of ``chip_smoke.py`` phase
``main`` (llama3.2-1b at full width and depth, random weights from seed 0,
PEQA 4-bit per-channel, 4 prompts of 256 tokens, 32 greedy tokens) with
``repro_torch`` taken from ``sys.path``, so it times whichever tree's port
is first there (run it with ``PYTHONPATH=<tree>/src`` to time another
checkout).  Prints one JSON line: the wall seconds of each of ``REPEATS``
``generate`` calls, of each of ``REPEATS`` prefills and of each of
``STEPS`` decode steps, and for one decode step under the profiler its
device ms, the kernels the device ran and the CUDA launch calls the host
made (``cudaLaunchKernel*``), by name.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

SEED, BATCH, PROMPT, NEW = 0, 4, 256, 32
REPEATS, STEPS = 5, 20


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _walls(torch, fn, n: int) -> list:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _profile(torch, fn) -> dict:
    """Device ms, device kernels and host launch calls of one ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, launches, dev_us = {}, {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name[:60]] = kernels.get(e.name[:60], 0) + 1
            dev_us += e.time_range.elapsed_us()
        elif e.name.startswith("cudaLaunchKernel"):
            launches[e.name] = launches.get(e.name, 0) + 1
    return {"device_ms": dev_us / 1e3,
            "device_kernels": sum(kernels.values()),
            "host_launch_calls": sum(launches.values()),
            "launch_calls_by_name": launches,
            "kernels_by_name": dict(sorted(kernels.items(),
                                           key=lambda kv: -kv[1]))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    from repro_torch.core import policies
    from repro_torch.models import registry
    from repro_torch.train.serve import Engine

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cfg = configs.get_config("llama3.2-1b").replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20))
    api = registry.build(cfg)
    model, _ = policies.build(api, SEED)
    engine = Engine(api, model)
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    engine.generate(prompt, 2)                       # warm-up
    res = {"label": args.label, "card": _card(),
           "generate_s": _walls(torch, lambda: engine.generate(prompt, NEW),
                                REPEATS)}
    with torch.inference_mode():
        tokens = prompt.to("cuda")
        model = engine.model
        logits, pcache = api.prefill(model, {"tokens": tokens})
        cache = api.init_cache(BATCH, PROMPT + 8)
        for key in cache:
            cache[key][:, :, :PROMPT] = pcache[key]
        nxt = torch.argmax(logits, -1)[:, None]

        def step():
            return api.decode_step(model, cache, nxt, PROMPT)

        res["prefill_s"] = _walls(
            torch, lambda: api.prefill(model, {"tokens": tokens}), REPEATS)
        step()
        res["decode_step_s"] = _walls(torch, step, STEPS)
        res["decode_step_profile"] = _profile(torch, step)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
