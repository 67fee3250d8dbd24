#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout
around this file; it imports nothing of JAX.  Phases, each printing one JSON
line:

  1. device  — the card, its power limit, the kernel build from
               src/repro_torch/kernels/csrc (one nvcc per source, all at
               once) and each kernel's registers, spills and shared memory
               (listed per wrapper: K1, K5, K2, the three K6a plane
               kernels, K3, K6b and K4; K2's wgmma, the four GEMVs' mma
               and K4's mma.sync instantiations must be there, with the
               dynamic shared memory of K2's and K4's and, where cuobjdump
               is, their HGMMA / HMMA instructions counted in the SASS);
  2. kernels — K1 (quant_gemv, M = 4), K2 (quant_matmul, M = 1024) and K5
               (quant_gemv_tasks, M = 8 rows over T = 4 tasks, ids
               0,1,2,3,0,1,2,3) against their plain versions at the main
               path's shapes, bf16, per-channel and group 128, each launch
               on its tensor-core route ("route": "mma" for the GEMVs,
               "wgmma" for K2; K1 also at f32 x, "simt"): error within the
               factored ``quant_matmul.error_bound`` of the plain version
               and of the route's emulation (``quant_gemv_factored_plain``,
               ``quant_matmul_factored_plain``), every K5 row bit-equal to
               K1's under that row's task, and K1's and K5's rows at M = 1,
               2, 4, 8, 16 bit-equal to the same rows at M = 32 (both
               routes for K1); kernel / plain / library time
               (CUDA events; weights rotated through > 2× the L2 so each
               launch reads them from HBM), and the least time the card
               could take (bytes for every GEMV: its tensor-core work
               falls under them), torch.matmul at the GEMV's M beside K5
               and the GEMV plane kernels.  Then K6a, the plane branch of each, on the
               same codes stored as 4 bit-planes, read whole (p = 4) and as
               the 3-plane draft (p = 3): K1-plane at M = 8 and 32,
               K5-plane at M = 8 over 4 tasks, K2-plane at M = 1024 —
               within the bound of its plain version and bit-equal to its
               nibble kernel on the codes q >> (4 − p) under draft_scales.
               K3 and K6b at the same shapes on bf16 weights, and per-
               channel on f32 weights, 4 and 3 bits: bit-equal to their
               plain version.  K4 at llama3.2-1b's heads (32 query, 8 KV
               heads of 64): the prefill (B 4, 256 tokens, causal), the
               lockstep decode (B 4, Sq 1, generate's PROMPT + NEW cache,
               an int position), the slot pool's decode and verify (B 8,
               Sq 1 and 4, caches of 512 and of a speculative pool's 307
               rows, offsets spread over [20, 300]), a decode and a verify
               deep in a 4096-key cache, a window and a non-causal case,
               within flash_attention.error_bound of its plain version
               (and its distance from the emulation of its split-P,
               split-KV arithmetic), each decode and verify also timed at
               splits of 64, 128 and 256 keys,
               scaled_dot_product_attention timed beside it as a
               yardstick.  Then the dense family at 7B: K1 (M = 4), K2
               (M = 1024) and K5 (M = 8, T = 4) at the four linears
               (N, K) of qwen2-7b — (3584, 3584), (512, 3584), (18944,
               3584), (3584, 18944) —, starcoder2-7b — (4608, 4608),
               (512, 4608), (18432, 4608), (4608, 18432) — and granite-34b
               — (6144, 6144), its MQA k/v (128, 6144), (24576, 6144),
               (6144, 24576) —, per-channel, within the factored bound of
               plain, K1's rows bitwise across M and its K split the
               mirror's, timed beside torch.matmul and the bound; K4 at
               head dim 128 with qwen2-7b's (28 / 4), starcoder2-7b's
               (36 / 4) and granite-34b's (48 / 1) heads: the prefill (B 4
               × 256), the lockstep decode, the slot pool's decode and
               verify and a ring's decode (offset past every key).
               Then the moe family: K1 and K2 at deepseek-moe-16b's new
               2-D linears — its experts' (1408, 2048) and (2048, 1408)
               (22 64-code tiles, 11 groups of 128: shapes K2's 256-wide
               tile and the GEMV's K split had not met) and its shared
               MLP's (2816, 2048) and (2048, 2816) —, K4 at its 16 / 16
               heads of 128; and each model's experts on the expert grid
               axis (``quant_gemv_experts`` at C = 1, ``quant_matmul_
               experts`` at the prefill's C = 320 for mixtral-8x7b's 8
               experts of (14336, 4096) and (4096, 14336), C = 120 for
               deepseek's 64 of (1408, 2048) and (2048, 1408)): every
               slice bit-equal to the 2-D kernel on its expert and within
               the factored bound of plain, timed as one launch, as E 2-D
               launches (a yardstick), as the plain version and as
               ``torch.bmm`` on a dequantized bf16 Ŵ stack, beside the
               bound;
  3. main    — llama3.2-1b at full width from a seeded generator, PEQA
               4-bit per-channel RTN (n_grid 20) through the layer-by-layer
               build (``policies.build``, as every PEQA model of the run
               but phase convert's, which times conversions of an fp
               model), Engine.generate with
               B = 4, a 256-token prompt and 32 new tokens; the launch
               counters must show 16 × 7 K2 launches for the prefill and
               16 × 7 K1 and 16 K4 launches per decode step (on the card
               the dense decode attention is K4);
     profile — device kernel time (torch.profiler) against wall time for one
               prefill and one decode step: the device's busy share;
  4. step    — one main-path step's launches of each kernel over the
               model's own 112 linears (K1 at M = 4, K2 at M = 1024, K5 at
               M = 8 with T = 4), kernel / plain / library time against the
               summed bound; and over the same linears repacked into bit-
               planes, K6a: a resident draft step (K5-plane, M = 8, p = 3),
               a resident verify (K5-plane, M = 32, p = 4), an untasked
               draft step and verify (K1-plane, M = 8, p = 3 and M = 32,
               p = 4) and a prefill (K2-plane, M = 1024, p = 4), each GEMV
               beside torch.matmul at its M; every launch on its
               tensor-core route;
  5. serve   — the same full model serving 16 requests of 4 tasks (a
               4-task ScaleBank: the base scales and three random scalings
               of them) through Engine.serve with 8 slots, under the drain
               and then the resident scheduler, each pool at Engine.serve's
               own capacity (304 rows): identical tokens, resident
               drain-free and in fewer steps, K1 never launched under
               resident and K5 launched 112 times per decode step plus its
               prefill launches, K4 16 times per decode step; the resident
               run repeated in a pool of LONG_CACHE (1100) rows serves the
               same tokens;
  6. speculative — the same model with its codes repacked into 4 bit-
               planes (scales shared by value), serving phase serve's 16
               requests: (a) resident, whose tokens must equal phase
               serve's; (b) speculative over resident, spec_k 3, a 3-plane
               draft; (c) speculative without tasks.  Gates: the launch
               counters (no nibble kernel; K5-plane or K1-plane 112 times
               per draft step, verify and short prefill; K2-plane per long
               prefill; K4 16 times per draft step and verify), the
               speculative pools at 307 rows against the greedy ones' 304,
               draft steps = 3 × rounds, full budgets, no
               task-drain wait in (b), the verify logits of (b)'s first
               full round bit-equal to the same tokens decoded one step at
               a time, that round's first draft step replayed proposing the
               same tokens, (b)'s tokens equal to (a)'s and (c)'s to (d)
               the same untasked requests decoded greedily, and (b)'s peak
               memory within 5% of the code bytes of (a)'s (the draft reads
               the target's planes);
  7. convert — the same model quantized with QuantConfig(n_grid=1), plain
               min/max RTN, through K3 (rtn_pack, nibbles) and then K6b
               (rtn_pack_planes, bit-planes): 112 launches each, codes,
               scales and zeros bit-equal to the plain route
               (force_impl("torch")); quantize seconds of both routes beside
               phase main's n_grid 20; one conversion's 112 launches timed;
  8. chunked — attn_impl="chunked" (K4, flash_attention) on those
               backbones: Engine.generate on the K3 backbone (K4 16 times
               per prefill and per decode step, K1 and K2 as in main;
               prefill logits within 2⁻⁵ of the largest logit under
               "dense"; the share of equal tokens), then phase serve's 16
               requests on the K6b backbone, resident and speculative over
               resident (K4 16 times per decode step, draft step, verify and
               prefill; the verify and the tokens checked as in phase
               speculative; the resident run repeated at 1100 rows serves
               the same tokens);
  9. invariance — a 2-layer llama3.2-1b at full width, nibble and plane
               codes, with and without task scales: one verify of 8 slots ×
               4 tokens (M = 32) against the 4 matching decode steps (M = 8)
               under "dense" and "chunked", every op's rows bit-equal, and
               each op kind alone on equal inputs likewise; then a 2-layer
               starcoder2-7b (LayerNorm, GELU, biases), nibble codes;
 10. check   — the same path at 2 layers, once through the kernels and once
               through the plain versions on the card: prefill logits within
               2⁻⁵ of their largest magnitude, and the greedy tokens that
               agree; likewise the slotted prefill (both its routes), a
               slotted decode step over mixed tasks, on the 2 layers
               repacked into bit-planes a slotted draft step and verify, and
               on a 2-layer K3 backbone under "chunked" a prefill and a
               slot-pool decode step and verify.  Then 2-layer models at
               full width, each through the kernels and the plain
               versions (prefill logits within 2⁻⁵, the kernel run
               launching K1, K2 and K4, the plain run none; on every model
               each of the kernel run's K1 and K2 calls held to plain on its
               own inputs within error_bound(factored=True)): starcoder2-7b,
               starcoder2-7b with a 64-slot sliding window over 256 + 96
               tokens (the ring wraps), qwen2-7b with the int8 KV cache,
               and granite-34b (MQA).  And a 2-layer llava-next-mistral-7b
               at full width: its layer-by-layer build bit-equal to the
               whole build tensor by tensor, then its codes as 4 bit-planes
               serving 6 requests with 576-row prefixes over 2 tasks in 4
               slots, resident and speculative over resident (spec_k 3,
               3-plane draft), gated as phase speculative (launches, the
               checked verify bit-equal to decoding step by step, the
               replayed draft, tokens equal to resident's, peak memory).
               Last a 2-layer deepseek-moe-16b at full width: its layer-by-
               layer build bit-equal to the whole build, then the kernels
               against the plain versions as above, every expert-axis call
               held to plain too;
 11. train   — PEQA training (the paper's step 2) on phase main's backbone
               at full width and depth, TrainConfig's default batch of 8 ×
               256 tokens (K2 at M = 2048), remat="block", a synthetic
               corpus at vocab 128256 from the seed.  First, on step 1's
               batch and weights, every recorded kernel call against its
               plain version on its own inputs, element by element: the
               112 K2 calls (M = 2048) within error_bound(factored=True)
               under "dense", "chunked" and on the bit-plane backbone, the
               16 K4 calls under "chunked" within flash_attention's
               error_bound.  Beside them, looser first-order checks: the
               loss and every scale gradient on the
               kernel route against force_impl("torch")'s (the loss within
               the first-order bound Σ|∂L/∂y|·error_bound(y) over the 112
               K2 calls, each linear's scale gradient within the bound its
               inputs' differences and ``ops.qmm_grad_bound`` give), the
               "chunked" loss against "dense"'s within the same bound over
               the 16 K4 calls, the loss bit-equal under remat "none" and
               "block"; K4's logsumexp within ``lse_error_bound`` and its
               o bit-equal with and without it; the backbone repacked
               into bit-planes gives the nibble one's step-1 loss and
               scale gradients bit for bit, and a train step on it
               launches the plane branch of K2 (K6a) 2 × 112 times; a
               step's time by part.
               Then 10 steps of ``train.loop.train`` under "dense" and 10
               under "chunked" from the same scales: exactly 2 × 112 K2
               launches a step (forward and recompute), 2 × 16 K4 launches
               under "chunked" and none under "dense", no GEMV; optimizer
               state = 8 bytes × the model's scales; median step ms,
               tokens/s, device ms (CUDA events), peak memory; one
               profiled step's top device ops; eval_perplexity over 4
               held-out batches; the codes, embedding, norms and zeros
               unchanged;
     train_full — one full-mode step at the same size (every float tensor
               trained, the token table a float32 master that must move at
               step 1): its peak memory — with the model's, the optimizer
               state's and the gradients' bytes and the peaks of the
               forward and backward and of the update — and optimizer
               state beside PEQA's (the paper's Table 1).
 13. dense_archs — llama3.2-1b's models freed, qwen2-7b at full width and
               depth (28 layers, d_model 3584, 28 / 4 heads of 128, d_ff
               18944, vocab 152064, untied, q/k/v biases), bf16, random
               weights from the seed, PEQA 4-bit per-channel (n_grid 20):
               its build's seconds and peak; Engine.generate (B 4, a
               256-token prompt, 32 new tokens; 28 × 7 K2 launches for the
               prefill, 28 × 7 K1 and 28 K4 a decode step), a prefill and
               a decode step profiled as in phase profile; the first 8
               of phase serve's requests (over 4 tasks) under drain and
               resident
               (identical tokens, K5 on resident); the same generate with
               the int8 KV cache (the same launches, its cache half of
               bf16's plus the scales, prefill logits bit-equal to the
               bf16 cache run's); 3 PEQA train steps at 8 × 256 (step 1's
               2 × 196 − 28 K2 calls that return an output — the recompute
               stops before the down projection's — each held to plain
               element by element, 2 × 196 K2 launches a step, state
               8 B × the scales, the codes, biases, norms, table and head
               unchanged; peak memory, step ms, tokens/s beside the
               reckoned full-mode bytes); the untied head's time under the fp linear's
               earlier rule and under ``ops.dot_f32``.  Then starcoder2-7b
               at full width and depth (32 layers): generate with its
               launch gates, and 2 train steps (the first checked).  Then
               granite-34b at full width and GRANITE_LAYERS (16) of its 88
               layers (d_model 6144, 48 heads of 128 over one KV head,
               d_ff 24576, vocab 49152, untied) through the layer-by-layer
               build — its peak gated at the model's bytes plus two
               blocks' float32 bytes; generate (B 4, 256 + 32 tokens: 112
               K2 launches for the prefill, 112 K1 and 16 K4 a decode
               step), the prefill's K2 calls and the first step's K1 calls
               each held to plain.
 15. vlm     — (run before arms) llava-next-mistral-7b at full width
               and depth (the mistral-7b backbone: 32 layers, d_model 4096,
               32 / 8 heads of 128, d_ff 14336, vocab 32000, untied, rope θ
               1e6), built layer by layer, bf16, PEQA 4-bit per-channel
               (n_grid 20), seed 0; each image prefix 576 rows of seeded
               N(0, 1) float32.  Build seconds, peak and model bytes;
               Engine.generate(prefix=) with B 4, 576 + 256 tokens and 32
               new (224 K2 launches for the prefill at M = 3328, 224 K1 and
               32 K4 a decode step), the prefill's K2 calls and the first
               step's K1 calls each held to plain, the logits moved by the
               prefix; a prefill and a decode step profiled (the busy
               share); 8 prefixed requests over 2 tasks (a burst each)
               in 4 slots, prompts of 32–128 tokens and budgets of 16–32,
               under drain and resident at serve's own capacity (which
               counts the 576 prefix rows): identical tokens, the exact
               launches; two
               PEQA train steps of 4 × (576 + 256) rows, the loss on the
               text rows, step 1's K2 calls each held to plain, state 8 B ×
               the scales, peak memory and step ms.
 16. moe     — (after vlm) mixtral-8x7b (32 layers, d_model 4096, 32 / 8
               heads of 128, 8 experts of d_ff 14336, top-2, a 4096-key
               window: the ring cache; vocab 32000, untied; 187 GB of
               float32 weights) and deepseek-moe-16b (28 layers, d_model
               2048, 16 / 16 heads of 128, 64 experts of d_ff 1408, top-6,
               2 shared experts of 2816; vocab 102400, untied) at full
               width and depth, each built layer by layer (bf16, PEQA
               4-bit per-channel, n_grid 20, seed 0; every expert stack
               quantized one expert at a time): the build's seconds and
               peak, gated at the model's bytes plus two float32 blocks;
               Engine.generate of 4 × 256 + 32 with exact launches
               (mixtral: 128 K2 and 96 expert-axis K2 at C = 320 for the
               prefill, 128 K1, 96 expert-axis K1 at C = 1 and 32 K4 a
               step; deepseek: 196 K2 (attention and shared MLP) and 84
               expert-axis K2 at C = 120, 196 K1, 84 expert-axis K1 and 28
               K4), the prefill's and the first step's every quantized
               call held to plain as it happens (``CheckedQuantMatmul``),
               each expert-axis slice also bit-equal to the 2-D kernel on
               its expert; a prefill and a decode step profiled (the busy
               share); MOE_REQUESTS requests over MOE_TASKS tasks in
               MOE_SLOTS slots under drain, twice (every budget served,
               exact launches, the second run's tokens equal to the
               first's), and the resident and speculative schedulers
               refusing with the reference's messages; 2 PEQA steps of 4
               × 256 rows under remat "block", the loss with the aux term,
               step 1's every K2 and expert-axis K2 call held to plain,
               the recompute's first expert call's input bit-equal to the
               forward's (the same routing), the codes, router, norms,
               table and head unchanged, state 8 B × the scales, peak
               memory and step ms.
 14. arms    — the paper's comparison arms at llama3.2-1b full width and
               depth (bf16, seed 0, QV4: rank 4 on wq and wv), the 7B
               models freed, on phase train's corpus and TrainConfig (8 ×
               256 tokens a step, remat "block").  lora_optq: GPTQ
               (``core.gptq``, 4-bit per-channel, n_grid 20) on 4 × 256
               calibration tokens of the train split — each layer's replay
               with its codes in place through K2, 112 calls each held to
               plain by ``CheckedQuantMatmul`` —, then ``add_lora``; 10
               train steps: exactly 2 × 112 K2 launches a step and nothing
               else, step 1's K2 calls each held to plain, the quantized
               backward asked for dx only (no ds, no dz; none at all for
               layer 0's q/k/v, which read the frozen table), the step-1
               loss within 2⁻⁸ of force_impl("torch")'s, optimizer state
               exactly 8 × 425,984 values = 3,407,872 bytes, the codes,
               scales, zeros, norms and table bit-equal after training;
               ``Engine.generate`` as phase main (timed, launches gated),
               then once more with every K1 and K2 call held to plain and
               the same tokens.  lora on the float32 backbone: 3 steps
               (no kernel of ours: the fp products are ``ops.dot_f32``),
               the backbone bit-equal after them; ``merge_lora``, then the
               prefill's and first decode step's logits within 2⁻⁵ of the
               largest of the unmerged model's.  AlphaTuning: BCQ (4 bits)
               of layer 0's seven linears, ``bcq_weight`` bit-equal to Σ
               α_b B_b of ``bcq_decompose`` and within a 0.2 relative
               residual of the float32 weight, ``linear_apply_bcq`` at 8 ×
               256 rows within the float32 summation bound of float64 plus
               a bf16 rounding, only ``alpha1`` getting a gradient (within
               2⁻⁷ of float64 in ℓ2).  qat: two steps as train_full (every
               float tensor trained; RTN scales and zeros; the float32
               table moves at step 1; no K1/K2 launch), its peak memory and
               state (8 B × 1,236,568,064 values).  Last, a line with each
               arm's trainable values, optimizer-state bytes, peak memory
               and median step ms beside phase train's PEQA and
               train_full's figures.

Every phase's seconds are printed on a line of their own as it ends.

Then the card's name and power limit, the ``kernels`` summary line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed phase raises
and exits non-zero before the summary lines.
"""
from __future__ import annotations

import contextlib
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
F32_FLOPS = 67e12           # CUDA cores: the GEMVs' and K2's SIMT routes (f32 x)
BF16_FLOPS = 989e12         # tensor cores: every bf16 GEMV and GEMM, K4 (bf16)

SEED = 0
BATCH, PROMPT, NEW = 4, 256, 32
GEMV_M, GEMM_M = BATCH, BATCH * PROMPT
GEMV_MAX = 32               # the GEMV's largest M: the verify's 8 × 4 rows
# K5 at the serve phase's decode shape: 8 slots over 4 resident tasks
TASKS_M, N_TASKS = 8, 4
TASK_IDS = [i % N_TASKS for i in range(TASKS_M)]
# serve phase: 16 requests cycling through the tasks; prompts of 20 tokens
# (bucketed to 32 rows: K5) and of 100 and 256 (K2 per task)
SERVE_SLOTS, SERVE_REQUESTS = 8, 16
SERVE_PROMPTS, SERVE_NEW = (20, 100, 256), (16, 32, 48)
SHAPES = ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192))
# speculative phase: 3 draft steps from the top 3 of 4 bit-planes, then one
# verify of 4 tokens per slot (8 × 4 = 32 rows: still the GEMV route)
SPEC_K, DRAFT_BITS = 3, 3
# every serve run takes Engine.serve's own pool capacity (304 rows for a
# greedy pool, 307 with the speculative headroom): the decode attention's
# bits do not depend on it.  The resident run is repeated at this capacity
# and must give the same tokens
LONG_CACHE = 1100
# phase check's sliding-window run: a 64-slot ring, 256 + SWA_NEW tokens
SWA_NEW = 96
L2_BYTES = 50 * 2 ** 20
# K4 at llama3.2-1b's heads: (case, B, Sq, Sk, offset, causal, window) —
# offset None (Sk − Sq), "rows" (a (B,) device tensor spread over [20,
# 300]) or an int.  The prefill; the lockstep decode over generate's
# PROMPT + NEW cache at one int position (most of K4's launches on the
# lockstep paths); the slot pool's decode and verify over a 512-slot cache
# and over a speculative pool's 307; a decode and a verify deep in a
# 4096-key cache; a window and a non-causal case.  The decode and verify
# cases are also timed at each split size a measurement chose among
HQ, HKV, DHEAD = 32, 8, 64
ATTN_CASES = (("prefill", 4, 256, 256, None, True, None),
              ("lockstep_decode", BATCH, 1, PROMPT + NEW, PROMPT + 10, True,
               None),
              ("slot_decode", 8, 1, 512, "rows", True, None),
              ("slot_verify", 8, 4, 512, "rows", True, None),
              ("pool_decode", 8, 1, 307, "rows", True, None),
              ("pool_verify", 8, 4, 307, "rows", True, None),
              ("long_decode", BATCH, 1, 4096, 4090, True, None),
              ("long_verify", BATCH, 4, 4096, 4088, True, None),
              ("window", 4, 256, 256, None, True, 64),
              ("non_causal", 4, 256, 256, None, False, None))
SPLIT_KEYS_TRIED = (64, 128, 256)
# the dense family at 7B: each model's four linears (N, K) — q/o, k/v,
# gate/up, down (starcoder2-7b's up/down around its GELU; granite-34b's
# MQA k/v of 128 rows) —, and (Hq, Hkv, D) of each model's heads
DENSE_7B_SHAPES = {
    "qwen2-7b": ((3584, 3584), (512, 3584), (18944, 3584), (3584, 18944)),
    "starcoder2-7b": ((4608, 4608), (512, 4608), (18432, 4608),
                      (4608, 18432)),
    "granite-34b": ((6144, 6144), (128, 6144), (24576, 6144),
                    (6144, 24576))}
DENSE_7B_HEADS = {"qwen2-7b": (28, 4, 128), "starcoder2-7b": (36, 4, 128),
                  "granite-34b": (48, 1, 128)}
# K4 at those heads: the prefill, the lockstep decode, the slot pool's
# decode and verify, and a ring's decode (starcoder2-7b's 64-slot window
# in phase check: every slot visible once the ring has wrapped)
ATTN_7B_CASES = (("prefill", 4, 256, 256, None, True, None),
                 ("lockstep_decode", BATCH, 1, PROMPT + NEW, PROMPT + 10,
                  True, None),
                 ("slot_decode", 8, 1, 512, "rows", True, None),
                 ("slot_verify", 8, 4, 512, "rows", True, None),
                 ("ring_decode", BATCH, 1, 64, PROMPT + 40, True, None))
# train phase: TrainConfig's default batch and length (8 × 256: K2 at M =
# 2048), TRAIN_STEPS steps under each attn_impl (the first TRAIN_SKIP left
# out of the medians), then eval_perplexity over TRAIN_EVAL_BATCHES held-out
# batches of a synthetic corpus of TRAIN_TOKENS tokens (10% held out)
TRAIN_STEPS, TRAIN_SKIP, TRAIN_EVAL_BATCHES = 10, 2, 4
TRAIN_TOKENS = 120_000
# dense_archs phase: PEQA train steps of qwen2-7b at 8 × 256 tokens (the
# first checked call by call, not timed); granite-34b's depth (of 88)
DENSE_TRAIN_STEPS = 3
GRANITE_LAYERS = 16
# qwen2-7b serves the first DENSE_SERVE_REQUESTS of phase serve's requests
DENSE_SERVE_REQUESTS = 8
# vlm phase: llava-next-mistral-7b at full width and depth, each image
# prefix its n_img_tokens (576) rows of seeded N(0, 1) float32, as the
# reference's serving workload makes them.  Serving: VLM_REQUESTS requests
# over VLM_TASKS tasks (one burst a task) in VLM_SLOTS slots, the prompts
# and budgets in turn; training: VLM_TRAIN_STEPS PEQA steps of
# VLM_TRAIN_BATCH × (576 + 256) rows.  Phase check's 2-layer llava serves VLM_CHECK_REQUESTS requests of
# VLM_CHECK_PROMPTS / VLM_CHECK_NEW in VLM_SLOTS slots, all at step 0
VLM_REQUESTS, VLM_TASKS, VLM_SLOTS = 8, 2, 4
VLM_PROMPTS, VLM_NEW = (32, 64, 96, 128), (16, 24, 32)
VLM_TRAIN_STEPS, VLM_TRAIN_BATCH = 2, 4
VLM_CHECK_REQUESTS, VLM_CHECK_PROMPTS, VLM_CHECK_NEW = 6, (32, 48, 64), \
    (8, 12, 16)
# moe phase: mixtral-8x7b and deepseek-moe-16b at full width and depth.
# Serving: MOE_REQUESTS requests over MOE_TASKS tasks (one burst a task) in
# MOE_SLOTS slots, the prompts and budgets in turn (every prompt over 32
# rows: the prefill's 2-D linears take K2); training: MOE_TRAIN_STEPS PEQA
# steps of MOE_TRAIN_BATCH × 256 rows.  Phase kernels: each model's expert
# linears (E, (N, K) of gate/up and of down, C of a 4 × 256-token prefill)
# at C = 1 (a decode step of 4 rows) and at that C, and deepseek's 2-D
# linears new to the kernels (the experts' shapes and the shared MLP's
# (2816, 2048) / (2048, 2816)) and its 16 / 16 heads of 128
MOE_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
MOE_REQUESTS, MOE_TASKS, MOE_SLOTS = 8, 2, 4
MOE_PROMPTS, MOE_NEW = (48, 64, 96, 128), (8, 12, 16)
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH = 2, 4
MOE_EXPERT_SHAPES = {
    "mixtral-8x7b": (8, ((14336, 4096), (4096, 14336)), 320),
    "deepseek-moe-16b": (64, ((1408, 2048), (2048, 1408)), 120)}
MOE_2D_SHAPES = ((1408, 2048), (2048, 1408), (2816, 2048), (2048, 2816))
MOE_HEADS = {"deepseek-moe-16b": (16, 16, 128)}
# new tokens of phase check's 2-layer deepseek-moe-16b
MOE_CHECK_NEW = 8
# arms phase: GPTQ's calibration tokens (B, S) from the train split, and
# the train steps of LoRA on the float32 backbone (lora_optq takes
# TRAIN_STEPS)
ARMS_CALIB = (4, 256)
LORA_FP_STEPS = 3


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


def bytes_ms(m: int, n: int, k: int, groups: int, scale_sets: int = 1,
             code_bits: int = 4) -> float:
    """Least time to move one y = x·Ŵᵀ's bytes at HBM rate: each input read
    once (the codes at ``code_bits`` per weight — 4 for nibbles, p for p
    planes —, x, and ``scale_sets`` scale and zero rows — the tasks K5's
    rows use), the output written once."""
    nbytes = (m * k * 2 + n * k * code_bits // 8
              + scale_sets * 2 * n * groups * 4 + m * n * 2)
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound_ms(m: int, n: int, k: int, groups: int, scale_sets: int = 1,
             code_bits: int = 4, tensor_cores: bool = False) -> tuple:
    """Least time for one y = x·Ŵᵀ: the larger of ``bytes_ms`` and 2·M·N·K
    operations at the rate of the units that do them — the bf16 tensor
    cores for K2's route (``tensor_cores``: bf16 x and 4-bit codes are
    exact bf16 operands), else the f32 CUDA cores.  Returns (ms, "bytes" |
    "operations", ms at the bf16 rate)."""
    t_bytes = bytes_ms(m, n, k, groups, scale_sets, code_bits)
    ops = 2 * m * n * k
    t_ops = ops / (BF16_FLOPS if tensor_cores else F32_FLOPS) * 1e3
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


# the expert-axis forms launch their 2-D kernels' (untasked, nibble)
# instantiations over a grid z axis: no instantiation of their own
SHARED_INSTANTIATIONS = {"quant_gemv_experts": "quant_gemv",
                         "quant_matmul_experts": "quant_matmul"}


def phase_device(torch) -> dict:
    from repro_torch.kernels import _build, ops, ptxas_variants
    t0 = time.perf_counter()
    built = _build.build()
    total = time.perf_counter() - t0
    rows = [r for v in built.values()
            for r in ptxas_variants.report(v["ptxas"])]
    info = {
        "phase": "device", "gpu": nvidia_smi(),
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": _build.nvcc(),
        "build_s": round(total, 3),
        "nvcc_s": {k: round(v["seconds"], 3) for k, v in built.items()},
        # registers, spills and shared memory per wrapper and instantiation
        "ptxas": {k.__name__: [{f: r[f] for f in r if f != "kernel"}
                               for r in rows
                               if r["kernel"] == SHARED_INSTANTIATIONS.get(
                                   k.__name__, k.__name__)]
                  for k in ops.KERNELS},
    }
    missing = [k for k, v in info["ptxas"].items() if not v]
    if missing:
        fail(f"no instantiation of {missing} in the build")
    for name, route in (("quant_matmul", "wgmma"),
                        ("quant_matmul_planes", "wgmma"),
                        ("quant_gemv", "mma"), ("quant_gemv_tasks", "mma"),
                        ("quant_gemv_planes", "mma"),
                        ("quant_gemv_tasks_planes", "mma"),
                        ("flash_attention", "mma.sync")):
        if not any(r.get("route") == route for r in info["ptxas"][name]):
            fail(f"no {route} instantiation of {name} in the build")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_matmul as qm
    # dynamic shared memory of the tensor-core kernels (above 48 KB through
    # cudaFuncSetAttribute), and their tensor-core instructions in the SASS
    info["dynamic_smem"] = {"quant_matmul": qm.tc_smem_bytes(),
                            "flash_attention": fa.tc_smem_bytes()}
    info["sass_tensor_core_ops"] = sass_ops(_build)
    for name, op in (("quant_matmul", "HGMMA"), ("quant_gemv", "HMMA"),
                     ("flash_attention", "HMMA")):
        got = info["sass_tensor_core_ops"].get(name)
        if got is not None and not got.get(op):
            fail(f"no {op} instruction in the compiled {name} library")
    emit(info)
    return info


def sass_ops(_build) -> dict:
    """Tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync) in the SASS
    of each built library, by ``cuobjdump -sass``; {} without cuobjdump."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    from concurrent.futures import ThreadPoolExecutor

    def count(name):
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                              capture_output=True, text=True, timeout=300)
        return {op: len(re.findall(rf"\b{op}\.", sass.stdout))
                for op in ("HGMMA", "HMMA")}
    names = ("quant_gemv", "quant_matmul", "flash_attention")
    with ThreadPoolExecutor(len(names)) as pool:     # all three at once
        return dict(zip(names, pool.map(count, names)))


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


def plain_tasks(qm, tasks, bits=None, shift=0):
    """K5's plain version over a known task list (with ``bits``: K6a's task
    GEMV's, reading that many planes): the same dots and selects as
    ``quant_matmul_tasks_plain`` without its host read of the distinct
    ids, so a CUDA graph can capture it."""
    import torch

    def one(x, qw, s, z):
        if bits is None:
            return qm.quant_matmul_plain(x, qw, s, z)
        return qm.quant_matmul_planes_plain(x, qw, s, z, bits, shift)

    def run(x, qw, ss, zs, ids, *_):
        y = None
        for t in tasks:
            yt = one(x, qw, ss[t], zs[t])
            y = yt if y is None else torch.where((ids == t)[:, None], yt, y)
        return y
    return run


def gemv_rows_invariant(torch, what, fn, x_all) -> bool:
    """Fail unless ``fn``'s rows at M = 1, 2, 4, 8, 16 are bit-equal to the
    same rows at M = 32 (x_all: 32 rows)."""
    full = fn(x_all)
    for m in (1, 2, 4, 8, 16):
        if not torch.equal(fn(x_all[:m].contiguous()), full[:m]):
            fail(f"{what}: rows at M = {m} differ from the same rows at "
                 f"M = {GEMV_MAX}")
    return True


def gemv_simt_case(torch, qm, what, x_all, qw, s, z) -> dict:
    """K1's SIMT route (f32 x) at the same shape: within the bound of its
    plain version and its rows bit-equal across M."""
    xf = x_all.float()
    if qm.tc_route(xf, s):
        fail(f"{what}: f32 x on the tensor-core route")
    got = qm.quant_gemv(xf[:GEMV_M].contiguous(), qw, s, z)
    plain = qm.quant_matmul_plain(xf[:GEMV_M], qw, s, z)
    err = check_close(f"{what} f32 (SIMT)", got, plain, qm.error_bound(
        xf[:GEMV_M], qw, s, z, plain))
    return {"route": "simt", "M": GEMV_M, "max_abs_err": err,
            "rows_bitwise_across_m": gemv_rows_invariant(
                torch, f"{what} f32 (SIMT)",
                lambda a: qm.quant_gemv(a, qw, s, z), xf)}


def matmul_ms(torch, m, w16, gen, iters=200) -> float:
    """A yardstick, never on a path: ``torch.matmul`` of bf16 x (M rows)
    with a bf16 Ŵ of the same shape, weights rotated through > 2× the L2."""
    n, k = w16.shape
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    sets = [(x, w16.clone()) for _ in range(max(2, math.ceil(
        2 * L2_BYTES / (n * k * 2))))]
    ms = timed(lambda a, b: torch.matmul(a, b.T), sets, iters)
    del sets
    return ms


def kernel_gemv_gemm(torch, qm, n, k, group, qw, s, z, w16, gen, worst,
                     emulate=True, model="llama3.2-1b") -> None:
    """K1 (M = GEMV_M) and K2 (M = GEMM_M) on one quantized layer, bf16:
    each on its tensor-core route within the factored bound of its plain
    version (and, with ``emulate``, of its emulation), K1's built K split
    the mirror's and its rows bit-equal across M (both routes); kernel /
    plain / ``torch.matmul`` time against the bound.  Updates ``worst``."""
    g = s.shape[1]
    for name, fn, m in (("quant_gemv", qm.quant_gemv, GEMV_M),
                        ("quant_matmul", qm.quant_matmul, GEMM_M)):
        gemv = fn is qm.quant_gemv
        x = torch.randn(GEMV_MAX if gemv else m, k, generator=gen,
                        device="cuda").to(torch.bfloat16)
        x_all, x = x, x[:m].contiguous()
        got = fn(x, qw, s, z)
        plain = qm.quant_matmul_plain(x, qw, s, z)
        torch.cuda.synchronize()
        tc = qm.tc_route(x, s)
        what = f"{name} M={m} N={n} K={k} group={group}"
        if not tc:
            fail(f"{what}: not on the tensor-core route")
        err = check_close(what, got, plain, qm.error_bound(
            x, qw, s, z, plain, factored=True, gemv=gemv))
        worst[name] = max(worst[name], err)
        del plain
        extra = {"model": model, "route": "mma" if gemv else "wgmma"}
        if emulate:
            # the kernel against its emulation, within the same bound
            emu = (qm.quant_gemv_factored_plain if gemv
                   else qm.quant_matmul_factored_plain)(x, qw, s, z)
            extra.update(max_abs_err_emulation=check_close(
                f"{what} (emulation)", got, emu, qm.error_bound(
                    x, qw, s, z, emu, factored=True, gemv=gemv)),
                bitwise_emulation=bool(torch.equal(got, emu)))
            del emu
        if gemv:
            # the built kernel's K split over blocks is the one the
            # emulation and the bound assume
            extra["block_split"] = qm.gemv_tc_split(n, k)
            if extra["block_split"] != qm.gemv_block_split(n, k):
                fail(f"{what}: the kernel splits K over "
                     f"{extra['block_split']} blocks, the emulation over "
                     f"{qm.gemv_block_split(n, k)}")
            extra["rows_bitwise_across_m"] = gemv_rows_invariant(
                torch, what, lambda a: qm.quant_gemv(a, qw, s, z), x_all)
            extra["simt_f32"] = gemv_simt_case(torch, qm, what, x_all, qw,
                                               s, z)
        # rotate weight copies through > 2x the L2 cache so every launch
        # streams its weights from HBM, as the model's does
        copies = max(2, math.ceil(2 * L2_BYTES / (n * k // 2)))
        sets = [(x, qw.clone(), s.clone(), z.clone()) for _ in range(copies)]
        lib_copies = max(2, math.ceil(2 * L2_BYTES / (n * k * 2)))
        lib_sets = [(x, w16.clone()) for _ in range(lib_copies)]
        iters = 200 if m == GEMV_M else 20
        ms = timed(fn, sets, iters)
        plain_ms = timed(qm.quant_matmul_plain, sets, max(10, iters // 4))
        lib_ms = timed(lambda a, b: torch.matmul(a, b.T), lib_sets, iters)
        b_ms, b_by, b_bf16 = bound_ms(m, n, k, g, tensor_cores=True)
        emit({"phase": "kernels", "kernel": name, "M": m, "N": n, "K": k,
              "group": group, "max_abs_err": err, **extra, "ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
              "bound_by": b_by, "bound_bf16_ms": b_bf16})
        del sets, lib_sets


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.ref import dequant_ref
    from repro_torch.core.quant import QuantSpec

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {k.__name__: 0.0 for k in qm.KERNELS}
    for (n, k) in SHAPES:
        for group in (None, 128):
            qw, s, z = quantized_operands(torch, n, k, group, gen)
            w16 = dequant_ref(qw, s, z, (n, k), QuantSpec(), torch.bfloat16)
            kernel_gemv_gemm(torch, qm, n, k, group, qw, s, z, w16, gen,
                             worst)
            worst["quant_gemv_tasks"] = max(
                worst["quant_gemv_tasks"],
                kernel_k5(torch, qm, n, k, group, qw, s, z, w16, gen))
            for name, err in kernel_planes(torch, qm, n, k, group, qw, s, z,
                                           w16, gen).items():
                worst[name] = max(worst[name], err)
            del qw, s, z, w16
            kernel_rtn_pack(torch, n, k, group, gen)
            torch.cuda.empty_cache()
    # K1, K2 and K5 at the 7B-class models' linears, per-channel (the
    # shapes of phases check and dense_archs); K2's and the GEMV's
    # emulations are checked at llama's above
    for model, shapes in DENSE_7B_SHAPES.items():
        for (n, k) in shapes:
            qw, s, z = quantized_operands(torch, n, k, None, gen)
            w16 = dequant_ref(qw, s, z, (n, k), QuantSpec(), torch.bfloat16)
            kernel_gemv_gemm(torch, qm, n, k, None, qw, s, z, w16, gen,
                             worst, emulate=False, model=model)
            worst["quant_gemv_tasks"] = max(
                worst["quant_gemv_tasks"],
                kernel_k5(torch, qm, n, k, None, qw, s, z, w16, gen,
                          emulate=False, model=model))
            del qw, s, z, w16
            torch.cuda.empty_cache()
    # the moe family: deepseek's new 2-D shapes, then each model's experts
    # on the expert grid axis beside E 2-D launches
    for (n, k) in MOE_2D_SHAPES:
        qw, s, z = quantized_operands(torch, n, k, None, gen)
        w16 = dequant_ref(qw, s, z, (n, k), QuantSpec(), torch.bfloat16)
        kernel_gemv_gemm(torch, qm, n, k, None, qw, s, z, w16, gen, worst,
                         emulate=False, model="deepseek-moe-16b")
        del qw, s, z, w16
    experts = {}
    for model, (e, shapes, c_pre) in MOE_EXPERT_SHAPES.items():
        experts[model] = [kernel_experts(torch, qm, model, e, n, k, c_pre,
                                         gen, worst) for (n, k) in shapes]
        torch.cuda.empty_cache()
    worst.update(rtn_pack=0.0, rtn_pack_planes=0.0)   # bit-equal, or failed
    worst["flash_attention"], attn_prefill = kernel_attention(torch, gen)
    attn_7b = {}
    for model, heads in {**DENSE_7B_HEADS, **MOE_HEADS}.items():
        err, attn_7b[model] = kernel_attention(
            torch, gen, heads, ATTN_7B_CASES, model=model, sweep=False)
        worst["flash_attention"] = max(worst["flash_attention"], err)
    return worst, attn_prefill, attn_7b, experts


def experts_bound_ms(e: int, c: int, n: int, k: int) -> tuple:
    """Least time for one expert-axis y[e] = x[e]·Ŵ[e]ᵀ over E experts
    (per-channel): the larger of its bytes at HBM rate (each expert's codes,
    x, scales and y once) and its 2·E·C·N·K operations at the bf16 tensor
    cores' rate.  Returns (ms, "bytes" | "operations")."""
    t_bytes = e * bytes_ms(c, n, k, 1)
    t_ops = 2 * e * c * n * k / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_experts(torch, qm, model, e, n, k, c_pre, gen, worst) -> dict:
    """One MoE linear's E experts (RTN codes of N(0, 1/K) weights, per-
    channel, bf16 x) on the expert grid axis: the GEMV at C = 1 and the
    GEMM at the prefill's C.  Each launch's slices bit-equal to the 2-D
    kernel on each expert and within ``error_bound`` (factored; ``gemv``
    for the GEMV) of the plain version; device ms (CUDA graphs, weights
    rotated through > 2× the L2) of the one launch, of E separate 2-D
    launches (a yardstick, not a route of the model), of the plain version
    and of ``torch.bmm`` on a dequantized bf16 Ŵ stack, beside the bound.
    Updates ``worst``; returns {kernel: figures}."""
    from repro_torch.core.quant import QuantSpec
    from repro_torch.kernels.ref import dequant_ref
    parts = [quantized_operands(torch, n, k, None, gen) for _ in range(e)]
    qw, s, z = (torch.stack([p[i] for p in parts]) for i in range(3))
    del parts
    w16 = dequant_ref(qw.reshape(e * n, -1), s.reshape(e * n, 1),
                      z.reshape(e * n, 1), (e * n, k), QuantSpec(),
                      torch.bfloat16).reshape(e, n, k)
    out = {}
    for c in (1, c_pre):
        gemv = c <= GEMV_MAX
        name = "quant_gemv_experts" if gemv else "quant_matmul_experts"
        fn, fn2 = ((qm.quant_gemv_experts, qm.quant_gemv) if gemv
                   else (qm.quant_matmul_experts, qm.quant_matmul))
        what = f"{name} {model} E={e} C={c} N={n} K={k}"
        x = torch.randn(e, c, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        y = fn(x, qw, s, z)
        for i in range(e):
            if not torch.equal(y[i], fn2(x[i], qw[i], s[i], z[i])):
                fail(f"{what}: slice {i} differs from the 2-D kernel's "
                     f"launch on expert {i}")
        plain = qm.quant_matmul_experts_plain(x, qw, s, z)
        err = check_close(what, y, plain, qm.error_bound(
            x, qw, s, z, plain, factored=True, gemv=gemv))
        worst[name] = max(worst[name], err)
        del plain, y
        copies = max(2, math.ceil(2 * L2_BYTES / (e * n * k // 2)))
        sets = [(x, qw.clone(), s.clone(), z.clone()) for _ in range(copies)]
        lib_sets = [(x, w16.clone()) for _ in range(max(2, math.ceil(
            2 * L2_BYTES / (e * n * k * 2))))]
        iters = 40 if gemv else 8

        def loop(a, b, c_, d, fn2=fn2):
            for i in range(e):
                fn2(a[i], b[i], c_[i], d[i])
        ms = timed(fn, sets, iters)
        loop_ms = timed(loop, sets, iters)
        plain_ms = timed(qm.quant_matmul_experts_plain, sets,
                         max(2, iters // 4))
        lib_ms = timed(lambda a, b: torch.bmm(a, b.transpose(1, 2)),
                       lib_sets, iters)
        b_ms, b_by = experts_bound_ms(e, c, n, k)
        fig = {"ms": ms, "loop_2d_ms": loop_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "kernels", "kernel": name, "model": model, "E": e,
              "C": c, "N": n, "K": k, "route": "mma" if gemv else "wgmma",
              "slices_bitwise_2d": e, "max_abs_err": err, **fig})
        out[name] = fig
        del sets, lib_sets, x
    del qw, s, z, w16
    return out


def pack_bytes_ms(n: int, k: int, groups: int, bits: int,
                  w_bytes: int) -> float:
    """Least time of one quantize-and-pack at HBM rate: w read once, the
    codes (``bits`` a weight), scales and zeros written once."""
    nbytes = n * k * w_bytes + n * k * bits // 8 + 2 * n * groups * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_rtn_pack(torch, n, k, group, gen) -> None:
    """K3 and K6b on bf16 weights of one layer shape at 4 and 3 bits, and,
    per-channel, on f32 weights (the conversion's own dtype): codes, scales
    and zeros bit-equal to the plain version; kernel / plain time (weights
    rotated through > 2× the L2) against the bytes bound.  No PyTorch call
    quantizes and packs: no library time."""
    from repro_torch.kernels import rtn_pack as rp
    w32 = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
    g = 1 if group is None else k // group
    dtypes = (torch.bfloat16, torch.float32) if group is None \
        else (torch.bfloat16,)
    for dtype in dtypes:
        w = w32.to(dtype)
        elt = w.element_size()
        sets = [(w.clone(),) for _ in range(max(2, math.ceil(
            2 * L2_BYTES / (n * k * elt))))]
        for name, fn, plain in (
                ("rtn_pack", rp.rtn_pack, rp.rtn_pack_plain),
                ("rtn_pack_planes", rp.rtn_pack_planes,
                 rp.rtn_pack_planes_plain)):
            for bits in (4, 3):
                got = fn(w, bits, group)
                want = plain(w, bits, group)
                torch.cuda.synchronize()
                what = (f"{name} N={n} K={k} group={group} bits={bits} "
                        f"{dtype}")
                for a, b, part in zip(got, want, ("codes", "scales",
                                                  "zeros")):
                    if a.shape != b.shape or not torch.equal(a, b):
                        fail(f"{what}: {part} differ from the plain version")
                ms = timed(lambda x: fn(x, bits, group), sets, 50)
                plain_ms = timed(lambda x: plain(x, bits, group), sets, 5)
                emit({"phase": "kernels", "kernel": name, "N": n, "K": k,
                      "group": group, "bits": bits,
                      "dtype": str(dtype).split(".")[1],
                      "bitwise_plain": True, "us": ms * 1e3,
                      "plain_us": plain_ms * 1e3, "library_ms": None,
                      "bound_us": pack_bytes_ms(n, k, g, bits, elt) * 1e3,
                      "bound_by": "bytes"})
        del sets


def attn_mask(torch, b, sq, sk, offset, causal, window):
    """(B, Sq, Sk) visibility of each key to each query: the plain
    version's mask, on the card."""
    iq = torch.arange(sq, device="cuda")[None, :, None] + (
        offset[:, None, None] if torch.is_tensor(offset)
        else sk - sq if offset is None else offset)
    jk = torch.arange(sk, device="cuda")[None, None, :]
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= jk <= iq
    if window is not None:
        mask &= jk > iq - window
    return mask


def attn_bound_ms(mask, heads=(HQ, HKV, DHEAD)) -> tuple:
    """Least time of one attention call at ``heads`` (Hq, Hkv, D; by
    default llama3.2-1b's), for the work of these inputs (``mask``): the
    larger of its bytes (q and out once, the K and V rows of the keys some
    query of a batch row sees, bf16) at HBM rate and its operations, 2·D
    per visible (query, key, head) for each of the two products, both at
    the bf16 tensor-core rate (q·kᵀ: bf16 products are exact in f32; P·V:
    the kernel runs it on the tensor cores, P as two bf16 halves — priced
    once, the function's work).  Returns (ms, "bytes" | "operations")."""
    hq, hkv, d = heads
    b, sq, _ = mask.shape
    pairs, keys = int(mask.sum()), int(mask.any(dim=1).sum())
    t_bytes = (2 * b * sq * hq * d * 2 + 2 * keys * hkv * d * 2
               ) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * (2 * d * pairs * hq) / BF16_FLOPS * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def kernel_attention(torch, gen, heads=(HQ, HKV, DHEAD), cases=ATTN_CASES,
                     model="llama3.2-1b", sweep=True) -> tuple:
    """K4 at ``model``'s heads (Hq, Hkv, D; by default llama3.2-1b's 32
    query and 8 KV heads of 64), bf16, in every case of ``cases``: within
    ``flash_attention.error_bound`` of the plain version; kernel / plain
    time (inputs rotated through > 2× the L2) against the bound, and as a
    yardstick only — never on the path — ``scaled_dot_product_attention``
    with ``enable_gqa`` (``is_causal`` for the aligned causal cases, a
    boolean mask otherwise); with ``sweep``, each decode and verify also
    at every split size tried.  Returns (the worst error, the prefill
    case's row)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    hq, hkv, dh = heads
    worst = 0.0
    for name, b, sq, sk, off, causal, window in cases:
        q = torch.randn(b, sq, hq, dh, generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        k, v = (torch.randn(b, sk, hkv, dh, generator=gen, device="cuda"
                            ).to(torch.bfloat16) for _ in range(2))
        offset = torch.linspace(20, 300, b, device="cuda").round().long() \
            if off == "rows" else off
        kw = dict(causal=causal, window=window, offset=offset)
        got = fa.flash_attention(q, k, v, **kw)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = check_close(f"flash_attention {name}", got, plain,
                          fa.error_bound(q, k, v, plain))
        worst = max(worst, err)
        splits = fa.decode_splits(sq, sk)
        # the kernel's arithmetic emulated (split-P product, split combine)
        emu_err = (got.float() - fa.flash_attention_split_plain(
            q, k, v, splits=splits, chunk=fa.SPLIT_KEYS if splits > 1
            else None, **kw).float()).abs().max().item()
        nbytes = (q.numel() + 2 * k.numel()) * 2
        sets = [tuple(t.clone() for t in (q, k, v)) for _ in range(
            max(2, math.ceil(2 * L2_BYTES / nbytes)))]
        mask = attn_mask(torch, b, sq, sk, offset, causal, window)
        b_ms, b_by = attn_bound_ms(mask, heads)
        aligned = causal and window is None and off is None and sq == sk
        mask = None if aligned or not (causal or window) else mask[:, None]

        def lib(q_, k_, v_, mask=mask, aligned=aligned):
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                attn_mask=mask, is_causal=aligned, enable_gqa=True)
        ms = timed(lambda *a: fa.flash_attention(*a, **kw), sets, 50)
        plain_ms = timed(lambda *a: fa.flash_attention_plain(*a, **kw), sets,
                         10)
        lib_ms = timed(lib, sets, 50)
        # a decode or verify at each split size tried (the earlier rule,
        # splits of Sk / 16 keys rounded to 64 for Sk > 1024, is 64 keys
        # at Sk ≤ 1024 and 256 at 4096)
        by_split = {}
        if sweep and sq <= fa.SPLIT_MAX_SQ:
            chosen = fa.SPLIT_KEYS
            for keys in SPLIT_KEYS_TRIED:
                fa.SPLIT_KEYS = keys
                try:
                    by_split[keys] = timed(
                        lambda *a: fa.flash_attention(*a, **kw), sets,
                        50) * 1e3
                finally:
                    fa.SPLIT_KEYS = chosen
        row = {"phase": "kernels", "kernel": "flash_attention", "case": name,
               "model": model, "B": b, "Sq": sq, "Sk": sk, "Hq": hq,
               "Hkv": hkv, "D": dh,
               "causal": causal, "window": window, "splits": splits,
               "split_keys": fa.SPLIT_KEYS if splits > 1 else None,
               "max_abs_err": err, "max_abs_err_emulation": emu_err,
               "us": ms * 1e3, "us_by_split_keys": by_split or None,
               "plain_us": plain_ms * 1e3,
               "library_us": lib_ms * 1e3, "bound_us": b_ms * 1e3,
               "bound_by": b_by}
        emit(row)
        if name == "prefill":
            prefill = row
        del sets
    return worst, prefill


def kernel_k5(torch, qm, n, k, group, qw, s, z, w16, gen, emulate=True,
              model="llama3.2-1b") -> float:
    """K5 at the serve decode shape: within the bound of its plain version
    and (with ``emulate``) of its emulation, every row bit-equal to K1's
    under that row's task, and its rows at M = 1 .. 16 bit-equal to them
    at M = 32 (the verify's 8 slots × 4 tokens)."""
    ss, zs = task_stacks(torch, s, z, N_TASKS, gen)
    ids_all = torch.tensor([i % N_TASKS for i in range(GEMV_MAX)],
                           dtype=torch.int32, device="cuda")
    ids = ids_all[:TASKS_M]
    x_all = torch.randn(GEMV_MAX, k, generator=gen, device="cuda"
                        ).to(torch.bfloat16)
    x = x_all[:TASKS_M].contiguous()
    got = qm.quant_gemv_tasks(x, qw, ss, zs, ids)
    plain = qm.quant_matmul_tasks_plain(x, qw, ss, zs, ids)
    torch.cuda.synchronize()
    what = f"quant_gemv_tasks M={TASKS_M} T={N_TASKS} N={n} K={k} group={group}"
    if not qm.tc_route(x, s):
        fail(f"{what}: not on the tensor-core route")
    err = check_close(what, got, plain, qm.error_bound(
        x, qw, ss, zs, plain, task_ids=ids, factored=True, gemv=True))
    emu_err = None
    if emulate:
        emu = qm.quant_gemv_factored_plain(x, qw, ss, zs, task_ids=ids)
        emu_err = check_close(f"{what} (emulation)", got, emu,
                              qm.error_bound(x, qw, ss, zs, emu,
                                             task_ids=ids, factored=True,
                                             gemv=True))
        del emu
    gemv_rows_invariant(
        torch, what, lambda a: qm.quant_gemv_tasks(
            a, qw, ss, zs, ids_all[:a.shape[0]]), x_all)
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
                                  scale_sets=len(set(TASK_IDS)),
                                  tensor_cores=True)
    emit({"phase": "kernels", "kernel": "quant_gemv_tasks", "model": model,
          "M": TASKS_M, "T": N_TASKS, "N": n, "K": k, "group": group,
          "route": "mma",
          "max_abs_err": err, "max_abs_err_emulation": emu_err,
          "rows_bitwise_k1": True, "rows_bitwise_across_m": True, "ms": ms,
          "k1_same_m_ms": k1_ms, "plain_ms": plain_ms, "library_ms": None,
          "matmul_bf16_same_m_ms": matmul_ms(torch, TASKS_M, w16, gen),
          "bound_ms": b_ms, "bound_by": b_by, "bound_bf16_ms": b_bf16})
    return err


def kernel_planes(torch, qm, n, k, group, qw, s, z, w16, gen) -> dict:
    """K6a on the layer's codes stored as 4 bit-planes, read whole (p = 4)
    and as the 3-plane draft (p = 3): K1-plane at M = 8 and 32, K5-plane at
    M = 8 over T = 4 tasks, K2-plane at M = 1024.  Each within the bound of
    its plain version and bit-equal to its nibble kernel on the codes
    q >> (4 − p) packed as nibbles, under ``draft_scales``.  Returns the
    worst error per plane kernel."""
    from repro_torch.core.quant import (draft_scales, pack_codes,
                                        pack_codes_planes, unpack_codes)
    codes = unpack_codes(qw)
    planes = pack_codes_planes(codes, 4)
    ss, zs = task_stacks(torch, s, z, N_TASKS, gen)
    ids = torch.tensor(TASK_IDS, dtype=torch.int32, device="cuda")
    g = s.shape[1]
    worst = {}
    for p in (4, 3):
        shift = 4 - p
        nib = pack_codes(codes >> shift)
        sd, zd = draft_scales(s, z, 4, p)
        ssd, zsd = (t.contiguous() for t in draft_scales(ss, zs, 4, p))
        cases = [
            ("quant_gemv_planes", qm.quant_gemv_planes, qm.quant_gemv, m,
             (s, z), (sd, zd), None, qm.quant_matmul_planes_plain, 1)
            for m in (TASKS_M, 32)]
        cases += [
            ("quant_gemv_tasks_planes", qm.quant_gemv_tasks_planes,
             qm.quant_gemv_tasks, TASKS_M, (ss, zs), (ssd, zsd), ids,
             plain_tasks(qm, range(N_TASKS), p, shift),
             len(set(TASK_IDS))),
            ("quant_matmul_planes", qm.quant_matmul_planes, qm.quant_matmul,
             GEMM_M, (s, z), (sd, zd), None, qm.quant_matmul_planes_plain, 1)]
        for name, fn, nib_fn, m, sz, szd, tid, plain_fn, sets_ in cases:
            x = torch.randn(m, k, generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            extra = () if tid is None else (tid,)
            got = fn(x, planes, *sz, *extra, p, shift)
            want = nib_fn(x, nib, *szd, *extra)
            plain = plain_fn(x, planes, *sz, *extra, p, shift)
            torch.cuda.synchronize()
            what = f"{name} M={m} N={n} K={k} group={group} p={p}"
            gemv = name != "quant_matmul_planes"
            if not qm.tc_route(x, s):
                fail(f"{what}: not on the tensor-core route")
            err = check_close(what, got, plain, qm.error_bound(
                x, planes, *sz, plain, task_ids=tid, planes=(p, shift),
                factored=True, gemv=gemv))
            if not torch.equal(got, want):
                fail(f"{what}: differs from its nibble kernel on the "
                     f"{p}-bit codes under draft_scales")
            worst[name] = max(worst.get(name, 0.0), err)
            copies = max(2, math.ceil(2 * L2_BYTES / (n * k * p // 8)))
            argsets = [(x, planes.clone(), *(t.clone() for t in sz), *extra)
                       for _ in range(copies)]
            iters = 20 if name == "quant_matmul_planes" else 200
            ms = timed(lambda *a: fn(*a, p, shift), argsets, iters)
            plain_ms = timed(lambda *a: plain_fn(*a, p, shift), argsets,
                             max(5, iters // 20))
            b_ms, b_by, _ = bound_ms(m, n, k, g, scale_sets=sets_,
                                     code_bits=p, tensor_cores=True)
            row = {"phase": "kernels", "kernel": name, "M": m, "N": n,
                   "K": k, "group": group, "planes": p,
                   "route": "mma" if gemv else "wgmma", "max_abs_err": err,
                   "bitwise_nibble": True, "us": ms * 1e3,
                   "plain_us": plain_ms * 1e3, "library_ms": None,
                   "bytes_bound_us": bytes_ms(m, n, k, g, sets_, p) * 1e3,
                   "bound_us": b_ms * 1e3, "bound_by": b_by}
            if gemv:
                row["matmul_bf16_same_m_us"] = matmul_ms(
                    torch, m, w16, gen) * 1e3
            emit(row)
            del argsets
    return worst


def phase_main(torch) -> dict:
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    from repro_torch.core import policies
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train.serve import Engine

    cfg = configs.get_config("llama3.2-1b").replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20))
    api = registry.build(cfg)
    t0 = time.perf_counter()
    model, mask = policies.build(api, SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine = Engine(api, model)
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    engine.generate(prompt, 2)                       # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompt, NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    peak = torch.cuda.max_memory_allocated()

    n_lin = cfg.n_layers * 7
    steps = NEW - 1                  # the last token needs no decode step
    # the prefill: K2 a linear, the plain attention; a decode step: K1 a
    # linear and K4 a layer (dense decode on the card)
    want = {"quant_matmul": n_lin, "quant_gemv": n_lin * steps,
            "flash_attention": cfg.n_layers * steps}
    if launches != want:
        fail(f"generate: launches {launches}, expected {want}")
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
           "build_s": build_s, "generate_s": total_s, "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_step": (total_s - prefill_s) * 1e3 / steps,
           "tokens_per_s": BATCH * NEW / total_s,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "trainable_scales": sum(int(p.numel()) for name, p
                                   in engine.model.named_parameters()
                                   if mask[name])}
    emit(res)
    return {"res": res, "model": engine.model, "cfg": cfg, "api": api,
            "prompt": prompt}


def convert_cfg(cfg, layout: str):
    """The main configuration under plain min/max RTN (n_grid 1) in
    ``layout``: the conversion path of K3 (nibbles) or K6b (bit-planes)."""
    import dataclasses
    return cfg.replace(quant=dataclasses.replace(cfg.quant, n_grid=1,
                                                 layout=layout))


def phase_convert(torch, main_path) -> dict:
    """Quantize full-width llama3.2-1b with QuantConfig(n_grid=1) through
    K3 (nibbles), then K6b (bit-planes): 112 launches each, codes, scales
    and zeros bit-equal to the plain route (``force_impl("torch")``) on the
    same seeded weights; quantize seconds of each route beside phase main's
    n_grid 20 path; and one conversion's 112 launches over the model's own
    f32 weights timed against the plain version and the bytes bound.
    Returns the kernel-quantized backbones for phase chunked."""
    from repro_torch.core import policies
    from repro_torch.kernels import ops
    from repro_torch.kernels import rtn_pack as rp
    from repro_torch.models import registry
    from repro_torch.models.linear import Linear

    res = {"phase": "convert",
           "n_grid20_build_s": main_path["res"]["build_s"]}
    out = {}
    for layout, kernel in (("nibble", rp.rtn_pack),
                           ("plane", rp.rtn_pack_planes)):
        cfg = convert_cfg(main_path["cfg"], layout)
        api = registry.build(cfg)
        n_lin = cfg.n_layers * 7
        models = {}
        for impl in ("cuda", "torch"):
            model = api.init(SEED)
            torch.cuda.synchronize()
            if impl == "cuda":
                step = convert_step(torch, kernel, model, cfg)
            for k in ops.KERNELS:
                k.launches = 0
            t0 = time.perf_counter()
            with ops.force_impl(impl):
                model, _ = policies.prepare(model, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in ops.KERNELS
                        if k.launches}
            want = {kernel.__name__: n_lin} if impl == "cuda" else {}
            if launches != want:
                fail(f"convert {layout} ({impl}): launches {launches}, "
                     f"expected {want}")
            models[impl] = model
            res[f"{layout}_{impl}_quantize_s"] = secs
            if impl == "cuda":
                step["launches"] = launches[kernel.__name__]
        lins = {name: m for name, m in models["cuda"].named_modules()
                if isinstance(m, Linear) and m.quantized}
        plain = dict(models["torch"].named_modules())
        for name, lin in lins.items():
            ref = plain[name]
            for part in ("qw", "scale", "zero"):
                a, b = getattr(lin, part), getattr(ref, part)
                if a.shape != b.shape or not torch.equal(a, b):
                    fail(f"convert {layout}: {name}.{part} differs between "
                         f"{kernel.__name__} and the plain route")
        if len(lins) != n_lin:
            fail(f"convert {layout}: {len(lins)} quantized linears, expected "
                 f"{n_lin}")
        res[layout] = {"kernel": kernel.__name__, "bitwise_plain": True,
                       **step}
        out[layout] = {"api": api, "model": models["cuda"], "cfg": cfg,
                       "step": step}
        del models, plain, lins
        torch.cuda.empty_cache()
    emit(res)
    return out


def convert_step(torch, kernel, model, cfg) -> dict:
    """One conversion's launches of ``kernel`` over the model's 112 f32
    weights (4.4 GB: cold in L2 by size), CUDA-graph timed, against its
    plain version and the bytes bound."""
    from repro_torch.models.linear import Linear
    from repro_torch.kernels import rtn_pack as rp
    plain = rp.rtn_pack_planes_plain if kernel is rp.rtn_pack_planes \
        else rp.rtn_pack_plain
    bits, group = cfg.quant.bits, cfg.quant.group_size
    ws = [m.w.detach() for m in model.modules() if isinstance(m, Linear)]

    def run(f):
        def go():
            for w in ws:
                f(w, bits, group)
        return go
    saved = kernel.launches
    ms = timed(run(kernel), [()], 3)
    plain_ms = timed(run(plain), [()], 1)
    kernel.launches = saved
    bound = sum(pack_bytes_ms(w.shape[0], w.shape[1],
                              w.shape[1] // (group or w.shape[1]), bits, 4)
                for w in ws)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "weights": len(ws)}


def phase_chunked(torch, conv, serve, prompt) -> dict:
    """attn_impl="chunked" on the min/max RTN backbones of phase convert.
    (1) The K3 backbone: Engine.generate (B 4, 256-token prompts, 32 new
    tokens) — K4 16 times per prefill and per decode step, K1 and K2 as in
    phase main; its prefill logits within 2⁻⁵ of the largest logit of the
    same backbone under "dense", and the share of equal greedy tokens
    (near-ties of random weights; not gated).  (2) The K6b backbone serving
    phase serve's 16 requests resident, then speculative over resident
    (spec_k 3, a 3-plane draft): K4 16 times per decode step, draft step,
    verify and prefill; the verify checked as in phase speculative.  Each
    run starts with every launch counter at 0."""
    import numpy as np
    from repro_torch.core.scale_bank import ScaleBank
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serve import ServeConfig
    from repro_torch.train.serve import Engine

    nib = conv["nibble"]
    cfg = nib["cfg"].replace(attn_impl="chunked")
    api, api_dense = registry.build(cfg), registry.build(nib["cfg"])
    model = nib["model"]
    n_lin, layers = cfg.n_layers * 7, cfg.n_layers
    steps = NEW - 1
    res = {"phase": "chunked", "model": cfg.name, "layers": layers}
    engine = Engine(api, model)
    engine.generate(prompt, 2)                       # warm-up, not counted
    torch.cuda.synchronize()
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompt, NEW)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    want = {"quant_matmul": n_lin, "quant_gemv": n_lin * steps,
            "flash_attention": layers * (1 + steps)}
    if launches != want:
        fail(f"chunked generate: launches {launches}, expected {want}")
    if tuple(out.shape) != (BATCH, PROMPT + NEW) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        fail(f"chunked generate returned {tuple(out.shape)} or ids outside "
             f"the vocabulary")
    dense = Engine(api_dense, model).generate(prompt, NEW)
    with torch.inference_mode():
        tokens = prompt.to("cuda")
        lc = api.prefill(model, {"tokens": tokens})[0].float()
        ld = api_dense.prefill(model, {"tokens": tokens})[0].float()
    diff = (lc - ld).abs().max().item()
    tol = 2.0 ** -5 * ld.abs().max().item()
    if not torch.isfinite(lc).all() or diff > tol:
        fail(f"chunked prefill logits differ from dense by {diff:.3e} > "
             f"{tol:.3e}")
    res["generate"] = {
        "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
        "generate_s": total_s, "tokens_per_s": BATCH * NEW / total_s,
        "launches": launches, "prefill_logits_max_abs_diff_vs_dense": diff,
        "tolerance": tol,
        "tokens_equal_share_vs_dense": (out[:, PROMPT:].cpu()
                                        == dense[:, PROMPT:].cpu()
                                        ).float().mean().item()}
    res["k4_launches_lockstep"] = launches["flash_attention"]

    # (2) the K6b backbone, chunked, behind a 4-task bank of its own scales
    pl = conv["plane"]
    cfg_p = pl["cfg"].replace(attn_impl="chunked")
    api_p, model_p = registry.build(cfg_p), pl["model"]
    bank = ScaleBank()
    bank.add("t0", model_p)
    rng = np.random.default_rng(SEED)
    for t in range(1, N_TASKS):
        bank.tasks[f"t{t}"] = {
            k: (v * rng.uniform(0.9, 1.1, v.shape)).astype(v.dtype)
            for k, v in bank.tasks["t0"].items()}
    reqs = serve["reqs"]
    short = sum(r.n_prompt <= 32 for r in reqs)
    code_bytes = sum(b.numel() * 4 for n, b in model_p.named_buffers()
                     if n.endswith("qw"))
    check = {"armed": False, "done": None, "peak": 0}
    long_ = {"quant_matmul_planes": n_lin * (len(reqs) - short)}
    rep_a, _, peak_a = serve_run(
        torch, res, check, cfg.vocab_size, "resident",
        Engine(api_p, model_p, bank=bank), "step", reqs,
        ServeConfig(n_slots=SERVE_SLOTS, scheduler="resident",
                    resident_tasks=N_TASKS),
        lambda n: {"quant_gemv_tasks_planes": n_lin * (n + short),
                   "flash_attention": layers * (n + len(reqs)), **long_})
    res["resident_tokens_equal_at_cache_len"] = gate_capacity(
        "chunked resident run", Engine(api_p, model_p, bank=bank), reqs,
        rep_a)
    eng = checked_speculative_engine(torch, api_p, model_p, bank, check)
    rep_b, rounds_b, peak_b = serve_run(
        torch, res, check, cfg.vocab_size, "speculative", eng, "spec_step",
        reqs, ServeConfig(n_slots=SERVE_SLOTS, scheduler="speculative",
                          spec_k=SPEC_K, draft_bits=DRAFT_BITS,
                          resident_tasks=N_TASKS),
        lambda n: {"quant_gemv_tasks_planes":
                   n_lin * ((SPEC_K + 1) * n + short),
                   "flash_attention": layers * ((SPEC_K + 1) * n + len(reqs)),
                   **long_})
    del eng
    gate_speculative("chunked speculative run", rep_a, rep_b, rounds_b,
                     check, peak_a, peak_b, code_bytes)
    res["verify_check"] = check["done"]
    res["peak_delta_mb"] = (peak_b - peak_a) / 1e6
    res["tokens_equal_share_spec_vs_resident"] = sum(
        sum(x == y for x, y in zip(a, b))
        for a, b in zip(rep_a.tokens, rep_b.tokens)) / rep_a.decoded
    emit(res)
    return res


def device_ms(torch, fn, top: int = 6) -> tuple:
    """(device kernel ms, the ``top`` kernels) of one call of ``fn`` under
    the profiler's CUDA tracing; the ms is None when it records no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()]
    total = sum(t for _, t in rows) / 1e3
    best = sorted(rows, key=lambda r: -r[1])[:top]
    return (total or None), [{"kernel": k[:80], "ms": t / 1e3}
                             for k, t in best]


def phase_profile(torch, main_path, phase="profile") -> dict:
    """Where one prefill's and one decode step's time goes: device kernel
    time (profiler) against the wall time of the same call.  A vlm's
    ``main_path["prefix"]`` (B, P, d) goes before the prompt.  Emits its
    line under ``phase``."""
    api, model, prompt = main_path["api"], main_path["model"], main_path["prompt"]
    prefix = main_path.get("prefix")
    res = {"phase": phase, "model": api.cfg.name}
    with torch.inference_mode():
        batch = {"tokens": prompt.to("cuda")}
        if prefix is not None:
            batch["image_embeds"] = prefix
        rows = PROMPT + (0 if prefix is None else prefix.shape[1])
        logits, pcache = api.prefill(model, batch)
        cache = api.init_cache(BATCH, rows + 8)
        for key in cache:
            cache[key][:, :, :rows] = pcache[key]
        nxt = torch.argmax(logits, -1)[:, None]
        calls = {
            "prefill": lambda: api.prefill(model, batch),
            "decode_step": lambda: api.decode_step(model, cache, nxt, rows),
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


def phase_step(torch, model, plane_model) -> dict:
    """One main-path step's launches of each kernel, over the model's own
    linears in model order (486 MB of codes: cold in L2 by size), and of
    each K6a kernel over the same linears as bit-planes."""
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
        off = [l for l, a in zip(lins, ops) if not qm.tc_route(a[0], a[2])]
        if off:
            fail(f"step {name}: {len(off)} of the model's linears are not on "
                 f"the tensor-core route")

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
        b = [bound_ms(m, l.out_features, l.in_features, l.scale.shape[1],
                      tensor_cores=True) for l in lins]
        out[name] = {"route": "mma" if fn is qm.quant_gemv else "wgmma",
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": sum(t for t, _, _ in b),
                     "bound_by": b[0][1],
                     "bound_bf16_ms": sum(t for _, _, t in b),
                     "launches": len(lins)}
        emit({"phase": "step", "kernel": name, "M": m, **out[name]})
    out["quant_gemv_tasks"] = step_k5(torch, qm, lins, gen)
    out.update(step_planes(torch, qm, [m for m in plane_model.modules()
                                       if isinstance(m, Linear)
                                       and m.quantized], gen))
    return out


def step_planes(torch, qm, lins, gen) -> dict:
    """K6a's launches of one step over the 112 plane linears: a resident
    draft step (K5-plane, M = 8 slots over 4 tasks, p = 3) and verify
    (K5-plane, 8 slots × 4 tokens, p = 4), an untasked draft step
    (K1-plane, M = 8, p = 3) and a prefill (K2-plane, M = 1024, p = 4).
    No PyTorch call reads bit-planes: no library time; torch.matmul at the
    same M on bf16 weights of the same shapes is timed beside each GEMV
    instance as a yardstick.  K1-plane also at the verify's M = 32.
    Returns each kernel's first entry (the draft steps, the prefill) for
    the summary."""
    from repro_torch.kernels.ref import dequant_ref
    ids = torch.tensor(TASK_IDS, dtype=torch.int32, device="cuda")
    stacks = [task_stacks(torch, l.scale.detach(), l.zero.detach(), N_TASKS,
                          gen) for l in lins]
    runs = (("quant_gemv_tasks_planes", "draft", TASKS_M, DRAFT_BITS, ids),
            ("quant_gemv_tasks_planes", "verify", TASKS_M * (SPEC_K + 1), 4,
             ids.repeat_interleave(SPEC_K + 1)),
            ("quant_gemv_planes", "draft", TASKS_M, DRAFT_BITS, None),
            ("quant_gemv_planes", "verify", TASKS_M * (SPEC_K + 1), 4, None),
            ("quant_matmul_planes", "prefill", GEMM_M, 4, None))
    # the yardstick beside each GEMV instance: torch.matmul at the same M
    # on a bf16 Ŵ of every linear (never on a path)
    w16 = [dequant_ref(l.qw, l.scale.detach(), l.zero.detach(),
                       (l.out_features, l.in_features), l.spec,
                       torch.bfloat16) for l in lins]
    out = {}
    for name, what, m, p, tid in runs:
        fn, shift = getattr(qm, name), 4 - p
        xs = {k: torch.randn(m, k, generator=gen, device="cuda"
                             ).to(torch.bfloat16)
              for k in {l.in_features for l in lins}}
        if tid is None:
            ops = [(xs[l.in_features], l.qw, l.scale.detach(),
                    l.zero.detach()) for l in lins]
            plain = qm.quant_matmul_planes_plain
        else:
            ops = [(xs[l.in_features], l.qw, *st, tid)
                   for l, st in zip(lins, stacks)]
            plain = plain_tasks(qm, range(N_TASKS), p, shift)

        def run(f=fn, ops=ops, p=p, shift=shift):
            for a in ops:
                f(*a, p, shift)

        def run_plain(f=plain, ops=ops, p=p, shift=shift):
            for a in ops:
                f(*a, p, shift)

        reps = 3 if name == "quant_matmul_planes" else 20
        ms = timed(run, [()], reps)
        plain_ms = timed(run_plain, [()], 2)
        sets_ = 1 if tid is None else len(set(TASK_IDS))
        b = [bound_ms(m, l.out_features, l.in_features, l.scale.shape[1],
                      scale_sets=sets_, code_bits=p, tensor_cores=True)
             for l in lins]
        res = {"route": "wgmma" if name == "quant_matmul_planes" else "mma",
               "ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": sum(t for t, _, _ in b), "bound_by": b[0][1],
               "bound_bf16_ms": sum(t for _, _, t in b),
               "launches": len(lins)}
        if name != "quant_matmul_planes":
            lib = [(xs[l.in_features], w) for l, w in zip(lins, w16)]

            def run_lib(lib=lib):
                for a, w in lib:
                    torch.matmul(a, w.T)
            res["matmul_bf16_same_m_ms"] = timed(run_lib, [()], reps)
            del lib
        emit({"phase": "step", "kernel": name, "step": what, "M": m,
              "planes": p, **res})
        out.setdefault(name, res)
        del ops
    del w16
    torch.cuda.empty_cache()
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
                  scale_sets=len(set(TASK_IDS)), tensor_cores=True)
         for l in lins]
    res = {"route": "mma", "ms": ms, "k1_same_m_ms": k1_ms,
           "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": sum(t for t, _, _ in b), "bound_by": b[0][1],
           "bound_bf16_ms": sum(t for _, _, t in b), "launches": len(lins)}
    emit({"phase": "step", "kernel": "quant_gemv_tasks", "M": TASKS_M,
          "T": N_TASKS, **res})
    del ops
    torch.cuda.empty_cache()
    return res


def serve_requests(vocab: int, n: int = SERVE_REQUESTS) -> list:
    """``n`` (16) requests cycling through the 4 tasks, arriving every 2
    decode steps; prompt lengths 20, 100, 256 and budgets 16, 32, 48 in
    turn."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 3)
    return [Request(
        tokens=rng.integers(0, vocab, SERVE_PROMPTS[i % 3]),
        n_new=SERVE_NEW[(i + 1) % 3], task=f"t{i % N_TASKS}",
        arrival_step=2 * i) for i in range(n)]


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


def phase_serve(torch, main_path, phase="serve", probes=True,
                n_requests=SERVE_REQUESTS) -> dict:
    """Drain vs resident on the full model: same tokens; resident through
    K5 (decode and short prefills) and K2 per task (long prefills), never
    K1.  Each run starts with the launch counters at 0.  With ``probes``,
    a profiled pool step of each and the resident run again at
    LONG_CACHE rows.  ``n_requests`` of ``serve_requests``.  Emits its line
    under ``phase``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.serve import ServeConfig
    from repro_torch.train.serve import Engine

    api, model, cfg = main_path["api"], main_path["model"], main_path["cfg"]
    bank = task_bank(model, N_TASKS, SEED)
    reqs = serve_requests(cfg.vocab_size, n_requests)
    n_lin = cfg.n_layers * 7
    short = sum(r.n_prompt <= 32 for r in reqs)    # prefills of <= 32 rows
    kernels = (qm.quant_gemv, qm.quant_matmul, qm.quant_gemv_tasks,
               fa.flash_attention)
    res, reports = {"phase": phase, "model": cfg.name,
                    "requests": len(reqs), "slots": SERVE_SLOTS,
                    "tasks": N_TASKS}, {}
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
        # <= 32 rows too; longer prefills through K2 (one task each); each
        # decode step's attention through K4, a launch a layer (the dense
        # prefill is the plain einsum)
        gemv = "quant_gemv_tasks" if sched == "resident" else "quant_gemv"
        other = "quant_gemv" if sched == "resident" else "quant_gemv_tasks"
        want = {gemv: n_lin * (calls["n"] + short), other: 0,
                "quant_matmul": n_lin * (len(reqs) - short),
                "flash_attention": cfg.n_layers * calls["n"]}
        if launches != want:
            fail(f"{phase} {sched}: kernel launches {launches}, expected "
                 f"{want}")
        if probes:
            res[sched]["profile_step"] = profile_serve_step(
                torch, engine, step, reqs, sched == "resident")
    engine.switch_task("t0")                  # the model's own scales back
    dr, rr = reports["drain"], reports["resident"]
    if probes:
        res["resident_tokens_equal_at_cache_len"] = gate_capacity(
            "resident run", Engine(api, model, bank=bank), reqs, rr)
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
    return {"res": res, "bank": bank, "reqs": reqs,
            "resident_tokens": rr.tokens}


def gate_capacity(label, engine, reqs, rep) -> int:
    """The resident run ``rep`` (at Engine.serve's own pool capacity)
    repeated through ``engine`` in a pool of LONG_CACHE rows: fail unless
    it serves the same tokens — the decode attention's bits do not depend
    on the capacity.  Returns LONG_CACHE."""
    from repro_torch.serve import ServeConfig
    again = engine.serve(reqs, ServeConfig(
        n_slots=SERVE_SLOTS, scheduler="resident", resident_tasks=N_TASKS,
        cache_len=LONG_CACHE))
    gate_tokens_equal(f"{label} at cache_len={LONG_CACHE}",
                      "default-capacity", rep, again)
    return LONG_CACHE


def plane_backbone(torch, main_path) -> dict:
    """The main model with its codes repacked into 4 bit-planes by the
    port's own ``unpack_codes``/``pack_codes_planes`` — the codes identical
    by construction, no second quantization —, its scales and zeros
    copied, its embedding and norms shared."""
    import dataclasses
    from repro_torch.core.quant import pack_codes_planes, unpack_codes
    from repro_torch.models import registry, transformer
    from repro_torch.models.linear import Linear

    cfg, src = main_path["cfg"], main_path["model"]
    cfg_p = cfg.replace(quant=dataclasses.replace(cfg.quant, layout="plane"))
    api_p = registry.build(cfg_p)
    t0 = time.perf_counter()
    model_p = transformer.Transformer(cfg_p, device="meta")
    srcs = dict(src.named_modules())
    with torch.no_grad():
        for name, mod in model_p.named_modules():
            if isinstance(mod, Linear) and srcs[name].quantized:
                lin = srcs[name]
                mod.set_quantized(
                    pack_codes_planes(unpack_codes(lin.qw), cfg.quant.bits),
                    lin.scale.detach().clone(), lin.zero.detach().clone(),
                    cfg_p.quant.spec())
            for pname, prm in list(mod._parameters.items()):
                if prm is not None and prm.is_meta:
                    mod._parameters[pname] = srcs[name]._parameters[pname]
    torch.cuda.synchronize()
    left = [n for n, t in model_p.named_parameters() if t.is_meta]
    if left:
        fail(f"plane backbone: tensors left unset: {left}")
    return {"api": api_p, "model": model_p, "cfg": cfg_p,
            "repack_s": time.perf_counter() - t0}


def serve_run(torch, res, check, vocab, label, engine, method, requests,
              config, want):
    """Serve ``requests`` through ``engine`` with every launch counter at 0,
    timing each ``method`` call (a step or a speculative round), and fail
    unless each kernel launched exactly as ``want(calls)`` says (others:
    0 times) and every request got its full budget.  Records the run under
    ``res[label]``; returns (report, calls, peak bytes)."""
    from repro_torch.kernels import ops
    calls = {"n": 0, "s": 0.0}
    inner = getattr(engine, method)

    def counted(pool, *a):
        t0 = time.perf_counter()
        out = inner(pool, *a)                 # ends in a host sync
        calls["s"] += time.perf_counter() - t0
        calls["n"] += 1
        return out
    setattr(engine, method, counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    rep = engine.serve(requests, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = max(check["peak"], torch.cuda.max_memory_allocated())
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    for i, (r, toks) in enumerate(zip(requests, rep.tokens)):
        if toks is None or len(toks) != r.n_new:
            fail(f"{label}: request {i} served {toks and len(toks)} of "
                 f"{r.n_new} tokens")
        if min(toks) < 0 or max(toks) >= vocab:
            fail(f"{label}: request {i} has token ids outside the "
                 f"vocabulary")
    expect = {k.__name__: 0 for k in ops.KERNELS}
    expect.update(want(calls["n"]))
    if launches != expect:
        fail(f"{label}: kernel launches {launches}, expected {expect}")
    res[label] = {
        "scheduler": rep.scheduler, "steps": rep.steps,
        f"{method}_calls": calls["n"], "draft_steps": rep.draft_steps,
        "draft_proposed": rep.draft_proposed,
        "draft_accepted": rep.draft_accepted,
        "acceptance_rate": rep.acceptance_rate,
        "task_drain_idle_slot_steps": rep.task_drain_idle_slot_steps,
        "decoded": rep.decoded, "wall_s": wall,
        "tokens_per_s": rep.decoded / wall,
        f"ms_per_{method}": calls["s"] * 1e3 / max(calls["n"], 1),
        "peak_mem_gb": peak / 1e9, "launches": launches}
    return rep, calls["n"], peak


def checked_speculative_engine(torch, api, model, bank, check):
    """A resident speculative engine whose first round with every slot live
    has its verify checked against k+1 decode steps on a cache copy (and
    its first draft step replayed), into ``check["done"]``.  The check's
    own launches and memory are not the run's."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.train.serve import Engine

    def verify_checked(m, st, c, t, pos, tid):
        if not check["armed"]:
            return api.decode_verify_slotted(m, st, c, t, pos, tid)
        check["armed"] = False
        peak_before = torch.cuda.max_memory_allocated()
        copies = [{k: v.clone() for k, v in c.items()} for _ in range(2)]
        logits, c = api.decode_verify_slotted(m, st, c, t, pos, tid)
        saved = [k.launches for k in ops.KERNELS]
        steps = []
        for j in range(t.shape[1]):
            lg, copies[0] = api.decode_step_slotted(
                m, st, copies[0], t[:, j:j + 1], pos + j, tid)
            steps.append(lg)
        # the round's first draft step again (the 2-layer check holds the
        # draft step to the plain versions)
        draft = api.decode_step_slotted(m, st, copies[1], t[:, :1], pos, tid,
                                        draft_bits=DRAFT_BITS)[0].float()
        for k, n in zip(ops.KERNELS, saved):  # not the main path's launches
            k.launches = n
        dec = torch.stack(steps, 1).float()
        diff = (logits.float() - dec).abs().amax().item()
        scale = dec.abs().amax().item()
        check["done"] = {
            "rows": t.shape[0] * t.shape[1],
            # every op of the path is row-invariant in M, so the verify's
            # M = 32 logits are the decode steps' M = 8 logits, bit for bit
            "bit_equal": bool(torch.equal(logits.float(), dec)),
            "max_abs_diff": diff, "logits_max_abs": scale,
            "argmax_equal_share": (logits.argmax(-1) == dec.argmax(-1)
                                   ).float().mean().item(),
            # the replayed draft step proposes the round's first draft
            "draft_replay_equal": bool(torch.equal(draft.argmax(-1),
                                                   t[:, 1])),
            # how far the 3-plane draft is from the target on these rows
            "draft_target_argmax_share": (draft.argmax(-1)
                                          == dec[:, 0].argmax(-1)
                                          ).float().mean().item(),
            "draft_target_logit_cosine": torch.nn.functional.cosine_similarity(
                draft, dec[:, 0], dim=-1).mean().item()}
        del copies, steps, dec, draft
        # the check's own cache copy is not the run's memory
        check["peak"] = peak_before
        torch.cuda.reset_peak_memory_stats()
        return logits, c

    eng = Engine(dataclasses.replace(api, decode_verify_slotted=verify_checked),
                 model, bank=bank)
    real_round = eng._spec_round

    def round_(pool, *a):
        check["armed"] = check["done"] is None and bool(pool.active.all())
        return real_round(pool, *a)
    eng._spec_round = round_
    return eng


def gate_speculative(label, rep_a, rep_b, rounds_b, check, peak_a, peak_b,
                     code_bytes) -> None:
    """The speculative-over-resident run's gates: scheduler, no task-drain
    wait, SPEC_K draft steps a round, a checked verify bit-equal to the
    step-by-step decode, the replayed draft, the same tokens as the
    resident (greedy) run ``rep_a``, and peak memory within 5% of the code
    bytes of the resident run's."""
    if rep_b.scheduler != "speculative" or rep_b.task_drain_idle_slot_steps:
        fail(f"{label}: scheduler {rep_b.scheduler!r}, task-drain "
             f"idle slot-steps {rep_b.task_drain_idle_slot_steps}")
    if rep_b.draft_steps != SPEC_K * rounds_b:
        fail(f"{label}: {rep_b.draft_steps} draft steps in "
             f"{rounds_b} rounds of {SPEC_K}")
    if not 0 <= rep_b.draft_accepted <= rep_b.draft_proposed:
        fail(f"{label}: {rep_b.draft_accepted} of "
             f"{rep_b.draft_proposed} drafts accepted")
    if check["done"] is None:
        fail(f"{label}: no round had every slot live")
    done = check["done"]
    if not done["bit_equal"]:
        fail(f"{label}: verify logits differ from successive decode steps "
             f"by up to {done['max_abs_diff']:.3e} (bit-equal required)")
    gate_tokens_equal(label, "resident", rep_a, rep_b)
    if not done["draft_replay_equal"]:
        fail(f"{label}: the replayed draft step does not propose the "
             f"round's draft tokens")
    if not peak_b - peak_a < 0.05 * code_bytes:
        fail(f"{label}: peak memory {peak_b / 1e9:.3f} GB exceeds the "
             f"resident run's {peak_a / 1e9:.3f} GB by 5% of the "
             f"{code_bytes / 1e9:.3f} GB of codes or more")


def gate_tokens_equal(label, what, rep_a, rep_b) -> float:
    """Fail unless ``rep_b`` served every request the tokens ``rep_a`` did
    (speculative decoding is greedy decoding, token for token); returns
    the share of equal tokens (1.0)."""
    same = sum(sum(x == y for x, y in zip(a, b))
               for a, b in zip(rep_a.tokens, rep_b.tokens))
    share = same / rep_a.decoded
    if rep_b.tokens != rep_a.tokens:
        first = min((j, i) for i, (a, b) in enumerate(zip(rep_a.tokens,
                                                          rep_b.tokens))
                    for j, (x, y) in enumerate(zip(a, b)) if x != y)
        fail(f"{label}: tokens differ from the {what} run's (share "
             f"{share:.4f} equal; first at token {first[0]} of request "
             f"{first[1]})")
    return share


def phase_speculative(torch, plane, serve) -> dict:
    """The 16 requests of phase serve on the bit-plane backbone: (a)
    resident, (b) speculative over resident, (c) speculative without tasks.
    Each run starts with every launch counter at 0."""
    from repro_torch.serve import Request, ServeConfig
    from repro_torch.train.serve import Engine

    api, model, cfg = plane["api"], plane["model"], plane["cfg"]
    bank, reqs = serve["bank"], serve["reqs"]
    n_lin, layers = cfg.n_layers * 7, cfg.n_layers
    short = sum(r.n_prompt <= 32 for r in reqs)
    code_bytes = sum(b.numel() * 4 for n, b in model.named_buffers()
                     if n.endswith("qw"))
    res = {"phase": "speculative", "requests": len(reqs),
           "slots": SERVE_SLOTS, "spec_k": SPEC_K, "draft_bits": DRAFT_BITS,
           "code_bytes": code_bytes}
    check = {"armed": False, "done": None, "peak": 0}

    def run(*a):
        return serve_run(torch, res, check, cfg.vocab_size, *a)

    long_ = {"quant_matmul_planes": n_lin * (len(reqs) - short)}
    # (a) resident on the plane backbone
    eng = Engine(api, model, bank=bank)
    rep_a, _, peak_a = run(
        "resident", eng, "step", reqs,
        ServeConfig(n_slots=SERVE_SLOTS, scheduler="resident",
                    resident_tasks=N_TASKS),
        lambda n: {"quant_gemv_tasks_planes": n_lin * (n + short),
                   "flash_attention": layers * n, **long_})
    del eng                                   # and its resident stack
    if rep_a.tokens != serve["resident_tokens"]:
        diff = sum(a != b for a, b in zip(rep_a.tokens,
                                          serve["resident_tokens"]))
        fail(f"plane resident tokens differ from the nibble backbone's in "
             f"{diff} of {len(reqs)} requests")

    # (b) speculative over resident; the verify of the first round with
    # every slot live is checked against k+1 decode steps on a cache copy
    eng = checked_speculative_engine(torch, api, model, bank, check)
    spec_cfg = dict(n_slots=SERVE_SLOTS, scheduler="speculative",
                    spec_k=SPEC_K, draft_bits=DRAFT_BITS,
                    resident_tasks=N_TASKS)
    rep_b, rounds_b, peak_b = run(
        "speculative", eng, "spec_step", reqs, ServeConfig(**spec_cfg),
        lambda n: {"quant_gemv_tasks_planes":
                   n_lin * ((SPEC_K + 1) * n + short),
                   "flash_attention": layers * (SPEC_K + 1) * n, **long_})
    check["peak"] = 0
    del eng
    gate_speculative("speculative run", rep_a, rep_b, rounds_b, check,
                     peak_a, peak_b, code_bytes)
    res["verify_check"] = check["done"]
    res["peak_delta_mb"] = (peak_b - peak_a) / 1e6
    same = [sum(x == y for x, y in zip(a, b))
            for a, b in zip(rep_a.tokens, rep_b.tokens)]
    res["tokens_equal_share_vs_resident"] = sum(same) / rep_a.decoded
    firsts = [i for a, b in zip(rep_a.tokens, rep_b.tokens)
              for i in [next((j for j, (x, y) in enumerate(zip(a, b))
                              if x != y), None)] if i is not None]
    res["first_divergence"] = min(firsts) if firsts else None

    # (c) speculative without tasks: the untasked draft and verify
    # (K1-plane), and (d) the same requests decoded greedily, one step at a
    # time: the same tokens
    untasked = [Request(tokens=r.tokens, n_new=r.n_new,
                        arrival_step=r.arrival_step) for r in reqs]
    rep_c, _, _ = run(
        "speculative_untasked", Engine(api, model), "spec_step", untasked,
        ServeConfig(**spec_cfg),
        lambda n: {"quant_gemv_planes": n_lin * ((SPEC_K + 1) * n + short),
                   "flash_attention": layers * (SPEC_K + 1) * n, **long_})
    rep_d, _, _ = run(
        "greedy_untasked", Engine(api, model), "step", untasked,
        ServeConfig(n_slots=SERVE_SLOTS, scheduler="drain"),
        lambda n: {"quant_gemv_planes": n_lin * (n + short),
                   "flash_attention": layers * n, **long_})
    res["tokens_equal_share_untasked_vs_greedy"] = gate_tokens_equal(
        "untasked speculative run", "greedy untasked", rep_d, rep_c)
    emit(res)
    return res


def phase_invariance(torch, cfg, layouts=("nibble", "plane")) -> dict:
    """Row invariance of the decode / verify path on the card: a 2-layer
    ``cfg`` at full width (PEQA 4-bit per-channel, and with "plane" in
    ``layouts`` its 4-plane repack), one verify of 8 slots × (SPEC_K + 1)
    tokens (M = 32) against the SPEC_K + 1 matching decode steps (M = 8),
    under "dense" and "chunked", with a 4-task resident stack and without:
    every op's rows (embedding, norms, linears and their biases, the GELU,
    RoPE, attention, head, argmax) must be bit-equal
    (``models.row_trace.compare_verify``), and each op kind alone on equal
    inputs likewise (``isolated_ops``)."""
    import numpy as np
    from repro_torch.core import policies
    from repro_torch.core.scale_bank import ResidentStack, ScaleBank
    from repro_torch.models import registry, row_trace

    cfg2 = cfg.replace(n_layers=2)
    api = registry.build(cfg2)
    model, _ = policies.build(api, SEED)
    backbones = {"nibble": (model, cfg2)}
    if "plane" in layouts:
        plane = plane_backbone(torch, {"cfg": cfg2, "model": model})
        backbones["plane"] = (plane["model"], plane["cfg"])
    bank = ScaleBank()
    bank.add("t0", model)
    rng = np.random.default_rng(SEED + 4)
    for t in range(1, N_TASKS):
        bank.tasks[f"t{t}"] = {
            k: (v * rng.uniform(0.9, 1.1, v.shape)).astype(v.dtype)
            for k, v in bank.tasks["t0"].items()}
    warm = [f"t{t}" for t in range(N_TASKS)]
    ids = torch.tensor(TASK_IDS, dtype=torch.int32, device="cuda")
    pos = torch.arange(TASKS_M, device="cuda") * 31 + 20
    toks = torch.randint(0, cfg2.vocab_size, (TASKS_M, SPEC_K + 1),
                         generator=torch.Generator().manual_seed(SEED + 7)
                         ).to("cuda")
    cache = api.init_cache(TASKS_M, 512)
    for key in cache:
        cache[key].normal_(generator=torch.Generator(device="cuda"
                                                     ).manual_seed(SEED))
    res = {"phase": "invariance", "model": cfg.name, "layers": 2,
           "rows_verify": TASKS_M * (SPEC_K + 1), "rows_decode": TASKS_M,
           "cases": {}, "isolated": {}}
    for layout, (m, c) in backbones.items():
        stack = ResidentStack(bank, m, N_TASKS, warm=warm).stack
        for tasked in (True, False):
            st, tid = (stack, ids) if tasked else (None, None)
            for impl in ("dense", "chunked"):
                rep = row_trace.compare_verify(
                    registry.build(c.replace(attn_impl=impl)), m, cache, toks,
                    pos, st, tid)
                key = f"{layout}/{impl}/{'tasks' if tasked else 'untasked'}"
                res["cases"][key] = {"ops": len(rep["ops"]),
                                     "first_differing": rep["first_differing"]}
                if rep["first_differing"] is not None:
                    bad = [(r["op"], r["max_abs_diff"]) for r in rep["ops"]
                           if not r["equal"]][:4]
                    fail(f"invariance {key}: rows differ from op "
                         f"{rep['first_differing']} on: {bad}")
            iso = row_trace.isolated_ops(m, c, cache, pos, SPEC_K + 1, st,
                                         tid)
            key = f"{layout}/{'tasks' if tasked else 'untasked'}"
            res["isolated"][key] = sorted(iso)
            bad = [k for k, r in iso.items() if not r["equal"]]
            if bad:
                fail(f"invariance {key}: ops not row-invariant alone: {bad}")
        del stack
    emit(res)
    return res


def check_path(torch, api, model, cfg, prompt, new) -> dict:
    """The prefill of ``prompt`` and a greedy generation of ``new`` tokens,
    once through the kernels and once through the plain versions on the
    card: prefill logits within 2⁻⁵ of their largest magnitude, the greedy
    tokens that agree reported (random weights give near-tied logits).
    The kernel run must launch K1, K2 and K4 and the plain run none; each
    of the kernel run's K1 and K2 calls is held to its plain version on its
    own inputs as it happens (``CheckedQuantMatmul``), so every linear shape
    of the model meets the element-wise gate in both routes."""
    from contextlib import nullcontext
    from repro_torch.kernels import ops
    from repro_torch.train.serve import Engine

    engine = Engine(api, model)
    b, s = prompt.shape
    runs, launched = {}, {}
    label = f"check {cfg.name}"
    for impl in ("cuda", "torch"):
        for k in ops.KERNELS:
            k.launches = 0
        checked = CheckedQuantMatmul(ops, label) if impl == "cuda" \
            else nullcontext()
        with ops.force_impl(impl), torch.inference_mode(), checked:
            logits, _ = api.prefill(model, {"tokens": prompt.to("cuda")})
            toks = engine.generate(prompt, new)
        runs[impl] = (logits.float(), toks[:, s:])
        launched[impl] = {k.__name__: k.launches for k in ops.KERNELS
                          if k.launches}
        if impl == "cuda":
            chk = checked
    kinds = {"quant_gemv", "quant_matmul", "flash_attention"}
    if n_quantized(model, experts=True):
        kinds |= {"quant_gemv_experts", "quant_matmul_experts"}
    if set(launched["cuda"]) != kinds or launched["torch"]:
        fail(f"{label}: kernels launched {launched['cuda']} through "
             f"the kernels and {launched['torch']} through the plain versions")
    if any(chk.calls[k] != launched["cuda"].get(k, 0) for k in chk.calls):
        fail(f"{label}: {chk.calls} calls checked against plain, "
             f"{launched['cuda']} launched")
    lk, tk = runs["cuda"]
    lp, tp = runs["torch"]
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail(f"non-finite logits in the 2-layer check of {cfg.name}")
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    tol = 2.0 ** -5 * scale
    if diff > tol:
        fail(f"2-layer {cfg.name} prefill logits: kernels vs plain differ by "
             f"{diff:.3e} > {tol:.3e}")
    prefix = [int((tk[i] != tp[i]).nonzero()[0]) if (tk[i] != tp[i]).any()
              else new for i in range(b)]
    return {"model": cfg.name, "layers": cfg.n_layers, "prompt": s,
            "new_tokens": new, "logits_max_abs_diff": diff,
            "logits_max_abs": scale, "tolerance": tol,
            "greedy_tokens_equal_share": (tk == tp).float().mean().item(),
            "greedy_equal_prefix_per_row": prefix,
            "launches": launched["cuda"], "calls_checked": chk.calls,
            "qmm_max_abs_err": chk.worst}


def dense_cfg(name: str, **kw):
    """``name`` as the smoke runs it: PEQA 4-bit per-channel RTN (n_grid
    20), bf16, with ``kw`` replaced."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    return configs.get_config(name).replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20), **kw)


# phase check's other 2-layer models at full width: (label, config name,
# replaced fields, new tokens)
CHECK_ARCHS = (("starcoder2-7b", "starcoder2-7b", {}, NEW),
               ("starcoder2-7b/swa64", "starcoder2-7b",
                {"swa_window": 64}, SWA_NEW),
               ("qwen2-7b/int8", "qwen2-7b", {"kv_cache_dtype": "int8"}, NEW),
               ("granite-34b", "granite-34b", {}, NEW))


def phase_check(torch, cfg) -> dict:
    """2 layers at full width: kernels vs plain versions on the card —
    llama3.2-1b (with its slotted and chunked paths), then each model of
    ``CHECK_ARCHS``."""
    from repro_torch.core import policies
    from repro_torch.models import registry

    cfg2 = cfg.replace(n_layers=2)
    api = registry.build(cfg2)
    model, _ = policies.build(api, SEED)
    gen = torch.Generator().manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg2.vocab_size, (BATCH, PROMPT), generator=gen)
    res = {"phase": "check", **check_path(torch, api, model, cfg2, prompt,
                                          NEW),
           "slotted": check_slotted(torch, api, model, cfg2),
           "chunked": check_chunked(torch, cfg2)}
    del model
    res["vlm"] = check_vlm(torch)
    res["moe"] = check_moe(torch)
    res["archs"] = {}
    for label, name, kw, new in CHECK_ARCHS:
        c = dense_cfg(name, n_layers=2, **kw)
        a = registry.build(c)
        m, _ = policies.build(a, SEED)
        p = torch.randint(0, c.vocab_size, (BATCH, PROMPT), generator=gen)
        res["archs"][label] = check_path(torch, a, m, c, p, new)
        del m
        torch.cuda.empty_cache()
    emit(res)
    return res


def check_chunked(torch, cfg) -> dict:
    """The 2-layer chunked path on a min/max RTN backbone (K3): a prefill
    (K4 at Sq = Sk = 256) and a slot-pool decode step and verify (K4 with
    (B,) offsets) through the kernels against the plain versions; logits
    within 2⁻⁵ of their largest magnitude."""
    from repro_torch.core import policies
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    cfg = convert_cfg(cfg, "nibble").replace(attn_impl="chunked")
    api = registry.build(cfg)
    model, _ = policies.build(api, SEED)
    gen = torch.Generator().manual_seed(SEED + 6)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=gen).to("cuda")
    toks = torch.randint(0, cfg.vocab_size, (TASKS_M, SPEC_K + 1),
                         generator=gen).to("cuda")
    pos = torch.arange(TASKS_M, device="cuda") * 31 + 20

    def cache():
        c = api.init_cache(TASKS_M, 512)
        for key in c:
            c[key].normal_(generator=torch.Generator(device="cuda"
                                                     ).manual_seed(SEED))
        return c

    cases = {
        "prefill": lambda: api.prefill(model, {"tokens": prompt})[0],
        "decode": lambda: api.decode_step(model, cache(), toks[:, :1],
                                          pos)[0],
        "verify": lambda: api.decode_verify(model, cache(), toks, pos)[0],
    }
    out = {}
    for name, fn in cases.items():
        logits = {}
        for impl in ("cuda", "torch"):
            with ops.force_impl(impl), torch.inference_mode():
                logits[impl] = fn().float()
        lk, lp = logits["cuda"], logits["torch"]
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            fail(f"non-finite logits in the 2-layer chunked {name}")
        diff = (lk - lp).abs().max().item()
        tol = 2.0 ** -5 * lp.abs().max().item()
        if diff > tol:
            fail(f"2-layer chunked {name}: kernels vs plain differ by "
                 f"{diff:.3e} > {tol:.3e}")
        out[name] = {"max_abs_diff": diff, "tolerance": tol}
    return out


def check_slotted(torch, api, model, cfg) -> dict:
    """The slotted prefill (20 tokens: K5; 100 tokens: K2 per task), a
    mixed-task decode step of 8 slots, and on the same model repacked into
    bit-planes a speculative draft step (K5-plane, p = 3) and verify
    (K5-plane, 8 slots × 4 tokens), kernels against plain versions."""
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
    warm = [f"t{t}" for t in range(N_TASKS)]
    stack = ResidentStack(bank, model, N_TASKS, warm=warm).stack
    plane = plane_backbone(torch, {"cfg": cfg, "model": model})
    pstack = ResidentStack(bank, plane["model"], N_TASKS, warm=warm).stack
    gen = torch.Generator().manual_seed(SEED + 5)
    ids = torch.tensor(TASK_IDS, dtype=torch.int32, device="cuda")
    pos = torch.arange(TASKS_M, device="cuda") * 7 + 3
    toks = torch.randint(0, cfg.vocab_size, (TASKS_M, SPEC_K + 1),
                         generator=gen).to("cuda")

    def cache():
        c = api.init_cache(TASKS_M, 64)
        for key in c:
            c[key].normal_(generator=torch.Generator(device="cuda"
                                                     ).manual_seed(SEED))
        return c

    def prefill(s):
        prompt = torch.randint(0, cfg.vocab_size, (1, s),
                               generator=torch.Generator().manual_seed(s))
        return api.prefill_slotted(model, stack, {"tokens": prompt.to("cuda")},
                                   ids[2:3])[0]

    pm, papi = plane["model"], plane["api"]
    cases = {
        "prefill_k5": lambda: prefill(20),
        "prefill_k2": lambda: prefill(100),
        "decode": lambda: api.decode_step_slotted(
            model, stack, cache(), toks[:, :1], pos, ids)[0],
        "plane_draft": lambda: papi.decode_step_slotted(
            pm, pstack, cache(), toks[:, :1], pos, ids,
            draft_bits=DRAFT_BITS)[0],
        "plane_verify": lambda: papi.decode_verify_slotted(
            pm, pstack, cache(), toks, pos, ids)[0],
    }
    out = {}
    for name, fn in cases.items():
        logits = {}
        for impl in ("cuda", "torch"):
            with ops.force_impl(impl), torch.inference_mode():
                logits[impl] = fn().float()
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

class Recorder:
    """Keeps every ``ops.quant_matmul`` and ``ops.attention`` call of one
    forward — inputs and output, and after the backward the gradient of
    the loss with respect to that output — by wrapping the two entry
    points the model calls (restored on exit)."""

    def __init__(self, ops):
        self.ops, self.lin, self.attn = ops, [], []

    def _keep(self, rec, out):
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("grad", g.detach()))

    def __enter__(self):
        self._qmm, self._attn = self.ops.quant_matmul, self.ops.attention

        def qmm(x, qw, scale, zero, spec, **kw):
            y = self._qmm(x, qw, scale, zero, spec, **kw)
            rec = {"x": x.detach(), "qw": qw, "scale": scale.detach(),
                   "zero": zero.detach(), "spec": spec, "y": y.detach()}
            self._keep(rec, y)
            self.lin.append(rec)
            return y

        def attn(q, k, v, **kw):
            o = self._attn(q, k, v, **kw)
            rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(),
                   "o": o.detach(), "impl": kw.get("impl", "dense"),
                   "mask": {n: kw.get(n) for n in ("causal", "window",
                                                   "scale", "offset")
                            if n in kw}}
            self._keep(rec, o)
            self.attn.append(rec)
            return o

        self.ops.quant_matmul, self.ops.attention = qmm, attn
        return self

    def __exit__(self, *exc):
        self.ops.quant_matmul, self.ops.attention = self._qmm, self._attn


def train_step1(torch, cfg, model, batch, impl):
    """Loss and scale gradients of one forward and backward at the current
    weights (no update), every kernel call recorded."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    api = registry.build(cfg, device="cuda")
    for p in model.parameters():
        p.grad = None
    with ops.force_impl(impl), Recorder(ops) as rec:
        loss = api.loss_fn(model, batch)
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads, rec


def rows(t):
    return t.reshape(-1, t.shape[-1])


def gate_recorded_calls(torch, label, rec, rows_m: int) -> dict:
    """Every kernel call of a recorded training forward against its plain
    version on that call's own inputs, element by element: each K2 call
    (M = ``rows_m``, on its tensor-core route) within ``error_bound(...,
    factored=True)`` of ``quant_matmul_plain`` (``quant_matmul_planes_plain``
    for a bit-plane backbone), each "chunked" attention call (K4) within
    ``flash_attention.error_bound`` of ``flash_attention_plain``.  Fails on
    any element outside; returns the worst |kernel − plain| of each."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    worst = {"quant_matmul": 0.0, "flash_attention": 0.0}
    for i, r in enumerate(rec.lin):
        x, qw = rows(r["x"]), r["qw"]
        s, z = r["scale"].float(), r["zero"].float()
        what = f"train {label}: K2 call {i} (M={x.shape[0]})"
        if x.shape[0] != rows_m or not qm.tc_route(x, s):
            fail(f"{what}: expected {rows_m} rows on the tensor-core route")
        planes = ops._layout(qw, r["spec"], None)
        plain = qm.quant_matmul_plain(x, qw, s, z) if planes is None \
            else qm.quant_matmul_planes_plain(x, qw, s, z, *planes)
        err = check_close(what, rows(r["y"]), plain, qm.error_bound(
            x, qw, s, z, plain, planes=planes, factored=True))
        worst["quant_matmul"] = max(worst["quant_matmul"], err)
        del plain
    for i, r in enumerate(a for a in rec.attn if a["impl"] == "chunked"):
        q, k, v = r["q"], r["k"], r["v"]
        plain = fa.flash_attention_plain(q, k, v, **r["mask"])
        err = check_close(f"train {label}: K4 call {i}", r["o"], plain,
                          fa.error_bound(q, k, v, plain,
                                         scale=r["mask"].get("scale")))
        worst["flash_attention"] = max(worst["flash_attention"], err)
    return {"k2_calls": len(rec.lin), "k4_calls": sum(
        a["impl"] == "chunked" for a in rec.attn), "max_abs_err": worst}


def loss_bound(torch, rec, attention: bool) -> float:
    """First-order bound on how far the loss moves when every kernel of the
    recorded run (K2 at each quantized linear, or with ``attention`` K4 at
    each attention) replaces its plain version: Σ over the calls of
    Σ |∂L/∂y|·bound(y), bound the kernel's elementwise ``error_bound``
    against its plain version on the call's own inputs (with the output's
    last bf16 rounding in it).  The loss is a smooth function of every
    call's output, so to first order its change is Σ ⟨∂L/∂y, δy⟩ with
    |δy| ≤ bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_matmul as qm
    total = 0.0
    if attention:
        for r in rec.attn:
            b = fa.error_bound(r["q"], r["k"], r["v"], r["o"])
            total += float((r["grad"].float().abs() * b).sum())
        return total
    for r in rec.lin:
        b = qm.error_bound(rows(r["x"]), r["qw"], r["scale"], r["zero"],
                           rows(r["y"]), factored=True)
        total += float((rows(r["grad"]).float().abs() * b).sum())
    return total


def scale_grad_gate(torch, rec_p, rec_k, grads_p, grads_k, names) -> dict:
    """Each linear's scale gradient on the kernel route against the plain
    route's.  Both compute ds = Σ_{k∈g} (dyᵀx)·(q − z) with the same code
    (``ops.quant_matmul_bwd``) from what reached the linear on their own
    route, (x_K, dy_K) and (x_P, dy_P).  In exact arithmetic the two
    differ by at most Σ_{k∈g} (|dy_K − dy_P|ᵀ|x_K| + |dy_P|ᵀ|x_K − x_P|)
    ·(q + |z|) (the triangle inequality on dy_K x_K − dy_P x_P), and each
    computed ds is within ``ops.qmm_grad_bound`` of its exact value, so
    the bound is that sum plus twice ``qmm_grad_bound`` at (x_K, dy_K).
    Fails on any scale outside; returns the worst |Δ| / bound and the
    relative ℓ2 distance of the whole gradient."""
    from repro_torch.kernels import ops
    worst, num, den = 0.0, 0.0, 0.0
    for name, rp, rk in zip(names, rec_p.lin, rec_k.lin):
        xp, xk = rows(rp["x"]).float(), rows(rk["x"]).float()
        dyp, dyk = rows(rp["grad"]).float(), rows(rk["grad"]).float()
        qw, s, z, spec = rk["qw"], rk["scale"], rk["zero"], rk["spec"]
        n, g = s.shape
        k = xk.shape[1]
        qz = ops._codes_f32(qw, k, spec, g) + z.abs()[..., None]
        prop = ((dyk - dyp).abs().T @ xk.abs()
                + dyp.abs().T @ (xk - xp).abs()).reshape(n, g, k // g)
        prop = (prop * qz).sum(-1) * 1.001
        bds, _ = ops.qmm_grad_bound(rows(rk["x"]), qw, s, z, spec,
                                    rows(rk["grad"]))
        bound = prop + 2 * bds
        err = (grads_k[name].float() - grads_p[name].float()).abs()
        if not torch.isfinite(grads_k[name]).all():
            fail(f"train: non-finite scale gradient of {name}")
        if (err > bound).any():
            i = int(torch.argmax(err - bound))
            fail(f"train: {name}'s scale gradient on the kernel route is "
                 f"{err.flatten()[i].item():.3e} from the plain route's, "
                 f"beyond the bound {bound.flatten()[i].item():.3e}")
        worst = max(worst, float((err / bound.clamp_min(1e-30)).max()))
        num += float((err ** 2).sum())
        den += float((grads_p[name].float() ** 2).sum())
    return {"worst_err_over_bound": worst,
            "rel_l2": math.sqrt(num / den) if den else None}


def events_ms(torch, fn, iters: int = 10) -> float:
    """Device ms per call of ``fn`` between two CUDA events, after a
    warm-up call (for parts large enough that launch costs do not count)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def train_parts(torch, model, cfg, batch_rows: int, gen) -> dict:
    """A PEQA training step's device time by part, each part timed alone at
    the step's shapes (CUDA events) and multiplied by its count a step: K2
    forward (twice under remat="block": the forward and the recompute),
    the backward's Ŵ dequantization, dx = dy·Ŵ, c = dyᵀx and the ds
    reduction at each of the 7 linears of 16 layers, the tied head
    (forward, and dx of its backward) with the cross entropy, the dense
    attention's forward and backward, and the chunked one's K4 forward
    (with the logsumexp) and plain backward."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models import common
    m, layers = batch_rows, cfg.n_layers
    lin = model.layers[0]
    by_shape = {}
    for name, mod in (("wq", lin.attn.wq), ("wk", lin.attn.wk),
                      ("wv", lin.attn.wv), ("wo", lin.attn.wo),
                      ("gate", lin.mlp.gate), ("up", lin.mlp.up),
                      ("down", lin.mlp.down)):
        n, k = mod.scale.shape[0], mod.in_features
        by_shape.setdefault((n, k), []).append((name, mod))
    parts = {p: 0.0 for p in ("k2_forward", "dequant", "dx", "c", "ds")}
    per_linear = []
    for (n, k), mods in by_shape.items():
        mod = mods[0][1]
        qw, s, z = mod.qw, mod.scale.detach(), mod.zero.detach()
        g = s.shape[1]
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        dy = (torch.randn(m, n, generator=gen, device="cuda") * 1e-3
              ).to(torch.bfloat16)
        w = ref.dequant_ref(qw, s, z, (n, k), mod.spec, torch.bfloat16)
        c = ops._mm_f32(dy.T, x)
        t = {"k2_forward": events_ms(torch, lambda: qm.quant_matmul(
                 x, qw, s, z)) * 2,
             "dequant": events_ms(torch, lambda: ref.dequant_ref(
                 qw, s, z, (n, k), mod.spec, torch.bfloat16)),
             "dx": events_ms(torch, lambda: ops._mm_f32(dy, w).to(
                 torch.bfloat16)),
             "c": events_ms(torch, lambda: ops._mm_f32(dy.T, x)),
             "ds": events_ms(torch, lambda: (c.reshape(n, g, k // g) * (
                 ops._codes_f32(qw, k, mod.spec, g) - z[..., None])).sum(-1))}
        count = len(mods) * layers
        for key, ms in t.items():
            parts[key] += ms * count
        per_linear.append({"N": n, "K": k, "linears": [nm for nm, _ in mods],
                           **{f"{key}_ms": ms for key, ms in t.items()}})
    d, v = cfg.d_model, cfg.vocab_size
    h = torch.randn(m, d, generator=gen, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, v, (m,), generator=gen, device="cuda")
    emb = model.embed.emb.detach()

    def head():
        hx = h.detach().requires_grad_(True)
        logits = common.head_apply(None, model.embed, hx, cfg)
        loss = common.cross_entropy(logits, labels)
        return torch.autograd.grad(loss, hx)
    parts["head_and_cross_entropy"] = events_ms(torch, head, 5)
    b, sq = m // 256, 256
    q = torch.randn(b, sq, cfg.n_heads, cfg.d_head, generator=gen,
                    device="cuda").to(torch.bfloat16)
    kk, vv = (torch.randn(b, sq, cfg.n_kv_heads, cfg.d_head, generator=gen,
                          device="cuda").to(torch.bfloat16) for _ in range(2))
    do = torch.randn_like(q)

    def dense():
        qq, k2, v2 = (t.detach().requires_grad_(True) for t in (q, kk, vv))
        o = ops.attention(qq, k2, v2, causal=True, impl="dense")
        return torch.autograd.grad(o, (qq, k2, v2), do)
    o, lse = fa.flash_attention(q, kk, vv, return_lse=True)
    parts["attention_dense_fwd_bwd"] = events_ms(torch, dense, 5) * layers
    parts["attention_chunked_fwd"] = events_ms(
        torch, lambda: fa.flash_attention(q, kk, vv, return_lse=True)
    ) * layers * 2
    parts["attention_chunked_bwd"] = events_ms(
        torch, lambda: ops.chunked_attention_bwd(q, kk, vv, o, lse, do),
        5) * layers
    del emb
    return {"parts_ms": parts, "per_linear": per_linear,
            "bound_ms": train_part_bounds(cfg, m, by_shape)}


def train_part_bounds(cfg, m: int, by_shape: dict) -> dict:
    """The least time of each part a step, (ms, "bytes" | "operations"):
    bytes at HBM rate (each input read once, each output written once),
    operations at the rate of the units the part's data allows — bf16
    tensor cores for K2, the GEMMs of bf16 operands (dx, c, K4) and the
    tied head (bf16 operands, exact products), the float32 CUDA cores for
    the float32 attention.  Beside the head's bound, the implementation's
    own: its dx = dlogits·emb takes the float32 dlogits as they are (the
    reference's numerics), so that product runs at the float32 rate.
    nk = Σ N·K over the 112 linears."""
    layers = cfg.n_layers
    nk = sum(n * k * len(mods) for (n, k), mods in by_shape.items()) * layers
    sn = sum(n * len(mods) for (n, _), mods in by_shape.items()) * layers
    sk = sum(k * len(mods) for (_, k), mods in by_shape.items()) * layers
    d, v, s = cfg.d_model, cfg.vocab_size, 256
    b, hq, hkv, dh = m // s, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def bound(nbytes, ops, rate):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")
    mm = 2 * m * nk                                  # one product's operations
    # causal attention: half the S² logits; forward 2 products, backward 4
    att = 2 * b * hq * s * s // 2 * dh
    qkv = b * s * (hq + 2 * hkv) * dh * 2            # q, k, v in bf16
    return {
        "k2_forward": bound(2 * (m * sk * 2 + nk // 2 + m * sn * 2),
                            2 * mm, BF16_FLOPS),
        "dequant": bound(nk // 2 + nk * 2, nk, F32_FLOPS),
        "dx": bound(m * sn * 2 + nk * 2 + m * sk * 2, mm, BF16_FLOPS),
        "c": bound(m * sn * 2 + m * sk * 2 + nk * 4, mm, BF16_FLOPS),
        "ds": bound(nk * 4 + nk // 2, 3 * nk, F32_FLOPS),
        "head_and_cross_entropy": bound(v * d * 2 + m * d * 2 + m * v * 4,
                                        2 * 2 * m * d * v, BF16_FLOPS),
        "head_and_cross_entropy_f32_dx": (
            bound(v * d * 2 + m * d * 2 + m * v * 4, 2 * m * d * v,
                  BF16_FLOPS)[0]
            + bound(m * v * 4 + v * d * 2 + m * d * 2, 2 * m * d * v,
                    F32_FLOPS)[0], "operations"),
        "attention_dense_fwd_bwd": bound(
            3 * layers * (qkv + b * s * hq * dh * 2), 3 * layers * 2 * att,
            F32_FLOPS),
        "attention_chunked_fwd": bound(2 * layers * (qkv + b * s * hq * dh * 2),
                                       2 * layers * 2 * att, BF16_FLOPS),
        "attention_chunked_bwd": bound(
            layers * (qkv + 2 * b * s * hq * dh * 2), layers * 4 * att,
            F32_FLOPS)}


def phase_train(torch, main_path) -> dict:
    """PEQA training on the card (see the module docstring, phase 11)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import policies
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import loop, step
    from repro_torch.train.state import make_state

    model, cfg0 = main_path["model"], main_path["cfg"]
    tcfg = TrainConfig(steps=TRAIN_STEPS, log_every=1, eval_every=10 ** 9,
                       ckpt_every=10 ** 9)
    cfg = cfg0.replace(remat="block")
    t0 = time.perf_counter()
    toks = synthetic.corpus(cfg.vocab_size, TRAIN_TOKENS, seed=SEED)
    train_toks, val_toks = synthetic.split(toks)
    data = pipeline.PackedLM(train_toks, tcfg.batch_size, tcfg.seq_len,
                             seed=SEED)
    corpus_s = time.perf_counter() - t0
    m_rows = tcfg.batch_size * tcfg.seq_len
    mask = policies.make_mask(model, cfg)
    scales = {n: p for n, p in model.named_parameters() if mask[n]}
    if not scales or any(not n.endswith(".scale") for n in scales):
        fail(f"train: the peqa mask trains {sorted(scales)[:4]}…, not only "
             f"scales")
    n_scales = sum(p.numel() for p in scales.values())
    # a recorded call's scale is a view of its parameter: name it by that
    by_ptr = {p.data_ptr(): n for n, p in scales.items()}
    frozen = {n: t.clone() for n, t in list(model.named_parameters())
              + list(model.named_buffers()) if not mask.get(n)}
    start_scales = {n: p.detach().clone() for n, p in scales.items()}
    # the memory a run holds, its model included: what is allocated now
    # less the model's own tensors
    model_bytes = sum(t.numel() * t.element_size() for t in
                      list(model.parameters()) + list(model.buffers()))
    base = torch.cuda.memory_allocated() - model_bytes
    res = {"phase": "train", "model": cfg.name, "layers": cfg.n_layers,
           "batch": tcfg.batch_size, "seq": tcfg.seq_len, "rows": m_rows,
           "remat": cfg.remat, "corpus_tokens": TRAIN_TOKENS,
           "corpus_s": corpus_s, "scales": n_scales,
           "trainable": policies.trainable_count(model, mask),
           "frozen": policies.frozen_count(model, mask)}

    # --- the kernel route against the plain route, on step 1's batch ------
    batch = step.to_device(data.batch_at(0), "cuda")
    none = cfg.replace(remat="none")
    loss_p, grads_p, rec_p = train_step1(torch, none, model, batch, "torch")
    loss_k, grads_k, rec_k = train_step1(torch, none, model, batch, "cuda")
    if len(rec_k.lin) != cfg.n_layers * 7 or len(rec_p.lin) != len(rec_k.lin):
        fail(f"train: {len(rec_k.lin)} quantized linears recorded")
    calls = {"dense": gate_recorded_calls(torch, "dense", rec_k, m_rows)}
    k2_bound = loss_bound(torch, rec_p, attention=False)
    k4_bound = loss_bound(torch, rec_k, attention=True)
    grad_gate = scale_grad_gate(
        torch, rec_p, rec_k, grads_p, grads_k,
        [by_ptr[r["scale"].data_ptr()] for r in rec_k.lin])
    grads_k_ = grads_k
    del rec_p, grads_p, grads_k
    loss_c, _, rec_c = train_step1(
        torch, none.replace(attn_impl="chunked"), model, batch, "cuda")
    calls["chunked"] = gate_recorded_calls(torch, "chunked", rec_c, m_rows)
    if calls["chunked"]["k4_calls"] != cfg.n_layers:
        fail(f"train: {calls['chunked']['k4_calls']} K4 calls recorded "
             f"under 'chunked', expected {cfg.n_layers}")
    del rec_c
    api_block = registry.build(cfg, device="cuda")
    loss_block = api_block.loss_fn(model, batch).detach()
    for p in model.parameters():
        p.grad = None
    if not all(torch.isfinite(t) for t in (loss_p, loss_k, loss_c)):
        fail(f"train: non-finite step-1 loss ({loss_p}, {loss_k}, {loss_c})")
    if abs(float(loss_k) - float(loss_p)) > k2_bound:
        fail(f"train: kernel-route loss {float(loss_k)!r} is "
             f"{abs(float(loss_k) - float(loss_p)):.3e} from the plain "
             f"route's {float(loss_p)!r}, beyond K2's bound {k2_bound:.3e}")
    if abs(float(loss_c) - float(loss_k)) > k4_bound:
        fail(f"train: chunked loss {float(loss_c)!r} is "
             f"{abs(float(loss_c) - float(loss_k)):.3e} from dense "
             f"{float(loss_k)!r}, beyond K4's bound {k4_bound:.3e}")
    if not torch.equal(loss_block, loss_k):
        fail(f"train: remat='block' changed the step-1 loss "
             f"({float(loss_block)!r} against {float(loss_k)!r})")
    res["route_check"] = {
        "loss_plain": float(loss_p), "loss_kernel": float(loss_k),
        "loss_chunked": float(loss_c), "loss_remat_block": float(loss_block),
        "k2_loss_bound": k2_bound, "k4_loss_bound": k4_bound,
        "scale_grads": grad_gate, "calls": calls}
    del rec_k

    # --- the same backbone as bit-planes: the plane branch of K2 ----------
    plane = plane_backbone(torch, main_path)
    model_p, cfg_p = plane["model"], plane["cfg"].replace(remat="block")
    mask_p = policies.make_mask(model_p, cfg_p)
    loss_pl, grads_pl, rec_pl = train_step1(
        torch, cfg_p.replace(remat="none"), model_p, batch, "cuda")
    plane_calls = gate_recorded_calls(torch, "planes", rec_pl, m_rows)
    del rec_pl
    if not torch.equal(loss_pl, loss_k):
        fail(f"train: the bit-plane backbone's step-1 loss "
             f"{float(loss_pl)!r} is not the nibble one's {float(loss_k)!r}")
    unequal = [n for n in scales if not torch.equal(grads_pl[n], grads_k_[n])]
    if unequal:
        fail(f"train: bit-plane scale gradients differ from the nibble "
             f"ones at {unequal[:3]}")
    opt_p = make_optimizer(tcfg.optim, tcfg.steps)
    state_p = make_state(model_p, opt_p.init(
        dict(model_p.named_parameters()), mask_p))
    ts_p = step.build_train_step(registry.build(cfg_p, device="cuda"), cfg_p,
                                 tcfg, mask_p, opt_p)
    for k in ops.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_p, metrics = ts_p(state_p, data.batch_at(0))
    torch.cuda.synchronize()
    plane_ms = (time.perf_counter() - t0) * 1e3
    got = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    want_p = {"quant_matmul_planes": 2 * cfg.n_layers * 7}
    if got != want_p or not math.isfinite(float(metrics["loss"])):
        fail(f"train (planes): a step launched {got}, expected {want_p}; "
             f"loss {float(metrics['loss'])}")
    res["planes"] = {"loss_step1": float(loss_pl), "calls": plane_calls,
                     "equal_to_nibble": True, "step_ms": plane_ms,
                     "launches_a_step": got,
                     "state_bytes": opt_p.state_bytes(state_p["opt"])}
    del plane, model_p, state_p, opt_p, ts_p, grads_pl, grads_k_

    # --- K4's logsumexp: o bit-equal with and without it -----------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(tcfg.batch_size, tcfg.seq_len, cfg.n_heads, cfg.d_head,
                    generator=gen, device="cuda").to(torch.bfloat16)
    kk, vv = (torch.randn(tcfg.batch_size, tcfg.seq_len, cfg.n_kv_heads,
                          cfg.d_head, generator=gen, device="cuda"
                          ).to(torch.bfloat16) for _ in range(2))
    o_only = fa.flash_attention(q, kk, vv)
    o, lse = fa.flash_attention(q, kk, vv, return_lse=True)
    _, lse_plain = fa.flash_attention_plain(q, kk, vv, return_lse=True)
    torch.cuda.synchronize()
    if not torch.equal(o, o_only):
        fail("train: K4's o changed when its logsumexp was asked for")
    res["lse_max_abs_err"] = check_close(
        "flash_attention logsumexp", lse, lse_plain,
        fa.lse_error_bound(q, kk, lse_plain))
    res["parts"] = train_parts(torch, model, cfg, m_rows, gen)
    del q, kk, vv, o, o_only, lse, lse_plain

    # --- 10 steps under "dense", then under "chunked" ---------------------
    want = {"dense": {"quant_matmul": 2 * cfg.n_layers * 7},
            "chunked": {"quant_matmul": 2 * cfg.n_layers * 7,
                        "flash_attention": 2 * cfg.n_layers}}
    for impl in ("dense", "chunked"):
        with torch.no_grad():
            for n, p in scales.items():
                p.copy_(start_scales[n])
        icfg = cfg.replace(attn_impl=impl)
        api = registry.build(icfg, device="cuda")
        opt = make_optimizer(tcfg.optim, tcfg.steps)
        state = make_state(model, opt.init(dict(model.named_parameters()),
                                           mask))
        ts = step.build_train_step(api, icfg, tcfg, mask, opt)
        walls, dev, seen = [], [], []

        def counted(state, batch, ts=ts):
            for k in ops.KERNELS:
                k.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            state, metrics = ts(state, batch)
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            dev.append(start.elapsed_time(end))
            seen.append({k.__name__: k.launches for k in ops.KERNELS
                         if k.launches})
            return state, metrics

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, hist = loop.train(state, counted, data, tcfg,
                                 log=lambda msg: None)
        peak = torch.cuda.max_memory_allocated() - base
        bad = [i for i, got in enumerate(seen) if got != want[impl]]
        if bad:
            fail(f"train ({impl}): step {bad[0] + 1} launched "
                 f"{seen[bad[0]]}, expected {want[impl]} a step")
        losses = [h["loss"] for h in hist]
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            fail(f"train ({impl}): losses {losses}")
        sbytes = opt.state_bytes(state["opt"])
        if sbytes != 8 * n_scales:
            fail(f"train ({impl}): optimizer state {sbytes} bytes, expected "
                 f"8 × {n_scales} scales")
        if all(torch.equal(p, start_scales[n]) for n, p in scales.items()):
            fail(f"train ({impl}): no scale moved in {TRAIN_STEPS} steps")
        med = sorted(walls[TRAIN_SKIP:])[(TRAIN_STEPS - TRAIN_SKIP) // 2]
        res[impl] = {
            "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
            "lrs": [h["lr"] for h in hist], "step_ms": walls,
            "median_step_ms": med, "tokens_per_s": m_rows / med * 1e3,
            "device_ms": dev,
            "median_device_ms": sorted(dev[TRAIN_SKIP:])[
                (TRAIN_STEPS - TRAIN_SKIP) // 2],
            "peak_mem_gb": peak / 1e9, "state_bytes": sbytes,
            "launches_a_step": seen[-1]}
        if impl == "chunked":
            # one more step, profiled: where the backward's time goes
            dev_ms, top = device_ms(
                torch, lambda: ts(state, data.batch_at(TRAIN_STEPS)), top=14)
            res["profile"] = {"device_ms": dev_ms, "top": top}
            ev = step.build_eval_step(api, icfg)
            for k in ops.KERNELS:
                k.launches = 0
            batches = [b for _, b in zip(range(TRAIN_EVAL_BATCHES),
                                         pipeline.eval_batches(
                                             val_toks, tcfg.batch_size,
                                             tcfg.seq_len))]
            ppl = loop.eval_perplexity(model, ev, batches)
            launches = {k.__name__: k.launches for k in ops.KERNELS
                        if k.launches}
            per = {kk: vv * len(batches) // 2 for kk, vv in want[impl].items()}
            if launches != per or not math.isfinite(ppl):
                fail(f"train: eval_perplexity {ppl} over {len(batches)} "
                     f"batches launched {launches}, expected {per}")
            res["eval"] = {"batches": len(batches), "perplexity": ppl,
                           "launches": launches}
        del state, opt, ts
    for n, t in list(model.named_parameters()) + list(model.named_buffers()):
        if n in frozen and not torch.equal(t, frozen[n]):
            fail(f"train: frozen {n} changed")
    res["frozen_checked"] = len(frozen)
    del frozen, start_scales
    emit(res)
    return res


class MeasuredUpdate:
    """``opt`` with the memory of its update measured from ``base``: the
    bytes allocated as it starts (model, optimizer state and gradients), the
    gradients' bytes, the forward and backward's peak before it and its own
    peak.  Pass it to ``build_train_step`` in the optimizer's place."""

    def __init__(self, torch, opt, base):
        self.torch, self.opt, self.base = torch, opt, base
        self.steps = []

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, grads, *args):
        cuda = self.torch.cuda
        cuda.synchronize()
        rec = {"fwd_bwd_peak": cuda.max_memory_allocated() - self.base,
               "at_update": cuda.memory_allocated() - self.base,
               "grad_bytes": sum(g.numel() * g.element_size()
                                 for g in grads.values() if g is not None)}
        cuda.reset_peak_memory_stats()
        out = self.opt.update(grads, *args)
        cuda.synchronize()
        rec["update_peak"] = cuda.max_memory_allocated() - self.base
        self.steps.append(rec)
        return out


def phase_train_full(torch, main_path, peqa) -> dict:
    """One full-mode step at the same size: every float tensor trained,
    float32 linear weights, AdamW moments for all of them — beside PEQA's
    peak memory and optimizer state (the paper's Table 1).  The token table
    must be a float32 master and move at step 1 (its entries in the first
    batch's rows, held on the host); the peak is given with its parts —
    the model's and the optimizer's bytes, the gradients', and the peaks of
    the forward and backward and of the update (``MeasuredUpdate``)."""
    from repro_torch.configs.base import TrainConfig, TuningConfig
    from repro_torch.core import policies
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import step
    from repro_torch.train.state import make_state
    cfg = main_path["cfg"].replace(tuning=TuningConfig(mode="full"),
                                   remat="block")
    tcfg = TrainConfig(steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    api = registry.build(cfg, device="cuda")
    model, mask = policies.prepare(api.init(SEED), cfg, device="cuda")
    table = model.embed.emb
    if table.dtype != torch.float32 or not mask["embed.emb"]:
        fail(f"train_full: the trained token table is {table.dtype}, "
             f"trained {mask['embed.emb']}; expected a float32 master")
    torch.cuda.synchronize()
    model_bytes = torch.cuda.memory_allocated() - base
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    measured = MeasuredUpdate(torch, opt, base)
    ts = step.build_train_step(api, cfg, tcfg, mask, measured)
    data = pipeline.PackedLM(synthetic.corpus(cfg.vocab_size, 20_000,
                                              seed=SEED),
                             tcfg.batch_size, tcfg.seq_len)
    batch0 = data.batch_at(0)
    ids = torch.unique(torch.as_tensor(batch0["tokens"]).flatten())
    rows0 = table.detach()[ids.to("cuda")].cpu()
    for k in ops.KERNELS:
        k.launches = 0
    walls, peaks = [], [torch.cuda.max_memory_allocated() - base]
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = ts(state, batch0 if i == 0 else data.batch_at(i))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        if i == 0:
            moved = (table.detach()[ids.to("cuda")].cpu() != rows0
                     ).float().mean().item()
    if moved < 0.5:
        fail(f"train_full: step 1 moved {moved:.3f} of the table's entries "
             f"in the batch's {ids.numel()} rows")
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        fail(f"train_full: loss {loss}")
    n_float = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    sbytes = opt.state_bytes(state["opt"])
    if sbytes != 8 * n_float:
        fail(f"train_full: optimizer state {sbytes} bytes for {n_float} "
             f"trained values")
    peak = max(peaks + [m for r in measured.steps
                        for m in (r["fwd_bwd_peak"], r["update_peak"])])
    res = {"phase": "train_full", "mode": "full", "trainable": n_float,
           "loss": loss, "step_ms": walls, "peak_mem_gb": peak / 1e9,
           "model_bytes": model_bytes,
           "table": {"dtype": str(table.dtype).removeprefix("torch."),
                     "bytes": table.numel() * table.element_size(),
                     "rows_checked": ids.numel(),
                     "moved_share_step1": moved},
           "memory_by_step": measured.steps, "state_bytes": sbytes,
           "launches": {k.__name__: k.launches for k in ops.KERNELS
                        if k.launches},
           "peqa": {"peak_mem_gb": peqa["dense"]["peak_mem_gb"],
                    "state_bytes": peqa["dense"]["state_bytes"],
                    "trainable": peqa["scales"]},
           "state_ratio": sbytes / peqa["dense"]["state_bytes"]}
    emit(res)
    del state, model, opt
    torch.cuda.empty_cache()
    return res


class CheckedQuantMatmul:
    """Holds every ``ops.quant_matmul`` call, as it happens, element by
    element against ``quant_matmul_plain`` on the call's own inputs, on the
    tensor-core route within ``error_bound(..., factored=True)`` — with
    ``gemv=True`` for the GEMV's M ≤ 32 rows (K1), else K2 —, without
    keeping a 7B model's activations alive (what ``gate_recorded_calls``
    asks of a recorded call).  ``rows_m``, where given, is the M every call
    must have.  Likewise every ``ops.quant_matmul_experts`` call (an MoE
    block's expert stacks: the expert-axis GEMV at C ≤ 32 rows an expert,
    else the expert-axis GEMM) against ``quant_matmul_experts_plain``
    within the same bound, expert by expert; with ``bitwise_2d`` each of
    its slices is also held bit for bit to the 2-D kernel's launch on that
    expert's operands (launches made for the comparison are taken off the
    counters again).  ``watch = (i, j)``: expert call j's input must equal
    expert call i's bit for bit (a remat recompute's first expert call
    against the forward's: the same routing).  Counts the calls checked by
    kernel (``calls``).  Wraps the entry points the model calls; restored
    on exit."""

    def __init__(self, ops, label, rows_m=None, bitwise_2d=False,
                 watch=None):
        self.ops, self.label, self.rows_m = ops, label, rows_m
        self.bitwise_2d, self.watch = bitwise_2d, watch
        self.calls = {"quant_gemv": 0, "quant_matmul": 0,
                      "quant_gemv_experts": 0, "quant_matmul_experts": 0}
        self.worst = 0.0
        self.slices_bitwise = 0
        self.watched = None
        self._n_expert = 0

    def __enter__(self):
        import torch
        from repro_torch.kernels import quant_matmul as qm
        self._qmm = self.ops.quant_matmul

        def qmm(x, qw, scale, zero, spec, **kw):
            y = self._qmm(x, qw, scale, zero, spec, **kw)
            with torch.no_grad():
                xr, s, z = rows(x), scale.float(), zero.float()
                m = xr.shape[0]
                gemv = m <= qm.GEMV_MAX_M
                name = "quant_gemv" if gemv else "quant_matmul"
                what = (f"{self.label}: {name} call {self.calls[name]} "
                        f"(M={m})")
                if kw.get("draft_bits") is not None or (
                        self.rows_m is not None and m != self.rows_m) \
                        or not qm.tc_route(xr, s):
                    fail(f"{what}: expected {self.rows_m or 'its'} rows of "
                         f"nibble codes on the tensor-core route")
                plain = qm.quant_matmul_plain(xr, qw, s, z)
                err = check_close(what, rows(y.detach()), plain,
                                  qm.error_bound(xr, qw, s, z, plain,
                                                 factored=True, gemv=gemv))
            self.calls[name] += 1
            self.worst = max(self.worst, err)
            return y

        self._qmme = self.ops.quant_matmul_experts

        def qmme(x, qw, scale, zero, spec):
            y = self._qmme(x, qw, scale, zero, spec)
            with torch.no_grad():
                self._expert_call(torch, qm, x, qw, scale, zero, y)
            return y

        self.ops.quant_matmul = qmm
        self.ops.quant_matmul_experts = qmme
        return self

    def _expert_call(self, torch, qm, x, qw, scale, zero, y):
        xe, s, z = x.detach().contiguous(), scale.float(), zero.float()
        gemv = xe.shape[1] <= qm.GEMV_MAX_M
        name = "quant_gemv_experts" if gemv else "quant_matmul_experts"
        what = (f"{self.label}: {name} call {self.calls[name]} "
                f"(E={xe.shape[0]}, C={xe.shape[1]})")
        if not qm.tc_route(xe[0], s[0]):
            fail(f"{what}: expected nibble codes on the tensor-core route")
        plain = qm.quant_matmul_experts_plain(xe, qw, s, z)
        err = check_close(what, y.detach(), plain, qm.error_bound(
            xe, qw, s, z, plain, factored=True, gemv=gemv))
        del plain
        if self.bitwise_2d:
            fn = qm.quant_gemv if gemv else qm.quant_matmul
            saved = fn.launches
            for e in range(xe.shape[0]):
                if not torch.equal(y[e], fn(xe[e], qw[e], s[e], z[e])):
                    fail(f"{what}: slice {e} differs from the 2-D kernel's "
                         f"launch on that expert")
            fn.launches = saved
            self.slices_bitwise += xe.shape[0]
        if self.watch is not None:
            i, j = self.watch
            if self._n_expert == i:
                self.watched = xe.clone()
            elif self._n_expert == j:
                if self.watched is None or not torch.equal(self.watched, xe):
                    fail(f"{self.label}: expert call {j}'s input (the "
                         f"recompute's) differs from call {i}'s (the "
                         f"forward's): the recompute routed differently")
                self.watched = True
        self._n_expert += 1
        self.calls[name] += 1
        self.worst = max(self.worst, err)

    def __exit__(self, *exc):
        self.ops.quant_matmul = self._qmm
        self.ops.quant_matmul_experts = self._qmme


def dense_build(torch, name: str, **kw):
    """``dense_cfg(name, **kw)`` at full width from the seed through the
    layer-by-layer build (``policies.build``: each block's random float32
    weights drawn and quantized before the next block exists).  Returns
    (cfg, api, model, mask, figures): the build's seconds, its peak above
    what was allocated before it (``max_memory_allocated``), the model's
    bytes and one block's float32 bytes."""
    from repro_torch.core import policies
    from repro_torch.models import registry
    cfg = dense_cfg(name, **kw)
    api = registry.build(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, mask = policies.build(api, SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return cfg, api, model, mask, {
        "build_s": secs,
        "build_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
        "model_gb": model_bytes(model) / 1e9,
        "block_fp32_gb": block_fp32_bytes(torch, cfg) / 1e9}


def block_fp32_bytes(torch, cfg) -> int:
    """One block's float32 bytes before quantization (its linears, biases
    and norms: what the layer-by-layer build holds beside the model)."""
    from repro_torch.models import transformer
    block = transformer.Block(cfg, device="meta")
    return 4 * sum(p.numel() for p in block.parameters())


def n_quantized(model, experts: bool = False) -> int:
    """The model's quantized linears: 7 a layer with a SwiGLU MLP, 6 with
    a GELU one, 4 (attention) with an MoE block — plus 3 with deepseek's
    shared MLP; with ``experts``, its quantized expert stacks instead (3
    an MoE block)."""
    from repro_torch.models.linear import Linear
    return sum(isinstance(m, Linear) and m.quantized
               and (m.n_experts is not None) == experts
               for m in model.modules())


def launch_want(model, prefill: int, steps: int, layers: int) -> dict:
    """The launches of ``prefill`` prefills and ``steps`` decode steps of a
    lockstep batch: one K2 (K1 for a step) a 2-D quantized linear, one
    expert-axis K2 (K1) an expert stack — a prefill's rows give every
    expert C > 32 capacity rows, a step's of BATCH rows C = 1 —, and L K4
    launches a step."""
    n_lin, n_exp = n_quantized(model), n_quantized(model, experts=True)
    want = {"quant_matmul": n_lin * prefill, "quant_gemv": n_lin * steps,
            "flash_attention": layers * steps}
    if n_exp:
        want.update(quant_matmul_experts=n_exp * prefill,
                    quant_gemv_experts=n_exp * steps)
    return {k: v for k, v in want.items() if v}


def dense_generate(torch, label, api, model, prompt, prefix=None) -> dict:
    """``Engine.generate`` of ``prompt`` (behind a vlm's ``prefix`` (B, P,
    d), where given) and NEW tokens with every launch counter at 0: one K2
    launch a quantized linear for the prefill, one K1 a linear and L K4
    launches a decode step; then the prefill alone, timed, its logits
    kept.  Returns {"res", "out", "logits"}."""
    from repro_torch.kernels import ops
    from repro_torch.train.serve import Engine
    cfg = api.cfg
    engine = Engine(api, model)
    engine.generate(prompt, 2, prefix=prefix)        # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompt, NEW, prefix=prefix)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = NEW - 1
    want = launch_want(model, 1, steps, cfg.n_layers)
    if launches != want:
        fail(f"{label} generate: launches {launches}, expected {want}")
    if tuple(out.shape) != (BATCH, PROMPT + NEW) or not torch.equal(
            out[:, :PROMPT].cpu(), prompt):
        fail(f"{label} generate returned {tuple(out.shape)} or changed the "
             f"prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail(f"{label}: generated token ids outside the vocabulary")
    batch = {"tokens": prompt.to("cuda")}
    if prefix is not None:
        batch["image_embeds"] = prefix
    with torch.inference_mode():
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = api.prefill(model, batch)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
    if not torch.isfinite(logits).all():
        fail(f"{label}: non-finite prefill logits")
    prefill_s = sorted(pre)[1]
    return {"res": {"generate_s": total_s, "prefill_ms": prefill_s * 1e3,
                    "decode_ms_per_step": (total_s - prefill_s) * 1e3
                    / steps,
                    "tokens_per_s": BATCH * NEW / total_s,
                    "peak_mem_gb": peak / 1e9, "launches": launches},
            "out": out, "logits": logits}


def checked_generate(torch, label, api, model, prompt, prefix=None) -> dict:
    """``Engine.generate`` of ``prompt`` (and ``prefix``) and 2 tokens —
    the prefill and one decode step — with every K2 call (the prefill's, M
    = B·(P + S)) and K1 call (the step's, M = B) held to plain element by
    element as it happens (``CheckedQuantMatmul``): exactly one of each a
    quantized linear; and likewise, for an MoE model, every expert-axis K2
    (the prefill's) and K1 (the step's) call, each slice also bit-equal to
    the 2-D kernel's launch on its expert."""
    from repro_torch.kernels import ops
    from repro_torch.train.serve import Engine
    with CheckedQuantMatmul(ops, f"{label} generate",
                            bitwise_2d=True) as chk:
        Engine(api, model).generate(prompt, 2, prefix=prefix)
    want = {k: 0 for k in chk.calls}
    want.update({k: v for k, v in launch_want(
        model, 1, 1, api.cfg.n_layers).items() if k in want})
    if chk.calls != want:
        fail(f"{label}: {chk.calls} calls checked against plain, expected "
             f"{want}")
    return {"calls_checked": chk.calls, "qmm_max_abs_err": chk.worst,
            "expert_slices_bitwise_2d": chk.slices_bitwise}


def full_mode_bytes(model) -> tuple:
    """(values, bytes) full fine-tuning would hold: every weight of the fp
    model (a quantized linear counted as its in × out weights) in float32
    with its gradient and two AdamW moments, 16 B a value."""
    from repro_torch.models.linear import Linear
    n = sum(m.in_features * m.out_features for m in model.modules()
            if isinstance(m, Linear) and m.quantized)
    n += sum(p.numel() for name, p in model.named_parameters()
             if not name.endswith((".scale", ".zero")))
    return n, 16 * n


def dense_train(torch, label, cfg0, model, mask, steps, batch_size=None,
                prefix_rows=0) -> dict:
    """``steps`` PEQA train steps at TrainConfig's 8 × 256 tokens (K2 at M =
    2048; ``batch_size`` rows of 256 where given, each behind
    ``prefix_rows`` seeded N(0, 1) float32 patch embeddings for a vlm, the
    loss on the text rows: K2 at M = B·(P + 256)), remat "block", on a
    synthetic corpus at the model's vocabulary:
    step 1's K2 calls (forward and recompute) each held to plain element by
    element (``CheckedQuantMatmul``); exactly two K2 launches a quantized linear and
    nothing else every step (the recompute of a block stops once its last
    saved tensor is back — the down projection's input —, so that
    projection's recomputed launch returns no output to check: L fewer
    calls are checked than launched); finite losses; optimizer state = 8 B × the scales; only
    the scales move (the codes, zeros, biases, norms, table and head equal
    their copies on the device).  Figures: the timed steps' walls (step 1,
    checked, is not timed), tokens/s, peak memory of the run."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import policies
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import step
    from repro_torch.train.state import make_state
    cfg = cfg0.replace(remat="block")
    tcfg = TrainConfig(steps=steps)
    if batch_size is not None:
        tcfg = TrainConfig(steps=steps, batch_size=batch_size)
    data = pipeline.PackedLM(
        synthetic.corpus(cfg.vocab_size, 4 * steps * tcfg.batch_size
                         * tcfg.seq_len, seed=SEED),
        tcfg.batch_size, tcfg.seq_len, seed=SEED)
    m_rows = tcfg.batch_size * (prefix_rows + tcfg.seq_len)
    pgen = torch.Generator().manual_seed(SEED + 12)

    def batch_at(i):
        batch = data.batch_at(i)
        if prefix_rows:
            batch["image_embeds"] = torch.randn(
                tcfg.batch_size, prefix_rows, cfg.d_model, generator=pgen)
        return batch
    n_lin, n_exp = n_quantized(model), n_quantized(model, experts=True)
    scales = {n: p for n, p in model.named_parameters() if mask[n]}
    if not scales or any(not n.endswith(".scale") for n in scales):
        fail(f"{label} train: the peqa mask trains {sorted(scales)[:4]}…")
    n_scales = sum(p.numel() for p in scales.values())
    # device copies (a host copy of mixtral-8x7b's 24 GB took ≈ 15 s each
    # way); they are allocated before ``base``, so the peak leaves them out
    frozen = {n: t.detach().clone() for n, t in
              list(model.named_parameters()) + list(model.named_buffers())
              if not mask.get(n)}
    start = {n: p.detach().clone() for n, p in scales.items()}
    model_bytes = sum(t.numel() * t.element_size() for t in
                      list(model.parameters()) + list(model.buffers()))
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(registry.build(cfg), cfg, tcfg, mask, opt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() - model_bytes
    torch.cuda.reset_peak_memory_stats()
    walls, losses, seen = [], [], []
    for i in range(steps):
        for k in ops.KERNELS:
            k.launches = 0
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            # an MoE model: the recompute's first expert call (the last
            # block's, 3 an MoE block) must see the forward's inputs
            watch = (3 * (cfg.n_layers - 1), 3 * cfg.n_layers) if n_exp \
                else None
            with CheckedQuantMatmul(ops, f"train {label}", m_rows,
                                    watch=watch) as chk:
                state, metrics = ts(state, batch)
            if n_exp and chk.watched is not True:
                fail(f"{label} train: the recompute's routing was not "
                     f"compared ({chk.calls} checked)")
        else:
            state, metrics = ts(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        seen.append({k.__name__: k.launches for k in ops.KERNELS
                     if k.launches})
    peak = torch.cuda.max_memory_allocated() - base
    want = {"quant_matmul": 2 * n_lin}
    checked = chk.calls["quant_matmul"]
    # the recompute stops once the block's last saved tensor is back: in a
    # dense block (and deepseek's, whose shared MLP comes last) inside the
    # down projection, whose output is then never returned; in mixtral's
    # MoE block after the expert combine (the aux loss saves last)
    unchecked = {2 * n_lin - cfg.n_layers} if not n_exp else \
        {2 * n_lin - cfg.n_layers, 2 * n_lin}
    if n_exp:
        want["quant_matmul_experts"] = 2 * n_exp
        if chk.calls["quant_matmul_experts"] not in (
                2 * n_exp, 2 * n_exp - cfg.n_layers):
            fail(f"{label} train: {chk.calls} checked in step 1")
    if checked not in unchecked or any(got != want for got in seen):
        fail(f"{label} train: {checked} K2 calls checked in step 1, "
             f"launches {seen}; expected {sorted(unchecked)} and "
             f"{want} a step")
    if not all(map(math.isfinite, losses)):
        fail(f"{label} train: losses {losses}")
    sbytes = opt.state_bytes(state["opt"])
    if sbytes != 8 * n_scales:
        fail(f"{label} train: optimizer state {sbytes} bytes, expected 8 × "
             f"{n_scales} scales")
    if all(torch.equal(p, start[n]) for n, p in scales.items()):
        fail(f"{label} train: no scale moved")
    for n, t in list(model.named_parameters()) + list(model.named_buffers()):
        if n in frozen and not torch.equal(t.detach(), frozen[n]):
            fail(f"{label} train: frozen {n} changed")
    timed_ms = walls[1:]
    med = sorted(timed_ms)[len(timed_ms) // 2] if timed_ms else None
    del state, opt, ts, start
    return {"steps": steps, "rows": m_rows, "batch": tcfg.batch_size,
            "prefix_rows": prefix_rows, "remat": cfg.remat,
            "losses": losses, "step_ms": walls,
            "median_step_ms": med,
            "tokens_per_s": m_rows / med * 1e3 if med else None,
            "k2_calls_checked": checked, "k2_max_abs_err": chk.worst,
            "expert_k2_calls_checked": chk.calls["quant_matmul_experts"],
            "recompute_routing_equal": (chk.watched is True) if n_exp
            else None,
            "launches_a_step": seen[-1], "peak_mem_gb": peak / 1e9,
            "state_bytes": sbytes, "scales": n_scales,
            "trainable": policies.trainable_count(model, mask),
            "frozen": policies.frozen_count(model, mask),
            "frozen_checked": len(frozen)}


def head_times(torch, model, cfg, gen) -> dict:
    """The untied head's device ms (CUDA events) under the fp linear's
    earlier rule — a float32 GEMM of x widened and of w cast to bf16 and
    widened — and under ``ops.dot_f32`` (a bf16 GEMM with a float32
    output): a decode step's (M = BATCH) forward, and a training step's
    (M = 2048) forward and dx."""
    from repro_torch.kernels import ops
    bf = torch.bfloat16
    w = model.lm_head.w.detach()

    def before(x):
        return torch.matmul(x.float(), w.to(bf).float().T).to(bf)

    def after(x):
        return ops.dot_f32(x, w.to(bf)).to(bf)
    x_dec = torch.randn(BATCH, cfg.d_model, generator=gen,
                        device="cuda").to(bf)
    x_tr = torch.randn(2048, cfg.d_model, generator=gen, device="cuda").to(bf)
    dy = (torch.randn(2048, cfg.vocab_size, generator=gen, device="cuda")
          * 1e-3).to(bf)
    out = {"shape": list(w.shape), "train_rows": 2048,
           "decode_rows": BATCH}
    for name, fn in (("before", before), ("after", after)):
        with torch.no_grad():
            dec = events_ms(torch, lambda: fn(x_dec), iters=20)

        def train(fn=fn):
            fn(x_tr.clone().requires_grad_(True)).backward(dy)
        out[name] = {"decode_ms": dec, "train_ms": events_ms(torch, train,
                                                             iters=5)}
    del dy
    return out


def phase_dense_archs(torch) -> dict:
    """qwen2-7b and starcoder2-7b at full width and depth (module
    docstring, phase 13)."""
    from repro_torch.models import registry
    gen = torch.Generator().manual_seed(SEED + 11)
    cgen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    res = {"phase": "dense_archs"}

    # --- qwen2-7b: generate, serve, the int8 cache, training --------------
    cfg, api, model, mask, built = dense_build(torch, "qwen2-7b")
    q = {"model": cfg.name, "layers": cfg.n_layers, **built}
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    g16 = dense_generate(torch, "qwen2-7b", api, model, prompt)
    q["generate"] = g16["res"]
    q["profile"] = phase_profile(torch, {"api": api, "model": model,
                                         "prompt": prompt},
                                 phase="dense_archs_profile")
    phase_serve(torch, {"api": api, "model": model, "cfg": cfg},
                phase="dense_archs_serve", probes=False,
                n_requests=DENSE_SERVE_REQUESTS)
    cfg8 = cfg.replace(kv_cache_dtype="int8")
    api8 = registry.build(cfg8)
    g8 = dense_generate(torch, "qwen2-7b int8 cache", api8, model, prompt)
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in c.values())
    c16, c8 = (a.init_cache(BATCH, PROMPT + NEW) for a in (api, api8))
    scale_bytes = nbytes({k: c8[k] for k in ("k_scale", "v_scale")})
    if nbytes(c8) != nbytes(c16) // 2 + scale_bytes:
        fail(f"int8 cache: {nbytes(c8)} bytes against bf16's {nbytes(c16)}")
    if not torch.equal(g8["logits"], g16["logits"]):
        fail("int8 cache: prefill logits differ from the bf16 cache run's "
             "(the prefill does not read the cache)")
    q["int8_cache"] = {
        **g8["res"], "cache_bytes": nbytes(c8), "bf16_cache_bytes":
        nbytes(c16), "scale_bytes": scale_bytes, "prefill_logits_equal": True,
        "tokens_equal_share_vs_bf16": (g8["out"] == g16["out"])[
            :, PROMPT:].float().mean().item()}
    del c16, c8, g8, g16, api8
    q["train"] = dense_train(torch, "qwen2-7b", cfg, model, mask,
                             DENSE_TRAIN_STEPS)
    q["full_mode_values"], q["full_mode_bytes_reckoned"] = \
        full_mode_bytes(model)
    q["head_ms"] = head_times(torch, model, cfg, cgen)
    res["qwen2-7b"] = q
    emit({"phase": "dense_archs_qwen2", **q})
    del model, mask, api
    torch.cuda.empty_cache()

    # --- starcoder2-7b: generate and a train step -------------------------
    cfg, api, model, mask, built = dense_build(torch, "starcoder2-7b")
    st = {"model": cfg.name, "layers": cfg.n_layers, **built}
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    st["generate"] = dense_generate(torch, "starcoder2-7b", api, model,
                                    prompt)["res"]
    st["train"] = dense_train(torch, "starcoder2-7b", cfg, model, mask, 2)
    st["full_mode_values"], st["full_mode_bytes_reckoned"] = \
        full_mode_bytes(model)
    res["starcoder2-7b"] = st
    emit({"phase": "dense_archs_starcoder2", **st})
    del model, mask, api
    torch.cuda.empty_cache()

    # --- granite-34b whole: the layer-by-layer build and generate ---------
    res["granite-34b"] = granite_whole(torch, gen)
    emit({"phase": "dense_archs_granite34b", **res["granite-34b"]})
    return res


def granite_whole(torch, gen) -> dict:
    """granite-34b at full width and GRANITE_LAYERS of its 88 layers (34 GB
    of float32 weights at 16; mixtral-8x7b's 187 GB in phase moe
    carry the proof of a build larger than the card): the build's peak
    within the model's bytes plus two blocks' float32 bytes;
    ``Engine.generate`` of 4 × 256 tokens and NEW new with the exact
    launch counts (L × 7 K2 for the prefill, L × 7 K1 and L K4 a decode
    step), the prefill's K2 calls and the first step's K1 calls each held
    to plain."""
    cfg, api, model, mask, built = dense_build(torch, "granite-34b",
                                               n_layers=GRANITE_LAYERS)
    g = {"model": cfg.name, "layers": cfg.n_layers, **built}
    bound = built["model_gb"] + 2 * built["block_fp32_gb"]
    g["build_peak_bound_gb"] = bound
    if built["build_peak_gb"] > bound:
        fail(f"granite-34b build: peak {built['build_peak_gb']:.3f} GB above "
             f"the model's {built['model_gb']:.3f} GB plus two blocks' "
             f"float32 {2 * built['block_fp32_gb']:.3f} GB")
    if n_quantized(model) != 7 * cfg.n_layers:
        fail(f"granite-34b build: {n_quantized(model)} quantized linears")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    g["checked"] = checked_generate(torch, "granite-34b", api, model, prompt)
    g["generate"] = dense_generate(torch, "granite-34b", api, model,
                                   prompt)["res"]
    del model, mask, api
    torch.cuda.empty_cache()
    return g


# ---------------------------------------------------------------------------
# phase vlm: llava-next-mistral-7b and its image-embedding prefix
# ---------------------------------------------------------------------------

def vlm_requests(cfg, n, prompts, news, tasks, arrive_every, seed):
    """``n`` requests, each behind its own prefix of ``cfg.n_img_tokens``
    seeded N(0, 1) float32 rows; prompt lengths and budgets in turn, the
    tasks ``t0``… in runs of ``n / tasks`` (one task's burst after
    another), arriving every ``arrive_every`` pool steps."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(
        tokens=rng.integers(0, cfg.vocab_size, prompts[i % len(prompts)]),
        n_new=news[i % len(news)], task=f"t{i * tasks // n}",
        prefix=rng.standard_normal((cfg.n_img_tokens, cfg.d_model),
                                   dtype=np.float32),
        arrival_step=arrive_every * i) for i in range(n)]


def task_bank(model, tasks: int, seed: int):
    """A ScaleBank of ``tasks`` scale sets: the model's own (``t0``), then
    seeded random scalings of them within 10%."""
    import numpy as np
    from repro_torch.core.scale_bank import ScaleBank
    bank = ScaleBank()
    bank.add("t0", model)
    rng = np.random.default_rng(seed)
    for t in range(1, tasks):
        bank.tasks[f"t{t}"] = {
            k: (v * rng.uniform(0.9, 1.1, v.shape)).astype(v.dtype)
            for k, v in bank.tasks["t0"].items()}
    return bank


def vlm_serve(torch, api, model, cfg) -> dict:
    """VLM_REQUESTS prefixed requests over VLM_TASKS tasks through
    ``Engine.serve`` in VLM_SLOTS slots, under drain and then resident, each
    pool at ``serve``'s own capacity — which must count the 576 prefix rows
    — with the exact launches (every prefill of 576 + S rows through K2,
    once a linear; a decode step K1 under drain, K5 under resident, and K4
    a layer) and identical tokens."""
    from repro_torch.serve import ServeConfig
    from repro_torch.train.serve import Engine
    bank = task_bank(model, VLM_TASKS, SEED + 14)
    reqs = vlm_requests(cfg, VLM_REQUESTS, VLM_PROMPTS, VLM_NEW, VLM_TASKS,
                        2, SEED + 15)
    n_lin = n_quantized(model)
    capacity = max(cfg.n_img_tokens + r.n_prompt + r.n_new for r in reqs)
    res = {"requests": len(reqs), "slots": VLM_SLOTS, "tasks": VLM_TASKS,
           "prefix_rows": cfg.n_img_tokens, "capacity": capacity}
    reports, check = {}, {"peak": 0}
    for sched, gemv in (("drain", "quant_gemv"),
                        ("resident", "quant_gemv_tasks")):
        eng = Engine(api, model, bank=bank)
        pools, open_pool = [], eng.open_pool

        def opened(n, c, _pools=pools, _open=open_pool):
            _pools.append(c)
            return _open(n, c)
        eng.open_pool = opened
        reports[sched], _, _ = serve_run(
            torch, res, check, cfg.vocab_size, sched, eng, "step", reqs,
            ServeConfig(n_slots=VLM_SLOTS, scheduler=sched,
                        resident_tasks=VLM_TASKS),
            lambda n, g=gemv: {g: n_lin * n,
                               "quant_matmul": n_lin * len(reqs),
                               "flash_attention": cfg.n_layers * n})
        if pools != [capacity]:
            fail(f"vlm {sched}: pools of {pools} rows, expected serve's own "
                 f"capacity {capacity} (prefix rows counted)")
        if sched == "drain":
            eng.switch_task("t0")             # the model's own scales back
    res["tokens_equal_share"] = gate_tokens_equal(
        "vlm resident run", "drain", reports["drain"], reports["resident"])
    return res


def phase_vlm(torch) -> dict:
    """llava-next-mistral-7b at full width and depth (module docstring,
    phase 15)."""
    gen = torch.Generator().manual_seed(SEED + 13)
    cfg, api, model, mask, built = dense_build(torch,
                                               "llava-next-mistral-7b")
    res = {"phase": "vlm", "model": cfg.name, "layers": cfg.n_layers,
           "prefix_rows": cfg.n_img_tokens, **built}
    if n_quantized(model) != 7 * cfg.n_layers:
        fail(f"vlm build: {n_quantized(model)} quantized linears")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    prefix = torch.randn(BATCH, cfg.n_img_tokens, cfg.d_model,
                         generator=gen).to("cuda")
    res["checked"] = checked_generate(torch, "vlm", api, model, prompt,
                                      prefix)
    g = dense_generate(torch, "vlm", api, model, prompt, prefix)
    res["generate"] = g["res"]
    with torch.inference_mode():
        text_only, _ = api.prefill(model, {"tokens": prompt.to("cuda")})
    # the prefix rows reach the output
    res["prefix_moves_logits_by"] = (g["logits"] - text_only).abs().max(
        ).item()
    if not res["prefix_moves_logits_by"] > 0:
        fail("vlm: the prefill's logits do not depend on the prefix")
    del g, text_only
    res["profile"] = phase_profile(
        torch, {"api": api, "model": model, "prompt": prompt,
                "prefix": prefix}, phase="vlm_profile")
    res["serve"] = vlm_serve(torch, api, model, cfg)
    emit({"phase": "vlm_serve", **res["serve"]})
    res["train"] = dense_train(torch, "vlm", cfg, model, mask,
                               VLM_TRAIN_STEPS, batch_size=VLM_TRAIN_BATCH,
                               prefix_rows=cfg.n_img_tokens)
    emit(res)
    del model, mask, api, prefix
    torch.cuda.empty_cache()
    return res


def check_vlm(torch) -> dict:
    """Phase check's 2-layer llava-next-mistral-7b at full width: the
    layer-by-layer build bit-equal, tensor by tensor, to the whole build
    (``api.init`` then ``policies.prepare``); then its codes as 4 bit-planes
    (``plane_backbone``) serving VLM_CHECK_REQUESTS requests with 576-row
    prefixes over VLM_TASKS tasks, resident and speculative over resident
    (spec_k 3, a 3-plane draft), gated as phase speculative gates its runs:
    the exact launches, the checked verify's logits bit-equal to decoding
    step by step, the replayed draft, the tokens equal to resident's."""
    from repro_torch.core import policies
    from repro_torch.models import registry
    from repro_torch.serve import ServeConfig
    from repro_torch.train.serve import Engine
    cfg = dense_cfg("llava-next-mistral-7b", n_layers=2)
    api = registry.build(cfg)
    streamed, _ = policies.build(api, SEED)
    whole, _ = policies.prepare(api.init(SEED), cfg)
    ts = dict(list(streamed.named_parameters())
              + list(streamed.named_buffers()))
    tw = dict(list(whole.named_parameters()) + list(whole.named_buffers()))
    differ = [n for n in tw if n not in ts or not torch.equal(ts[n], tw[n])]
    if differ or ts.keys() != tw.keys():
        fail(f"vlm 2-layer: the layer-by-layer build differs from the whole "
             f"build in {differ[:4]} ({len(differ)} tensors)")
    res = {"model": cfg.name, "layers": cfg.n_layers,
           "build_bit_equal_tensors": len(tw)}
    del whole, tw, ts
    plane = plane_backbone(torch, {"cfg": cfg, "model": streamed})
    api_p, model_p = plane["api"], plane["model"]
    bank = task_bank(model_p, VLM_TASKS, SEED + 16)
    reqs = vlm_requests(cfg, VLM_CHECK_REQUESTS, VLM_CHECK_PROMPTS,
                        VLM_CHECK_NEW, VLM_TASKS, 0, SEED + 17)
    n_lin, layers = n_quantized(model_p), cfg.n_layers
    code_bytes = sum(b.numel() * 4 for n, b in model_p.named_buffers()
                     if n.endswith("qw"))
    prefill = {"quant_matmul_planes": n_lin * len(reqs)}
    check = {"armed": False, "done": None, "peak": 0}
    rep_a, _, peak_a = serve_run(
        torch, res, check, cfg.vocab_size, "resident",
        Engine(api_p, model_p, bank=bank), "step", reqs,
        ServeConfig(n_slots=VLM_SLOTS, scheduler="resident",
                    resident_tasks=VLM_TASKS),
        lambda n: {"quant_gemv_tasks_planes": n_lin * n,
                   "flash_attention": layers * n, **prefill})
    eng = checked_speculative_engine(torch, api_p, model_p, bank, check)
    rep_b, rounds_b, peak_b = serve_run(
        torch, res, check, cfg.vocab_size, "speculative", eng, "spec_step",
        reqs, ServeConfig(n_slots=VLM_SLOTS, scheduler="speculative",
                          spec_k=SPEC_K, draft_bits=DRAFT_BITS,
                          resident_tasks=VLM_TASKS),
        lambda n: {"quant_gemv_tasks_planes": n_lin * (SPEC_K + 1) * n,
                   "flash_attention": layers * (SPEC_K + 1) * n, **prefill})
    check["peak"] = 0
    del eng
    gate_speculative("vlm 2-layer speculative run", rep_a, rep_b, rounds_b,
                     check, peak_a, peak_b, code_bytes)
    res["verify_check"] = check["done"]
    del plane, model_p, streamed
    torch.cuda.empty_cache()
    return res


def check_moe(torch) -> dict:
    """Phase check's 2-layer deepseek-moe-16b at full width (64 experts,
    top-6, 2 shared): the layer-by-layer build bit-equal, tensor by tensor,
    to the whole build (``api.init`` then ``policies.prepare``), then
    ``check_path``: the kernels against the plain versions on the card,
    every K1, K2 and expert-axis call held to plain as it happens."""
    from repro_torch.core import policies
    from repro_torch.models import registry
    cfg = dense_cfg("deepseek-moe-16b", n_layers=2)
    api = registry.build(cfg)
    streamed, _ = policies.build(api, SEED)
    whole, _ = policies.prepare(api.init(SEED), cfg)
    ts = dict(list(streamed.named_parameters())
              + list(streamed.named_buffers()))
    tw = dict(list(whole.named_parameters()) + list(whole.named_buffers()))
    differ = [n for n in tw if n not in ts or not torch.equal(ts[n], tw[n])]
    if differ or ts.keys() != tw.keys():
        fail(f"moe 2-layer: the layer-by-layer build differs from the whole "
             f"build in {differ[:4]} ({len(differ)} tensors)")
    n_tensors = len(tw)
    del whole, tw, ts
    gen = torch.Generator().manual_seed(SEED + 19)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    res = {**check_path(torch, api, streamed, cfg, prompt, MOE_CHECK_NEW),
           "build_bit_equal_tensors": n_tensors}
    del streamed
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase moe: mixtral-8x7b and deepseek-moe-16b, the experts on a grid axis
# ---------------------------------------------------------------------------

def moe_requests(cfg, seed):
    """MOE_REQUESTS requests over MOE_TASKS tasks in runs (one task's burst
    after the other), prompt lengths and budgets in turn, all at step 0."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    n = MOE_REQUESTS
    return [Request(
        tokens=rng.integers(0, cfg.vocab_size, MOE_PROMPTS[i % len(
            MOE_PROMPTS)]),
        n_new=MOE_NEW[i % len(MOE_NEW)], task=f"t{i * MOE_TASKS // n}",
        arrival_step=0) for i in range(n)]


def moe_serve_want(cfg, model, reqs, capacity, steps) -> dict:
    """The exact launches of a drain run: each admitted prompt of S rows
    (bucketed to a power of two within the pool's ``capacity`` unless the
    ring forbids it) launches K2 once a 2-D quantized linear (S > 32) and,
    by its experts' capacity rows C, the expert-axis GEMV (C ≤ 32) or GEMM
    once an expert stack; each of ``steps`` pool steps routes MOE_SLOTS
    rows (C = 1): K1 and the expert-axis GEMV once a linear, K4 a layer."""
    from repro_torch.models import moe
    from repro_torch.train.serve import Engine
    mc = cfg.moe
    n_lin, n_exp = n_quantized(model), n_quantized(model, experts=True)
    cap = lambda t: moe.capacity(t, mc.top_k, mc.n_experts,
                                 mc.capacity_factor)
    want = dict.fromkeys(("quant_matmul", "quant_gemv", "quant_gemv_experts",
                          "quant_matmul_experts", "flash_attention"), 0)
    for r in reqs:
        t = r.n_prompt if cfg.swa_window is not None \
            else Engine._bucket_len(r.n_prompt, capacity)
        want["quant_matmul" if t > GEMV_MAX else "quant_gemv"] += n_lin
        want["quant_matmul_experts" if cap(t) > GEMV_MAX
             else "quant_gemv_experts"] += n_exp
    want["quant_gemv"] += n_lin * steps
    want["quant_matmul_experts" if cap(MOE_SLOTS) > GEMV_MAX
         else "quant_gemv_experts"] += n_exp * steps
    want["flash_attention"] += cfg.n_layers * steps
    return {k: v for k, v in want.items() if v}


def moe_serve(torch, api, model, cfg) -> dict:
    """MOE_REQUESTS requests over MOE_TASKS tasks through ``Engine.serve``
    in MOE_SLOTS slots under drain, twice: every request its full budget,
    the exact launches (``moe_serve_want``), and the second run's tokens
    equal to the first's.  Then the resident and speculative schedulers
    must refuse with the reference's messages (``FamilyCaps``' reasons)."""
    from repro_torch.models import registry
    from repro_torch.serve import ServeConfig
    from repro_torch.train.serve import Engine
    bank = task_bank(model, MOE_TASKS, SEED + 20)
    reqs = moe_requests(cfg, SEED + 21)
    res = {"requests": len(reqs), "slots": MOE_SLOTS, "tasks": MOE_TASKS}
    reports, check = [], {"peak": 0}
    for run in ("drain", "drain_again"):
        eng = Engine(api, model, bank=bank)
        pools, open_pool = [], eng.open_pool

        def opened(n, c, _pools=pools, _open=open_pool):
            _pools.append(c)
            return _open(n, c)
        eng.open_pool = opened
        rep, _, _ = serve_run(
            torch, res, check, cfg.vocab_size, run, eng, "step", reqs,
            ServeConfig(n_slots=MOE_SLOTS, scheduler="drain"),
            lambda n, p=pools: moe_serve_want(cfg, model, reqs, p[0], n))
        eng.switch_task("t0")                 # the model's own scales back
        reports.append(rep)
    res["capacity"] = pools[0]
    res["tokens_equal_share"] = gate_tokens_equal(
        f"{cfg.name} second drain run", "first drain", reports[0],
        reports[1])
    eng = Engine(api, model, bank=bank)
    res["refused"] = {}
    for sched, reason in (("resident", registry.MOE_SLOTTED_REASON),
                          ("speculative", registry.MOE_VERIFY_REASON)):
        want = f"scheduler='{sched}' unsupported here: {reason}"
        try:
            eng.serve(reqs, ServeConfig(n_slots=MOE_SLOTS, scheduler=sched))
        except ValueError as err:
            if str(err) != want:
                fail(f"{cfg.name} {sched}: refused with {err!r}, expected "
                     f"{want!r}")
            res["refused"][sched] = str(err)
        else:
            fail(f"{cfg.name}: the {sched} scheduler served an MoE model")
    return res


def moe_model(torch, name, gen) -> dict:
    """One MoE configuration at full width and depth (module docstring,
    phase moe)."""
    cfg, api, model, mask, built = dense_build(torch, name)
    res = {"model": cfg.name, "layers": cfg.n_layers,
           "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
           "shared_experts": cfg.moe.n_shared_experts, **built}
    bound = built["model_gb"] + 2 * built["block_fp32_gb"]
    res["build_peak_bound_gb"] = bound
    if built["build_peak_gb"] > bound:
        fail(f"{name} build: peak {built['build_peak_gb']:.3f} GB above "
             f"the model's {built['model_gb']:.3f} GB plus two blocks' "
             f"float32 {2 * built['block_fp32_gb']:.3f} GB")
    n_exp = n_quantized(model, experts=True)
    n_lin = n_quantized(model)
    want_lin = (4 + 3 * (cfg.moe.n_shared_experts > 0)) * cfg.n_layers
    if n_exp != 3 * cfg.n_layers or n_lin != want_lin:
        fail(f"{name} build: {n_lin} 2-D quantized linears and {n_exp} "
             f"expert stacks")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    secs = {"build": built["build_s"]}

    def part(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs[key] = time.perf_counter() - t0
        return out
    res["checked"] = part("checked_generate", checked_generate, torch, name,
                          api, model, prompt)
    res["generate"] = part("generate", dense_generate, torch, name, api,
                           model, prompt)["res"]
    res["profile"] = part("profile", phase_profile, torch, {
        "api": api, "model": model, "prompt": prompt}, phase="moe_profile")
    res["serve"] = part("serve", moe_serve, torch, api, model, cfg)
    res["train"] = part("train", dense_train, torch, name, cfg, model, mask,
                        MOE_TRAIN_STEPS, batch_size=MOE_TRAIN_BATCH)
    res["seconds"] = secs
    emit({"phase": "moe_model", **res})
    del model, mask, api
    torch.cuda.empty_cache()
    return res


def phase_moe(torch) -> dict:
    """mixtral-8x7b and deepseek-moe-16b at full width and depth (module
    docstring, phase moe)."""
    gen = torch.Generator().manual_seed(SEED + 18)
    res = {"phase": "moe"}
    for name in MOE_ARCHS:
        res[name] = moe_model(torch, name, gen)
    return res


# ---------------------------------------------------------------------------
# phase arms: the paper's comparison arms at llama3.2-1b
# ---------------------------------------------------------------------------

class RecordedNeed:
    """Records the ``need`` flags of every ``ops.quant_matmul_bwd`` call
    (which of dx, ds, dz the quantized backward computes) by wrapping the
    function the autograd node calls; restored on exit."""

    def __init__(self, ops):
        self.ops, self.needs = ops, []

    def __enter__(self):
        self._bwd = self.ops.quant_matmul_bwd

        def bwd(*args, **kw):
            need = args[6] if len(args) > 6 else kw.get("need",
                                                        (True, True, True))
            self.needs.append(tuple(bool(f) for f in need))
            return self._bwd(*args, **kw)

        self.ops.quant_matmul_bwd = bwd
        return self

    def __exit__(self, *exc):
        self.ops.quant_matmul_bwd = self._bwd


def arm_cfg(mode: str):
    """llama3.2-1b as phase main quantizes it (4-bit per-channel, n_grid
    20, bf16) under tuning ``mode``, QV4 (rank 4 on wq and wv), remat
    "block"."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    return configs.get_config("llama3.2-1b").replace(
        tuning=TuningConfig(mode=mode, lora_rank=4,
                            lora_targets=("wq", "wv")),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20),
        remat="block")


def model_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in
               list(model.parameters()) + list(model.buffers()))


def arm_train(torch, label, api, cfg, model, mask, data, steps, want,
              step1=None) -> dict:
    """``steps`` steps of ``train.loop.train`` (TrainConfig's 8 × 256), every
    kernel counter at 0 before each step and read after it: each step must
    launch exactly ``want``.  ``step1``, a context manager factory, wraps
    the first step (the checks).  Figures: walls, device ms (CUDA events),
    the median of the steps after the first ``TRAIN_SKIP`` (after the first
    when there are fewer), peak memory of the run with the model in it
    (after a checked step 1: of the steps after it), optimizer-state
    bytes; then one more step profiled (its kernels' device
    ms and the top ones: the busy share of a step)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import loop, step
    from repro_torch.train.state import make_state
    tcfg = TrainConfig(steps=steps, log_every=1, eval_every=10 ** 9,
                       ckpt_every=10 ** 9)
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(api, cfg, tcfg, mask, opt)
    walls, dev, seen = [], [], []

    def counted(state, batch):
        for k in ops.KERNELS:
            k.launches = 0
        if step1 is not None and len(walls) == 1:
            # the peak leaves out step 1's checks and their temporaries
            torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        if step1 is not None and not walls:
            with step1():
                state, metrics = ts(state, batch)
        else:
            state, metrics = ts(state, batch)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
        seen.append({k.__name__: k.launches for k in ops.KERNELS
                     if k.launches})
        return state, metrics

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() - model_bytes(model)
    torch.cuda.reset_peak_memory_stats()
    state, hist = loop.train(state, counted, data, tcfg,
                             log=lambda msg: None)
    peak = torch.cuda.max_memory_allocated() - base
    bad = [i for i, got in enumerate(seen) if got != want]
    if bad:
        fail(f"arms {label}: step {bad[0] + 1} launched {seen[bad[0]]}, "
             f"expected {want}")
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"arms {label}: losses {losses}")
    skip = TRAIN_SKIP if steps > TRAIN_SKIP + 1 else 1
    timed = sorted(walls[skip:]) or walls
    res = {"steps": steps, "losses": losses, "step_ms": walls,
           "device_ms": dev, "median_step_ms": timed[len(timed) // 2],
           "tokens_per_s": tcfg.batch_size * tcfg.seq_len
           / timed[len(timed) // 2] * 1e3,
           "peak_mem_gb": peak / 1e9,
           "state_bytes": opt.state_bytes(state["opt"]),
           "launches_a_step": seen[-1]}
    dev_ms, top = device_ms(torch, lambda: ts(state, data.batch_at(steps)),
                            top=8)
    res["profile"] = {"device_ms": dev_ms, "top": top}
    del state, opt, ts
    return res


def arms_lora_optq(torch, data, calib, prompt) -> dict:
    """GPTQ on 4 × 256 calibration tokens, QV4 LoRA, 10 train steps, then
    ``Engine.generate`` (module docstring, phase 14)."""
    from repro_torch.core import gptq, lora, policies
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import step
    from repro_torch.train.serve import Engine
    cfg = arm_cfg("lora_optq")
    api = registry.build(cfg)
    model = api.init(SEED)
    n_lin = cfg.n_layers * 7
    # the column loop replayed from its CUDA graph gives the eager loop's
    # codes: layer 0's k projection on correlated inputs, twice replayed
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    w = model.layers[0].attn.wk.w.detach()
    graphs, equal = {}, []
    for _ in range(2):
        x = torch.randn(calib.numel(), w.shape[1] // 4, generator=gen,
                        device="cuda") @ torch.randn(
            w.shape[1] // 4, w.shape[1], generator=gen, device="cuda")
        eager = gptq.gptq_quantize_matrix(w, x, cfg.quant)
        graphed = gptq.gptq_quantize_matrix(w, x, cfg.quant, graphs=graphs)
        equal.append(all(torch.equal(a, b) for a, b in zip(eager, graphed)))
    if not all(equal) or len(graphs) != 1:
        fail(f"arms gptq: the graphed column loop's codes equal the eager "
             f"loop's: {equal}")
    del graphs, w, x, eager, graphed
    for k in ops.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CheckedQuantMatmul(ops, "arms gptq replay",
                            calib.numel()) as chk:
        gptq.gptq_quantize_transformer(model, cfg, calib.to("cuda"))
    torch.cuda.synchronize()
    gptq_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    # each layer's replay with its codes in place: K2 a quantized linear
    if launches != {"quant_matmul": n_lin} or \
            chk.calls["quant_matmul"] != n_lin:
        fail(f"arms gptq: launches {launches}, {chk.calls} checked; "
             f"expected {n_lin} K2")
    if n_quantized(model) != n_lin:
        fail(f"arms gptq: {n_quantized(model)} quantized linears")
    lora.add_lora(model, torch.Generator(device="cuda").manual_seed(SEED),
                  cfg.tuning)
    mask = policies.make_mask(model, cfg)
    trained = {n: p for n, p in model.named_parameters() if mask[n]}
    values = sum(p.numel() for p in trained.values())
    # wq: A (r, d) and B (d, r); wv: A (r, d) and B (kv, r)
    want_values = cfg.n_layers * cfg.tuning.lora_rank * (
        3 * cfg.d_model + cfg.n_kv_heads * cfg.d_head)
    if values != want_values or any("lora" not in n for n in trained):
        fail(f"arms lora_optq: trains {values} values in "
             f"{sorted(trained)[:3]}…, expected {want_values} of lora_a/b")
    frozen = {n: t.clone() for n, t in list(model.named_parameters())
              + list(model.named_buffers()) if not mask.get(n)}
    start = {n: p.detach().clone() for n, p in trained.items()}
    # step 1's loss on the plain route, the same weights
    batch0 = step.to_device(data.batch_at(0), "cuda")
    with torch.no_grad(), ops.force_impl("torch"):
        loss_plain = float(api.loss_fn(model, batch0))
    del batch0
    checked = {}

    @contextlib.contextmanager
    def step1():
        with CheckedQuantMatmul(ops, "arms lora_optq step 1",
                                data.batch_size * data.seq_len) as chk, \
                RecordedNeed(ops) as need:
            yield
        checked.update(k2=chk.calls["quant_matmul"],
                       gemv=chk.calls["quant_gemv"], worst=chk.worst,
                       needs=need.needs)

    res = {"gptq_s": gptq_s, "gptq_k2_checked": n_lin,
           "gptq_k2_max_abs_err": chk.worst, "calib_tokens": calib.numel(),
           "trainable": policies.trainable_count(model, mask),
           "frozen": policies.frozen_count(model, mask),
           "model_bytes": model_bytes(model)}
    res["train"] = arm_train(torch, "lora_optq", api, cfg, model, mask, data,
                             TRAIN_STEPS, {"quant_matmul": 2 * n_lin},
                             step1=step1)
    tr = res["train"]
    # the recompute of a block stops once the down projection's input is
    # back: that launch returns nothing to check (as dense_train)
    if checked["k2"] != 2 * n_lin - cfg.n_layers or checked["gemv"]:
        fail(f"arms lora_optq: step 1 checked {checked}, expected "
             f"{2 * n_lin - cfg.n_layers} K2 calls")
    # layer 0's q/k/v read the frozen table: no node, no backward
    needs = checked.pop("needs")
    if len(needs) != n_lin - 3 or any(nd != (True, False, False)
                                      for nd in needs):
        fail(f"arms lora_optq: the quantized backward ran {len(needs)} "
             f"times with {sorted(set(needs))}; expected {n_lin - 3} dx-only")
    if tr["state_bytes"] != 8 * want_values:
        fail(f"arms lora_optq: optimizer state {tr['state_bytes']} bytes, "
             f"expected {8 * want_values}")
    tol = 2 ** -8 * abs(loss_plain)
    if abs(tr["losses"][0] - loss_plain) > tol:
        fail(f"arms lora_optq: step-1 loss {tr['losses'][0]!r} against the "
             f"plain route's {loss_plain!r}, beyond bf16's 2^-8 ({tol:.3e})")
    for n, t in list(model.named_parameters()) + list(model.named_buffers()):
        if n in frozen and not torch.equal(t, frozen[n]):
            fail(f"arms lora_optq: frozen {n} changed")
    if any(torch.equal(p, start[n]) for n, p in trained.items()):
        fail("arms lora_optq: an adapter did not move")
    res.update(step1_checked=checked, loss_plain_step1=loss_plain,
               frozen_checked=len(frozen), trained_values=values)
    del frozen, start
    # serving: timed, then every K1/K2 call of one generate checked
    gen = dense_generate(torch, "arms lora_optq", api, model, prompt)
    res["generate"] = gen["res"]
    engine = Engine(api, model)
    for k in ops.KERNELS:
        k.launches = 0
    with CheckedQuantMatmul(ops, "arms lora_optq generate") as chk:
        out = engine.generate(prompt, NEW)
    torch.cuda.synchronize()
    want = {"quant_gemv": n_lin * (NEW - 1), "quant_matmul": n_lin,
            "quant_gemv_experts": 0, "quant_matmul_experts": 0}
    if chk.calls != want or not torch.equal(out, gen["out"]):
        fail(f"arms lora_optq generate: {chk.calls} checked, expected "
             f"{want}; tokens equal to the unchecked run's: "
             f"{torch.equal(out, gen['out'])}")
    res["generate"]["checked"] = dict(chk.calls, max_abs_err=chk.worst)
    del gen, engine, model, trained, out
    torch.cuda.empty_cache()
    return res


def arms_lora_fp(torch, data, prompt) -> dict:
    """QV4 LoRA on the float32 backbone: 3 steps, the backbone bit-equal
    after them; ``merge_lora`` then the first decode step's logits against
    the unmerged model's.  Returns the layer-0 weights for AlphaTuning."""
    from repro_torch.core import lora, policies
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    cfg = arm_cfg("lora")
    api = registry.build(cfg)
    model, mask = policies.prepare(api.init(SEED), cfg)
    trained = {n: p for n, p in model.named_parameters() if mask[n]}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not mask[n]}
    if not trained or any("lora" not in n for n in trained):
        fail(f"arms lora: trains {sorted(trained)[:3]}")
    if model.layers[0].attn.wq.w.dtype != torch.float32:
        fail("arms lora: the frozen backbone is not float32")
    res = {"trainable": policies.trainable_count(model, mask),
           "frozen": policies.frozen_count(model, mask),
           "model_bytes": model_bytes(model)}
    res["train"] = arm_train(torch, "lora", api, cfg, model, mask, data,
                             LORA_FP_STEPS, {})
    if res["train"]["state_bytes"] != 8 * res["trainable"]:
        fail(f"arms lora: state {res['train']['state_bytes']} bytes")
    for n, p in model.named_parameters():
        if n in frozen and not torch.equal(p, frozen[n]):
            fail(f"arms lora: frozen {n} changed")
    res["frozen_checked"] = len(frozen)
    del frozen

    def first_decode():
        with torch.inference_mode():
            logits, cache = api.prefill(model, {"tokens": prompt.to("cuda")})
            full = api.init_cache(BATCH, PROMPT + 1)
            for key in full:
                full[key][:, :, :PROMPT] = cache[key]
            nxt = logits.argmax(-1)[:, None]
            step_logits, _ = api.decode_step(model, full, nxt, PROMPT)
        return logits, step_logits

    for k in ops.KERNELS:
        k.launches = 0
    pre, dec = first_decode()
    attn = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    layer0 = {f"/layers/{g}/{n}/w": getattr(getattr(model.layers[0], g),
                                             n).w.detach().clone()
              for g, n in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                           ("attn", "wo"), ("mlp", "up"), ("mlp", "gate"),
                           ("mlp", "down"))}
    lora.merge_lora(model, cfg.tuning)
    if lora.lora_param_count(model):
        fail("arms lora: merge_lora left adapters")
    pre_m, dec_m = first_decode()
    errs = {}
    for what, a, b in (("prefill", pre, pre_m), ("decode", dec, dec_m)):
        tol = 2 ** -5 * float(a.abs().max())
        errs[what] = float((a - b).abs().max())
        if not errs[what] <= tol:
            fail(f"arms lora: merged {what} logits {errs[what]:.4f} from "
                 f"the unmerged model's, beyond 2^-5 of the largest ({tol})")
    res["merge"] = {"max_abs_diff": errs, "largest_logit": float(
        dec.abs().max()), "launches_unmerged": attn,
        "top1_equal_share": (dec.argmax(-1) == dec_m.argmax(-1)
                             ).float().mean().item()}
    del model, trained
    torch.cuda.empty_cache()
    return res, layer0


def arms_qat(torch, data) -> dict:
    """QAT at full width: every float tensor trained (w, RTN-initialised
    scales and zero points, norms, a float32 table that must move at step
    1); its peak memory with the update's parts and its state."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import policies
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import step
    from repro_torch.train.state import make_state
    cfg = arm_cfg("qat")
    tcfg = TrainConfig(steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    api = registry.build(cfg)
    t0 = time.perf_counter()
    model, mask = policies.prepare(api.init(SEED), cfg)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    table = model.embed.emb
    if table.dtype != torch.float32 or not mask["embed.emb"]:
        fail(f"arms qat: the token table is {table.dtype}, trained "
             f"{mask['embed.emb']}; expected a float32 master")
    n_float = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    n_sz = sum(p.numel() for n, p in model.named_parameters()
               if n.endswith((".scale", ".zero")))
    if not all(mask.values()) or n_sz != 2 * cfg.n_layers * (
            2 * cfg.d_model + 2 * cfg.n_kv_heads * cfg.d_head
            + 2 * cfg.d_ff + cfg.d_model):
        fail(f"arms qat: {n_sz} scales and zeros, mask {set(mask.values())}")
    mbytes = torch.cuda.memory_allocated() - base
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    measured = MeasuredUpdate(torch, opt, base)
    ts = step.build_train_step(api, cfg, tcfg, mask, measured)
    batch0 = data.batch_at(0)
    ids = torch.unique(torch.as_tensor(batch0["tokens"]).flatten())
    rows0 = table.detach()[ids.to("cuda")].cpu()
    scales0 = model.layers[0].attn.wq.scale.detach().clone()
    for k in ops.KERNELS:
        k.launches = 0
    walls, peaks = [], [torch.cuda.max_memory_allocated() - base]
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = ts(state, batch0 if i == 0 else data.batch_at(i))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        if i == 0:
            moved = (table.detach()[ids.to("cuda")].cpu() != rows0
                     ).float().mean().item()
    launches = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
    if moved < 0.5 or launches:
        fail(f"arms qat: step 1 moved {moved:.3f} of the table's entries "
             f"in the batch's rows; launches {launches} (expected none)")
    if torch.equal(model.layers[0].attn.wq.scale.detach(), scales0):
        fail("arms qat: the scales did not move")
    sbytes = opt.state_bytes(state["opt"])
    if sbytes != 8 * n_float:
        fail(f"arms qat: optimizer state {sbytes} bytes for {n_float} "
             f"trained values")
    if not math.isfinite(float(metrics["loss"])):
        fail(f"arms qat: loss {float(metrics['loss'])}")
    peak = max(peaks + [m for r in measured.steps
                        for m in (r["fwd_bwd_peak"], r["update_peak"])])
    res = {"trainable": n_float, "scales_and_zeros": n_sz,
           "prepare_s": prepare_s, "model_bytes": mbytes,
           "loss": float(metrics["loss"]), "step_ms": walls,
           "median_step_ms": walls[-1], "peak_mem_gb": peak / 1e9,
           "state_bytes": sbytes, "memory_by_step": measured.steps,
           "table": {"dtype": "float32", "moved_share_step1": moved,
                     "rows_checked": ids.numel()}}
    del state, model, opt, measured, ts
    torch.cuda.empty_cache()
    return res


def arms_alphatuning(torch, layer0) -> dict:
    """AlphaTuning's BCQ (4 bits) of one layer's seven linears at full
    width: ``bcq_weight`` against the float32 weights (residual, and bit-
    equal to Σ α_b B_b of a direct ``bcq_decompose``), and
    ``linear_apply_bcq`` forward (within the float32 summation bound of the
    float64 product plus a bf16 rounding) and backward (only ``alpha1``
    gets a gradient, within 2^-7 of float64 in ℓ2) at 8 × 256 rows."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core import alphatuning as at
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = at.alphatuning_params(layer0, QuantConfig(bits=4))
    torch.cuda.synchronize()
    res = {"decompose_s": time.perf_counter() - t0, "linears": {}}
    mask = at.alphatuning_mask(params)
    if {p.rsplit("/", 1)[-1] for p, v in mask.items() if v} != {"alpha1"}:
        fail(f"arms alphatuning: mask trains {mask}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    u = 2.0 ** -24
    for path, w in layer0.items():
        prefix = path[:-len("/w")]
        p = at.linear_entry(params, prefix)
        if p["signs"].dtype != torch.int8 or set(p) != {
                "alpha1", "alpha_rest", "signs"}:
            fail(f"arms alphatuning {prefix}: leaves {sorted(p)}")
        wb = at.bcq_weight(p)
        a, s = at.bcq_decompose(w, 4)
        if not torch.equal(wb, at.bcq_apply(a, s)):
            fail(f"arms alphatuning {prefix}: bcq_weight differs from "
                 f"Σ α_b B_b of bcq_decompose")
        resid = float((w - wb).norm() / w.norm())
        if not resid < 0.2:
            fail(f"arms alphatuning {prefix}: BCQ residual {resid:.3f}")
        p = {k: v.detach() for k, v in p.items()}
        p["alpha1"].requires_grad_(True)
        n, k = w.shape
        x = torch.randn(8 * 256, k, generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        ct = torch.randn(8 * 256, n, generator=gen, device="cuda")
        y = at.linear_apply_bcq(p, x)
        (y.float() * ct).sum().backward()
        wd, xd = wb.detach().to(torch.bfloat16).double(), x.double()
        want = xd @ wd.T
        bound = 2 * k * u * (xd.abs() @ wd.abs().T) + want.abs() * 2.0 ** -8
        err = float(((y.detach().double() - want).abs() - bound).max())
        # dα1[n] = Σ_m (ctᵀx)[n, m] · B_1[n, m]
        g_want = ((ct.double().T @ xd) * p["signs"][0].double()).sum(-1)
        g = p["alpha1"].grad
        g_err = float((g.double() - g_want).norm() / g_want.norm())
        if err > 0 or not g_err <= 2 ** -7 or p["alpha_rest"].grad is not \
                None or p["alpha_rest"].requires_grad:
            fail(f"arms alphatuning {prefix}: forward beyond its bound by "
                 f"{err}, alpha1 gradient {g_err:.2e} from float64 in ℓ2, "
                 f"alpha_rest grad {p['alpha_rest'].grad is not None}")
        res["linears"][prefix] = {"shape": [n, k], "residual": resid,
                                  "alpha1_grad_rel_l2": g_err}
        del x, ct, y, want, bound, wd, xd
    res["trainable"] = sum(params[q].numel() for q, v in mask.items() if v)
    res["alpha_values"] = sum(params[q].numel() for q in params
                              if "alpha" in q)
    del params
    torch.cuda.empty_cache()
    return res


def phase_arms(torch, prompt, peqa, full) -> dict:
    """The paper's comparison arms at llama3.2-1b (module docstring, phase
    14); ``peqa`` and ``full`` are phase train's and train_full's figures,
    printed beside them."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline, synthetic
    cfg = arm_cfg("lora_optq")
    tcfg = TrainConfig()
    # phase train's corpus: the same call, the same seed
    train_toks, _ = synthetic.split(synthetic.corpus(
        cfg.vocab_size, TRAIN_TOKENS, seed=SEED))
    data = pipeline.PackedLM(train_toks, tcfg.batch_size, tcfg.seq_len,
                             seed=SEED)
    calib = torch.as_tensor(train_toks[:ARMS_CALIB[0] * ARMS_CALIB[1]]
                            .reshape(ARMS_CALIB).astype("int64"))
    res = {"phase": "arms", "model": cfg.name, "layers": cfg.n_layers}
    t0 = time.perf_counter()
    res["lora_optq"] = arms_lora_optq(torch, data, calib, prompt)
    res["lora_optq"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "arms_lora_optq", **res["lora_optq"]})
    t0 = time.perf_counter()
    res["lora"], layer0 = arms_lora_fp(torch, data, prompt)
    res["lora"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "arms_lora", **res["lora"]})
    res["alphatuning"] = arms_alphatuning(torch, layer0)
    del layer0
    emit({"phase": "arms_alphatuning", **res["alphatuning"]})
    t0 = time.perf_counter()
    res["qat"] = arms_qat(torch, data)
    res["qat"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "arms_qat", **res["qat"]})
    table = {"peqa": {"trainable": peqa["scales"],
                      "state_bytes": peqa["dense"]["state_bytes"],
                      "peak_mem_gb": peqa["dense"]["peak_mem_gb"],
                      "median_step_ms": peqa["dense"]["median_step_ms"]},
             "full": {"trainable": full["trainable"],
                      "state_bytes": full["state_bytes"],
                      "peak_mem_gb": full["peak_mem_gb"],
                      "median_step_ms": full["step_ms"][-1]}}
    for arm in ("lora_optq", "lora"):
        tr = res[arm]["train"]
        table[arm] = {"trainable": res[arm]["trainable"],
                      "state_bytes": tr["state_bytes"],
                      "peak_mem_gb": tr["peak_mem_gb"],
                      "median_step_ms": tr["median_step_ms"]}
    q = res["qat"]
    table["qat"] = {k: q[k] for k in ("trainable", "state_bytes",
                                      "peak_mem_gb", "median_step_ms")}
    res["table"] = table
    emit({"phase": "arms_table", "model": cfg.name, "arms": table})
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
    seconds = {}

    def run(name, fn, *args, **kw):
        """Run one phase and print its seconds on a line of its own."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        emit({"phase": "seconds", "of": name, "s": seconds[name]})
        return out

    dev = run("device", phase_device, torch)
    worst_err, attn_prefill, attn_7b, experts = run("kernels", phase_kernels,
                                                    torch)
    main_path = run("main", phase_main, torch)
    run("profile", phase_profile, torch, main_path)
    plane = run("plane_backbone", plane_backbone, torch, main_path)
    emit({"phase": "plane_backbone", "repack_s": plane["repack_s"]})
    with torch.inference_mode():
        step = run("step", phase_step, torch, main_path["model"],
                   plane["model"])
    serve = run("serve", phase_serve, torch, main_path)
    spec = run("speculative", phase_speculative, torch, plane, serve)
    del plane
    conv = run("convert", phase_convert, torch, main_path)
    chunked = run("chunked", phase_chunked, torch, conv, serve,
                  main_path["prompt"])
    steps = {layout: conv[layout]["step"] for layout in conv}
    del conv
    run("invariance", phase_invariance, torch, main_path["cfg"])
    run("invariance_starcoder2", phase_invariance, torch,
        dense_cfg("starcoder2-7b"), layouts=("nibble",))
    run("check", phase_check, torch, main_path["cfg"])
    train = run("train", phase_train, torch, main_path)
    full = run("train_full", phase_train_full, torch, main_path, train)
    # llama3.2-1b's models go before the 7B ones are made
    llama_cfg = main_path["cfg"]
    main_launches = dict(main_path["res"]["launches"])
    prompt = main_path["prompt"]
    peqa = {"scales": train["scales"], "dense": train["dense"]}
    del main_path, train
    torch.cuda.empty_cache()
    dense = run("dense_archs", phase_dense_archs, torch)
    vlm = run("vlm", phase_vlm, torch)
    moe = run("moe", phase_moe, torch)
    arms = run("arms", phase_arms, torch, prompt, peqa, full)
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        fail("the port loaded JAX or the JAX package")

    from repro_torch.kernels import ops
    plane_branch = "src/repro/kernels/quant_matmul.py:98"
    # kernel → (its CUDA source, the TPU kernel it replaces)
    where = {
        "quant_gemv": ("quant_gemv", "src/repro/kernels/quant_matmul.py:290"),
        "quant_matmul": ("quant_matmul",
                         "src/repro/kernels/quant_matmul.py:170"),
        "quant_gemv_tasks": ("quant_gemv",
                             "src/repro/kernels/quant_matmul.py:364"),
        "quant_gemv_planes": ("quant_gemv", plane_branch),
        "quant_matmul_planes": ("quant_matmul", plane_branch),
        "quant_gemv_tasks_planes": ("quant_gemv", plane_branch),
        "rtn_pack": ("rtn_pack", "src/repro/kernels/rtn_pack.py:124"),
        "rtn_pack_planes": ("rtn_pack", "src/repro/kernels/rtn_pack.py:107"),
        "flash_attention": ("flash_attention",
                            "src/repro/kernels/flash_attention.py:113"),
        "quant_gemv_experts": (
            "quant_gemv", "src/repro/kernels/quant_matmul.py:290 under vmap "
            "at src/repro/models/moe.py:133"),
        "quant_matmul_experts": (
            "quant_matmul", "src/repro/kernels/quant_matmul.py:170 under "
            "vmap at src/repro/models/moe.py:133"),
    }
    # each kernel's launches on the path that runs it: K1 and K2 on the
    # lockstep main path, K5 on the resident serve path, K6a's on the
    # speculative runs (K5- and K2-plane over resident, K1-plane untasked),
    # K3 and K6b on the conversions, K4 on the chunked lockstep path
    launches = main_launches
    launches["quant_gemv_tasks"] = \
        serve["res"]["resident"]["launches"]["quant_gemv_tasks"]
    for name in ("quant_gemv_tasks_planes", "quant_matmul_planes"):
        launches[name] = spec["speculative"]["launches"][name]
    launches["quant_gemv_planes"] = \
        spec["speculative_untasked"]["launches"]["quant_gemv_planes"]
    times = dict(step)
    for layout, name in (("nibble", "rtn_pack"), ("plane", "rtn_pack_planes")):
        launches[name] = steps[layout]["launches"]
        times[name] = steps[layout]
    # K4: launches over the chunked lockstep generate (prefill + 31 steps,
    # 16 each); ms, bound and library per prefill (16 × phase kernels'
    # prefill case)
    launches["flash_attention"] = chunked["k4_launches_lockstep"]
    per = llama_cfg.n_layers
    times["flash_attention"] = {
        "ms": attn_prefill["us"] * per / 1e3,
        "plain_ms": attn_prefill["plain_us"] * per / 1e3,
        "bound_ms": attn_prefill["bound_us"] * per / 1e3,
        "bound_by": attn_prefill["bound_by"],
        "library_ms": attn_prefill["library_us"] * per / 1e3}
    # the expert-axis forms: launches over phase moe's two generate runs
    # (its main path); ms, bound and library for one mixtral-8x7b block's
    # three expert linears (gate and up (14336, 4096), down (4096, 14336))
    # at C = 1 (K1) and C = 320 (K2), from phase kernels
    for name in ("quant_gemv_experts", "quant_matmul_experts"):
        launches[name] = sum(moe[m]["generate"]["launches"].get(name, 0)
                             for m in MOE_ARCHS)
        up, down = (f[name] for f in experts["mixtral-8x7b"])
        times[name] = {k: 2 * up[k] + down[k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "loop_2d_ms")}
        times[name]["bound_by"] = up["bound_by"]
    kernels = []
    for name in (k.__name__ for k in ops.KERNELS):
        st = times[name]
        if launches[name] < 1:
            fail(f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{where[name][0]}.cu",
            "replaces": where[name][1],
            "launches": launches[name],
            "max_abs_err": worst_err[name],
            "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": st["library_ms"],
            **({"loop_2d_ms": st["loop_2d_ms"]} if "loop_2d_ms" in st
               else {})})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds,
          "k4_7b_prefill_us": {m: r["us"] for m, r in attn_7b.items()},
          "dense_archs": {m: {"generate": r["generate"], "train": {
              k: r["train"][k] for k in ("median_step_ms", "peak_mem_gb",
                                         "state_bytes")}}
              for m, r in dense.items() if m not in ("phase", "granite-34b")},
          "granite-34b": {k: dense["granite-34b"][k] for k in (
              "layers", "build_s", "build_peak_gb", "build_peak_bound_gb",
              "model_gb", "generate")},
          "vlm": {"model": vlm["model"], "build_s": vlm["build_s"],
                  "build_peak_gb": vlm["build_peak_gb"],
                  "model_gb": vlm["model_gb"], "generate": vlm["generate"],
                  "busy_share": {k: vlm["profile"][k]["device_busy_share"]
                                 for k in ("prefill", "decode_step")},
                  "serve_wall_s": {k: vlm["serve"][k]["wall_s"]
                                   for k in ("drain", "resident")},
                  "train": {k: vlm["train"][k] for k in (
                      "median_step_ms", "peak_mem_gb", "state_bytes",
                      "scales")}},
          "moe": {m: {k: moe[m][k] for k in (
              "layers", "build_s", "build_peak_gb", "build_peak_bound_gb",
              "model_gb", "generate")} | {
              "busy_share": {k: moe[m]["profile"][k]["device_busy_share"]
                             for k in ("prefill", "decode_step")},
              "serve_wall_s": moe[m]["serve"]["drain"]["wall_s"],
              "train": {k: moe[m]["train"][k] for k in (
                  "median_step_ms", "peak_mem_gb", "state_bytes",
                  "scales")}} for m in MOE_ARCHS},
          "arms": arms["table"]})
    print(dev["gpu"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
