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
               bound.  Then their plane forms (``quant_gemv_experts_
               planes``, ``quant_matmul_experts_planes``) at the same
               shapes and C, on 4 and on 3 bit-planes (an expert's planes
               3·N·K/32 words, not a nibble expert's N·K/8): every slice
               bit-equal to the 2-D plane kernel on its expert, at 4 bits
               the launch bit-equal to the nibble expert-axis kernel on the
               same codes, within the factored bound of plain; timed as
               one launch beside the bound, at 4 bits also as E 2-D plane
               launches, the plain version and ``torch.bmm``;
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
               held to plain too; then the same model built on 4 bit-planes
               from the same seed (codes equal to the nibble build's), the
               same check through the plane forms, and its greedy tokens
               equal to the nibble model's;
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
               step's time by part.  remat "dots" beside "block"
               (``remat_pair``): step 1's loss and scale gradients bit-
               equal, K2 launched 112 times in the forward and 112 in the
               recompute under both, the bytes held after the forward
               (``memory_allocated``; and counted: the tensors autograd
               saves outside the checkpoints, ``saved_tensors_hooks``, plus
               the products "dots" keeps), more under "dots"; then
               REMAT_STEPS PEQA steps each: step ms, K2 a step, peak.
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
               14 of its 28 layers (``DEPTH``: the time limit; d_model
               3584, 28 / 4 heads of 128, d_ff
               18944, vocab 152064, untied, q/k/v biases), bf16, random
               weights from the seed, PEQA 4-bit per-channel (n_grid 20):
               its build's seconds and peak; Engine.generate (B 4, a
               256-token prompt, 32 new tokens; L × 7 K2 launches for the
               prefill, L × 7 K1 and L K4 a decode step), a prefill and
               a decode step profiled as in phase profile; the first 8
               of phase serve's requests (over 4 tasks) under drain and
               resident
               (identical tokens, K5 on resident); the same generate with
               the int8 KV cache (the same launches, its cache half of
               bf16's plus the scales, prefill logits bit-equal to the
               bf16 cache run's); 3 PEQA train steps at 8 × 256 (step 1's
               2 × 7L − L K2 calls that return an output — the recompute
               stops before the down projection's — each held to plain
               element by element, 2 × 7L K2 launches a step, state
               8 B × the scales, the codes, biases, norms, table and head
               unchanged; peak memory, step ms, tokens/s beside the
               reckoned full-mode bytes); the untied head's time under the fp linear's
               earlier rule and under ``ops.dot_f32``.  Then starcoder2-7b
               at full width and 16 of its 32 layers: generate with its
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
               and 16 of its 32 layers (``DEPTH``; the mistral-7b
               backbone: d_model 4096,
               32 / 8 heads of 128, d_ff 14336, vocab 32000, untied, rope θ
               1e6), built layer by layer, bf16, PEQA 4-bit per-channel
               (n_grid 20), seed 0; each image prefix 576 rows of seeded
               N(0, 1) float32.  Build seconds, peak and model bytes;
               Engine.generate(prefix=) with B 4, 576 + 256 tokens and 32
               new (7L K2 launches for the prefill at M = 3328, 7L K1 and
               L K4 a decode step), the prefill's K2 calls and the first
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
 16. moe     — (after vlm) mixtral-8x7b (16 of its 32 layers, d_model
               4096, 32 / 8 heads of 128, 8 experts of d_ff 14336, top-2,
               a 4096-key window: the ring cache; vocab 32000, untied; 93
               of its 187 GB of float32 weights) and deepseek-moe-16b (28
               layers, d_model
               2048, 16 / 16 heads of 128, 64 experts of d_ff 1408, top-6,
               2 shared experts of 2816; vocab 102400, untied) at full
               width at their ``DEPTH``: mixtral at 16 of its 32 layers
               (93 GB of float32, still more than the card), deepseek at
               14 of its 28,
               each built layer by layer (bf16, PEQA
               4-bit per-channel, n_grid 20, seed 0; every expert stack
               quantized in chunks of whole experts; mixtral in nibbles,
               deepseek on 4 bit-planes, ``MOE_LAYOUTS``, its launches the
               plane form of each kernel): the build's seconds and
               peak, gated at the model's bytes plus two float32 blocks;
               Engine.generate of 4 × 256 + 32 with exact launches
               (mixtral: 128 K2 and 96 expert-axis K2 at C = 320 for the
               prefill, 128 K1, 96 expert-axis K1 at C = 1 and 32 K4 a
               step; deepseek, each on planes: 7 K2-plane (attention and
               shared MLP) and 3 expert-axis K2-plane at C = 120 a layer
               for the prefill, 7 K1-plane, 3 expert-axis K1-plane and one
               K4 a layer a step), the prefill's and the first step's every quantized
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
 17. encdec  — (after moe, before arms) whisper-medium at full width and
               depth (24 encoder and 24 decoder layers, d_model 1024, 16
               heads of 64, d_ff 4096, 1500 frames, vocab 51968, LayerNorm,
               GELU, learned positions, tied head), built layer by layer
               (bf16, PEQA 4-bit per-channel, n_grid 20, seed 0): the
               build's seconds and peak, gated at the model's bytes plus
               two float32 decoder blocks; B 4 rows of 32 tokens behind
               1500 seeded N(0, 1) frames each: Engine.generate(prefix=
               frames) of 32 new tokens with exact launches (384 K2 a
               prefill: the encoder's 6 and the decoder's 10 linears a
               layer; 192 K1 and 24 K4 a decode step: the cross K/V are
               cached), the prefill's and the first step's every K1 and K2
               call held to plain as it happens (``CheckedQuantMatmul``),
               the logits moved by the frames; the prefill's time by part
               (K2's device ms from the profiler, the plain encoder
               attention timed alone) and a prefill and a decode step
               profiled (the busy share); ENC_REQUESTS frame-prefixed
               requests over ENC_TASKS tasks in ENC_SLOTS slots under
               drain, twice (every budget, exact launches, equal tokens),
               and the resident and speculative schedulers and a request
               without frames refused with the reference's messages; 2
               PEQA steps of 4 × (1500 + 256) rows under remat "block",
               step 1's K2 calls held to plain, the codes, positions, norms
               and table unchanged, state 8 B × the scales, peak memory
               and step ms.
 18. ssm     — (after encdec) xlstm-125m at full width and depth (12
               layers: an sLSTM every 4th, 9 mLSTMs; d_model 768, 4 heads —
               mLSTM hd 384, sLSTM hd 192 —, vocab 50304, untied), built
               layer by layer (bf16, PEQA 4-bit per-channel, n_grid 20,
               seed 0): the build's seconds and peak, gated at the model's
               bytes plus two float32 blocks; Engine.generate of 4 × 256 +
               32 (two 128-token chunks of the scan) with exact launches
               (69 K2 a prefill, 69 K1 a step, no K4), the prefill's and
               the first step's every K1 and K2 call held to plain as it
               happens; a prefill and a decode step profiled; REC_REQUESTS
               requests over REC_TASKS tasks in REC_SLOTS slots under
               drain, twice (every budget, exact launches, equal tokens;
               the slot's state bytes), the resident and speculative
               schedulers refused with the reference's messages; 2 PEQA
               steps of 4 × 256 rows under remat "block" (132 K2 a step:
               the mLSTMs' linears twice, the sLSTMs' once), step 1's K2
               calls held to plain, the codes, ``sr``, ``sb``, norms and
               table unchanged, state 8 B × the scales; then the sLSTM
               time loop timed in place: its share of a prefill and of a
               training forward and backward.
 19. hybrid  — zamba2-7b likewise at full width, at 15 of its 81 Mamba2
               layers (``DEPTH``: the time limit; d_model 3584, d_inner
               7168, 112 SSM heads of 64, d_state 64; the shared block
               after every 6: 2 groups of 6 and a 3-layer tail, 2
               applications of 32 / 32 heads of 112 and d_ff 14336; vocab
               32000, untied): exact launches 104 K2 a prefill (15 × 6
               Mamba2 linears and 2 × 7 shared ones), 104 K1 and 2 K4 at
               head dim 112 a step; the slot's SSM and conv state and its
               KV bytes a position; 2 PEQA steps of 4 × 256 under the
               nested remat.  Phase kernels carries K1 and K2 at both
               models' linears (N = 4, 64 and 112 among them) and K4 at
               zamba2's heads.
 20. harness — (after speculative, on phase main's llama3.2-1b and its
               bit-planes) the serving harness and ``launch.serve``'s own
               functions: two tasks tuned by ``launch.serve.tune_tasks``
               (8 PEQA steps of 8 × 64 each, lr 3e-3; exactly 2 × 112 K2
               a step; the backbone's scales restored after each task)
               into a bank on disk, reopened tiered with a host LRU of
               one task; ``run_continuous`` with the CLI's arguments under
               resident (24 Poisson requests at rate 2.0, prompts 4–8,
               budgets 8 / 16 / 32; tiered-bank admits counted) and drain
               (the canned two-burst trace), each gated as the CLI gates
               it; the Poisson stream speculatively on the planes (spec_k
               2, the 3-plane draft) and replayed greedily: the same
               tokens, 2 draft steps a round (acceptance recorded: random
               weights give the draft nothing to agree with); then
               ``driver.run`` of 32 Poisson requests (prompts 64 / 128 /
               256, budgets 16 / 32) in 8 slots under resident into a
               ``MetricSink``, written, reloaded, and run again from the
               same seed: equal stable rows and equal tokens.  Every run's
               launches exact (K5 or K1 per decode step and short
               prefill, K2 per long prefill, K4 per decode step, the plane
               K5 per draft step and verify); the ``kernels`` line's
               ``harness_launches`` is their sum.
 21. mesh    — (after harness) serving on (data, model) meshes over
               torch.distributed at llama3.2-1b's full width and depth:
               phase main's whole model saved once, each spawned rank
               cutting its shard (``dist.sharding.shard_model``).  Mesh
               (1, 1) over NCCL: prefill logits and tokens bit-equal to
               the unsharded engine's, and a decode step's host time by
               operator beside the unsharded one's (``decode_profile``).
               Every rank's backend and device from ``backend.summary``
               (NCCL or gloo, cuda:0).  Meshes (1, 2) and (2, 2), their
               ranks on cuda:0 under gloo (one card): ``generate`` 4 ×
               256 + 32 twice (equal tokens), prefill logits within 2⁻⁵
               of the largest unsharded one, each rank's K1 / K2 / K4
               launches those of phase main, every new shard shape of K1,
               K2, K4, K5 and the three K6a forms held once to its plain
               version (and timed) as it happens on rank 0
               (``CheckedQuantMatmul(shapes=True)``); 8 requests
               over 2 tasks resident on nibbles, resident and speculative
               on 4 planes, equal tokens; a task swap's and a row
               install's collective record empty; 0 vocab-extent gathers
               a logitshard decode step, ≥ 1 without.  The collectives a
               decode step makes (count and bytes by kind), decode ms a
               step, the peak a rank; gloo's times are its loopback path,
               not NCCL's speed.
 22. mesh_train — (after mesh) PEQA training on the same meshes at
               llama3.2-1b's full width and depth, 8 × 256 a step
               (phase train's batches), remat "block", each rank cutting
               its shard of the whole train state from phase mesh's saved
               model (``train.state.shard_state``): 3 steps at each mesh,
               every rank's metrics equal, the step-1 loss within 2⁻⁸ and
               ``grad_norm`` within 5e-2 of the unsharded step from the
               same state and batch (every step at (1, 1)), every K2 call
               of step 1 (and at (1, 2) every K4 call of a "chunked" step)
               held to plain on rank 0 (``CheckedQuantMatmul(attention=
               True)``), K2 launched 14L a step, all-reduces only, their
               count on each axis ``step.mesh_collectives``', no
               vocab-extent gather, the codes frozen; at (1, 2) also an
               int8-compressed step, and a checkpoint of the whole state
               written from the shards and restored off the mesh (its next
               step's loss the mesh's).  Step ms, the peak a rank and the
               collectives a step (count and bytes by axis), beside the
               unsharded step's ms and peak in the same call.
 25. mesh_moe — (after moe) MoE expert parallelism on (data, model)
               meshes at full width: deepseek-moe-16b at 14 of its 28
               layers (64 experts sharded whole, ``"expert"``; the time
               limit's cut) and mixtral-8x7b at 4 of its 32 layers (every
               expert's d_ff sharded,
               ``"tensor"``; whole it is 24 GB a copy), PEQA 4-bit
               nibbles, remat "block", each built once; (1, 1) over NCCL
               in the script's process, deepseek also at (1, 2) and (2,
               2), mixtral at (1, 2), spawned on cuda:0 under gloo (the
               two meshes at the same time: each one's times include the
               other's load), each rank reading the script's whole model
               over CUDA IPC (``torch.multiprocessing``) and copying only
               its shard: the card holds one whole model, not D·M.
               Each rank: ``generate`` 4 × 256 + 32 under logitshard (its
               launches those of the unsharded generate) and without (the
               same tokens); deepseek at (1, 2) also its shard repacked
               into 4 bit-planes (``generate`` of MESH_MOE_PLANE_NEW
               tokens: K1-plane × E and K2-plane × E at z = 32);
               deepseek's drain serving of phase moe's 8 requests over 2
               tasks (every budget, a task swap); then 2
               PEQA steps of 4 × 256 from the model's own scales.  Gates:
               (1, 1) bit-equal to the unsharded engine; the prefill
               logits within MESH_LOGIT_TOL of the largest unsharded one
               (at (2, 2) the unsharded run on each data block's rows);
               step 1's loss within 2⁻⁸ and ``grad_norm`` within 5e-2 of
               the unsharded step (at (2, 2) the mean over the data
               blocks); layer 0's routing at step 1 equal on every model
               rank; every rank's metrics equal; all-reduces only, their
               count ``step.mesh_collectives``', no vocab-extent gather;
               a task swap's collective record empty; the codes frozen;
               every new shard shape of K1, K2, K4 and the expert-axis
               K1 × E, K2 × E and plane forms held once to its plain
               version on rank 0 and timed beside its bound and, for the
               expert forms, ``torch.bmm`` on the dequantized stack.  The
               decode ms a step, step ms and peak a rank beside the
               unsharded run's, the collectives by axis, and at data 1
               the count of layer 0's router assignments that differ from
               the unsharded run (reported, not gated: near-tied router
               probabilities may flip).
 26. mesh_families — (built and its (1, 2) ranks spawned after chunked,
               running beside phases invariance and check, which time
               nothing; joined after check, then its (1, 1) run, the
               unsharded engine and the gates alone) the vlm and encdec
               families and a
               KV head that model ranks share, on (data, model) meshes at
               full width: whisper-medium whole (24 + 24 layers, 8 local
               heads of 64 a rank at M 2), llava-next-mistral-7b at 4 of
               its 32 layers (576 image-embedding rows a prompt row) and
               granite-34b at 4 of its 88 (one KV head: at M 2 both
               ranks hold it whole, ``sharding.kv_share``, their 24 query
               heads each a group of 24), PEQA 4-bit nibbles, remat
               "block", each built once; (1, 2) spawned on cuda:0 under
               gloo first, its ranks reading the script's whole models
               over CUDA IPC and copying only their shards, while this
               process runs phases invariance and check (the (1, 2)
               ranks' times include their load), then, once they are
               joined, (1, 1) over NCCL and the unsharded engine alone.  Each rank and model: ``generate`` of 4 ×
               64 tokens behind each row's prefix, 16 new, under
               logitshard (launches counted) and without (the same
               tokens); the prefill logits; a task swap's record; 4
               prefixed requests over 2 tasks, resident (whisper: drain,
               no slotted step); 2 PEQA steps of MESH_FAM_TRAIN_ROWS ×
               (prefix + 128) rows.  Gates: (1, 1) bit-equal to the
               unsharded engine (logits and tokens); (1, 2) logits within
               MESH_LOGIT_TOL of the largest unsharded one; every rank's
               launches those of the unsharded generate; step 1's loss
               within 2⁻⁸ and ``grad_norm`` within 5e-2 of the unsharded
               step's; all-reduces only, their count
               ``step.mesh_collectives``' (whisper's encoder and decoder
               terms); no vocab-extent gather in training, none a
               logitshard decode step, ≥ 1 without; an empty swap record;
               every rank's tokens, served tokens and metrics equal; the
               codes frozen; every new shard shape of K1, K2, K4 and K5
               held once to its plain version on rank 0 of (1, 2) and
               timed beside its bound and its library call
               (``torch.matmul`` on the dequantized bf16 Ŵ, SDPA).
 27. mesh_recurrent — (built and its (1, 2) ranks spawned beside
               mesh_families', also beside phases invariance and check;
               joined before phase mesh_families times anything) the ssm
               and hybrid families on (data, model) meshes at full width:
               xlstm-125m whole (2 local mLSTM heads of 384 a rank at M 2,
               the sLSTM whole on both) and zamba2-7b at its ``DEPTH`` (15
               of 81 layers: 2 groups of 6 and the 3-layer tail, so every
               kind of state leaf exists; 56 SSM heads and 16 / 16
               attention heads a rank), PEQA 4-bit nibbles, remat "block",
               xlstm in bf16 and zamba2 in float32 activations
               (``MESH_DTYPE``: its random-weight stack amplifies a
               perturbation ≈ 1.4× a layer, so two bf16 runs that round
               their sums in another order part by O(1); phase kernels
               holds its shard shapes on the bf16 routes), the runs and
               gates of mesh_families (drain serving: no slotted step)
               with the state after the prefill at (1, 1) bit-equal to
               the unsharded engine's too, and zamba2's gated-norm sums
               timed in a decode step (their share).
               Every new shard shape of K1, K2 and K4 held once to its
               plain version on rank 0 of (1, 2): dtproj's N 56, the
               scalar gates' N 4 kept whole, K4 at D 112 over 16 heads.
 28. mesh_arms — (built after arms; its (1, 2) ranks spawned beside
               phases launch and examples, and joined after them) the
               comparison arms on (data, model) meshes at llama3.2-1b's
               full width and depth (16 layers), each as phase arms runs
               it (QV4, 4-bit per-channel, remat "block"): ``lora`` on its
               float32 backbone built from the seed, ``lora_optq`` on
               phase arms' GPTQ backbone, ``qat`` phase arms' trained
               model, and ``lora_optq`` under QKVO16 (rank 16 on wq, wk,
               wv and the row-parallel wo, on a copy of that backbone) at
               (1, 2) only; every adapter fresh, its lora_b drawn N(0,
               MESH_ARMS_B²).  (1, 2) as gloo ranks on
               cuda:0 reading the models over CUDA IPC; then (1, 1) over
               NCCL and the unsharded runs in this process.  Each rank
               and model: ``generate`` of 4 × 64 + 16 under logitshard
               (launches counted) and without (the same tokens), the
               prefill logits, a decode step's collectives, the fp
               backbone's adapters merged on copies, MESH_ARMS_STEPS
               steps of 2 × 128 through ``arm_train`` (each step's
               launches and all-reduces held to their counts).  Gates:
               (1, 1) bit-equal to the unsharded engine in logits and
               tokens and in step 1's loss; (1, 2) logits within
               MESH_LOGIT_TOL of the largest unsharded one and step 1's
               loss within 2⁻⁸, and both within ADAPTER_SHARE of how far
               the adapters move the unsharded ones (every lora_b zeroed;
               QKVO16 also wo's alone), so that a dropped, doubled or
               unsummed delta fails; launches those of the unsharded
               generate; 2 L + 1 model-axis sums a decode step (the arms
               add none); a step's all-reduces ``step.mesh_collectives``';
               ``merge_lora`` on the (1, 2) shards, put back together,
               within 2⁻²⁰ of the largest merged weight of the whole
               model's (and whether bit-equal); every new shard shape of
               K1, K2 (lora_optq) and K4 held to plain on rank 0 of (1,
               2).  Beside them, the dry run's CLI pass
               (``launch.dryrun --all --tuning all``, CPU, ``meta``
               tensors: a record for every arch × shape × production mesh
               × tuning mode, the roofline over them), its seconds on a
               line of their own.
 23. launch  — (after arms, while this process runs phase examples: the
               time limit's cut, so both phases' walls include the
               other's load) the CLIs as subprocesses, each gated on exit
               code 0 and its own success line: ``launch.train`` at
               llama3.2-1b's full width and depth, 10 PEQA steps of 8 ×
               256 checkpointed (its step wall from its log lines'
               arrival), then 14 steps on the same directory (resumed
               from step 10, a finite loss); ``launch.serve --continuous
               --traffic poisson`` and its speculative form on bit-planes
               (fewer target steps than its greedy replay), both on the
               reduced config the CLI's ``--tiny`` forces; ``--family-smoke``
               for llama3.2-1b (tokens equal to lockstep ``generate``).
 24. examples — ``train.instruction_tune.run`` at its defaults
               (llama3.2-20m, 300 + 300 steps, 3 bits): the PEQA-tuned
               instruction perplexity below the RTN 3-bit one, the codes
               bit-identical, the exported npz reloading equal to the
               model's scales; again on the same checkpoint directory,
               resumed from step 300; ``train.serve_multitask.run``: the
               two tasks' continuations differ.

Every phase's seconds are printed on a line of their own as it ends.

Then the card's name and power limit, the ``kernels`` summary line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed phase raises
and exits non-zero before the summary lines.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
MAX_COPIES = 512
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
# phase train's remat pair: PEQA steps under "block", then under "dots"
REMAT_STEPS = 3
# dense_archs phase: PEQA train steps of qwen2-7b at 8 × 256 tokens (the
# first checked call by call, not timed); granite-34b's depth (of 88)
DENSE_TRAIN_STEPS = 3
GRANITE_LAYERS = 16
# the layers of each whole model the script's time limit cuts (at full
# width; every other model runs whole): qwen2-7b 14 of 28, starcoder2-7b
# 16 of 32, llava-next-mistral-7b 16 of 32, mixtral-8x7b 16 of 32 (93 GB
# of float32, still more than the card: the layer-by-layer build's
# proof), deepseek-moe-16b 14 of 28, zamba2-7b 15 of 81 (2 groups of 6
# and the 3-layer tail: every kind of block and state leaf)
DEPTH = {"qwen2-7b": 14, "starcoder2-7b": 16, "llava-next-mistral-7b": 16,
         "mixtral-8x7b": 16, "deepseek-moe-16b": 14, "zamba2-7b": 15}
# qwen2-7b serves the first DENSE_SERVE_REQUESTS of phase serve's requests
DENSE_SERVE_REQUESTS = 8
# vlm phase: llava-next-mistral-7b at full width (DEPTH), each image
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
# moe phase: mixtral-8x7b (DEPTH) and deepseek-moe-16b at full width.
# Serving: MOE_REQUESTS requests over MOE_TASKS tasks (one burst a task) in
# MOE_SLOTS slots, the prompts and budgets in turn (every prompt over 32
# rows: the prefill's 2-D linears take K2); training: MOE_TRAIN_STEPS PEQA
# steps of MOE_TRAIN_BATCH × 256 rows.  Phase kernels: each model's expert
# linears (E, (N, K) of gate/up and of down, C of a 4 × 256-token prefill)
# at C = 1 (a decode step of 4 rows) and at that C, and deepseek's 2-D
# linears new to the kernels (the experts' shapes and the shared MLP's
# (2816, 2048) / (2048, 2816)) and its 16 / 16 heads of 128
MOE_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
# each whole model's code layout: deepseek-moe-16b whole on 4 bit-planes
# (the expert-axis plane kernels' main path); its nibble path runs at 2
# layers in phase check, mixtral's whole on nibbles here
MOE_LAYOUTS = {"mixtral-8x7b": "nibble", "deepseek-moe-16b": "plane"}
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
# encdec phase: whisper-medium at full width and depth.  Lockstep: BATCH
# rows of ENC_PROMPT tokens behind their 1500 frames, NEW new tokens.
# Serving: ENC_REQUESTS frame-prefixed requests over ENC_TASKS tasks (one
# burst a task) in ENC_SLOTS slots, the prompts and budgets in turn;
# training: ENC_TRAIN_STEPS PEQA steps of ENC_TRAIN_BATCH × (1500 frames +
# 256 tokens)
ENC_PROMPT = 32
ENC_REQUESTS, ENC_TASKS, ENC_SLOTS = 8, 2, 4
ENC_PROMPTS, ENC_NEW = (16, 32, 48, 64), (12, 16, 24)
ENC_TRAIN_STEPS, ENC_TRAIN_BATCH = 2, 4
# ssm and hybrid phases: xlstm-125m and zamba2-7b at full width, xlstm
# whole and zamba2 at its DEPTH.  Each model's quantized-linear calls a
# forward and K4 launches a decode step (zamba2: 6 linears a Mamba2 layer;
# its shared block 7 linears and one attention an application, 2 of them).  Serving: REC_REQUESTS requests over REC_TASKS tasks (one
# burst a task) in REC_SLOTS slots, the prompts (each at most the scan's
# 128-token chunk) and the model's budgets in turn; training:
# REC_TRAIN_STEPS PEQA steps of REC_TRAIN_BATCH × 256 rows.  Phase kernels:
# K1 and K2 at each model's linears (N, K) — among them output widths of 4
# (xlstm's scalar gates), 64 and 112 (Mamba2's B / C and dt) —, and K4 at
# zamba2's 32 / 32 heads of 112
REC_CALLS = {"xlstm-125m": (69, 0), "zamba2-7b": (104, 2)}
REC_REQUESTS, REC_TASKS, REC_SLOTS = 8, 2, 4
REC_PROMPTS = (32, 64, 96, 128)
REC_NEW = {"xlstm-125m": (16, 24, 32), "zamba2-7b": (8, 12, 16)}
REC_TRAIN_STEPS, REC_TRAIN_BATCH = 2, 4
REC_SHAPES = {
    "xlstm-125m": ((3072, 768), (768, 768), (1536, 768), (4, 768),
                   (768, 1536)),
    "zamba2-7b": ((7168, 3584), (64, 3584), (112, 3584), (3584, 7168)),
    # a (1, 2) and a (1, 4) shard's (phase mesh_recurrent runs zamba2 in
    # float32, so its bf16 tensor-core routes at the shard shapes are held
    # here): zproj / xproj and out_proj (3584, 3584), (1792, 3584) and
    # (3584, 1792); dtproj's 56 and 28 heads (N 28: K2's scalar store
    # route); the shared q/k/v (1792, 7168), (896, 7168) and wo (3584,
    # 1792), (3584, 896); the shared MLP's (7168, 3584) and (3584, 7168)
    # are the whole model's shapes above
    "zamba2-7b shard": ((3584, 3584), (1792, 3584), (3584, 1792), (56, 3584),
                        (28, 3584), (1792, 7168), (896, 7168), (3584, 896))}
ZAMBA2_HEADS = (32, 32, 112)
# a (1, 2) shard's heads of zamba2's shared attention
ZAMBA2_SHARD_HEADS = (16, 16, 112)
# arms phase: GPTQ's calibration tokens (B, S) from the train split, and
# the train steps of LoRA on the float32 backbone (lora_optq takes
# TRAIN_STEPS)
ARMS_CALIB = (4, 256)
LORA_FP_STEPS = 3
# harness phase: launch.serve's tuning of its two tasks (8 × 64 tokens a
# step), then driver.run over HARNESS_REQUESTS Poisson requests (rate 2.0)
# of HARNESS_PROMPTS prompt lengths and HARNESS_NEW budgets in SERVE_SLOTS
# slots under resident, twice
HARNESS_TUNE_STEPS = 8
HARNESS_REQUESTS = 32
HARNESS_PROMPTS, HARNESS_NEW = (64, 128, 256), (16, 32)
# phase kernels at the reduced float32 configs of phases launch and
# examples (launch.serve's tiny llama3.2-1b, d 64 and 4 heads of 16, its
# nibbles and its bit-planes; serve_multitask's paper_lm, d 128 and 4 heads
# of 32; instruction_tune's llama3.2-20m, d 384, 6 / 2 heads of 64, 3
# bits): every quantized linear's GEMV at up to 32 rows, its GEMM at a
# prefill's TINY_GEMM_M rows and the 8 × 64 and 8 × 128 training rows, and
# K4 in each case of TINY_ATTN_CASES at each config's heads (offset "rows":
# a (B,) tensor spread over [0, Sk − Sq])
TINY_GEMM_M = (40, 512, 1024)
TINY_ATTN_CASES = (("prefill", 2, 64, 64, None, True, None),
                   ("lockstep_decode", 2, 1, 24, 12, True, None),
                   ("slot_prefill", 8, 16, 64, "rows", True, None),
                   ("slot_decode", 8, 1, 64, "rows", True, None),
                   ("slot_verify", 8, 3, 64, "rows", True, None),
                   ("long_slot_decode", 8, 1, 512, "rows", True, None))


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


# the expert-axis forms launch their 2-D kernels' (untasked, nibble or
# plane) instantiations over a grid z axis: no instantiation of their own
SHARED_INSTANTIATIONS = {"quant_gemv_experts": "quant_gemv",
                         "quant_matmul_experts": "quant_matmul",
                         "quant_gemv_experts_planes": "quant_gemv_planes",
                         "quant_matmul_experts_planes": "quant_matmul_planes"}


def model_planes(model) -> bool:
    """True when the model's quantized linears hold bit-plane codes."""
    from repro_torch.models.linear import Linear
    return any(isinstance(m, Linear) and m.quantized and m.spec.plane
               for m in model.modules())


def kname(name: str, planes: bool) -> str:
    """A quantized-linear kernel's wrapper name, its plane form with
    ``planes``."""
    return f"{name}_planes" if planes else name


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
        # streams its weights from HBM, as the model's does (at most
        # MAX_COPIES: xlstm's (4, 768) gates would take 68,000)
        copies = min(MAX_COPIES, max(2, math.ceil(2 * L2_BYTES
                                                  / (n * k // 2))))
        sets = [(x, qw.clone(), s.clone(), z.clone()) for _ in range(copies)]
        lib_copies = min(MAX_COPIES,
                         max(2, math.ceil(2 * L2_BYTES / (n * k * 2))))
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
    experts, experts_planes = {}, {}
    for model, (e, shapes, c_pre) in MOE_EXPERT_SHAPES.items():
        experts[model] = [kernel_experts(torch, qm, model, e, n, k, c_pre,
                                         gen, worst) for (n, k) in shapes]
        torch.cuda.empty_cache()
        experts_planes[model] = [kernel_experts_planes(
            torch, qm, model, e, n, k, c_pre, gen, worst)
            for (n, k) in shapes]
        torch.cuda.empty_cache()
    # the recurrent families' linears (zamba2's shared q/k/v, (3584, 7168)
    # over the 7168-wide concat, share out_proj's shape)
    for model, shapes in REC_SHAPES.items():
        for (n, k) in shapes:
            qw, s, z = quantized_operands(torch, n, k, None, gen)
            w16 = dequant_ref(qw, s, z, (n, k), QuantSpec(), torch.bfloat16)
            kernel_gemv_gemm(torch, qm, n, k, None, qw, s, z, w16, gen,
                             worst, emulate=n < 128, model=model)
            del qw, s, z, w16
        torch.cuda.empty_cache()
    worst.update(rtn_pack=0.0, rtn_pack_planes=0.0)   # bit-equal, or failed
    worst["flash_attention"], attn_prefill = kernel_attention(torch, gen)
    attn_7b = {}
    for model, heads in {**DENSE_7B_HEADS, **MOE_HEADS,
                         "zamba2-7b": ZAMBA2_HEADS,
                         "zamba2-7b shard": ZAMBA2_SHARD_HEADS}.items():
        err, attn_7b[model] = kernel_attention(
            torch, gen, heads, ATTN_7B_CASES, model=model, sweep=False)
        worst["flash_attention"] = max(worst["flash_attention"], err)
    # the reduced float32 configs of phases launch and examples
    kernel_tiny(torch, gen, worst)
    return worst, attn_prefill, attn_7b, experts, experts_planes


def experts_bound_ms(e: int, c: int, n: int, k: int,
                     code_bits: int = 4) -> tuple:
    """Least time for one expert-axis y[e] = x[e]·Ŵ[e]ᵀ over E experts
    (per-channel): the larger of its bytes at HBM rate (each expert's codes
    at ``code_bits`` a weight, x, scales and y once) and its 2·E·C·N·K
    operations at the bf16 tensor cores' rate.  Returns (ms, "bytes" |
    "operations")."""
    t_bytes = e * bytes_ms(c, n, k, 1, code_bits=code_bits)
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


def kernel_experts_planes(torch, qm, model, e, n, k, c_pre, gen,
                          worst) -> dict:
    """The expert-axis plane kernels at one MoE linear's E experts (RTN
    codes of N(0, 1/K) weights, per-channel, bf16 x), on 4 bit-planes and
    on 3 (the codes q >> 1 under ``draft_scales``: an expert's planes are
    then 3·N·K/32 words, not a nibble expert's N·K/8): the GEMV form at
    C = 1 and the GEMM form at the prefill's C.  Each launch's slices
    bit-equal to the 2-D plane kernel on each expert, at 4 bits bit-equal
    to the nibble expert-axis kernel on the same codes, and within
    ``error_bound`` (factored; ``gemv`` for the GEMV) of the plain version;
    device ms (CUDA graphs, the codes rotated through > 2× the L2) of the
    one launch beside the bound, and at 4 bits of E separate 2-D plane
    launches (a yardstick), of the plain version and of ``torch.bmm`` on a
    dequantized bf16 Ŵ stack.  Updates ``worst``; returns {(bits,
    kernel): figures}."""
    from repro_torch.core.quant import (QuantSpec, draft_scales,
                                        pack_codes_planes, unpack_codes)
    from repro_torch.kernels.ref import dequant_ref
    parts = [quantized_operands(torch, n, k, None, gen) for _ in range(e)]
    qw, s4, z4 = (torch.stack([p[i] for p in parts]) for i in range(3))
    del parts
    codes = torch.stack([unpack_codes(q) for q in qw])
    out = {}
    for bits in (4, 3):
        planes = torch.stack([pack_codes_planes(c >> (4 - bits), bits)
                              for c in codes])
        s, z = (t.contiguous() for t in draft_scales(s4, z4, 4, bits))
        w16 = None
        if bits == 4:
            w16 = dequant_ref(qw.reshape(e * n, -1), s.reshape(e * n, 1),
                              z.reshape(e * n, 1), (e * n, k), QuantSpec(),
                              torch.bfloat16).reshape(e, n, k)
        for c in (1, c_pre):
            gemv = c <= GEMV_MAX
            name = ("quant_gemv_experts_planes" if gemv
                    else "quant_matmul_experts_planes")
            fn, fn2, nib = ((qm.quant_gemv_experts_planes,
                             qm.quant_gemv_planes, qm.quant_gemv_experts)
                            if gemv else
                            (qm.quant_matmul_experts_planes,
                             qm.quant_matmul_planes,
                             qm.quant_matmul_experts))
            what = f"{name} {model} E={e} C={c} N={n} K={k} bits={bits}"
            x = torch.randn(e, c, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            y = fn(x, planes, s, z, bits)
            for i in range(e):
                if not torch.equal(y[i], fn2(x[i], planes[i], s[i], z[i],
                                             bits)):
                    fail(f"{what}: slice {i} differs from the 2-D plane "
                         f"kernel's launch on expert {i}")
            if bits == 4 and not torch.equal(y, nib(x, qw, s, z)):
                fail(f"{what}: differs from the nibble expert-axis kernel "
                     f"on the same codes")
            plain = qm.quant_matmul_experts_planes_plain(x, planes, s, z,
                                                         bits)
            err = check_close(what, y, plain, qm.error_bound(
                x, planes, s, z, plain, planes=(bits, 0), factored=True,
                gemv=gemv))
            worst[name] = max(worst[name], err)
            del plain, y
            copies = max(2, math.ceil(2 * L2_BYTES / (e * n * k * bits
                                                      // 8)))
            sets = [(x, planes.clone(), s.clone(), z.clone())
                    for _ in range(copies)]
            iters = 40 if gemv else 8
            b_ms, b_by = experts_bound_ms(e, c, n, k, code_bits=bits)
            fig = {"ms": timed(lambda a, b, c_, d: fn(a, b, c_, d, bits),
                               sets, iters),
                   "bound_ms": b_ms, "bound_by": b_by}
            if bits == 4:
                lib_sets = [(x, w16.clone()) for _ in range(max(2, math.ceil(
                    2 * L2_BYTES / (e * n * k * 2))))]

                def loop(a, b, c_, d, fn2=fn2):
                    for i in range(e):
                        fn2(a[i], b[i], c_[i], d[i], bits)
                fig.update(
                    loop_2d_ms=timed(loop, sets, iters),
                    plain_ms=timed(lambda a, b, c_, d:
                                   qm.quant_matmul_experts_planes_plain(
                                       a, b, c_, d, bits), sets,
                                   max(2, iters // 4)),
                    library_ms=timed(lambda a, b: torch.bmm(
                        a, b.transpose(1, 2)), lib_sets, iters))
                del lib_sets
            emit({"phase": "kernels", "kernel": name, "model": model,
                  "E": e, "C": c, "N": n, "K": k, "planes": bits,
                  "route": "mma" if gemv else "wgmma",
                  "slices_bitwise_2d": e, "bitwise_nibble": bits == 4,
                  "max_abs_err": err, **fig})
            out[(bits, name)] = fig
            del sets, x
        del planes, w16
    del qw, s4, z4, codes
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


def tiny_models(torch) -> list:
    """[(label, cfg, model)]: the reduced float32 configs phases launch and
    examples run, each from its entry point's own config function, built
    from the seed on the card — ``launch.serve``'s (as its ``--tiny``
    forces) in nibbles and in bit-planes (its speculative run), then
    ``serve_multitask``'s and ``instruction_tune``'s."""
    from repro_torch.core import policies
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry
    from repro_torch.train import instruction_tune, serve_multitask
    cfgs = [(f"launch.serve {layout}", launch_serve.model_config(
        launch_serve.parse_args(["--device", "cuda", "--layout", layout])))
        for layout in ("nibble", "plane")]
    cfgs += [("serve_multitask", serve_multitask.model_config()),
             ("instruction_tune", instruction_tune.peqa_config(3))]
    return [(label, cfg, policies.build(registry.build(cfg), SEED)[0])
            for label, cfg in cfgs]


def check_linear_f32(torch, qm, what, qw, s, z, spec, gen) -> dict:
    """One quantized linear's kernels on their SIMT routes (f32 x), each
    within ``error_bound`` of its plain version on the same inputs:
    nibbles — K1 at 32 rows (its rows at M = 1 .. 16 bit-equal to them),
    K2 at every M of TINY_GEMM_M, K5 at 8 slots over N_TASKS tasks;
    bit-planes — K6a's three forms (the GEMV at 32 rows, the task GEMV at
    8, the GEMM at TINY_GEMM_M) reading all planes and the draft's one
    fewer.  Returns the worst error per kernel."""
    k = qw.shape[-1] * (32 if spec.plane else 8)
    x_of = {m: torch.randn(m, k, generator=gen, device="cuda")
            for m in (GEMV_MAX, TASKS_M, *TINY_GEMM_M)}
    x32, x8 = x_of[GEMV_MAX], x_of[TASKS_M]
    ss, zs = task_stacks(torch, s, z, N_TASKS, gen)
    ids = torch.tensor(TASK_IDS, dtype=torch.int32, device="cuda")
    if qm.tc_route(x32, s):
        fail(f"{what}: f32 x on the tensor-core route")
    worst = {}

    def held(name, got, plain, task_ids=None, planes=None):
        m = got.shape[0]
        sz = (s, z) if task_ids is None else (ss, zs)
        err = check_close(f"{what}: {name} M={m} f32", got, plain,
                          qm.error_bound(x_of[m], qw, *sz, plain,
                                         task_ids=task_ids, planes=planes))
        worst[name] = max(worst.get(name, 0.0), err)

    if not spec.plane:
        held("quant_gemv", qm.quant_gemv(x32, qw, s, z),
             qm.quant_matmul_plain(x32, qw, s, z))
        gemv_rows_invariant(torch, f"{what}: quant_gemv f32",
                            lambda a: qm.quant_gemv(a, qw, s, z), x32)
        for m in TINY_GEMM_M:
            held("quant_matmul", qm.quant_matmul(x_of[m], qw, s, z),
                 qm.quant_matmul_plain(x_of[m], qw, s, z))
        held("quant_gemv_tasks", qm.quant_gemv_tasks(x8, qw, ss, zs, ids),
             qm.quant_matmul_tasks_plain(x8, qw, ss, zs, ids), task_ids=ids)
        return worst
    for p in (spec.bits, spec.bits - 1):
        pl = (p, spec.bits - p)
        held("quant_gemv_planes", qm.quant_gemv_planes(x32, qw, s, z, *pl),
             qm.quant_matmul_planes_plain(x32, qw, s, z, *pl), planes=pl)
        for m in TINY_GEMM_M:
            held("quant_matmul_planes",
                 qm.quant_matmul_planes(x_of[m], qw, s, z, *pl),
                 qm.quant_matmul_planes_plain(x_of[m], qw, s, z, *pl),
                 planes=pl)
        held("quant_gemv_tasks_planes",
             qm.quant_gemv_tasks_planes(x8, qw, ss, zs, ids, *pl),
             qm.quant_matmul_tasks_planes_plain(x8, qw, ss, zs, ids, *pl),
             task_ids=ids, planes=pl)
    return worst


def check_attention_f32(torch, gen, what, heads) -> float:
    """K4 in float32 at ``heads`` (Hq, Hkv, D) in every case of
    TINY_ATTN_CASES, within ``flash_attention.error_bound`` of the plain
    version on the same inputs.  Returns the worst error."""
    from repro_torch.kernels import flash_attention as fa
    hq, hkv, dh = heads
    worst = 0.0
    for name, b, sq, sk, off, causal, window in TINY_ATTN_CASES:
        q = torch.randn(b, sq, hq, dh, generator=gen, device="cuda")
        k, v = (torch.randn(b, sk, hkv, dh, generator=gen, device="cuda")
                for _ in range(2))
        offset = torch.linspace(0, sk - sq, b, device="cuda").round().long() \
            if off == "rows" else off
        kw = dict(causal=causal, window=window, offset=offset)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        worst = max(worst, check_close(
            f"{what}: flash_attention {name} f32 D={dh}",
            fa.flash_attention(q, k, v, **kw), plain,
            fa.error_bound(q, k, v, plain)))
    return worst


def kernel_tiny(torch, gen, worst) -> dict:
    """The kernels at the call shapes of phases launch and examples (the
    reduced float32 configs of ``tiny_models``): each distinct quantized
    linear (N, K, groups, bits) of each config by ``check_linear_f32`` on
    the model's own codes and scales, and K4 by ``check_attention_f32`` at
    each config's heads.  Updates ``worst``; prints one line a config and
    returns them."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.linear import Linear
    rows = {}
    for label, cfg, model in tiny_models(torch):
        errs, shapes = {}, set()
        for m in model.modules():
            if not (isinstance(m, Linear) and m.quantized):
                continue
            key = (m.out_features, m.in_features, m.scale.shape[-1])
            if key in shapes:
                continue
            shapes.add(key)
            s, z = m.scale.detach().float(), m.zero.detach().float()
            for name, err in check_linear_f32(
                    torch, qm, f"{label} {key}", m.qw, s.contiguous(),
                    z.contiguous(), m.spec, gen).items():
                errs[name] = max(errs.get(name, 0.0), err)
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
        errs["flash_attention"] = check_attention_f32(torch, gen, label,
                                                      heads)
        for name, err in errs.items():
            worst[name] = max(worst[name], err)
        rows[label] = {"phase": "kernels", "tiny": label, "dtype": "float32",
                       "bits": cfg.quant.bits, "layout": cfg.quant.layout,
                       "linears_nkg": sorted(shapes), "heads": heads,
                       "max_abs_err": errs}
        emit(rows[label])
        del model
    torch.cuda.empty_cache()
    return rows


def phase_main(torch) -> dict:
    from repro_torch.core import policies
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train.serve import Engine

    cfg = main_cfg()
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
    ``main_path["prefix"]`` (B, P, d) goes before the prompt, an encdec's
    is its frames.  Emits its line under ``phase``."""
    from repro_torch.train.serve import cache_dims
    api, model, prompt = main_path["api"], main_path["model"], main_path["prompt"]
    prefix = main_path.get("prefix")
    res = {"phase": phase, "model": api.cfg.name}
    with torch.inference_mode():
        batch = {"tokens": prompt.to("cuda")}
        if prefix is not None:
            batch[api.caps.prefix_key] = prefix
        rows = prompt.shape[1] + (prefix.shape[1] if prefix is not None
                                  and api.caps.prefix_positions else 0)
        logits, pcache = api.prefill(model, batch)
        cache = api.init_cache(BATCH, rows + 8)
        seq_dims = cache_dims(api.init_cache)[1]
        for key in cache:
            sd = seq_dims[key]
            (cache[key] if sd < 0 else cache[key].narrow(sd, 0, rows)
             ).copy_(pcache[key])
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


def counted_calls(engine, *methods) -> dict:
    """Count each call of the engine's ``methods`` (``step``,
    ``spec_step``) under its name in the returned dict, and its seconds
    under ``<name>_s`` (each call ends in a host sync)."""
    calls = {}
    for m in methods:
        calls[m], calls[f"{m}_s"] = 0, 0.0
        inner = getattr(engine, m)

        def counted(pool, *a, _inner=inner, _m=m):
            t0 = time.perf_counter()
            out = _inner(pool, *a)
            calls[f"{_m}_s"] += time.perf_counter() - t0
            calls[_m] += 1
            return out
        setattr(engine, m, counted)
    return calls


def launch_gate(torch, label, fn, want=None) -> tuple:
    """Run ``fn()`` with every launch counter at 0 and the peak memory
    reset; with ``want``, fail unless the launches equal ``want(result)``
    (others 0).  Returns (result, launches, wall s, peak bytes)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    if want is not None:
        expect = {k.__name__: 0 for k in ops.KERNELS}
        expect.update(want(out))
        if launches != expect:
            fail(f"{label}: kernel launches {launches}, expected {expect}")
    return out, launches, wall, torch.cuda.max_memory_allocated()


def serve_run(torch, res, check, vocab, label, engine, method, requests,
              config, want):
    """Serve ``requests`` through ``engine`` under ``launch_gate``, timing
    each ``method`` call (a step or a speculative round), and fail unless
    each kernel launched exactly as ``want(calls)`` says (others: 0 times)
    and every request got its full budget.  Records the run under
    ``res[label]``; returns (report, calls, peak bytes)."""
    calls = counted_calls(engine, method)
    rep, launches, wall, peak = launch_gate(
        torch, label, lambda: engine.serve(requests, config),
        lambda _: want(calls[method]))
    peak = max(check["peak"], peak)
    for i, (r, toks) in enumerate(zip(requests, rep.tokens)):
        if toks is None or len(toks) != r.n_new:
            fail(f"{label}: request {i} served {toks and len(toks)} of "
                 f"{r.n_new} tokens")
        if min(toks) < 0 or max(toks) >= vocab:
            fail(f"{label}: request {i} has token ids outside the "
                 f"vocabulary")
    res[label] = {
        "scheduler": rep.scheduler, "steps": rep.steps,
        f"{method}_calls": calls[method], "draft_steps": rep.draft_steps,
        "draft_proposed": rep.draft_proposed,
        "draft_accepted": rep.draft_accepted,
        "acceptance_rate": rep.acceptance_rate,
        "task_drain_idle_slot_steps": rep.task_drain_idle_slot_steps,
        "decoded": rep.decoded, "wall_s": wall,
        "tokens_per_s": rep.decoded / wall,
        f"ms_per_{method}": calls[f"{method}_s"] * 1e3 / max(calls[method],
                                                            1),
        "peak_mem_gb": peak / 1e9, "launches": launches}
    return rep, calls[method], peak


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
    pl = model_planes(model)
    kinds = {kname("quant_gemv", pl), kname("quant_matmul", pl),
             "flash_attention"}
    if n_quantized(model, experts=True):
        kinds |= {kname("quant_gemv_experts", pl),
                  kname("quant_matmul_experts", pl)}
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


def dense_cfg(name: str, layout: str = "nibble", **kw):
    """``name`` as the smoke runs it: PEQA 4-bit per-channel RTN (n_grid
    20) in ``layout``, bf16, with ``kw`` replaced."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    return configs.get_config(name).replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20, layout=layout),
        **kw)


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

    # --- remat "dots" beside "block": a PEQA step pair at 8 × 256 --------
    res["remat_dots"] = remat_pair(torch, model, cfg, tcfg, mask, scales,
                                   data, batch, base)
    with torch.no_grad():
        for n, p in scales.items():
            p.copy_(start_scales[n])

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


def product_bytes(func, args, kwargs) -> int:
    """Bytes of a dense product's output, from its operands' shapes."""
    a, b = [t for t in args if hasattr(t, "shape")][-2:]
    dtype = next((x for x in args if not hasattr(x, "shape")
                  and hasattr(x, "itemsize")),
                 kwargs.get("out_dtype", a.dtype))
    return a.shape[:-1].numel() * b.shape[-1] * dtype.itemsize


def remat_pair(torch, model, cfg, tcfg, mask, scales, data, batch,
               base) -> dict:
    """Phase train's model under remat "block" and "dots", each in turn: on
    step 1's batch the loss and every scale gradient (those of "dots" bit-
    equal to "block"'s: the same kernels on the same inputs, only what is
    kept differs), the K2 launches of the forward and of the backward's
    recompute (7 a layer each under both), the bytes held for the backward
    after the forward — the device's allocation then (``memory_allocated``
    after the forward less before it) and the tensors autograd saves
    outside the checkpoints (``saved_tensors_hooks``; the parameters and
    buffers excluded) plus the products "dots" keeps (counted from
    ``transformer.dots_policy``'s choices) —; then two PEQA train steps
    from the same scales: step ms, K2 launches a step, peak memory (the
    model included).  The caller restores the scales."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import registry, transformer
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import step
    from repro_torch.train.state import make_state
    weights = {t.untyped_storage().data_ptr() for t in
               list(model.parameters()) + list(model.buffers())}
    start = {n: p.detach().clone() for n, p in scales.items()}
    policy = transformer.dots_policy
    out, step1 = {}, {}
    for remat in ("block", "dots"):
        rcfg = cfg.replace(remat=remat)
        api = registry.build(rcfg, device="cuda")
        saved, kept = {}, []

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in weights:
                saved[ptr] = t.untyped_storage().nbytes()
            return t

        def counting(ctx, func, *args, **kwargs):
            got = policy(ctx, func, *args, **kwargs)
            if got == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                kept.append(product_bytes(func, args, kwargs))
            return got
        for k in ops.KERNELS:
            k.launches = 0
        transformer.dots_policy = counting
        try:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = api.loss_fn(model, batch)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - before
        finally:
            transformer.dots_policy = policy
        fwd = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
        loss.backward()
        total = {k.__name__: k.launches for k in ops.KERNELS if k.launches}
        step1[remat] = (loss.detach(), {n: p.grad.detach().clone()
                                        for n, p in scales.items()})
        for p in model.parameters():
            p.grad = None
        del loss
        opt = make_optimizer(tcfg.optim, tcfg.steps)
        state = make_state(model, opt.init(dict(model.named_parameters()),
                                           mask))
        ts = step.build_train_step(api, rcfg, tcfg, mask, opt)
        walls, seen = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(REMAT_STEPS):
            for k in ops.KERNELS:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = ts(state, data.batch_at(i))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            seen.append({k.__name__: k.launches for k in ops.KERNELS
                         if k.launches})
            if not math.isfinite(float(metrics["loss"])):
                fail(f"train remat {remat}: loss {float(metrics['loss'])}")
        peak = torch.cuda.max_memory_allocated() - base
        del state, opt, ts
        with torch.no_grad():
            for n, p in scales.items():
                p.copy_(start[n])
        want = {"quant_matmul": cfg.n_layers * 7}
        if fwd != want or total != {"quant_matmul": 2 * cfg.n_layers * 7} \
                or any(got != {"quant_matmul": 2 * cfg.n_layers * 7}
                       for got in seen):
            fail(f"train remat {remat}: K2 launches {fwd} in the forward, "
                 f"{total} with the backward, {seen} a step; expected "
                 f"{want}, twice that, twice that")
        out[remat] = {"loss_step1": float(step1[remat][0]),
                      "held_after_forward_bytes": held,
                      "saved_outside_checkpoints_bytes": sum(saved.values()),
                      "dots_kept_bytes": sum(kept),
                      "dots_kept_products": len(kept),
                      "k2_forward": fwd["quant_matmul"],
                      "k2_a_step": seen[-1]["quant_matmul"],
                      "step_ms": walls, "peak_mem_gb": peak / 1e9}
    (loss_b, grads_b), (loss_d, grads_d) = step1["block"], step1["dots"]
    if not torch.equal(loss_b, loss_d):
        fail(f"train: remat 'dots' changed the step-1 loss "
             f"({float(loss_d)!r} against 'block''s {float(loss_b)!r})")
    unequal = [n for n in grads_b if not torch.equal(grads_b[n], grads_d[n])]
    if unequal:
        fail(f"train: remat 'dots' scale gradients differ from 'block''s at "
             f"{unequal[:3]}")
    if not out["dots"]["dots_kept_products"] or \
            out["dots"]["held_after_forward_bytes"] <= \
            out["block"]["held_after_forward_bytes"]:
        fail(f"train: remat 'dots' kept {out['dots']['dots_kept_products']} "
             f"products and holds {out['dots']['held_after_forward_bytes']} "
             f"bytes after the forward against 'block''s "
             f"{out['block']['held_after_forward_bytes']}")
    out["grads_equal_to_block"] = len(grads_b)
    emit({"phase": "train_remat", **out})
    return out


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

    def update(self, grads, *args, **kw):
        cuda = self.torch.cuda
        cuda.synchronize()
        rec = {"fwd_bwd_peak": cuda.max_memory_allocated() - self.base,
               "at_update": cuda.memory_allocated() - self.base,
               "grad_bytes": sum(g.numel() * g.element_size()
                                 for g in grads.values() if g is not None)}
        cuda.reset_peak_memory_stats()
        out = self.opt.update(grads, *args, **kw)
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
    against the forward's: the same routing).  With ``attention`` every
    "chunked" ``ops.attention`` call on the card (K4) too, against
    ``flash_attention_plain`` within ``flash_attention.error_bound``.
    Counts the calls checked by kernel (``calls``).

    With ``shapes`` it holds instead the kernel each ``ops.quant_matmul``,
    ``ops.quant_matmul_slotted``, ``ops.quant_matmul_experts`` and chunked
    ``ops.attention`` call reaches — K1, K2, K5, the K6a forms (draft reads
    too), K1 × E, K2 × E and their plane forms, and K4 —, once for each
    new call shape, on the call's operands: launched again,
    within ``error_bound`` of its plain version (factored on the
    tensor-core route), and timed (``timed``: CUDA-graph replay, so no
    host launch cost; operands warm in L2) beside its plain version
    (``events_ms``: the plain K5 reads its task ids on the host, which a
    graph cannot capture) and its bound (``rows``); an expert-axis call
    also beside ``torch.bmm`` on its dequantized bf16 stack.  The launches
    made for this are taken off the kernels' counters again.

    Wraps the ops entry points the model calls; restored on exit."""

    HOOKS = ("quant_matmul", "quant_matmul_experts", "quant_matmul_slotted",
             "attention")

    def __init__(self, ops, label, rows_m=None, bitwise_2d=False,
                 watch=None, shapes=False, attention=False):
        self.ops, self.label, self.rows_m = ops, label, rows_m
        self.bitwise_2d, self.watch, self.shapes = bitwise_2d, watch, shapes
        self.attention = attention
        self.calls = {kname(k, p): 0 for p in (False, True) for k in (
            "quant_gemv", "quant_matmul", "quant_gemv_experts",
            "quant_matmul_experts")}
        if attention:
            self.calls["flash_attention"] = 0
        self.worst = 0.0
        self.slices_bitwise = 0
        self.watched = None
        self._n_expert = 0
        self.rows = {}

    def __enter__(self):
        self._saved = {n: getattr(self.ops, n) for n in self.HOOKS}
        hooks = self._shape_hooks() if self.shapes else self._call_hooks()
        for n, fn in hooks.items():
            setattr(self.ops, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self.ops, n, fn)

    @staticmethod
    def _plain(name, args):
        """The plain version of kernel ``name`` on ``args`` (the wrapper's
        own positionals), as a call."""
        from repro_torch.kernels import quant_matmul as qm
        tasks, planes = "tasks" in name, "planes" in name
        fn = getattr(qm, "quant_matmul" + ("_tasks" if tasks else "")
                     + ("_planes" if planes else "") + "_plain")
        return lambda: fn(*args)

    def _held(self, what, name, args, y) -> float:
        """``y``, kernel ``name``'s output on ``args``, within its bound of
        the plain version; returns the worst |error|."""
        from repro_torch.kernels import quant_matmul as qm
        tasks, planes = "tasks" in name, "planes" in name
        x, qw, s, z = args[:4]
        rest = args[5:] if tasks else args[4:]
        plain = self._plain(name, args)()
        return check_close(what, y, plain, qm.error_bound(
            x, qw, s, z, plain, task_ids=args[4] if tasks else None,
            planes=(rest[0], rest[1] if len(rest) > 1 else 0)
            if planes else None,
            factored=qm.tc_route(x, s), gemv="gemv" in name))

    def _call_hooks(self) -> dict:
        import torch
        from repro_torch.kernels import quant_matmul as qm
        saved = self._saved

        def qmm(x, qw, scale, zero, spec, **kw):
            y = saved["quant_matmul"](x, qw, scale, zero, spec, **kw)
            with torch.no_grad():
                xr, s, z = rows(x), scale.float(), zero.float()
                m = xr.shape[0]
                gemv = m <= qm.GEMV_MAX_M
                name = kname("quant_gemv" if gemv else "quant_matmul",
                             spec.plane)
                what = (f"{self.label}: {name} call {self.calls[name]} "
                        f"(M={m})")
                if kw.get("draft_bits") is not None or (
                        self.rows_m is not None and m != self.rows_m) \
                        or not qm.tc_route(xr, s):
                    fail(f"{what}: expected {self.rows_m or 'its'} rows of "
                         f"every stored plane or nibble on the tensor-core "
                         f"route")
                err = self._held(what, name, (xr, qw, s, z) + (
                    (spec.bits, 0) if spec.plane else ()), rows(y.detach()))
            self.calls[name] += 1
            self.worst = max(self.worst, err)
            return y

        def qmme(x, qw, scale, zero, spec):
            y = saved["quant_matmul_experts"](x, qw, scale, zero, spec)
            with torch.no_grad():
                self._expert_call(torch, qm, x, qw, scale, zero, y,
                                  spec.bits if spec.plane else None)
            return y

        def attention(q, k, v, **kw):
            from repro_torch.kernels import flash_attention as fa
            o = saved["attention"](q, k, v, **kw)
            if kw.get("impl", "dense") == "chunked" and q.is_cuda:
                mask = {n: kw[n] for n in ("causal", "window", "scale",
                                           "offset") if n in kw}
                with torch.no_grad():
                    plain = fa.flash_attention_plain(q, k, v, **mask)
                    err = check_close(
                        f"{self.label}: flash_attention call "
                        f"{self.calls['flash_attention']}", o.detach(), plain,
                        fa.error_bound(q, k, v, plain,
                                       scale=mask.get("scale")))
                self.calls["flash_attention"] += 1
                self.worst = max(self.worst, err)
            return o

        hooks = {"quant_matmul": qmm, "quant_matmul_experts": qmme}
        if self.attention:
            hooks["attention"] = attention
        return hooks

    def _shape_hooks(self) -> dict:
        import torch
        from repro_torch.kernels import quant_matmul as qm
        ops, saved = self.ops, self._saved

        def f32(*ts):
            return [t.float().contiguous() for t in ts]

        def qmm(x, qw, scale, zero, spec, **kw):
            y = saved["quant_matmul"](x, qw, scale, zero, spec, **kw)
            p = ops._layout(qw, spec, kw.get("draft_bits")) or ()
            x2d = ops._rows(x)
            gemv = x2d.shape[0] <= qm.GEMV_MAX_M
            self._shape(kname("quant_gemv" if gemv else "quant_matmul",
                              bool(p)), (x2d, qw, *f32(scale, zero), *p))
            return y

        def slotted(x, qw, scale_stack, zero_stack, task_ids, spec, **kw):
            y = saved["quant_matmul_slotted"](x, qw, scale_stack, zero_stack,
                                              task_ids, spec, **kw)
            p = ops._layout(qw, spec, kw.get("draft_bits")) or ()
            x2d = ops._rows(x)
            ss, zs = f32(scale_stack, zero_stack)
            tid = task_ids.to(torch.int32).contiguous()
            if x2d.shape[0] <= qm.GEMV_MAX_M:
                self._shape(kname("quant_gemv_tasks", bool(p)),
                            (x2d, qw, ss, zs, tid, *p))
            else:                  # K2 under each task's scales: the first's
                t = int(tid[0])
                self._shape(kname("quant_matmul", bool(p)),
                            (x2d, qw, ss[t], zs[t], *p))
            return y

        def attention(q, k, v, **kw):
            y = saved["attention"](q, k, v, **kw)
            if kw.pop("impl", "dense") == "chunked" and q.is_cuda:
                key = ("flash_attention", tuple(q.shape), tuple(k.shape),
                       torch.is_tensor(kw.get("offset")))
                if key not in self.rows:
                    with torch.no_grad():
                        self.rows[key] = self._fa_row(q, k, v, kw)
            return y

        def experts(x, qw, scale, zero, spec):
            y = saved["quant_matmul_experts"](x, qw, scale, zero, spec)
            xe = x.detach().contiguous()
            name = kname("quant_gemv_experts" if xe.shape[1] <= qm.GEMV_MAX_M
                         else "quant_matmul_experts", spec.plane)
            args = (xe, qw, *f32(scale, zero)) + (
                (spec.bits,) if spec.plane else ())
            key = (name,) + tuple(tuple(a.shape) if torch.is_tensor(a) else a
                                  for a in args)
            if key not in self.rows:
                with torch.no_grad():
                    self.rows[key] = self._expert_row(name, args, spec)
            return y

        return {"quant_matmul": qmm, "quant_matmul_slotted": slotted,
                "quant_matmul_experts": experts, "attention": attention}

    def _expert_row(self, name, args, spec) -> dict:
        """One expert-axis call shape (K1 × E, K2 × E or a plane form) held
        to its plain version, timed beside it, its bound and ``torch.bmm``
        on the stack's dequantized bf16 Ŵ."""
        import torch
        from repro_torch.kernels import quant_matmul as qm
        from repro_torch.kernels.ref import dequant_ref
        x, qw, s, z = args[:4]
        bits = args[4] if len(args) > 4 else None
        fn = getattr(qm, name)
        plain = (functools.partial(qm.quant_matmul_experts_planes_plain,
                                   bits=bits) if bits is not None
                 else qm.quant_matmul_experts_plain)
        saved = fn.launches
        y = fn(*args)
        want = plain(x, qw, s, z)
        e, c, k = x.shape
        n, g = s.shape[-2:]
        err = check_close(
            f"{self.label}: {name} at E={e}, C={c}, qw {tuple(qw.shape)}",
            y, want, qm.error_bound(x, qw, s, z, want,
                                    planes=(bits, 0) if bits else None,
                                    factored=qm.tc_route(x[0], s[0]),
                                    gemv="gemv" in name))
        del y, want
        ms = timed(fn, [args], 20)
        fn.launches = saved
        flat = qw.transpose(0, 1) if bits is not None \
            else qw.reshape(e * n, -1)
        w16 = dequant_ref(flat, s.reshape(e * n, g), z.reshape(e * n, g),
                          (e * n, k), spec, torch.bfloat16).reshape(e, n, k)
        lib = timed(lambda a, b: torch.bmm(a, b.transpose(1, 2)),
                    [(x, w16)], 20)
        del w16
        b_ms, b_by = experts_bound_ms(e, c, n, k, code_bits=bits or 4)
        return {"kernel": name, "E": e, "C": c, "N": n, "K": k, "G": g,
                "planes": bits, "max_abs_err": err, "ms": ms,
                "plain_ms": events_ms(torch, lambda: plain(x, qw, s, z), 2),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}

    def _shape(self, name, args) -> None:
        import torch
        key = (name,) + tuple(tuple(a.shape) if torch.is_tensor(a) else a
                              for a in args)
        if key not in self.rows:
            with torch.no_grad():
                self.rows[key] = self._qm_row(name, args)

    def _qm_row(self, name, args) -> dict:
        import torch
        from repro_torch.kernels import quant_matmul as qm
        tasks, planes = "tasks" in name, "planes" in name
        x, qw, s, z = args[:4]
        fn = getattr(qm, name)
        saved = fn.launches
        err = self._held(f"{self.label}: {name} at M={x.shape[0]}, qw "
                         f"{tuple(qw.shape)}", name, args, fn(*args))
        ms = timed(fn, [args], 50)
        fn.launches = saved
        bits = (args[5] if tasks else args[4]) if planes else None
        m, k = x.shape
        n, g = s.shape[-2], s.shape[-1]
        b_ms, b_by, _ = bound_ms(
            m, n, k, g, scale_sets=s.shape[0] if tasks else 1,
            code_bits=bits if planes else 4,
            tensor_cores=qm.tc_route(x, s))
        lib = None
        if not (tasks or planes):
            # the library yardstick: torch.matmul on the dequantized bf16 Ŵ
            from repro_torch.kernels.ref import dequant_ref
            w16 = dequant_ref(qw, s, z, (n, k), qm.QuantSpec(),
                              torch.bfloat16)
            lib = timed(lambda a, b: torch.matmul(a, b.T),
                        [(x.to(torch.bfloat16), w16)], 50)
            del w16
        return {"kernel": name, "M": m, "N": n, "K": k, "G": g,
                "tasks": s.shape[0] if tasks else None, "planes": bits,
                "max_abs_err": err, "ms": ms,
                "plain_ms": events_ms(torch, self._plain(name, args), 3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}

    def _fa_row(self, q, k, v, kw) -> dict:
        import torch
        from repro_torch.kernels import flash_attention as fa
        fn = fa.flash_attention
        saved = fn.launches
        y = fn(q, k, v, **kw)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        b, sq, hq, d = q.shape
        err = check_close(
            f"{self.label}: flash_attention at B={b}, Sq={sq}, "
            f"Sk={k.shape[1]}, Hq={hq}, Hkv={k.shape[2]}", y, plain,
            fa.error_bound(q, k, v, plain))
        ms = timed(lambda *a: fn(*a, **kw), [(q, k, v)], 50)
        fn.launches = saved
        mask = attn_mask(torch, b, sq, k.shape[1], kw.get("offset"),
                         kw.get("causal", True), kw.get("window"))
        b_ms, b_by = attn_bound_ms(mask, (hq, k.shape[2], d))
        # the library yardstick: scaled_dot_product_attention over the
        # same visible keys
        import torch.nn.functional as F
        lmask = mask[:, None] if kw.get("causal", True) or kw.get(
            "window") else None
        lib = timed(lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            attn_mask=lmask, enable_gqa=True), [(q, k, v)], 50)
        return {"kernel": "flash_attention", "B": b, "Sq": sq, "library_ms": lib,
                "Sk": k.shape[1], "Hq": hq, "Hkv": k.shape[2], "D": d,
                "max_abs_err": err, "ms": ms,
                "plain_ms": events_ms(torch, lambda:
                                      fa.flash_attention_plain(q, k, v, **kw),
                                      3),
                "bound_ms": b_ms, "bound_by": b_by}

    def _expert_call(self, torch, qm, x, qw, scale, zero, y, bits=None):
        """One expert-axis call (``bits``: the planes read, None for
        nibbles) held to plain, and with ``bitwise_2d`` slice by slice to
        the 2-D kernel."""
        xe, s, z = x.detach().contiguous(), scale.float(), zero.float()
        gemv = xe.shape[1] <= qm.GEMV_MAX_M
        planes = bits is not None
        name = kname("quant_gemv_experts" if gemv else "quant_matmul_experts",
                     planes)
        what = (f"{self.label}: {name} call {self.calls[name]} "
                f"(E={xe.shape[0]}, C={xe.shape[1]})")
        if not qm.tc_route(xe[0], s[0]):
            fail(f"{what}: expected the tensor-core route")
        plain = qm.quant_matmul_experts_planes_plain(xe, qw, s, z, bits) \
            if planes else qm.quant_matmul_experts_plain(xe, qw, s, z)
        err = check_close(what, y.detach(), plain, qm.error_bound(
            xe, qw, s, z, plain, planes=(bits, 0) if planes else None,
            factored=True, gemv=gemv))
        del plain
        if self.bitwise_2d:
            fn = getattr(qm, kname("quant_gemv" if gemv else "quant_matmul",
                                   planes))
            extra = (bits,) if planes else ()
            saved = fn.launches
            for e in range(xe.shape[0]):
                if not torch.equal(y[e], fn(xe[e], qw[e], s[e], z[e],
                                            *extra)):
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


def dense_build(torch, name: str, **kw):
    """``dense_cfg(name, **kw)`` (``layout`` among them; ``n_layers`` by
    default the model's ``DEPTH``) at full width from the seed through the
    layer-by-layer build (``policies.build``: each block's random float32
    weights drawn and quantized before the next block exists).  Returns
    (cfg, api, model, mask, figures): the build's seconds, its peak above
    what was allocated before it (``max_memory_allocated``), the model's
    bytes and one block's float32 bytes."""
    from repro_torch.core import policies
    from repro_torch.models import registry
    if name in DEPTH:
        kw.setdefault("n_layers", DEPTH[name])
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
    and norms: what the layer-by-layer build holds beside the model) — of
    a family with two kinds of block, the larger: a whisper's decoder
    block, xlstm's mLSTM, zamba2's shared block."""
    from repro_torch.models import mamba2, transformer, whisper, xlstm, zamba2
    kinds = {"encdec": (whisper.DecBlock,),
             "ssm": (xlstm.SLSTM, xlstm.MLSTM),
             "hybrid": (mamba2.Mamba2, zamba2.Shared)}.get(
                 cfg.family, (transformer.Block,))
    return max(4 * sum(p.numel() for p in kind(cfg, device="meta")
                       .parameters()) for kind in kinds)


def n_quantized(model, experts: bool = False) -> int:
    """The model's quantized linears: 7 a layer with a SwiGLU MLP, 6 with
    a GELU one, 4 (attention) with an MoE block — plus 3 with deepseek's
    shared MLP; with ``experts``, its quantized expert stacks instead (3
    an MoE block)."""
    from repro_torch.models.linear import Linear
    return sum(isinstance(m, Linear) and m.quantized
               and (m.n_experts is not None) == experts
               for m in model.modules())


def n_step_linears(model) -> int:
    """The 2-D quantized linears a decode step runs: every one of a
    decoder's; of a whisper, its decoder's but the cross-attention's wk and
    wv (the cross K/V are computed once, at prefill) — 8 a layer."""
    from repro_torch.models.linear import Linear
    encdec = hasattr(model, "enc")
    return sum(isinstance(m, Linear) and m.quantized and m.n_experts is None
               and (not encdec or (name.startswith("dec.") and not
                                   name.endswith(("xattn.wk", "xattn.wv"))))
               for name, m in model.named_modules())


def shared_calls(model) -> int:
    """The quantized-linear calls a forward makes beyond one a linear:
    zamba2's shared block runs once an application (13 at full depth), its
    7 linears each time; 0 elsewhere."""
    groups = getattr(model, "mamba_groups", None)
    if groups is None:
        return 0
    return n_quantized(model.shared) * (len(groups) - 1)


def attn_layers(model, cfg) -> int:
    """K4 launches a decode step: one a decoder layer; zamba2's shared
    block once an application; none in xlstm."""
    if hasattr(model, "mamba_groups"):
        return len(model.mamba_groups)
    return 0 if hasattr(model, "mlstm") else cfg.n_layers


def launch_want(model, prefill: int, steps: int, layers: int) -> dict:
    """The launches of ``prefill`` prefills and ``steps`` decode steps of a
    lockstep batch: one K2 a 2-D quantized linear for a prefill (a
    whisper's encoder linears and cross wk / wv too), one K1 a linear a
    step runs (``n_step_linears``), one expert-axis K2 (K1) an expert
    stack — a prefill's rows give every expert C > 32 capacity rows, a
    step's of BATCH rows C = 1 —, and L K4 launches a step (L the decoder's
    layers).  A model on bit-planes launches the plane form of each."""
    n_lin, n_exp = n_quantized(model), n_quantized(model, experts=True)
    extra = shared_calls(model)
    pl = model_planes(model)
    want = {kname("quant_matmul", pl): (n_lin + extra) * prefill,
            kname("quant_gemv", pl): (n_step_linears(model) + extra) * steps,
            "flash_attention": layers * steps}
    if n_exp:
        want.update({kname("quant_matmul_experts", pl): n_exp * prefill,
                     kname("quant_gemv_experts", pl): n_exp * steps})
    return {k: v for k, v in want.items() if v}


def dense_generate(torch, label, api, model, prompt, prefix=None) -> dict:
    """``Engine.generate`` of ``prompt`` (behind a vlm's ``prefix`` (B, P,
    d), or an encdec's frames, where given) and NEW tokens with every
    launch counter at 0: the launches ``launch_want`` gives for one prefill
    and NEW − 1 steps; then the prefill alone, timed, its logits kept.
    Returns {"res", "out", "logits"}."""
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
    want = launch_want(model, 1, steps, attn_layers(model, cfg))
    if launches != want:
        fail(f"{label} generate: launches {launches}, expected {want}")
    s = prompt.shape[1]
    if tuple(out.shape) != (BATCH, s + NEW) or not torch.equal(
            out[:, :s].cpu(), prompt):
        fail(f"{label} generate returned {tuple(out.shape)} or changed the "
             f"prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail(f"{label}: generated token ids outside the vocabulary")
    batch = {"tokens": prompt.to("cuda")}
    if prefix is not None:
        batch[api.caps.prefix_key] = prefix
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
        model, 1, 1, attn_layers(model, api.cfg)).items() if k in want})
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


def remat_k2_calls(model, cfg) -> tuple:
    """(K2 launches a remat "block" train step, the calls of step 1 that
    return an output) of xlstm and zamba2, or None for the other families
    (2 a linear, one a block fewer).  The recompute of a checkpointed body
    stops once its last saved tensor is back, inside its last linear,
    whose output is then never returned.  xlstm checkpoints each mLSTM
    block (7 linears), not the sLSTM; zamba2 each Mamba2 block of a group
    AND each whole group, nested, not the tail: a grouped Mamba2 linear
    runs three times, a shared one twice an application."""
    if hasattr(model, "mlstm"):
        n_m = sum(len(g) for g in model.mlstm)
        calls = n_quantized(model) + 7 * n_m
        return calls, calls - n_m
    if hasattr(model, "mamba_groups"):
        n_g = len(model.mamba_groups)
        grouped = sum(len(g) for g in model.mamba_groups)
        tail = len(model.mamba_tail or ())
        shared = n_quantized(model.shared)
        calls = 6 * (3 * grouped + tail) + 2 * n_g * shared
        return calls, calls - grouped - n_g
    return None


def dense_train(torch, label, cfg0, model, mask, steps, batch_size=None,
                prefix_rows=0) -> dict:
    """``steps`` PEQA train steps at TrainConfig's 8 × 256 tokens (K2 at M =
    2048; ``batch_size`` rows of 256 where given, each behind
    ``prefix_rows`` seeded N(0, 1) float32 patch embeddings for a vlm, the
    loss on the text rows: K2 at M = B·(P + 256); for an encdec each row
    behind ``prefix_rows`` seeded frames: its encoder's K2 at M = B·P, its
    decoder's at B·256), remat "block", on a synthetic corpus at the
    model's vocabulary:
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
    api = registry.build(cfg)
    encdec = cfg.family == "encdec"
    pgen = torch.Generator().manual_seed(SEED + 12)

    def batch_at(i):
        batch = data.batch_at(i)
        if prefix_rows:
            batch[api.caps.prefix_key] = torch.randn(
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
    ts = step.build_train_step(api, cfg, tcfg, mask, opt)
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
            with CheckedQuantMatmul(ops, f"train {label}",
                                    None if encdec else m_rows,
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
    pl = model_planes(model)
    k2, k2e = kname("quant_matmul", pl), kname("quant_matmul_experts", pl)
    want = {k2: 2 * n_lin}
    checked = chk.calls[k2]
    recurrent = remat_k2_calls(model, cfg)
    # the recompute stops once the block's last saved tensor is back: in a
    # dense block (and deepseek's, whose shared MLP comes last, and each of
    # a whisper's encoder and decoder blocks) inside the down projection,
    # whose output is then never returned; in mixtral's MoE block after the
    # expert combine (the aux loss saves last)
    n_blocks = cfg.n_layers + cfg.enc_layers
    unchecked = {2 * n_lin - n_blocks} if not n_exp else \
        {2 * n_lin - n_blocks, 2 * n_lin}
    if recurrent is not None:
        want[k2], returned = recurrent
        unchecked = {returned}
    if n_exp:
        want[k2e] = 2 * n_exp
        if chk.calls[k2e] not in (2 * n_exp, 2 * n_exp - cfg.n_layers):
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
            "expert_k2_calls_checked": chk.calls[k2e],
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
    """qwen2-7b and starcoder2-7b at full width, at their ``DEPTH``
    (module docstring, phase 13)."""
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
    """llava-next-mistral-7b at full width, at its ``DEPTH`` (module
    docstring, phase 15)."""
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
    every K1, K2 and expert-axis call held to plain as it happens.  Then
    the same model built on 4 bit-planes from the same seed (its codes the
    nibble model's, bit for bit): ``check_path`` through the plane forms,
    and ``Engine.generate``'s tokens equal to the nibble model's."""
    from repro_torch.core import policies
    from repro_torch.core.quant import unpack_codes, unpack_codes_planes
    from repro_torch.models import registry
    from repro_torch.train.serve import Engine
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
    cfg_p = dense_cfg("deepseek-moe-16b", layout="plane", n_layers=2)
    api_p = registry.build(cfg_p)
    plane, _ = policies.build(api_p, SEED)
    tp = dict(plane.named_buffers())
    differ = []
    for name, qw in streamed.named_buffers():
        if not name.endswith(".qw"):
            continue
        codes = torch.stack([unpack_codes_planes(q) for q in tp[name]]) \
            if qw.dim() == 3 else unpack_codes_planes(tp[name])
        if not torch.equal(codes, unpack_codes(qw.reshape(-1, qw.shape[-1])
                                               ).reshape(codes.shape)):
            differ.append(name)
    if differ:
        fail(f"moe 2-layer planes: codes differ from the nibble build's in "
             f"{differ[:4]}")
    res["planes"] = check_path(torch, api_p, plane, cfg_p, prompt,
                               MOE_CHECK_NEW)
    with torch.inference_mode():
        tok_n = Engine(api, streamed).generate(prompt, MOE_CHECK_NEW)
        tok_p = Engine(api_p, plane).generate(prompt, MOE_CHECK_NEW)
    if not torch.equal(tok_n, tok_p):
        fail(f"moe 2-layer: the 4-bit plane model's generate "
             f"{tok_p[:, PROMPT:].tolist()} differs from the nibble "
             f"model's {tok_n[:, PROMPT:].tolist()}")
    res["planes"]["tokens_equal_to_nibble"] = True
    del streamed, plane
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
    k = functools.partial(kname, planes=model_planes(model))
    want = dict.fromkeys((k("quant_matmul"), k("quant_gemv"),
                          k("quant_gemv_experts"), k("quant_matmul_experts"),
                          "flash_attention"), 0)
    for r in reqs:
        t = r.n_prompt if cfg.swa_window is not None \
            else Engine._bucket_len(r.n_prompt, capacity)
        want[k("quant_matmul" if t > GEMV_MAX else "quant_gemv")] += n_lin
        want[k("quant_matmul_experts" if cap(t) > GEMV_MAX
               else "quant_gemv_experts")] += n_exp
    want[k("quant_gemv")] += n_lin * steps
    want[k("quant_matmul_experts" if cap(MOE_SLOTS) > GEMV_MAX
           else "quant_gemv_experts")] += n_exp * steps
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
    """One MoE configuration at full width, at its ``DEPTH``, in its
    ``MOE_LAYOUTS`` layout (module docstring, phase moe)."""
    cfg, api, model, mask, built = dense_build(torch, name,
                                               layout=MOE_LAYOUTS[name])
    res = {"model": cfg.name, "layout": cfg.quant.layout,
           "layers": cfg.n_layers,
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
    """mixtral-8x7b (at its DEPTH) and deepseek-moe-16b at full width
    (module docstring, phase moe)."""
    gen = torch.Generator().manual_seed(SEED + 18)
    res = {"phase": "moe"}
    for name in MOE_ARCHS:
        res[name] = moe_model(torch, name, gen)
    return res


# ---------------------------------------------------------------------------
# phase encdec: whisper-medium, its encoder and cross-attention
# ---------------------------------------------------------------------------

def prefill_parts(torch, api, model, prompt, frames) -> dict:
    """Where an encdec prefill's time goes: its wall (CUDA events around a
    warm call) and device time (``torch.profiler``), K2's device time (the
    profiled kernels named ``quant_matmul``) and the plain float32 encoder
    self-attention's (one call at the encoder's (B, T, H, D), timed alone
    with CUDA events over 5 calls, × the encoder's layers)."""
    from repro_torch.kernels import ops
    from torch.profiler import ProfilerActivity, profile
    cfg = api.cfg
    batch = {"tokens": prompt.to("cuda"), "frames": frames}
    with torch.inference_mode():
        api.prefill(model, batch)                     # warm-up
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        api.prefill(model, batch)
        e1.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            api.prefill(model, batch)
            torch.cuda.synchronize()
        b, t = frames.shape[:2]
        q, k, v = (torch.randn(b, t, cfg.n_heads, cfg.d_head, device="cuda"
                               ).to(torch.bfloat16) for _ in range(3))
        attn_ms = events_ms(torch, lambda: ops.attention(q, k, v,
                                                         causal=False),
                            iters=5)
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3)
            for e in prof.key_averages()]
    device = sum(ms for _, ms in rows)
    k2 = sum(ms for key, ms in rows if "quant_matmul" in key)
    enc_attn = attn_ms * cfg.enc_layers
    return {"prefill_ms": e0.elapsed_time(e1), "device_ms": device or None,
            "k2_device_ms": k2, "k2_share_of_device": k2 / device
            if device else None,
            "encoder_attention_ms": enc_attn,
            "encoder_attention_share_of_device": enc_attn / device
            if device else None,
            "rows_encoder": b * t, "rows_decoder": prompt.numel()}


def encdec_requests(cfg, seed):
    """ENC_REQUESTS requests, each behind its own 1500 seeded N(0, 1)
    float32 frames, over ENC_TASKS tasks in runs (one task's burst after
    the other), prompt lengths and budgets in turn, all at step 0."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    n = ENC_REQUESTS
    return [Request(
        tokens=rng.integers(0, cfg.vocab_size, ENC_PROMPTS[i % len(
            ENC_PROMPTS)]),
        n_new=ENC_NEW[i % len(ENC_NEW)], task=f"t{i * ENC_TASKS // n}",
        prefix=rng.standard_normal((cfg.enc_frames, cfg.d_model),
                                   dtype=np.float32),
        arrival_step=0) for i in range(n)]


def encdec_serve_want(cfg, model, reqs, capacity, steps) -> dict:
    """The exact launches of a drain run: each admitted prompt (bucketed to
    a power of two within the pool's ``capacity``) runs its encoder's and
    cross wk / wv's linears over 1500 frame rows (K2) and its decoder's
    step linears over its S rows (K2 for S > 32, else K1); each of
    ``steps`` pool steps launches K1 once a step linear and K4 a layer."""
    from repro_torch.train.serve import Engine
    n_lin, n_step = n_quantized(model), n_step_linears(model)
    want = dict.fromkeys(("quant_matmul", "quant_gemv", "flash_attention"),
                         0)
    for r in reqs:
        t = Engine._bucket_len(r.n_prompt, capacity)
        want["quant_matmul"] += n_lin - n_step
        want["quant_matmul" if t > GEMV_MAX else "quant_gemv"] += n_step
    want["quant_gemv"] += n_step * steps
    want["flash_attention"] += cfg.n_layers * steps
    return {k: v for k, v in want.items() if v}


def encdec_serve(torch, api, model, cfg) -> dict:
    """ENC_REQUESTS frame-prefixed requests over ENC_TASKS tasks through
    ``Engine.serve`` in ENC_SLOTS slots under drain, twice, each pool at
    serve's own capacity (no frame takes a decoder position): every budget
    served, the exact launches (``encdec_serve_want``), the second run's
    tokens equal to the first's.  Then the resident and speculative
    schedulers and a request without frames must be refused with the
    reference's messages."""
    from repro_torch.models import registry
    from repro_torch.serve import Request, ServeConfig
    from repro_torch.train.serve import Engine
    bank = task_bank(model, ENC_TASKS, SEED + 23)
    reqs = encdec_requests(cfg, SEED + 24)
    capacity = max(r.n_prompt + r.n_new for r in reqs)
    res = {"requests": len(reqs), "slots": ENC_SLOTS, "tasks": ENC_TASKS,
           "capacity": capacity}
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
            ServeConfig(n_slots=ENC_SLOTS, scheduler="drain"),
            lambda n: encdec_serve_want(cfg, model, reqs, capacity, n))
        if pools != [capacity]:
            fail(f"encdec {run}: pools of {pools} rows, expected serve's "
                 f"own capacity {capacity}")
        eng.switch_task("t0")                 # the model's own scales back
        reports.append(rep)
    res["tokens_equal_share"] = gate_tokens_equal(
        f"{cfg.name} second drain run", "first drain", reports[0],
        reports[1])
    eng = Engine(api, model, bank=bank)
    bare = [Request(tokens=r.tokens, n_new=r.n_new, task=r.task)
            for r in reqs[:2]]
    missing = ("family 'encdec' requires prefix state 'frames' on every "
               "request (encoder inputs)")
    res["refused"] = {}
    for what, reqs_, sched, want in (
            ("resident", reqs, "resident",
             "scheduler='resident' unsupported here: "
             + registry.ENCDEC_SLOTTED_REASON),
            ("speculative", reqs, "speculative",
             "scheduler='speculative' unsupported here: "
             + registry.NO_VERIFY_REASON),
            ("no_frames", bare, "drain", missing)):
        try:
            eng.serve(reqs_, ServeConfig(n_slots=ENC_SLOTS, scheduler=sched))
        except ValueError as err:
            if str(err) != want:
                fail(f"{cfg.name} {what}: refused with {err!r}, expected "
                     f"{want!r}")
            res["refused"][what] = str(err)
        else:
            fail(f"{cfg.name}: {what} was served")
    return res


def phase_encdec(torch) -> dict:
    """whisper-medium at full width and depth (module docstring, phase
    17)."""
    gen = torch.Generator().manual_seed(SEED + 22)
    cfg, api, model, mask, built = dense_build(torch, "whisper-medium")
    res = {"phase": "encdec", "model": cfg.name,
           "enc_layers": cfg.enc_layers, "layers": cfg.n_layers,
           "frames": cfg.enc_frames, **built}
    bound = built["model_gb"] + 2 * built["block_fp32_gb"]
    res["build_peak_bound_gb"] = bound
    if built["build_peak_gb"] > bound:
        fail(f"{cfg.name} build: peak {built['build_peak_gb']:.3f} GB above "
             f"the model's {built['model_gb']:.3f} GB plus two blocks' "
             f"float32 {2 * built['block_fp32_gb']:.3f} GB")
    n_lin, n_step = n_quantized(model), n_step_linears(model)
    if n_lin != 6 * cfg.enc_layers + 10 * cfg.n_layers or \
            n_step != 8 * cfg.n_layers:
        fail(f"{cfg.name} build: {n_lin} quantized linears, {n_step} of "
             f"them a decode step's")
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, ENC_PROMPT),
                           generator=gen)
    frames = torch.randn(BATCH, cfg.enc_frames, cfg.d_model,
                         generator=gen).to("cuda")
    secs = {"build": built["build_s"]}

    def part(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs[key] = time.perf_counter() - t0
        return out
    res["checked"] = part("checked_generate", checked_generate, torch,
                          cfg.name, api, model, prompt, frames)
    g = part("generate", dense_generate, torch, cfg.name, api, model, prompt,
             frames)
    res["generate"] = g["res"]
    with torch.inference_mode():
        other, _ = api.prefill(model, {"tokens": prompt.to("cuda"),
                                       "frames": frames.flip(0)})
    # the frames reach the output
    res["frames_move_logits_by"] = (g["logits"] - other.flip(0)).abs().max(
        ).item()
    if not res["frames_move_logits_by"] > 0:
        fail(f"{cfg.name}: the prefill's logits do not depend on the frames")
    del g, other
    res["prefill_parts"] = part("prefill_parts", prefill_parts, torch, api,
                                model, prompt, frames)
    res["profile"] = part("profile", phase_profile, torch, {
        "api": api, "model": model, "prompt": prompt, "prefix": frames},
        phase="encdec_profile")
    res["serve"] = part("serve", encdec_serve, torch, api, model, cfg)
    res["train"] = part("train", dense_train, torch, cfg.name, cfg, model,
                        mask, ENC_TRAIN_STEPS, batch_size=ENC_TRAIN_BATCH,
                        prefix_rows=cfg.enc_frames)
    res["seconds"] = secs
    emit(res)
    del model, mask, api, frames
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases ssm and hybrid: xlstm-125m and zamba2-7b, the recurrent families
# ---------------------------------------------------------------------------

def recurrent_requests(cfg, seed):
    """REC_REQUESTS requests over REC_TASKS tasks in runs (one task's burst
    after the other), prompt lengths (each at most the chunk: one chunk of
    the scan) and budgets in turn, all at step 0."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    n, news = REC_REQUESTS, REC_NEW[cfg.name]
    return [Request(
        tokens=rng.integers(0, cfg.vocab_size, REC_PROMPTS[i % len(
            REC_PROMPTS)]),
        n_new=news[i % len(news)], task=f"t{i * REC_TASKS // n}",
        arrival_step=0) for i in range(n)]


def recurrent_serve_want(cfg, model, reqs, steps) -> dict:
    """The exact launches of a drain run: each admitted prompt of S rows
    (never bucketed: the state integrates every row) calls every quantized
    linear once (zamba2's shared ones once an application) — K2 for S > 32,
    else K1 —; each of ``steps`` pool steps calls them through K1, and K4
    once a shared-block application."""
    calls = n_quantized(model) + shared_calls(model)
    want = dict.fromkeys(("quant_matmul", "quant_gemv", "flash_attention"),
                         0)
    for r in reqs:
        want["quant_matmul" if r.n_prompt > GEMV_MAX
             else "quant_gemv"] += calls
    want["quant_gemv"] += calls * steps
    want["flash_attention"] += attn_layers(model, cfg) * steps
    return {k: v for k, v in want.items() if v}


def state_bytes(api) -> dict:
    """The slot pool's state of one slot: the bytes of the position-free
    leaves (the recurrent states) and of each position of the paged ones
    (zamba2's shared-block K/V), from ``init_cache`` on ``meta``."""
    from repro_torch.train.serve import cache_dims
    bdims, sdims = cache_dims(api.init_cache)
    one = api.init_cache(1, 1, device="meta")
    size = lambda t: t.numel() * t.element_size()
    return {"state_bytes_a_slot": sum(size(t) for k, t in one.items()
                                      if sdims[k] < 0),
            "kv_bytes_a_position": sum(size(t) for k, t in one.items()
                                       if sdims[k] >= 0)}


def recurrent_serve(torch, api, model, cfg) -> dict:
    """REC_REQUESTS requests over REC_TASKS tasks through ``Engine.serve``
    in REC_SLOTS slots under drain, twice, each pool at serve's own
    capacity: every budget served, the exact launches
    (``recurrent_serve_want``), the second run's tokens equal to the
    first's.  Then the resident and speculative schedulers must refuse
    with the reference's messages."""
    from repro_torch.models import registry
    from repro_torch.serve import ServeConfig
    from repro_torch.train.serve import Engine
    bank = task_bank(model, REC_TASKS, SEED + 25)
    reqs = recurrent_requests(cfg, SEED + 26)
    capacity = max(r.n_prompt + r.n_new for r in reqs)
    res = {"requests": len(reqs), "slots": REC_SLOTS, "tasks": REC_TASKS,
           "capacity": capacity, **state_bytes(api)}
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
            ServeConfig(n_slots=REC_SLOTS, scheduler="drain"),
            lambda n: recurrent_serve_want(cfg, model, reqs, n))
        if pools != [capacity]:
            fail(f"{cfg.name} {run}: pools of {pools} rows, expected "
                 f"serve's own capacity {capacity}")
        eng.switch_task("t0")                 # the model's own scales back
        reports.append(rep)
    res["tokens_equal_share"] = gate_tokens_equal(
        f"{cfg.name} second drain run", "first drain", reports[0],
        reports[1])
    eng = Engine(api, model, bank=bank)
    res["refused"] = {}
    for sched, reason in (("resident", registry.RECURRENT_SLOTTED_REASON),
                          ("speculative", registry.NO_VERIFY_REASON)):
        want = f"scheduler='{sched}' unsupported here: {reason}"
        try:
            eng.serve(reqs, ServeConfig(n_slots=REC_SLOTS, scheduler=sched))
        except ValueError as err:
            if str(err) != want:
                fail(f"{cfg.name} {sched}: refused with {err!r}, expected "
                     f"{want!r}")
            res["refused"][sched] = str(err)
        else:
            fail(f"{cfg.name}: the {sched} scheduler served a recurrent "
                 f"model")
    return res


def slstm_parts(torch, api, model, cfg, prompt) -> dict:
    """xlstm's sLSTM time loop in place, in one warm prefill of ``prompt``
    and in one training forward and backward of REC_TRAIN_BATCH × 256
    rows: each sLSTM block's forward (the host clock around the call, the
    device synchronised at both ends) and backward (from its output's
    gradient to the accumulation of its ``sw`` scale's, the block's first
    linear), beside the whole call's wall.  The sLSTM is host-bound, so
    only times taken inside the same call share a clock's state."""
    from repro_torch.models import xlstm
    real = xlstm.slstm_apply_train
    fwd, bwd, handles = [], [], []

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    def block(p, u_res, c, state=None, return_state=False):
        t0 = now()
        out = real(p, u_res, c, state=state, return_state=return_state)
        fwd.append(now() - t0)
        y = out[0] if return_state else out
        if y.requires_grad:
            mark = {}

            def start(grad, mark=mark):
                mark["t0"] = now()

            def end(param, mark=mark):
                bwd.append(now() - mark["t0"])
            y.register_hook(start)
            handles.append(p.sw.scale.register_post_accumulate_grad_hook(end))
        return out
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    toks = torch.randint(0, cfg.vocab_size, (REC_TRAIN_BATCH, 257),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    xlstm.slstm_apply_train = block
    try:
        with torch.inference_mode():
            api.prefill(model, {"tokens": prompt.to("cuda")})   # warm-up
            fwd.clear()
            t0 = now()
            api.prefill(model, {"tokens": prompt.to("cuda")})
            prefill = now() - t0
        pre, fwd[:] = sum(fwd), []
        t0 = now()
        api.loss_fn(model, batch).backward()
        step = now() - t0
    finally:
        xlstm.slstm_apply_train = real
        for h in handles:
            h.remove()
        for p in model.parameters():
            p.grad = None
    if len(bwd) != len(model.slstm):
        fail(f"xlstm: {len(bwd)} sLSTM backwards timed, expected "
             f"{len(model.slstm)}")
    train = sum(fwd) + sum(bwd)
    return {"prefill_ms": prefill * 1e3, "prefill_slstm_ms": pre * 1e3,
            "prefill_slstm_share": pre / prefill,
            "train_fwd_bwd_ms": step * 1e3, "train_slstm_ms": train * 1e3,
            "train_slstm_fwd_ms": sum(fwd) * 1e3,
            "train_slstm_share": train / step}


def recurrent_model(torch, name, phase, gen) -> dict:
    """One recurrent configuration at full width, at its DEPTH (module
    docstring, phases ssm and hybrid)."""
    cfg, api, model, mask, built = dense_build(torch, name)
    res = {"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
           **built}
    bound = built["model_gb"] + 2 * built["block_fp32_gb"]
    res["build_peak_bound_gb"] = bound
    if built["build_peak_gb"] > bound:
        fail(f"{name} build: peak {built['build_peak_gb']:.3f} GB above "
             f"the model's {built['model_gb']:.3f} GB plus two blocks' "
             f"float32 {2 * built['block_fp32_gb']:.3f} GB")
    calls = n_quantized(model) + shared_calls(model)
    res["linear_calls"], res["k4_a_step"] = calls, attn_layers(model, cfg)
    if (calls, res["k4_a_step"]) != REC_CALLS[name]:
        fail(f"{name} build: {calls} quantized linear calls and "
             f"{res['k4_a_step']} K4 a step, expected {REC_CALLS[name]}")
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
        "api": api, "model": model, "prompt": prompt},
        phase=f"{phase}_profile")
    res["serve"] = part("serve", recurrent_serve, torch, api, model, cfg)
    res["train"] = part("train", dense_train, torch, name, cfg, model, mask,
                        REC_TRAIN_STEPS, batch_size=REC_TRAIN_BATCH)
    if phase == "ssm":
        res["slstm"] = part("slstm_parts", slstm_parts, torch, api, model,
                            cfg, prompt)
    res["seconds"] = secs
    emit(res)
    del model, mask, api
    torch.cuda.empty_cache()
    return res


def phase_ssm(torch) -> dict:
    """xlstm-125m at full width and depth (module docstring, phase 18)."""
    return recurrent_model(torch, "xlstm-125m", "ssm",
                           torch.Generator().manual_seed(SEED + 28))


def phase_hybrid(torch) -> dict:
    """zamba2-7b at full width, at its DEPTH (module docstring, phase
    19)."""
    return recurrent_model(torch, "zamba2-7b", "hybrid",
                           torch.Generator().manual_seed(SEED + 29))


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
              step1=None, mesh=None, profile=True) -> dict:
    """``steps`` steps of ``train.loop.train`` (``data``'s batches:
    TrainConfig's 8 × 256 in phase arms), every kernel counter at 0 before
    each step and read after it: each step must launch exactly ``want``.
    ``step1``, a context manager factory, wraps the first step (the
    checks).  Figures: walls, device ms (CUDA events), the median of the
    steps after the first ``TRAIN_SKIP`` (after the first when there are
    fewer), peak memory of the run with the model in it (after a checked
    step 1: of the steps after it), optimizer-state bytes; then one more
    step profiled (its kernels' device ms and the top ones: the busy share
    of a step; not with ``profile`` False).  ``mesh``: a rank's context,
    ``model`` its shard — the mesh step, each step's collective record
    (all-reduces by axis) held to ``step.mesh_collectives``, and no
    profiled step."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import loop, step
    from repro_torch.train.state import make_state
    tcfg = TrainConfig(steps=steps, log_every=1, eval_every=10 ** 9,
                       ckpt_every=10 ** 9)
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    ts = step.build_train_step(api, cfg, tcfg, mask, opt, mesh=mesh)
    walls, dev, seen, records = [], [], [], []

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
        with (step1() if step1 is not None and not walls
              else contextlib.nullcontext()), \
                (mesh.recording() if mesh is not None
                 else contextlib.nullcontext([])) as rec:
            state, metrics = ts(state, batch)
        records.append(rec)
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
                             log=lambda msg: None, mesh=mesh)
    peak = torch.cuda.max_memory_allocated() - base
    bad = [i for i, got in enumerate(seen) if got != want]
    if bad:
        fail(f"arms {label}: step {bad[0] + 1} launched {seen[bad[0]]}, "
             f"expected {want}")
    formula = None if mesh is None else step.mesh_collectives(model, cfg,
                                                              mask)
    for i, rec in enumerate(records if mesh is not None else ()):
        got = collectives_by_axis(rec)
        if {e["kind"] for e in rec} != {"all_reduce"} or \
                {a: c["count"] for a, c in got.items()} != formula:
            fail(f"arms {label}: step {i + 1} issued {got} (kinds "
                 f"{sorted({e['kind'] for e in rec})}), the formula "
                 f"{formula}")
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"arms {label}: losses {losses}")
    skip = TRAIN_SKIP if steps > TRAIN_SKIP + 1 else 1
    timed = sorted(walls[skip:]) or walls
    res = {"steps": steps, "losses": losses, "step_ms": walls,
           "device_ms": dev, "median_step_ms": timed[len(timed) // 2],
           "tokens_per_s": data.batch_size * data.seq_len
           / timed[len(timed) // 2] * 1e3,
           "peak_mem_gb": peak / 1e9,
           "state_bytes": opt.state_bytes(state["opt"]),
           "launches_a_step": seen[-1], "hist": hist}
    if mesh is not None:
        res.update(collectives_a_step=collectives_by_axis(records[-1]),
                   formula=formula)
    elif profile:
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
    want = dict.fromkeys(chk.calls, 0)
    want.update(quant_gemv=n_lin * (NEW - 1), quant_matmul=n_lin)
    if chk.calls != want or not torch.equal(out, gen["out"]):
        fail(f"arms lora_optq generate: {chk.calls} checked, expected "
             f"{want}; tokens equal to the unchecked run's: "
             f"{torch.equal(out, gen['out'])}")
    res["generate"]["checked"] = dict(chk.calls, max_abs_err=chk.worst)
    del gen, engine, trained, out
    torch.cuda.empty_cache()
    return res, model


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
    del state, opt, measured, ts
    torch.cuda.empty_cache()
    return res, model


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
    printed beside them.  Its ``models`` (lora_optq's, qat's) go on to
    phase mesh_arms."""
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
    res["lora_optq"], optq = arms_lora_optq(torch, data, calib, prompt)
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
    res["qat"], qat = arms_qat(torch, data)
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
    # phase mesh_arms serves and trains these two on meshes: the GPTQ
    # backbone with its trained adapters, and the trained QAT model
    res["models"] = {"lora_optq": optq, "qat": qat}
    return res


HARNESS_TASKS = ("taskA", "taskB")


def quiet(msg: str) -> None:
    """A log sink for the port's entry points' progress lines."""


def slo_row(summary) -> dict:
    """tok/s on the wall clock and the virtual-clock p50 / p99 of TTFT, TPOT
    and e2e of a ``driver.summarize`` summary."""
    slo = summary["slo"]
    return {"tok_s_wall": summary["tok_s_wall"],
            **{f"{k[:-2]}_{q}": slo[k][q] for k in ("ttft_s", "tpot_s",
                                                    "e2e_s")
               for q in ("p50", "p99")}}


def harness_row(out, calls, wall, peak, launches) -> dict:
    """One harness run's line: counts, tiers, walls, SLOs, launches."""
    rep, summ = out["report"], out["summary"]
    return {"requests": len(out["requests"]), "steps": rep.steps,
            "calls": dict(calls), "decoded": rep.decoded,
            "switches": rep.switches,
            "task_drain_idle_slot_steps": rep.task_drain_idle_slot_steps,
            "tiers": [rep.tier_device_hits, rep.tier_host_hits,
                      rep.tier_disk_loads],
            "wall_s": wall, "serve_wall_s": summ["wall_s"],
            "peak_gb": peak / 1e9, **slo_row(summ), "launches": launches}


def phase_harness(torch, main_path, plane) -> dict:
    """The serving harness (``serve.traffic`` → ``serve.driver`` →
    ``serve.telemetry``) and ``launch.serve``'s own functions on phase
    main's llama3.2-1b and phase plane_backbone's planes: two tasks tuned
    by ``launch.serve.tune_tasks`` into a bank on disk, reopened tiered;
    ``run_continuous`` with the CLI's arguments under resident (poisson)
    and drain (the canned trace); the poisson stream speculatively on the
    planes and replayed greedily (the same tokens); then one
    ``driver.run`` into a ``MetricSink`` twice from the same seed: equal
    stable rows.  Every run's launches gated exactly."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.core import policies
    from repro_torch.core.scale_bank import ScaleBank
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import ServeConfig, driver, telemetry, traffic
    from repro_torch.train.serve import Engine

    api, model, cfg = main_path["api"], main_path["model"], main_path["cfg"]
    n_lin, layers = cfg.n_layers * 7, cfg.n_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_harness_")
    root = os.path.join(tmp, "bank")
    res = {"phase": "harness", "model": cfg.name, "tasks": HARNESS_TASKS}
    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # 1. tuning: the backbone trained in place and restored after each task
    mask = policies.make_mask(model, cfg)
    own = {n: p.detach().clone() for n, p in model.named_parameters()
           if mask[n]}
    steps = HARNESS_TUNE_STEPS
    losses, launches, wall, peak = launch_gate(
        torch, "harness tuning", lambda: launch_serve.tune_tasks(
            api, model, mask, HARNESS_TASKS, steps, ScaleBank(root=root),
            log=quiet),
        # forward and remat recompute, 8 × 64 rows: K2 at M = 512
        lambda _: {"quant_matmul": len(HARNESS_TASKS) * steps * 2 * n_lin})
    add(launches)
    moved = [n for n, p in model.named_parameters()
             if n in own and not torch.equal(p, own[n])]
    if moved:
        fail(f"harness: tuning left {len(moved)} backbone scales changed")
    if not all(math.isfinite(x) for ls in losses.values() for x in ls):
        fail(f"harness: non-finite tuning losses {losses}")
    res["tune"] = {"steps": steps, "wall_s": wall, "peak_gb": peak / 1e9,
                   "losses": losses, "launches": launches}

    def cli(*flags):
        return launch_serve.parse_args(["--device", "cuda", "--host-cache",
                                        "1", *flags])

    # 2. run_continuous with the CLI's arguments, each on a fresh engine
    #    over the reopened tiered bank (a host LRU of one task)
    runs = (
        ("resident_poisson", (
            "--traffic", "poisson", "--rate", "2.0", "--batch", "8",
            "--n-new", "16", "--scheduler", "resident", "--prefetch-depth",
            "2"),
         lambda c, n: {"quant_gemv_tasks": n_lin * (c + n),
                       "flash_attention": layers * c}),
        ("drain_trace", (
            "--traffic", "trace", "--batch", "8", "--n-new", "16",
            "--scheduler", "drain"),
         lambda c, n: {"quant_gemv": n_lin * (c + n),
                       "flash_attention": layers * c}),
    )
    for label, flags, want in runs:
        args = cli(*flags)
        engine = Engine(api, model,
                        bank=launch_serve.open_tiered(root, 1, log=quiet))
        calls = counted_calls(engine, "step")
        out, lines = {}, []
        ok, launches, wall, peak = launch_gate(
            torch, f"harness {label}",
            lambda: launch_serve.run_continuous(engine, cfg, args,
                                                list(HARNESS_TASKS),
                                                log=lines.append, out=out),
            lambda _: want(calls["step"], len(out["requests"])))
        if not ok:
            fail(f"harness {label}: run_continuous failed its gates:\n"
                 + "\n".join(line for line in lines
                              if not line.startswith("[serve] req")))
        add(launches)
        res[label] = harness_row(out, calls, wall, peak, launches)
        if label == "resident_poisson" and sum(res[label]["tiers"]) < 1:
            fail(f"harness {label}: no tiered-bank admit counted")

    # 3. the same poisson stream speculatively on the plane backbone
    #    (spec_k 2, the 3-plane draft) through driver.run, and replayed
    #    greedily: the same tokens, SPEC 2 draft steps a round.  On random
    #    weights the draft accepts next to nothing, so the step count is
    #    recorded, not gated (launch.serve's tiny tuned run gates it)
    args = cli("--traffic", "poisson", "--rate", "2.0", "--batch", "8",
               "--n-new", "16", "--scheduler", "speculative", "--spec-k",
               "2")
    reqs = launch_serve.continuous_requests(cfg, args, HARNESS_TASKS,
                                            log=quiet)
    config = launch_serve.serve_config(args)
    engine = Engine(plane["api"], plane["model"],
                    bank=launch_serve.open_tiered(root, 1, log=quiet))
    calls = counted_calls(engine, "step", "spec_step")
    n = len(reqs)
    (rep, summ), launches, wall, peak = launch_gate(
        torch, "harness speculative_poisson",
        lambda: driver.run(engine, reqs, config),
        # rounds of k + 1 plane-K5 steps; every prefill (<= 8 rows) K5
        lambda _: {"quant_gemv_tasks_planes": n_lin * (
            3 * calls["spec_step"] + n),
            "flash_attention": layers * 3 * calls["spec_step"]})
    add(launches)
    greedy, g_launches, g_wall, _ = launch_gate(
        torch, "harness speculative_poisson greedy replay",
        lambda: engine.serve(reqs, dataclasses.replace(config,
                                                       scheduler="auto")),
        lambda _: {"quant_gemv_tasks_planes": n_lin * (calls["step"] + n),
                   "flash_attention": layers * calls["step"]})
    add(g_launches)
    if rep.scheduler != "speculative" or rep.n_served != n \
            or rep.bubble_slot_steps:
        fail(f"harness speculative: scheduler {rep.scheduler}, served "
             f"{rep.n_served} of {n}, {rep.bubble_slot_steps} bubbles")
    if rep.draft_steps != 2 * calls["spec_step"]:
        fail(f"harness speculative: {rep.draft_steps} draft steps in "
             f"{calls['spec_step']} rounds of 2")
    gate_tokens_equal("harness speculative", "greedy replay", greedy, rep)
    res["speculative_poisson"] = {
        **harness_row({"requests": reqs, "report": rep, "summary": summ},
                      {"spec_step": calls["spec_step"]}, wall, peak,
                      launches),
        "greedy_steps": greedy.steps, "greedy_wall_s": g_wall,
        "acceptance_rate": rep.acceptance_rate,
        "draft_proposed": rep.draft_proposed,
        "draft_accepted": rep.draft_accepted}
    # the drain run swapped task scales into the backbone: its own back
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in own:
                p.copy_(own[n])

    # 3. driver.run into a MetricSink, twice from the same seed
    docs, reps = [], []
    for i in range(2):
        reqs, meta = traffic.make(
            "poisson", vocab=cfg.vocab_size, seed=SEED,
            tasks=HARNESS_TASKS, rate=2.0, n_requests=HARNESS_REQUESTS,
            prompt_lens=HARNESS_PROMPTS, n_new=HARNESS_NEW)
        engine = Engine(api, model,
                        bank=launch_serve.open_tiered(root, 1, log=quiet))
        calls = counted_calls(engine, "step")
        sink = telemetry.MetricSink()
        (rep, summ), launches, wall, peak = launch_gate(
            torch, f"harness driver run {i + 1}",
            lambda: driver.run(engine, reqs, ServeConfig(
                n_slots=SERVE_SLOTS, scheduler="resident"), sink=sink),
            # every prompt over 32 rows: K2 a prefill, one task each
            lambda _: {"quant_matmul": n_lin * len(reqs),
                       "quant_gemv_tasks": n_lin * calls["step"],
                       "flash_attention": layers * calls["step"]})
        add(launches)
        if rep.n_served != len(reqs) or rep.bubble_slot_steps:
            fail(f"harness driver run {i + 1}: served {rep.n_served} of "
                 f"{len(reqs)}, {rep.bubble_slot_steps} bubble slot-steps")
        path = os.path.join(tmp, f"serving_{i}.json")
        sink.write(path, **meta)
        docs.append(telemetry.load(path))
        reps.append(rep)
        res[f"driver_run_{i + 1}"] = {
            "requests": len(reqs), "steps": rep.steps,
            "step_calls": calls["step"], "decoded": rep.decoded,
            "wall_s": wall, "peak_gb": peak / 1e9, **slo_row(summ),
            "launches": launches}
    if telemetry.stable_metrics(docs[0]) != telemetry.stable_metrics(docs[1]):
        fail("harness: two same-seed driver runs wrote different stable "
             "metrics")
    gate_tokens_equal("harness driver run 2", "first driver", reps[0],
                      reps[1])
    res["stable_rows"] = len(telemetry.stable_metrics(docs[0]))
    res["launches"] = total
    shutil.rmtree(tmp)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# Phase mesh: serving on a (data, model) mesh over torch.distributed
# ---------------------------------------------------------------------------

# the meshes phase mesh serves on: (1, 1) over NCCL in the script's own
# process, the others spawned on cuda:0 under gloo (the machine has one
# card), at the same time (``spawn_meshes``); MESH_REQUESTS of phase
# serve's requests over MESH_TASKS tasks, all at step 0, their budgets cut
# to MESH_NEW (gloo's loopback makes a step ~0.1–0.3 s)
MESH_WORLDS = ((1, 1), (1, 2), (2, 2))
MESH_REQUESTS, MESH_TASKS, MESH_NEW = 8, 2, (4, 6, 8)
# the mesh's prefill logits against the unsharded engine's: within 2⁻⁵ of
# their largest magnitude (the row-parallel sums add in another order)
MESH_LOGIT_TOL = 2.0 ** -5
MESH_QM = ("quant_gemv", "quant_matmul", "quant_gemv_tasks",
           "quant_gemv_planes", "quant_matmul_planes",
           "quant_gemv_tasks_planes")


def main_cfg():
    """Phase main's configuration: llama3.2-1b, PEQA 4-bit per-channel RTN
    (n_grid 20)."""
    from repro_torch import configs
    from repro_torch.configs.base import QuantConfig, TuningConfig
    return configs.get_config("llama3.2-1b").replace(
        tuning=TuningConfig(mode="peqa"),
        quant=QuantConfig(bits=4, group_size=None, n_grid=20))


def load_whole(torch, cfg, path):
    """The whole quantized model saved by ``phase_mesh`` (a state dict),
    rebuilt on this rank's card."""
    return model_from_state(torch, cfg, torch.load(
        path, map_location="cuda", weights_only=True))


def model_from_state(torch, cfg, state):
    """A model of ``cfg`` (any family's module, any arm's storage: codes,
    QAT's scales beside ``w``, LoRA adapters) around the tensors of a
    state dict (taken as they are: no copy)."""
    from repro_torch.models import registry
    from repro_torch.models.linear import Linear
    model = registry.module_class(cfg)(cfg, device="meta")
    spec = cfg.quant.spec()
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear):
            continue
        if f"{name}.qw" in state:
            mod.set_quantized(state[f"{name}.qw"], state[f"{name}.scale"],
                              state[f"{name}.zero"], spec)
        elif f"{name}.scale" in state:
            mod.set_fake_quant(state[f"{name}.scale"],
                               state[f"{name}.zero"], spec)
        if f"{name}.lora_a" in state:
            mod.set_lora(state[f"{name}.lora_a"], state[f"{name}.lora_b"])
    model.load_state_dict(state, assign=True)
    return model


def mesh_requests(vocab: int) -> list:
    """The first MESH_REQUESTS of phase serve's requests (prompts of 20,
    100 and 256 tokens), over MESH_TASKS tasks, all arriving at step 0,
    budgets MESH_NEW."""
    from repro_torch.serve import Request
    return [Request(tokens=r.tokens, n_new=MESH_NEW[i % len(MESH_NEW)],
                    task=f"t{i % MESH_TASKS}")
            for i, r in enumerate(serve_requests(vocab, MESH_REQUESTS))]


def mesh_rank(rank: int, shape: tuple, tmp: str, train: bool) -> None:
    """One spawned rank of phase mesh: the whole model saved by the parent,
    then ``mesh_serve``; the results go to ``tmp``.  With ``train`` the
    rank then runs phase mesh_train's part too (``train_rank``: the same
    process, so no second start and warm-up).  A failed gate exits
    non-zero."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    ctx = mesh_mod.make_debug_mesh(*shape)       # on the rank's own card
    prompt = torch.load(os.path.join(tmp, "prompt.pt"))
    # no name here holds the whole model: mesh_serve frees it once cut
    out = mesh_serve(torch, ctx, rank,
                     load_whole(torch, main_cfg(),
                                os.path.join(tmp, "whole.pt")),
                     prompt, {"mesh_and_load": time.perf_counter() - t0})
    torch.save(out, rank_file(tmp, shape, rank))
    del out
    if train:
        torch.cuda.empty_cache()
        train_rank(torch, ctx, rank, tmp)


def mesh_serve(torch, ctx, rank: int, whole, prompt, stages: dict) -> dict:
    """One rank's part of phase mesh on ``ctx``: its shard of ``whole``
    (phase main's model) and of its bit-planes, then the gated runs;
    returns what ``mesh_gate`` reads (``stages``: seconds by part)."""
    from repro_torch.core.scale_bank import swap_collectives
    from repro_torch.dist import backend, context, sharding
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serve import ServeConfig
    from repro_torch.train.serve import Engine

    shape = (ctx.data_size, ctx.model_size)
    dev = ctx.device
    label = f"mesh {shape} rank {rank}"
    t_stage = [time.perf_counter()]

    def stage(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t_stage[0]
        t_stage[0] = now
    cfg = main_cfg()
    api = registry.build(cfg)
    bank = task_bank(whole, MESH_TASKS, SEED)
    local = sharding.shard_model(whole, cfg, ctx)
    plane = None
    if shape != (1, 1):
        plane = plane_backbone(torch, {"cfg": cfg, "model": whole})
        plane_local = sharding.shard_model(plane["model"], plane["cfg"], ctx)
        plane["model"] = None
    del whole
    torch.cuda.empty_cache()
    stage("cut")
    out = {"rank": rank, "stages": stages, "data_rank": ctx.data_rank,
           "model_rank": ctx.model_rank, "summary": backend.summary(),
           "local_gb": sum(t.numel() * t.element_size() for t in (
               *local.parameters(), *local.buffers())) / 1e9}
    engine = Engine(api, local, bank=bank, ctx=ctx, logitshard=True)
    engine.generate(prompt, 2)                        # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    toks = engine.generate(prompt, NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    out["launches"] = {k.__name__: k.launches for k in ops.KERNELS
                       if k.launches}
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if shape != (1, 1):              # (1, 1) is held to the unsharded run
        again = engine.generate(prompt, NEW)
        if not torch.equal(toks, again):
            fail(f"{label}: two identical sharded generate runs differ")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = engine.prefill_logits(prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out.update(tokens=toks.cpu(), logits=logits.cpu() if rank == 0 else None,
               generate_s=gen_s, prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=(gen_s - prefill_s) * 1e3 / (NEW - 1))
    cache = PROMPT + NEW
    rec_ls = engine.decode_collectives(BATCH, cache)
    rec_base = Engine(api, local, bank=bank, ctx=ctx,
                      logitshard=False).decode_collectives(BATCH, cache)
    out["decode_collectives"] = context.collective_stats(rec_ls)
    out["decode_collectives_no_logitshard"] = context.collective_stats(
        rec_base)
    out["vocab_gathers"] = context.allgather_extent_count(
        rec_ls, cfg.vocab_size)
    out["vocab_gathers_no_logitshard"] = context.allgather_extent_count(
        rec_base, cfg.vocab_size)
    swap = swap_collectives(local, bank.tasks["t1"], ctx)
    bank.switch(local, "t0", ctx=ctx)
    out["swap_collectives"] = len(swap)
    out["swap_local_bytes"] = bank.local_nbytes("t1", ctx)
    out["swap_bytes"] = bank.nbytes("t1")
    stage("generate")
    if shape == (1, 1):
        out["profile"] = decode_profile(torch, engine, prompt)
        return out

    # every new shard shape of K1, K2, K4, K5 and K6a held to plain once,
    # on rank 0 (the others wait in their next collective meanwhile, so
    # its timings have the card to themselves)
    reqs = mesh_requests(cfg.vocab_size)
    resident = ServeConfig(n_slots=SERVE_SLOTS, scheduler="resident",
                           resident_tasks=MESH_TASKS)
    checked = CheckedQuantMatmul(ops, label, shapes=True) if rank == 0 \
        else contextlib.nullcontext()
    with checked as chk:
        engine.generate(prompt, 2)
        t0 = time.perf_counter()
        rep_n = engine.serve(reqs, resident)
        out["resident_wall_s"] = time.perf_counter() - t0
        stage("resident")
        out["install_collectives"] = len(
            engine.resident.install_collectives("t1"))
        p_engine = Engine(plane["api"], plane_local, ctx=ctx,
                          logitshard=True)
        p_engine.generate(prompt, 2)                 # K2-plane, K1-plane
        p_engine = Engine(plane["api"], plane_local, bank=bank, ctx=ctx,
                          logitshard=True)
        rep_p = p_engine.serve(reqs, resident)
        stage("plane_resident")
        t0 = time.perf_counter()
        rep_s = p_engine.serve(reqs, ServeConfig(
            n_slots=SERVE_SLOTS, scheduler="speculative", spec_k=SPEC_K,
            draft_bits=DRAFT_BITS, resident_tasks=MESH_TASKS))
        out["speculative_wall_s"] = time.perf_counter() - t0
        stage("speculative")
    for what, rep in (("plane resident", rep_p), ("speculative", rep_s)):
        if rep.tokens != rep_n.tokens:
            diff = sum(a != b for a, b in zip(rep.tokens, rep_n.tokens))
            fail(f"{label}: {what} tokens differ from nibble resident in "
                 f"{diff} of {len(reqs)} requests")
    if any(t is None or len(t) != r.n_new
           for r, t in zip(reqs, rep_n.tokens)):
        fail(f"{label}: a request was not served its budget")
    out["serve"] = {"requests": len(reqs), "resident_steps": rep_n.steps,
                    "speculative_steps": rep_s.steps,
                    "acceptance": rep_s.acceptance_rate,
                    "decoded": rep_n.decoded, "tokens": rep_n.tokens}
    out["continuous_decode_collectives"] = context.collective_stats(
        engine.continuous_decode_collectives(SERVE_SLOTS, cache))
    if rank == 0:
        kinds = {r["kernel"] for r in chk.rows.values()}
        want = {*MESH_QM, "flash_attention"}
        if kinds != want:
            fail(f"{label}: shard shapes checked for {sorted(kinds)}, "
                 f"expected {sorted(want)}")
        out["shapes"] = list(chk.rows.values())
    stage("records")
    return out


def decode_profile(torch, engine, prompt, steps: int = 8) -> dict:
    """Host time a decode step by operator (``torch.profiler``, CPU
    activity): ``generate(prompt, 1 + steps)``'s self CPU time less that
    of ``generate(prompt, 1)`` (the prefill and first sample alone), over
    ``steps``; the ``top`` ops as [name, ms a step, calls a step], and
    the profiling's own wall seconds."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()

    def by_op(n_new):
        engine.generate(prompt, n_new)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine.generate(prompt, n_new)
            torch.cuda.synchronize()
        return {e.key: (e.self_cpu_time_total, e.count)
                for e in prof.key_averages()}
    base, run = by_op(1), by_op(1 + steps)
    ops = {k: ((us - base.get(k, (0, 0))[0]) / steps / 1e3,
               (n - base.get(k, (0, 0))[1]) / steps)
           for k, (us, n) in run.items()}
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:12]
    return {"host_ms_a_step": sum(ms for ms, _ in ops.values()),
            "top": [[k, ms, n] for k, (ms, n) in top],
            "s": time.perf_counter() - t0}


def spawn_meshes(fn, jobs) -> dict:
    """``backend.spawn(fn, D·M, "cuda", (D, M), *args)`` for every ((D, M),
    args) of ``jobs`` at the same time, one thread each — their ranks
    share the card, so each mesh's times include the others' load —, and
    wait for all; returns {(D, M): wall s}.  A failed rank fails the
    phase."""
    import threading
    from repro_torch.dist import backend
    walls, errors = {}, {}

    def run(shape, args):
        t0 = time.perf_counter()
        try:
            backend.spawn(fn, shape[0] * shape[1], "cuda", shape, *args)
        except Exception as e:           # reported in the caller's thread
            errors[shape] = e
        walls[shape] = time.perf_counter() - t0
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for shape, e in errors.items():
        fail(f"{fn.__name__} {shape}: a rank failed: {e}")
    return walls


def rank_file(tmp: str, shape: tuple, rank: int, name: str = "") -> str:
    return os.path.join(tmp, f"{name}rank_{shape[0]}x{shape[1]}_{rank}.pt")


def phase_mesh(torch, main_path, tmp=None, train=False) -> dict:
    """Serving on (data, model) meshes at llama3.2-1b's full width and
    depth, each rank cutting its shard from phase main's whole model:
    (1, 1) over NCCL in this process, bit-equal to the unsharded engine;
    (1, 2) and (2, 2) spawned on cuda:0 under gloo at the same time
    (``spawn_meshes``), the whole model saved once for them in ``tmp``
    (kept there for phase mesh_train; None: a
    directory of this phase's own, removed after it).  With ``train`` the
    spawned ranks also run phase mesh_train's part, into ``tmp``.  gloo's
    times measure the path, not NCCL's speed."""
    import torch.distributed as dist

    from repro_torch.dist import backend
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train.serve import Engine

    cfg, model, prompt = main_path["cfg"], main_path["model"], \
        main_path["prompt"]
    ref = Engine(main_path["api"], model)
    ref_logits = ref.prefill_logits(prompt).float().cpu()
    ref_tokens = ref.generate(prompt, NEW).cpu()
    want = main_path["res"]["launches"]
    own = tmp is None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_") if own else tmp
    res = {"phase": "mesh", "model": cfg.name, "layers": cfg.n_layers,
           "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
           "logit_tolerance_share": MESH_LOGIT_TOL, "meshes": {}}
    try:
        t0 = time.perf_counter()
        backend.init(0, 1, "cuda", backend.free_port())
        try:
            ctx = mesh_mod.make_debug_mesh(1, 1)
            one = mesh_serve(torch, ctx, 0, model, prompt, {})
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        res["meshes"]["1x1"] = mesh_gate(
            torch, (1, 1), [one], ref_logits, ref_tokens, want, cfg,
            time.perf_counter() - t0)
        # where a (1, 1) step's host time goes, beside the unsharded one's
        res["profile_1x1"] = {"mesh": one["profile"],
                              "unsharded": decode_profile(torch, ref,
                                                          prompt)}
        torch.save(model.state_dict(), os.path.join(tmp, "whole.pt"))
        torch.save(prompt, os.path.join(tmp, "prompt.pt"))
        walls = spawn_meshes(mesh_rank, [(shape, (tmp, train))
                                         for shape in MESH_WORLDS[1:]])
        for shape in MESH_WORLDS[1:]:
            world = shape[0] * shape[1]
            ranks = [torch.load(rank_file(tmp, shape, r), weights_only=False)
                     for r in range(world)]
            res["meshes"][f"{shape[0]}x{shape[1]}"] = mesh_gate(
                torch, shape, ranks, ref_logits, ref_tokens, want, cfg,
                walls[shape])
            for r in range(world):
                os.remove(rank_file(tmp, shape, r))
    finally:
        if own:
            shutil.rmtree(tmp, ignore_errors=True)
    emit(res)
    return res


def mesh_gate(torch, shape, ranks, ref_logits, ref_tokens, want, cfg,
              wall) -> dict:
    """Phase mesh's gates on one mesh's rank results; returns its row."""
    label = f"mesh {shape}"
    r0 = ranks[0]
    placed = {(r["summary"]["backend"], r["summary"]["device"])
              for r in ranks}
    expect = "nccl" if shape == (1, 1) else "gloo"
    if placed != {(expect, "cuda:0")}:
        fail(f"{label}: ranks ran over (backend, device) {placed}, "
             f"expected {expect} on cuda:0")
    for r in ranks:
        if not torch.equal(r["tokens"], r0["tokens"]):
            fail(f"{label}: rank {r['rank']}'s tokens differ from rank 0's")
        if r["launches"] != want:
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, the "
                 f"unsharded run {want}")
        if r["swap_collectives"] or r.get("install_collectives"):
            fail(f"{label}: a task swap or a row install made a collective")
        if r["vocab_gathers"] != 0 or r["vocab_gathers_no_logitshard"] < 1:
            fail(f"{label}: vocab-extent gathers {r['vocab_gathers']} under "
                 f"logitshard (want 0), {r['vocab_gathers_no_logitshard']} "
                 f"without (want >= 1)")
    logits = r0["logits"].float()
    if not torch.isfinite(logits).all():
        fail(f"{label}: non-finite prefill logits")
    diff = (logits - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    if shape == (1, 1):
        if diff != 0.0 or not torch.equal(r0["tokens"], ref_tokens):
            fail(f"{label}: the mesh path is not bit-equal to the unsharded "
                 f"engine (logits differ by {diff:.3e})")
    elif diff > MESH_LOGIT_TOL * scale:
        fail(f"{label}: prefill logits differ from the unsharded engine's "
             f"by {diff:.3e} > {MESH_LOGIT_TOL * scale:.3e}")
    row = {"world": len(ranks), "backend": expect, "wall_s": wall,
           "logits_max_abs_diff": diff, "logits_max_abs": scale,
           "tokens_equal_share_vs_unsharded":
               (r0["tokens"][:, PROMPT:] == ref_tokens[:, PROMPT:]
                ).float().mean().item(),
           "launches_a_rank": r0["launches"],
           "decode_collectives": r0["decode_collectives"],
           "decode_collectives_no_logitshard":
               r0["decode_collectives_no_logitshard"],
           "vocab_gathers": r0["vocab_gathers"],
           "vocab_gathers_no_logitshard": r0["vocab_gathers_no_logitshard"],
           "swap_collectives": r0["swap_collectives"],
           "swap_local_bytes": r0["swap_local_bytes"],
           "swap_bytes": r0["swap_bytes"],
           "decode_ms_per_step": [r["decode_ms_per_step"] for r in ranks],
           "prefill_ms": [r["prefill_ms"] for r in ranks],
           "peak_gb": [r["peak_gb"] for r in ranks],
           "local_gb": [r["local_gb"] for r in ranks]}
    if shape != (1, 1):
        for r in ranks:
            if r["serve"]["tokens"] != r0["serve"]["tokens"]:
                fail(f"{label}: rank {r['rank']} served other tokens")
        row["serve"] = {k: v for k, v in r0["serve"].items()
                        if k != "tokens"}
        row["install_collectives"] = r0["install_collectives"]
        row["resident_wall_s"] = r0["resident_wall_s"]
        row["speculative_wall_s"] = r0["speculative_wall_s"]
        row["continuous_decode_collectives"] = \
            r0["continuous_decode_collectives"]
        # one compact row a shape: kernel, M, N, K, err, ms, plain ms,
        # bound ms (heads for K4: B, Sq, Sk, Hq, Hkv, D)
        row["shapes"] = [
            [s["kernel"], *(s[k] for k in (("M", "N", "K")
                                           if "M" in s else ("B", "Sq", "Sk",
                                                             "Hq", "Hkv"))),
             s["max_abs_err"], s["ms"], s["plain_ms"], s["bound_ms"]]
            for s in r0["shapes"]]
        row["shapes_max_abs_err"] = max(s["max_abs_err"]
                                        for s in r0["shapes"])
    row["stages_s"] = [r["stages"] for r in ranks]
    return row


# ---------------------------------------------------------------------------
# Phase mesh_train: PEQA training on the meshes of phase mesh
# ---------------------------------------------------------------------------

# steps a mesh takes (phase train's batch: 8 × 256 a step, its corpus and
# optimizer); the step-1 loss against the unsharded step within phase
# train's bf16 tolerances
MESH_TRAIN_STEPS = 3
MESH_TRAIN_LOSS_RTOL, MESH_TRAIN_GNORM_RTOL = 2.0 ** -8, 5e-2


def mesh_train_batches(cfg) -> list:
    """Phase train's first MESH_TRAIN_STEPS + 1 global batches (the last
    for the step after a checkpoint)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import pipeline, synthetic
    tcfg = TrainConfig()
    train_toks, _ = synthetic.split(synthetic.corpus(
        cfg.vocab_size, TRAIN_TOKENS, seed=SEED))
    data = pipeline.PackedLM(train_toks, tcfg.batch_size, tcfg.seq_len,
                             seed=SEED)
    return [data.batch_at(i) for i in range(MESH_TRAIN_STEPS + 1)]


def mesh_train_state(model, cfg, compress: bool = False):
    """(train config, API, mask, optimizer, state) of a fresh PEQA run over
    the whole ``model`` (trained in place)."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.core import policies
    from repro_torch.models import registry
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train.state import make_state
    tcfg = TrainConfig(optim=OptimConfig(
        grad_compression="int8" if compress else None))
    mask = policies.make_mask(model, cfg)
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(dict(model.named_parameters()), mask))
    return tcfg, registry.build(cfg, device="cuda"), mask, opt, state


def mesh_train_runs(cfg) -> tuple:
    """(name, config, int8, steps) of each run: the dense trajectory (its
    last step after the checkpoint), and one "chunked" and one int8 step
    from the start."""
    return (("dense", cfg, False, MESH_TRAIN_STEPS + 1),
            ("chunked", cfg.replace(attn_impl="chunked"), False, 1),
            ("int8", cfg, True, 1))


def mesh_train_unsharded(torch, model, cfg, batches) -> dict:
    """Each run's metrics unsharded, every run from ``model``'s scales
    (restored after each); the dense run's steps after the first timed
    (``step_ms``) and its peak over them (``peak_gb``, the model
    included)."""
    from repro_torch.train import step
    out = {}
    for name, c, int8, n in mesh_train_runs(cfg):
        tcfg, api, mask, opt, state = mesh_train_state(model, c, int8)
        start = {k: p.detach().clone() for k, p in
                 model.named_parameters() if mask[k]}
        ts = step.build_train_step(api, c, tcfg, mask, opt)
        hist, ms = [], []
        for i, b in enumerate(batches[:n]):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = ts(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append({k: float(v) for k, v in m.items()})
        out[name] = hist
        if name == "dense":
            out["step_ms"] = ms[1:]
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            for k, p in model.named_parameters():
                if k in start:
                    p.copy_(start[k])
    return out


def train_file(tmp: str, shape: tuple, rank: int) -> str:
    return os.path.join(tmp, f"train_{shape[0]}x{shape[1]}_{rank}.pt")


def train_rank(torch, ctx, rank: int, tmp: str) -> None:
    """A spawned rank's part of phase mesh_train on ``ctx``: phase mesh's
    whole model, then ``mesh_train``; the results go to ``tmp``."""
    t0 = time.perf_counter()
    cfg = main_cfg().replace(remat="block")
    out = mesh_train(torch, ctx, rank, load_whole(
        torch, cfg, os.path.join(tmp, "whole.pt")), cfg,
        mesh_train_batches(cfg), tmp, {"load": time.perf_counter() - t0})
    torch.save(out, train_file(tmp, (ctx.data_size, ctx.model_size), rank))


def mesh_train_rank(rank: int, shape: tuple, tmp: str) -> None:
    """One spawned rank of phase mesh_train alone (when phase mesh's ranks
    did not run its part): the mesh context, then ``train_rank``."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import mesh as mesh_mod
    train_rank(torch, mesh_mod.make_debug_mesh(*shape), rank, tmp)


def collectives_by_axis(record) -> dict:
    """{axis: {"count", "bytes"}} of a collective record (all-reduces)."""
    out = {}
    for e in record:
        s = out.setdefault(e["axis"], {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += e["bytes"]
    return out


def mesh_train(torch, ctx, rank: int, whole, cfg, batches, tmp,
               stages: dict) -> dict:
    """One rank's part of phase mesh_train on ``ctx``, cutting its shards
    from ``whole`` (left as it was): at (1, 2) first a "chunked" and an
    int8 step from the start; then MESH_TRAIN_STEPS steps — step 1's every
    K2 call (and K4 call, "chunked") held to plain on rank 0, its
    collectives recorded, steps 2–3 timed —, and at (1, 2) the whole state
    checkpointed to ``tmp`` and one step more.  Returns what
    ``mesh_train_gate`` reads."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist import backend, context
    from repro_torch.kernels import ops
    from repro_torch.train import state as state_mod
    from repro_torch.train import step

    shape = (ctx.data_size, ctx.model_size)
    label = f"mesh_train {shape} rank {rank}"
    rows_m = batches[0]["tokens"].size // ctx.data_size
    t_stage = [time.perf_counter()]

    def stage(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t_stage[0]
        t_stage[0] = now

    def run(c, int8):
        tcfg, api, mask, opt, whole_state = mesh_train_state(whole, c, int8)
        local = state_mod.shard_state(whole_state, ctx, c)
        return (local, step.build_train_step(api, c, tcfg, mask, opt,
                                             mesh=ctx), mask)

    def checked(what):
        return CheckedQuantMatmul(ops, f"{label} {what}", rows_m=rows_m,
                                  attention=True) if rank == 0 \
            else contextlib.nullcontext()

    def metrics(m):
        return {k: float(v) for k, v in m.items()}

    out = {"rank": rank, "coords": (ctx.data_rank, ctx.model_rank),
           "summary": backend.summary(), "stages": stages, "rows": rows_m}
    for name, c, int8, _ in mesh_train_runs(cfg)[1:] if shape == (1, 2) \
            else ():
        local, ts, _ = run(c, int8)
        for k in ops.KERNELS:
            k.launches = 0
        with checked(name) as chk:
            local, m = ts(local, batches[0])
        out[name] = {"step": metrics(m), "launches": {
            k.__name__: k.launches for k in ops.KERNELS if k.launches}}
        if chk is not None:
            out[name]["checked"] = dict(chk.calls, worst=chk.worst)
        del local, ts
        stage(name)

    local, ts, mask = run(cfg, False)
    del whole                   # a spawned rank's copy is freed here
    torch.cuda.empty_cache()
    model = local["params"]
    out["want"] = step.mesh_collectives(model, cfg, mask)
    out["local_gb"] = sum(t.numel() * t.element_size() for t in (
        *model.parameters(), *model.buffers())) / 1e9
    codes = {n: b.clone() for n, b in model.named_buffers()}
    hist, ms, launches, records = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(ctx.device)
    for i, b in enumerate(batches[:MESH_TRAIN_STEPS]):
        for k in ops.KERNELS:
            k.launches = 0
        with (checked("step 1") if i == 0 else contextlib.nullcontext()
              ) as chk, ctx.recording() as rec:
            t0 = time.perf_counter()
            local, m = ts(local, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        hist.append(metrics(m))
        launches.append({k.__name__: k.launches for k in ops.KERNELS
                         if k.launches})
        records.append(rec)
        if chk is not None:
            out["checked"] = dict(chk.calls, worst=chk.worst)
    out["peak_gb"] = torch.cuda.max_memory_allocated(ctx.device) / 1e9
    stage("steps")
    out.update(hist=hist, step_ms=ms, launches=launches,
               collectives=[collectives_by_axis(r) for r in records],
               kinds=sorted({e["kind"] for r in records for e in r}),
               vocab_gathers=sum(context.allgather_extent_count(
                   r, cfg.vocab_size) for r in records),
               codes_frozen=all(torch.equal(b, codes[n])
                                for n, b in model.named_buffers()))
    if shape == (1, 2):
        tree = state_mod.whole_tree(local, ctx)
        if rank == 0:
            CheckpointManager(os.path.join(tmp, "mesh_ckpt")).save(
                MESH_TRAIN_STEPS, tree)
        del tree
        ctx.barrier()
        stage("checkpoint")
        local, m = ts(local, batches[MESH_TRAIN_STEPS])
        out["after_checkpoint"] = metrics(m)
        stage("step_after")
    return out


def phase_mesh_train(torch, main_path, tmp) -> dict:
    """PEQA training on the (data, model) meshes of phase mesh at
    llama3.2-1b's full width and depth, 8 × 256 a step, remat "block",
    each rank cutting its shard of the whole train state: (1, 1) over NCCL
    in this process, (1, 2) and (2, 2) on cuda:0 under gloo from the model
    phase mesh saved in ``tmp`` — their results read from ``tmp`` where
    phase mesh's ranks ran this phase's part (``train``), else spawned
    here.  Every run is held to the unsharded step from the same state
    and batch."""
    import torch.distributed as dist
    from torch.multiprocessing import ProcessExitedException

    from repro_torch import bridge
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist import backend
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import step

    model = main_path["model"]
    cfg = main_path["cfg"].replace(remat="block")
    batches = mesh_train_batches(cfg)
    grads_on = {n: p.requires_grad for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    ref = mesh_train_unsharded(torch, model, cfg, batches)
    res = {"phase": "mesh_train", "model": cfg.name, "layers": cfg.n_layers,
           "batch": len(batches[0]["tokens"]),
           "seq": batches[0]["tokens"].shape[1], "remat": cfg.remat,
           "steps": MESH_TRAIN_STEPS, "unsharded": ref,
           "unsharded_s": time.perf_counter() - t0, "meshes": {}}
    t0 = time.perf_counter()
    backend.init(0, 1, "cuda", backend.free_port())
    try:
        one = mesh_train(torch, mesh_mod.make_debug_mesh(1, 1), 0, model,
                         cfg, batches, tmp, {})
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    res["meshes"]["1x1"] = mesh_train_gate(torch, (1, 1), [one], ref, cfg,
                                           time.perf_counter() - t0)
    for shape in MESH_WORLDS[1:]:
        world = shape[0] * shape[1]
        t0 = time.perf_counter()
        if not os.path.exists(train_file(tmp, shape, 0)):
            try:
                backend.spawn(mesh_train_rank, world, "cuda", shape, tmp)
            except ProcessExitedException as e:
                fail(f"phase mesh_train {shape}: a rank failed: {e}")
        ranks = [torch.load(train_file(tmp, shape, r), weights_only=False)
                 for r in range(world)]
        res["meshes"][f"{shape[0]}x{shape[1]}"] = mesh_train_gate(
            torch, shape, ranks, ref, cfg, time.perf_counter() - t0)

    # the (1, 2) checkpoint restored off the mesh: its next step's loss
    t0 = time.perf_counter()
    tcfg, api, mask, opt, state = mesh_train_state(model, cfg)
    start = {n: p.detach().clone() for n, p in model.named_parameters()
             if mask[n]}
    tree, extra = CheckpointManager(os.path.join(tmp, "mesh_ckpt")).restore(
        bridge.state_to_tree(state))
    if tree is None or extra["step"] != MESH_TRAIN_STEPS:
        fail("mesh_train: no checkpoint of the (1, 2) run to restore")
    state = bridge.load_state(state, tree)
    del tree
    _, m = step.build_train_step(api, cfg, tcfg, mask, opt)(
        state, batches[MESH_TRAIN_STEPS])
    off = float(m["loss"])
    mesh = res["meshes"]["1x2"]["after_checkpoint"]["loss"]
    if abs(off - mesh) > MESH_TRAIN_LOSS_RTOL * abs(mesh):
        fail(f"mesh_train: the (1, 2) checkpoint restored off the mesh "
             f"gives step {MESH_TRAIN_STEPS + 1} loss {off!r}, the mesh "
             f"{mesh!r}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in start:
                p.copy_(start[n])
            p.requires_grad_(grads_on[n])
    res["checkpoint"] = {"restored_off_mesh_loss": off, "mesh_loss": mesh,
                         "unsharded_loss": ref["dense"][-1]["loss"],
                         "s": time.perf_counter() - t0}
    emit(res)
    return res


def mesh_train_gate(torch, shape, ranks, ref, cfg, wall) -> dict:
    """Phase mesh_train's gates on one mesh's rank results; its row."""
    label = f"mesh_train {shape}"
    r0 = ranks[0]
    expect = "nccl" if shape == (1, 1) else "gloo"
    placed = {(r["summary"]["backend"], r["summary"]["device"])
              for r in ranks}
    if placed != {(expect, "cuda:0")}:
        fail(f"{label}: ranks ran over (backend, device) {placed}, "
             f"expected {expect} on cuda:0")
    n = cfg.n_layers
    want_launch = {"quant_matmul": 14 * n}        # forward + recompute
    held = MESH_TRAIN_STEPS if shape == (1, 1) else 1

    def close(what, got, want):
        for k, rtol in (("loss", MESH_TRAIN_LOSS_RTOL),
                        ("grad_norm", MESH_TRAIN_GNORM_RTOL)):
            if not math.isfinite(got[k]) or \
                    abs(got[k] - want[k]) > rtol * abs(want[k]):
                fail(f"{label}: {what} {k} {got[k]!r} against the "
                     f"unsharded {want[k]!r} (rtol {rtol})")
    for r in ranks:
        if r["hist"] != r0["hist"]:
            fail(f"{label}: rank {r['rank']}'s metrics differ from rank 0's")
        for i, (got, want) in enumerate(zip(r["hist"][:held],
                                            ref["dense"])):
            close(f"step {i + 1}", got, want)
        if any(got != want_launch for got in r["launches"]):
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, "
                 f"expected {want_launch} a step")
        if r["kinds"] != ["all_reduce"] or r["vocab_gathers"]:
            fail(f"{label}: collectives {r['kinds']}, {r['vocab_gathers']} "
                 f"vocab-extent gathers (want all-reduces only, none)")
        for c in r["collectives"]:
            got = {axis: s["count"] for axis, s in c.items()}
            if got != r["want"]:
                fail(f"{label}: rank {r['rank']} issued {got} all-reduces a "
                     f"step, the formula {r['want']}")
        if not r["codes_frozen"]:
            fail(f"{label}: rank {r['rank']}'s frozen codes changed")
    checked = r0["checked"]
    if checked["quant_matmul"] < 13 * n:
        fail(f"{label}: {checked['quant_matmul']} K2 calls of step 1 held "
             f"to plain, expected at least {13 * n}")
    row = {"world": len(ranks), "backend": expect, "wall_s": wall,
           "rows_a_rank": r0["rows"], "hist": r0["hist"],
           "unsharded": ref["dense"][:MESH_TRAIN_STEPS],
           "unsharded_step_ms": ref["step_ms"],
           "unsharded_peak_gb": ref["peak_gb"],
           "step_ms": [r["step_ms"] for r in ranks],
           "peak_gb": [r["peak_gb"] for r in ranks],
           "local_gb": [r["local_gb"] for r in ranks],
           "launches_a_step": r0["launches"][-1],
           "collectives_a_step": r0["collectives"][-1],
           "formula": r0["want"], "vocab_gathers": r0["vocab_gathers"],
           "step1_checked": checked,
           "stages_s": [r["stages"] for r in ranks]}
    if shape == (1, 2):
        for name in ("chunked", "int8"):
            for r in ranks:
                close(f"the {name} step", r[name]["step"], ref[name][0])
            row[name] = {k: r0[name][k] for k in ("step", "launches",
                                                  "checked")}
            row[name]["unsharded"] = ref[name][0]
        chunked = r0["chunked"]["checked"]
        if chunked["flash_attention"] != 2 * n or \
                r0["chunked"]["launches"].get("flash_attention") != 2 * n:
            fail(f"{label}: the chunked step checked "
                 f"{chunked['flash_attention']} and launched "
                 f"{r0['chunked']['launches']} K4 calls, expected {2 * n}")
        row["after_checkpoint"] = r0["after_checkpoint"]
    emit({"phase": "mesh_train_row", "mesh": f"{shape[0]}x{shape[1]}",
          **{k: row[k] for k in ("backend", "step_ms", "peak_gb",
                                 "collectives_a_step", "formula")}})
    return row


# ---------------------------------------------------------------------------
# Phase mesh_moe: MoE expert parallelism on (data, model) meshes
# ---------------------------------------------------------------------------

# arch → (its meshes, its layers), at full width: deepseek-moe-16b at 14
# of its 28 layers (the script's time limit, as phase moe's), mixtral-8x7b
# at 4 of its 32 (whole it is 24 GB a copy, and the parent's model, its
# (1, 1) shard and the ranks' would put three on the card)
MESH_MOE = {"deepseek-moe-16b": (((1, 1), (1, 2), (2, 2)), 14),
            "mixtral-8x7b": (((1, 1), (1, 2)), 4)}
MESH_MOE_STEPS = 2
# the mesh whose deepseek-moe-16b ranks also serve the shard repacked into
# 4 bit-planes (K1-plane × E and K2-plane × E at z = 32)
MESH_MOE_PLANES = (1, 2)
# the new tokens of that plane shard's generate (its kernels' shapes are
# those of the first steps; its tokens are held only across ranks)
MESH_MOE_PLANE_NEW = 8
# what each mesh runs besides generate and the steps: deepseek's drain
# serving of phase moe's requests (a task swap among them)
MESH_MOE_SERVE = ("deepseek-moe-16b",)


def mesh_moe_cfg(name: str):
    """``name`` as phase mesh_moe runs it: PEQA 4-bit nibbles (n_grid 20),
    remat "block", at its MESH_MOE depth."""
    return dense_cfg(name, remat="block", n_layers=MESH_MOE[name][1])


def mesh_moe_batches(cfg) -> list:
    """MESH_MOE_STEPS global batches of BATCH × PROMPT rows of a synthetic
    corpus."""
    from repro_torch.data import pipeline, synthetic
    data = pipeline.PackedLM(synthetic.corpus(
        cfg.vocab_size, 4 * MESH_MOE_STEPS * BATCH * PROMPT + 4096,
        seed=SEED + 40), BATCH, PROMPT, seed=SEED)
    return [data.batch_at(i) for i in range(MESH_MOE_STEPS)]


def all_routing(torch, forced=None):
    """A context that keeps every ``moe.route`` call's ``gate_idx`` in the
    list it yields (one a MoE layer of a forward, on the host); with
    ``forced`` (such a list) call i takes forced[i]'s experts instead of
    its own top k — its gate values its own float32 probabilities at them,
    renormalized as ``route`` does —, so two runs share one routing."""
    from repro_torch.models import moe

    @contextlib.contextmanager
    def scope():
        got, orig = [], moe.route

        def route(xt, w, k):
            idx, vals, probs = orig(xt, w, k)
            if forced is not None:
                idx = forced[len(got)].to(idx.device)
                vals = probs.gather(1, idx)
                vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
            got.append(idx.detach().cpu())
            return idx, vals, probs
        moe.route = route
        try:
            yield got
        finally:
            moe.route = orig
    return scope()


def routing_flips(got, want) -> list:
    """Each layer's router assignments that differ between two runs'
    ``all_routing`` records."""
    return [int((a != b).sum()) for a, b in zip(got, want)]


def plane_shard(torch, local, cfg):
    """A rank's nibble shard with its codes repacked into 4 bit-planes by
    the port's own ``unpack_codes`` / ``pack_codes_planes`` (an expert
    stack's planes per expert, (E, bits, N, K/32)): the same codes, no
    second quantization.  Returns (the plane config, its API, the
    shard)."""
    import copy
    import dataclasses
    from repro_torch.core.quant import pack_codes_planes, unpack_codes
    from repro_torch.models import registry
    from repro_torch.models.linear import Linear
    cfg_p = cfg.replace(quant=dataclasses.replace(cfg.quant, layout="plane"))
    spec = cfg_p.quant.spec()
    out = copy.deepcopy(local)
    with torch.no_grad():
        for mod in out.modules():
            if isinstance(mod, Linear) and mod.quantized:
                planes = pack_codes_planes(unpack_codes(mod.qw), spec.bits)
                if mod.n_experts is not None:
                    planes = planes.transpose(0, 1).contiguous()
                mod.set_quantized(planes, mod.scale.detach(),
                                  mod.zero.detach(), spec)
    return cfg_p, registry.build(cfg_p), out


def codes_sum(torch, model) -> int:
    """A checksum of the model's frozen codes (their int64 sum)."""
    return int(sum(b.to(torch.int64).sum() for n, b in
                   model.named_buffers() if n.endswith(".qw")))


def mesh_moe_run(torch, ctx, rank: int, whole, cfg, prompt, batches,
                 routes, check: bool, planes: bool, serve: bool) -> dict:
    """One rank's part of phase mesh_moe for one MoE model on ``ctx``: its
    shard cut from ``whole`` (on the host for a spawned rank) and moved to
    its card; ``generate`` under logitshard (its launches counted) and
    without; with ``planes`` the same shard on 4 bit-planes; with
    ``serve`` the drain serving of phase moe's requests (a task swap
    among them); then
    MESH_MOE_STEPS PEQA steps from the shard of the model's own scales
    (step 1's collectives and layer 0's routing recorded).  ``check``:
    every new call shape held to plain (``CheckedQuantMatmul``, rank 0).
    ``routes``: the unsharded prefill's routing of each data block's rows
    (``all_routing``), which a second prefill here is forced to take."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.core import policies
    from repro_torch.core.scale_bank import swap_collectives
    from repro_torch.dist import backend, context, sharding
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.serve import ServeConfig
    from repro_torch.train import step
    from repro_torch.train.serve import Engine
    from repro_torch.train.state import make_state

    shape = (ctx.data_size, ctx.model_size)
    label = f"mesh_moe {cfg.name} {shape} rank {rank}"
    dev = ctx.device
    stages, t_stage = {}, [time.perf_counter()]

    def stage(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t_stage[0]
        t_stage[0] = now

    def checked(what):
        return CheckedQuantMatmul(ops, f"{label} {what}", shapes=True) \
            if check else contextlib.nullcontext()

    def counted(fn):
        torch.cuda.synchronize()
        for k in ops.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0, {
            k.__name__: k.launches for k in ops.KERNELS if k.launches}

    api = registry.build(cfg)
    bank = task_bank(whole, MOE_TASKS, SEED + 20)
    local = sharding.shard_model(whole, cfg, ctx).to(dev)
    del whole
    torch.cuda.empty_cache()
    stage("cut")
    out = {"rank": rank, "coords": (ctx.data_rank, ctx.model_rank),
           "summary": backend.summary(), "stages": stages,
           "local_gb": sum(t.numel() * t.element_size() for t in (
               *local.parameters(), *local.buffers())) / 1e9}
    codes0 = codes_sum(torch, local)
    shapes = []
    engine = Engine(api, local, bank=bank, ctx=ctx, logitshard=True)
    with checked("generate") as chk:
        engine.generate(prompt, 2)                 # warm-up, not counted
    if chk is not None:
        shapes += list(chk.rows.values())
    torch.cuda.reset_peak_memory_stats(dev)
    toks, gen_s, launches = counted(lambda: engine.generate(prompt, NEW))
    out["generate_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    with all_routing(torch) as free:
        t0 = time.perf_counter()
        logits = engine.prefill_logits(prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    mine = routes[ctx.data_size][ctx.data_rank] \
        if ctx.batch_axes(BATCH) else routes[1][0]
    with all_routing(torch, forced=mine):
        forced = engine.prefill_logits(prompt)
    base = Engine(api, local, bank=bank, ctx=ctx, logitshard=False)
    toks_base = base.generate(prompt, NEW)
    if not torch.equal(toks, toks_base):
        fail(f"{label}: generate's tokens differ with and without "
             f"logitshard")
    cache = PROMPT + NEW
    rec_ls = engine.decode_collectives(BATCH, cache)
    rec_base = base.decode_collectives(BATCH, cache)
    out.update(tokens=toks.cpu(), launches=launches,
               logits=logits.float().cpu() if rank == 0 else None,
               forced_logits=forced.float().cpu() if rank == 0 else None,
               prefill_flips=routing_flips(free, mine),
               generate_s=gen_s, prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=(gen_s - prefill_s) * 1e3 / (NEW - 1),
               decode_collectives=context.collective_stats(rec_ls),
               decode_collectives_no_logitshard=context.collective_stats(
                   rec_base),
               vocab_gathers=context.allgather_extent_count(
                   rec_ls, cfg.vocab_size),
               vocab_gathers_no_logitshard=context.allgather_extent_count(
                   rec_base, cfg.vocab_size))
    del base
    stage("generate")
    if planes:
        cfg_p, api_p, local_p = plane_shard(torch, local, cfg)
        p_engine = Engine(api_p, local_p, ctx=ctx, logitshard=True)
        with checked("planes") as chk:
            p_engine.generate(prompt, 2)
        if chk is not None:
            shapes += list(chk.rows.values())
        p_toks, p_s, p_launches = counted(
            lambda: p_engine.generate(prompt, MESH_MOE_PLANE_NEW))
        with all_routing(torch, forced=mine):          # every rank: gathers
            p_logits = p_engine.prefill_logits(prompt)
        out["planes"] = {
            "tokens": p_toks.cpu(), "launches": p_launches,
            "generate_s": p_s,
            "logits": p_logits.float().cpu() if rank == 0 else None}
        del p_engine, local_p
        torch.cuda.empty_cache()
        stage("planes")
    swap = swap_collectives(local, bank.tasks["t1"], ctx)
    bank.switch(local, "t0", ctx=ctx)
    out.update(swap_collectives=len(swap),
               swap_local_bytes=bank.local_nbytes("t1", ctx),
               swap_bytes=bank.nbytes("t1"))
    if serve:
        reqs = moe_requests(cfg, SEED + 21)
        with checked("serve") as chk:
            t0 = time.perf_counter()
            rep = engine.serve(reqs, ServeConfig(n_slots=MOE_SLOTS,
                                                 scheduler="drain"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if chk is not None:
            shapes += list(chk.rows.values())
        if any(t is None or len(t) != r.n_new
               for r, t in zip(reqs, rep.tokens)):
            fail(f"{label}: a request was not served its budget")
        out["serve"] = {"requests": len(reqs), "wall_s": wall,
                        "steps": rep.steps, "decoded": rep.decoded,
                        "switches": rep.switches, "tokens": rep.tokens}
        engine.switch_task("t0")            # the model's own scales back
        stage("serve")
    del engine

    # training: the shard of a fresh PEQA state over the model's own scales
    tcfg = TrainConfig(optim=OptimConfig())
    mask = policies.make_mask(local, cfg)
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(local, opt.init(dict(local.named_parameters()), mask))
    ts = step.build_train_step(api, cfg, tcfg, mask, opt, mesh=ctx)
    out["want"] = step.mesh_collectives(local, cfg, mask)
    hist, ms, records, train_launches = [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for i, b in enumerate(batches):
        for k in ops.KERNELS:
            k.launches = 0
        with (checked("step 1") if i == 0 else contextlib.nullcontext()
              ) as chk, ctx.recording() as rec, \
                (all_routing(torch) if i == 0
                 else contextlib.nullcontext()) as routing:
            t0 = time.perf_counter()
            state, m = ts(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if chk is not None:
            shapes += list(chk.rows.values())
        if i == 0:                          # layer 0's, in the forward
            out["gate_idx"] = routing[0]
        hist.append({k: float(v) for k, v in m.items()})
        records.append(rec)
        train_launches.append({k.__name__: k.launches for k in ops.KERNELS
                               if k.launches})
    # each call shape once, as the first part that met it checked it
    dims = ("kernel", "E", "C", "M", "N", "K", "G", "planes", "B", "Sq",
            "Sk", "Hq", "Hkv")
    seen = {}
    for sh in shapes:
        seen.setdefault(tuple(sh.get(k) for k in dims), sh)
    shapes = list(seen.values())
    out.update(hist=hist, step_ms=ms,
               train_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               collectives=[collectives_by_axis(r) for r in records],
               kinds=sorted({e["kind"] for r in records for e in r}),
               train_vocab_gathers=sum(context.allgather_extent_count(
                   r, cfg.vocab_size) for r in records),
               train_launches=train_launches,
               codes_frozen=codes_sum(torch, local) == codes0,
               shapes=shapes)
    stage("train")
    del state, local
    torch.cuda.empty_cache()
    return out


def mesh_moe_rank(rank: int, shape: tuple, tmp: str, prompt, shared) -> None:
    """One spawned rank of phase mesh_moe: for each model of ``shared``
    ({name: (the parent's whole state dict, its unsharded routing)}) the
    whole model around the parent's own tensors — on the card, passed by
    ``torch.multiprocessing`` as CUDA IPC handles: nothing is copied but
    the rank's shard —, then ``mesh_moe_run``; the results go to ``tmp``.
    A failed gate exits non-zero."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import mesh as mesh_mod
    ctx = mesh_mod.make_debug_mesh(*shape)       # on the rank's own card
    for name, (state, routes) in shared.items():
        t0 = time.perf_counter()
        cfg = mesh_moe_cfg(name)
        whole = model_from_state(torch, cfg, state)
        load_s = time.perf_counter() - t0
        out = mesh_moe_run(
            torch, ctx, rank, whole, cfg, prompt, mesh_moe_batches(cfg),
            routes, check=rank == 0,
            planes=shape == MESH_MOE_PLANES and name in MESH_MOE_SERVE,
            serve=name in MESH_MOE_SERVE)
        out["stages"]["load"] = load_s
        del whole, state
        torch.save(out, rank_file(tmp, shape, rank, f"{name}_"))
        del out
        torch.cuda.empty_cache()
    # the last references to the parent's tensors: their IPC blocks return
    # to it now, not when this process exits
    shared.clear()


def mesh_moe_routes(torch, api, model, prompt) -> list:
    """The unsharded prefill's routing (``all_routing``) of each data
    block's rows, by the data axis' size: {1: [the whole batch's], 2:
    [the first half's, the second half's]} — what a mesh rank's prefill
    is forced to take."""
    from repro_torch.train.serve import Engine
    eng, half = Engine(api, model), BATCH // 2
    out = []
    for rows in (slice(0, BATCH), slice(0, half), slice(half, BATCH)):
        with all_routing(torch) as got:
            eng.prefill_logits(prompt[rows])
        out.append(got)
    return {1: out[:1], 2: out[1:]}


def mesh_moe_unsharded(torch, api, model, cfg, prompt, batches) -> dict:
    """The unsharded runs each mesh is held to, on the whole ``model``
    (its scales trained by the last part): ``generate``'s tokens, launches
    and time, the prefill logits — whole and of each data block's rows —,
    then MESH_MOE_STEPS PEQA steps (metrics, ms, peak, layer 0's routing
    at step 1) after step 1's loss and gradient norm over the two data
    blocks of the first batch (the mean of their losses, the norm of
    their mean gradient)."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.core import policies
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import step
    from repro_torch.train.serve import Engine
    from repro_torch.train.state import make_state
    out = {}
    eng = Engine(api, model)
    eng.generate(prompt, 2)
    torch.cuda.synchronize()
    for k in ops.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = eng.generate(prompt, NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    out["launches"] = {k.__name__: k.launches for k in ops.KERNELS
                       if k.launches}
    out["generate_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    out["logits"] = eng.prefill_logits(prompt).float().cpu()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    half = BATCH // 2
    out["logits_blocks"] = torch.cat([
        eng.prefill_logits(prompt[:half]).float().cpu(),
        eng.prefill_logits(prompt[half:]).float().cpu()])
    out.update(tokens=toks.cpu(), generate_s=gen_s,
               prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=(gen_s - prefill_s) * 1e3 / (NEW - 1))
    del eng
    mask = policies.make_mask(model, cfg)
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    losses = []
    for rows in (slice(0, half), slice(half, BATCH)):
        loss = api.loss_fn(model, step.to_device(
            {k: v[rows] for k, v in batches[0].items()}, api.device))
        (loss / 2).backward()
        losses.append(float(loss.detach()))
    out["blocks_step1"] = {"loss": sum(losses) / 2, "grad_norm": math.sqrt(
        sum(float((p.grad.float() ** 2).sum()) for n, p in params.items()
            if mask[n] and p.grad is not None))}
    for p in params.values():
        p.grad = None
    tcfg = TrainConfig(optim=OptimConfig())
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(model, opt.init(params, mask))
    ts = step.build_train_step(api, cfg, tcfg, mask, opt)
    hist, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches):
        with (all_routing(torch) if i == 0
              else contextlib.nullcontext()) as routing:
            t0 = time.perf_counter()
            state, m = ts(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["gate_idx"] = routing[0]
        hist.append({k: float(v) for k, v in m.items()})
    out.update(hist=hist, step_ms=ms,
               train_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def mesh_moe_gate(torch, name, cfg, shape, ranks, ref, wall) -> dict:
    """Phase mesh_moe's gates on one model's rank results on one mesh;
    returns its row."""
    label = f"mesh_moe {name} {shape}"
    r0 = ranks[0]
    expect = "nccl" if shape == (1, 1) else "gloo"
    placed = {(r["summary"]["backend"], r["summary"]["device"])
              for r in ranks}
    if placed != {(expect, "cuda:0")}:
        fail(f"{label}: ranks ran over (backend, device) {placed}, "
             f"expected {expect} on cuda:0")
    for r in ranks:
        if not torch.equal(r["tokens"], r0["tokens"]):
            fail(f"{label}: rank {r['rank']}'s tokens differ from rank 0's")
        if r["launches"] != ref["launches"]:
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, the "
                 f"unsharded generate {ref['launches']}")
        if r["swap_collectives"]:
            fail(f"{label}: a task swap made a collective")
        if r["vocab_gathers"] != 0 or r["vocab_gathers_no_logitshard"] < 1:
            fail(f"{label}: vocab-extent gathers {r['vocab_gathers']} under "
                 f"logitshard (want 0), {r['vocab_gathers_no_logitshard']} "
                 f"without (want >= 1)")
        if r["hist"] != r0["hist"]:
            fail(f"{label}: rank {r['rank']}'s metrics differ from rank 0's")
        if r["kinds"] != ["all_reduce"] or r["train_vocab_gathers"]:
            fail(f"{label}: a step's collectives {r['kinds']}, "
                 f"{r['train_vocab_gathers']} vocab-extent gathers (want "
                 f"all-reduces only, none)")
        for c in r["collectives"]:
            got = {axis: s["count"] for axis, s in c.items()}
            if got != r["want"]:
                fail(f"{label}: rank {r['rank']} issued {got} all-reduces a "
                     f"step, the formula {r['want']}")
        if not r["codes_frozen"]:
            fail(f"{label}: rank {r['rank']}'s frozen codes changed")
        if "serve" in r and r["serve"]["tokens"] != r0["serve"]["tokens"]:
            fail(f"{label}: rank {r['rank']} served other tokens")
        twin = next(q for q in ranks if q["coords"] == (r["coords"][0], 0))
        if not torch.equal(r["gate_idx"], twin["gate_idx"]):
            fail(f"{label}: layer 0's routing at step 1 differs between "
                 f"model ranks")
    logits, forced = r0["logits"], r0["forced_logits"]
    want = ref["logits"] if shape[0] == 1 else ref["logits_blocks"]
    if not (torch.isfinite(logits).all() and torch.isfinite(forced).all()):
        fail(f"{label}: non-finite prefill logits")
    diff = (logits - want).abs().max().item()
    forced_diff = (forced - want).abs().max().item()
    scale = want.abs().max().item()
    if shape == (1, 1):
        if diff != 0.0 or forced_diff != 0.0 or \
                not torch.equal(r0["tokens"], ref["tokens"]) or \
                any(r0["prefill_flips"]):
            fail(f"{label}: the mesh path is not bit-equal to the unsharded "
                 f"engine (logits differ by {diff:.3e})")
    elif forced_diff > MESH_LOGIT_TOL * scale:
        # free routing is held by the flips it reports: a bf16 hidden
        # state a last bit off may take another expert from a near tie
        fail(f"{label}: prefill logits under the unsharded run's routing "
             f"differ from the unsharded engine's by {forced_diff:.3e} > "
             f"{MESH_LOGIT_TOL * scale:.3e}")
    step1 = ref["hist"][0] if shape[0] == 1 else ref["blocks_step1"]
    for k, rtol in (("loss", MESH_TRAIN_LOSS_RTOL),
                    ("grad_norm", MESH_TRAIN_GNORM_RTOL)):
        got = r0["hist"][0][k]
        if not math.isfinite(got) or abs(got - step1[k]) > rtol * abs(
                step1[k]):
            fail(f"{label}: step 1 {k} {got!r} against the unsharded "
                 f"{step1[k]!r} (rtol {rtol})")
    row = {"world": len(ranks), "backend": expect, "wall_s": wall,
           "logits_max_abs_diff": diff, "logits_max_abs": scale,
           "forced_routing_logits_max_abs_diff": forced_diff,
           "prefill_routing_flips": r0["prefill_flips"],
           "prefill_assignments_a_layer": int(r0["gate_idx"].numel()),
           "tokens_equal_share_vs_unsharded": (
               r0["tokens"][:, PROMPT:] == ref["tokens"][:, PROMPT:]
           ).float().mean().item(),
           "launches_a_rank": r0["launches"],
           "decode_ms_per_step": [r["decode_ms_per_step"] for r in ranks],
           "unsharded_decode_ms_per_step": ref["decode_ms_per_step"],
           "prefill_ms": [r["prefill_ms"] for r in ranks],
           "unsharded_prefill_ms": ref["prefill_ms"],
           "generate_peak_gb": [r["generate_peak_gb"] for r in ranks],
           "unsharded_generate_peak_gb": ref["generate_peak_gb"],
           "local_gb": [r["local_gb"] for r in ranks],
           "decode_collectives": r0["decode_collectives"],
           "vocab_gathers_no_logitshard": r0["vocab_gathers_no_logitshard"],
           "swap_collectives": r0["swap_collectives"],
           "swap_local_bytes": r0["swap_local_bytes"],
           "swap_bytes": r0["swap_bytes"],
           "hist": r0["hist"], "unsharded_hist": ref["hist"],
           "step1_reference": step1,
           "step_ms": [r["step_ms"] for r in ranks],
           "unsharded_step_ms": ref["step_ms"],
           "train_peak_gb": [r["train_peak_gb"] for r in ranks],
           "unsharded_train_peak_gb": ref["train_peak_gb"],
           "train_launches_a_step": r0["train_launches"][-1],
           "collectives_a_step": r0["collectives"][-1],
           "formula": r0["want"],
           "stages_s": [r["stages"] for r in ranks]}
    if shape[0] == 1:
        row["routing_differs_vs_unsharded"] = int(
            (r0["gate_idx"] != ref["gate_idx"]).sum())
    if "serve" in r0:
        row["serve"] = {k: v for k, v in r0["serve"].items()
                        if k != "tokens"}
        if row["serve"]["switches"] < 1:
            fail(f"{label}: drain serving made no task swap")
    if "planes" in r0:
        p = r0["planes"]
        # the nibble run's launches in plane form: the prefill's as they
        # are, the decode kernels' (K1, K1 × E, K4) for fewer steps
        decode = ("quant_gemv", "quant_gemv_experts", "flash_attention")
        pl = {kname(k, k != "flash_attention"):
              v * (MESH_MOE_PLANE_NEW - 1) // (NEW - 1) if k in decode
              else v for k, v in r0["launches"].items()}
        for r in ranks:
            if r["planes"]["launches"] != pl:
                fail(f"{label}: the plane shard launched "
                     f"{r['planes']['launches']}, expected {pl}")
            if not torch.equal(r["planes"]["tokens"], p["tokens"]):
                fail(f"{label}: rank {r['rank']}'s plane tokens differ")
        pdiff = (p["logits"] - want).abs().max().item()
        if not torch.isfinite(p["logits"]).all() or \
                pdiff > MESH_LOGIT_TOL * scale:
            fail(f"{label}: the plane shard's prefill logits under the "
                 f"unsharded run's routing differ from the unsharded "
                 f"nibble engine's by {pdiff:.3e}")
        row["planes"] = {"launches": p["launches"],
                         "generate_s": p["generate_s"],
                         "logits_max_abs_diff": pdiff,
                         "tokens_equal_share_vs_nibble": (
                             p["tokens"] == r0["tokens"][:, :p["tokens"]
                                                         .shape[1]])
                         .float().mean().item()}
    if r0["shapes"]:
        row["shapes"] = r0["shapes"]
        kinds = {s["kernel"] for s in r0["shapes"]}
        need = {"quant_gemv", "quant_matmul", "quant_gemv_experts",
                "quant_matmul_experts"}
        if "planes" in r0:
            need |= {kname(k, True) for k in need}
        if not need <= kinds:
            fail(f"{label}: shard shapes checked for {sorted(kinds)}, "
                 f"expected at least {sorted(need)}")
    emit({"phase": "mesh_moe_row", "model": name,
          "mesh": f"{shape[0]}x{shape[1]}",
          **{k: row[k] for k in ("backend", "logits_max_abs_diff",
                                 "forced_routing_logits_max_abs_diff",
                                 "prefill_routing_flips",
                                 "decode_ms_per_step",
                                 "unsharded_decode_ms_per_step", "step_ms",
                                 "unsharded_step_ms", "train_peak_gb",
                                 "unsharded_train_peak_gb",
                                 "collectives_a_step", "formula")},
          **({"routing_differs_vs_unsharded":
              row["routing_differs_vs_unsharded"]} if shape[0] == 1
             else {})})
    return row


def phase_mesh_moe(torch) -> dict:
    """MoE expert parallelism on (data, model) meshes (module docstring,
    phase mesh_moe): each MESH_MOE model built once at full width, then
    served and PEQA-trained by every rank of each of its meshes from its
    shard — (1, 1) over NCCL in this process, the others spawned on cuda:0
    under gloo at the same time (``spawn_meshes``), reading this process'
    whole model over CUDA IPC and copying only their shard —, and held to
    the unsharded runs on the same model (made last: the steps train
    it)."""
    import torch.distributed as dist

    from repro_torch.dist import backend
    from repro_torch.launch import mesh as mesh_mod

    gen = torch.Generator().manual_seed(SEED + 41)
    res = {"phase": "mesh_moe", "batch": BATCH, "prompt": PROMPT,
           "new_tokens": NEW, "steps": MESH_MOE_STEPS,
           "logit_tolerance_share": MESH_LOGIT_TOL, "models": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_moe_")
    built, ranks = {}, {}
    try:
        # one prompt for both models: tokens of the smaller vocabulary
        prompt = torch.randint(0, min(mesh_moe_cfg(n).vocab_size
                                      for n in MESH_MOE), (BATCH, PROMPT),
                               generator=gen)
        for name in MESH_MOE:
            t0 = time.perf_counter()
            cfg, api, model, _, figs = dense_build(
                torch, name, remat="block", n_layers=MESH_MOE[name][1])
            built[name] = {"cfg": cfg, "api": api, "model": model,
                           "figs": figs,
                           "routes": mesh_moe_routes(torch, api, model,
                                                     prompt),
                           "build_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        backend.init(0, 1, "cuda", backend.free_port())
        try:
            ctx = mesh_mod.make_debug_mesh(1, 1)
            for name, b in built.items():
                ranks[(name, (1, 1))] = ([mesh_moe_run(
                    torch, ctx, 0, b["model"], b["cfg"], prompt,
                    mesh_moe_batches(b["cfg"]), b["routes"], check=False,
                    planes=False,
                    serve=name in MESH_MOE_SERVE)],
                    time.perf_counter() - t0)
                t0 = time.perf_counter()
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        shapes = sorted({s for meshes, _ in MESH_MOE.values()
                         for s in meshes} - {(1, 1)})
        names = {shape: [n for n, (meshes, _) in MESH_MOE.items()
                         if shape in meshes] for shape in shapes}
        # the ranks read the parent's whole models over CUDA IPC
        walls = spawn_meshes(mesh_moe_rank, [(shape, (tmp, prompt, {
            n: (built[n]["model"].state_dict(), built[n]["routes"])
            for n in names[shape]})) for shape in shapes])
        torch.cuda.ipc_collect()
        for shape in shapes:
            for name in names[shape]:
                ranks[(name, shape)] = ([torch.load(
                    rank_file(tmp, shape, r, f"{name}_"), weights_only=False)
                    for r in range(shape[0] * shape[1])], walls[shape])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, b in built.items():
        t0 = time.perf_counter()
        ref = mesh_moe_unsharded(torch, b["api"], b["model"], b["cfg"],
                                 prompt, mesh_moe_batches(b["cfg"]))
        row = {"layers": b["cfg"].n_layers, "experts": b["cfg"].moe.n_experts,
               "expert_sharding": b["cfg"].moe.expert_sharding,
               "model_gb": b["figs"]["model_gb"],
               "build_s": b["figs"]["build_s"],
               "build_and_routing_s": b["build_s"],
               "unsharded_s": time.perf_counter() - t0, "meshes": {}}
        for shape in MESH_MOE[name][0]:
            rs, wall = ranks[(name, shape)]
            row["meshes"][f"{shape[0]}x{shape[1]}"] = mesh_moe_gate(
                torch, name, b["cfg"], shape, rs, ref, wall)
        res["models"][name] = row
        del b["model"], ref
        torch.cuda.empty_cache()
    emit(res)
    return res


# ---------------------------------------------------------------------------
# Phase mesh_families: the vlm and encdec families and a KV head that model
# ranks share, on (data, model) meshes
# ---------------------------------------------------------------------------

# arch → its layers at full width (None: whole): whisper-medium whole (24 +
# 24), llava-next-mistral-7b at 4 of its 32 layers and granite-34b at 4 of
# its 88 (the script's time limit: phases vlm and dense_archs run them
# deeper off the mesh)
MESH_FAM = {"whisper-medium": None, "llava-next-mistral-7b": 4,
            "granite-34b": 4}
MESH_FAM_SHAPES = ((1, 1), (1, 2))
MESH_FAM_STEPS = 2
# the lockstep prompt's text tokens (behind each row's prefix) and new
# tokens; a training row's text tokens (behind its prefix)
MESH_FAM_PROMPT, MESH_FAM_NEW, MESH_FAM_SEQ = 64, 16, 128
# a training batch's rows (whisper's 1500 frames a row dominate the
# phase's time under gloo: 4 rows took 46 s of its 137 s at (1, 2))
MESH_FAM_TRAIN_ROWS = 2
# serving: MESH_FAM_REQUESTS prefixed requests over 2 tasks in 4 slots,
# prompts and budgets in turn, resident (whisper: drain, it has no slotted
# step)
MESH_FAM_REQUESTS, MESH_FAM_PROMPTS, MESH_FAM_BUDGETS = 4, (32, 64), (4, 8)
# phase mesh_recurrent, run by mesh_families' functions: arch → its layers
# at full width (None: whole): xlstm-125m whole, zamba2-7b at its DEPTH
MESH_REC = {"xlstm-125m": None, "zamba2-7b": DEPTH["zamba2-7b"]}
# the activation dtype a mesh model runs in where not the bf16 default:
# zamba2's random-weight Mamba2 stack amplifies a perturbation ≈ 1.4× a
# layer (PERF.md), so two bf16 runs that round their sums in another order
# (a (1, 2) shard's row-parallel and norm sums against the whole model's)
# part by O(1) in the logits at 15 layers; in float32 the mesh is held to
# the unsharded engine as every other model is
MESH_DTYPE = {"zamba2-7b": "float32"}
# decode steps timed for zamba2's gated-norm sums' share (each way)
MESH_REC_GNORM_STEPS = 8


def mesh_phase(cfg) -> str:
    """The phase that runs ``cfg`` on meshes: mesh_recurrent for the ssm
    and hybrid families, else mesh_families."""
    return "mesh_recurrent" if cfg.family in ("ssm", "hybrid") \
        else "mesh_families"


def mesh_fam_kw(name: str) -> dict:
    """The config changes of ``name`` in phase mesh_families
    (mesh_recurrent): remat "block", its MESH_FAM (MESH_REC) depth, its
    MESH_DTYPE."""
    layers = {**MESH_FAM, **MESH_REC}[name]
    return {"remat": "block", **({"n_layers": layers} if layers else {}),
            **({"dtype": MESH_DTYPE[name]} if name in MESH_DTYPE else {})}


def mesh_fam_cfg(name: str):
    """``name`` as phase mesh_families (mesh_recurrent) runs it: PEQA
    4-bit nibbles (n_grid 20) with ``mesh_fam_kw``'s changes."""
    return dense_cfg(name, **mesh_fam_kw(name))


def prefill_state(torch, api, model, prompt, ctx=None) -> dict:
    """The state after a prefill of ``prompt`` (a recurrent family's cache
    leaves, on the card), on a mesh under ``ctx``."""
    from repro_torch.dist import context
    with torch.inference_mode(), (context.use_mesh(ctx) if ctx is not None
                                  else contextlib.nullcontext()):
        return api.prefill(model, {"tokens": prompt.to("cuda")})[1]


def gnorm_share(torch, engine, batch: int, cache_len: int) -> dict:
    """zamba2's gated-norm sums (``context.sum_over_model``, one a Mamba2
    block) in a lockstep decode step of ``batch`` rows on a mesh:
    MESH_REC_GNORM_STEPS steps timed as they run (host clock, the device
    synchronised at both ends), then as many with every sum timed alone
    (the device synchronised before and after it); the sums' ms a step
    over the instrumented step's."""
    from repro_torch.dist import context
    api, ctx = engine.api, engine.ctx
    rows = ctx.local_rows(batch)
    n = rows.stop - rows.start
    cache = api.init_cache(n, cache_len)
    tok = torch.zeros((n, 1), dtype=torch.int64, device=ctx.device)
    real, spent = context.sum_over_model, []

    def timed_sum(t, c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, c)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    def steps(first: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MESH_REC_GNORM_STEPS):
            api.decode_step(engine.model, cache, tok, first + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / MESH_REC_GNORM_STEPS
    with torch.inference_mode(), context.use_mesh(ctx):
        api.decode_step(engine.model, cache, tok, 0)        # warm-up
        plain = steps(1)
        context.sum_over_model = timed_sum
        try:
            inst = steps(1 + MESH_REC_GNORM_STEPS)
        finally:
            context.sum_over_model = real
    a_step = sum(spent) / MESH_REC_GNORM_STEPS
    return {"decode_ms": plain * 1e3, "instrumented_decode_ms": inst * 1e3,
            "sums_a_step": len(spent) // MESH_REC_GNORM_STEPS,
            "sums_ms_a_step": a_step * 1e3, "share": a_step / inst}


def mesh_fam_batches(cfg) -> list:
    """MESH_FAM_STEPS global batches of MESH_FAM_TRAIN_ROWS ×
    MESH_FAM_SEQ text tokens of a synthetic corpus, each row behind its
    seeded prefix (image embeddings or frames: ``pipeline.Prefixed``)."""
    from repro_torch.data import pipeline, synthetic
    rows = MESH_FAM_TRAIN_ROWS
    data = pipeline.Prefixed(pipeline.PackedLM(synthetic.corpus(
        cfg.vocab_size, 4 * MESH_FAM_STEPS * rows * MESH_FAM_SEQ + 4096,
        seed=SEED + 50), rows, MESH_FAM_SEQ, seed=SEED), cfg, SEED + 51)
    return [data.batch_at(i) for i in range(MESH_FAM_STEPS)]


def mesh_fam_requests(cfg) -> list:
    """MESH_FAM_REQUESTS requests over 2 tasks, each behind its own seeded
    prefix where the family takes one, all at step 0."""
    import numpy as np
    from repro_torch.data import pipeline
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED + 52)
    out = []
    for i in range(MESH_FAM_REQUESTS):
        got = pipeline.family_prefix(cfg, 1, (SEED + 53, i))
        out.append(Request(
            tokens=rng.integers(0, cfg.vocab_size,
                                MESH_FAM_PROMPTS[i % len(MESH_FAM_PROMPTS)]),
            n_new=MESH_FAM_BUDGETS[i % len(MESH_FAM_BUDGETS)],
            task=f"t{i % 2}", prefix=None if got is None else got[1][0]))
    return out


def mesh_fam_inputs(torch, cfg, gen):
    """The lockstep prompt (BATCH × MESH_FAM_PROMPT) and its prefix on the
    card (seeded image embeddings or frames, ``pipeline.family_prefix``;
    None for granite)."""
    from repro_torch.data import pipeline
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, MESH_FAM_PROMPT),
                           generator=gen)
    got = pipeline.family_prefix(cfg, BATCH, SEED + 56)
    prefix = None if got is None else torch.from_numpy(got[1]).to("cuda")
    return prompt, prefix


def mesh_fam_run(torch, ctx, rank: int, whole, cfg, prompt, prefix,
                 check: bool) -> dict:
    """One rank's part of phase mesh_families for one model on ``ctx``:
    its shard cut from ``whole``; ``generate`` with the prefix under
    logitshard (launches counted) and without, the prefill logits, the
    decode step's collectives, a task swap's, the serving of
    ``mesh_fam_requests`` (resident, or drain for an encdec), then
    MESH_FAM_STEPS PEQA steps from the model's own scales.  ``check``:
    every new call shape held to plain (``CheckedQuantMatmul``, rank
    0)."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.core import policies
    from repro_torch.core.scale_bank import swap_collectives
    from repro_torch.dist import backend, context, sharding
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.serve import ServeConfig
    from repro_torch.train import step
    from repro_torch.train.serve import Engine
    from repro_torch.train.state import make_state

    shape = (ctx.data_size, ctx.model_size)
    label = f"{mesh_phase(cfg)} {cfg.name} {shape} rank {rank}"
    dev = ctx.device
    stages, t_stage = {}, [time.perf_counter()]

    def stage(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t_stage[0]
        t_stage[0] = now

    # one checker for the whole run: each new call shape is held to plain
    # once, however many stages reach it
    checker = CheckedQuantMatmul(ops, label, shapes=True) if check else None

    def checked(what):
        if checker is None:
            return contextlib.nullcontext()
        checker.label = f"{label} {what}"
        return checker

    api = registry.build(cfg)
    bank = task_bank(whole, 2, SEED + 54)
    local = sharding.shard_model(whole, cfg, ctx)
    del whole
    torch.cuda.empty_cache()
    stage("cut")
    out = {"rank": rank, "coords": (ctx.data_rank, ctx.model_rank),
           "summary": backend.summary(), "stages": stages,
           "kv_share": local.kv_share,
           "local_gb": sum(t.numel() * t.element_size() for t in (
               *local.parameters(), *local.buffers())) / 1e9}
    codes0 = codes_sum(torch, local)
    engine = Engine(api, local, bank=bank, ctx=ctx, logitshard=True)
    with checked("generate"):
        engine.generate(prompt, 2, prefix=prefix)      # warm-up, not counted
    torch.cuda.synchronize()
    for k in ops.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    toks = engine.generate(prompt, MESH_FAM_NEW, prefix=prefix)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    out["launches"] = {k.__name__: k.launches for k in ops.KERNELS
                       if k.launches}
    out["generate_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    logits = engine.prefill_logits(prompt, prefix=prefix)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if cfg.family in ("ssm", "hybrid") and ctx.world == 1:
        out["state"] = prefill_state(torch, engine.api, local, prompt, ctx)
    if cfg.family == "hybrid":
        out["gnorm"] = gnorm_share(torch, engine, BATCH,
                                   MESH_FAM_PROMPT + MESH_FAM_NEW)
    base = Engine(api, local, bank=bank, ctx=ctx, logitshard=False)
    if not torch.equal(toks, base.generate(prompt, MESH_FAM_NEW,
                                           prefix=prefix)):
        fail(f"{label}: generate's tokens differ with and without "
             f"logitshard")
    cache = MESH_FAM_PROMPT + MESH_FAM_NEW + (
        cfg.n_img_tokens if cfg.family == "vlm" else 0)
    rec_ls = engine.decode_collectives(BATCH, cache)
    rec_base = base.decode_collectives(BATCH, cache)
    del base
    out.update(tokens=toks.cpu(),
               logits=logits.float().cpu() if rank == 0 else None,
               generate_s=gen_s, prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=(gen_s - prefill_s) * 1e3
               / (MESH_FAM_NEW - 1),
               decode_collectives=context.collective_stats(rec_ls),
               vocab_gathers=context.allgather_extent_count(
                   rec_ls, cfg.vocab_size),
               vocab_gathers_no_logitshard=context.allgather_extent_count(
                   rec_base, cfg.vocab_size))
    swap = swap_collectives(local, bank.tasks["t1"], ctx)
    bank.switch(local, "t0", ctx=ctx)
    out.update(swap_collectives=len(swap),
               swap_local_bytes=bank.local_nbytes("t1", ctx, local.kv_share),
               swap_bytes=bank.nbytes("t1"))
    stage("generate")
    resident = api.decode_step_slotted is not None
    reqs = mesh_fam_requests(cfg)
    with checked("serve"):
        t0 = time.perf_counter()
        rep = engine.serve(reqs, ServeConfig(
            n_slots=4, scheduler="resident" if resident else "drain",
            resident_tasks=2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if any(t is None or len(t) != r.n_new
           for r, t in zip(reqs, rep.tokens)):
        fail(f"{label}: a request was not served its budget")
    out["serve"] = {"scheduler": rep.scheduler, "requests": len(reqs),
                    "wall_s": wall, "steps": rep.steps,
                    "decoded": rep.decoded, "switches": rep.switches,
                    "tokens": rep.tokens}
    engine.switch_task("t0")                 # the model's own scales back
    del engine
    stage("serve")

    tcfg = TrainConfig(optim=OptimConfig())
    mask = policies.make_mask(local, cfg)
    opt = make_optimizer(tcfg.optim, tcfg.steps)
    state = make_state(local, opt.init(dict(local.named_parameters()), mask))
    ts = step.build_train_step(api, cfg, tcfg, mask, opt, mesh=ctx)
    out["want"] = step.mesh_collectives(local, cfg, mask)
    hist, ms, records = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for i, b in enumerate(mesh_fam_batches(cfg)):
        with (checked("step 1") if i == 0 else contextlib.nullcontext()
              ), ctx.recording() as rec:
            t0 = time.perf_counter()
            state, m = ts(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        hist.append({k: float(v) for k, v in m.items()})
        records.append(rec)
    out.update(hist=hist, step_ms=ms,
               train_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               collectives=[collectives_by_axis(r) for r in records],
               kinds=sorted({e["kind"] for r in records for e in r}),
               train_vocab_gathers=sum(context.allgather_extent_count(
                   r, cfg.vocab_size) for r in records),
               codes_frozen=codes_sum(torch, local) == codes0,
               shapes=[] if checker is None else list(checker.rows.values()))
    stage("train")
    del state, local
    torch.cuda.empty_cache()
    return out


def mesh_fam_rank(rank: int, shape: tuple, tmp: str, shared) -> None:
    """One spawned rank of phase mesh_families: for each model of
    ``shared`` ({name: (the parent's whole state dict, the prompt, its
    prefix)}) the whole model around the parent's own tensors — CUDA IPC
    handles: nothing is copied but the rank's shard —, then
    ``mesh_fam_run``; the results go to ``tmp``.  A failed gate exits
    non-zero."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import mesh as mesh_mod
    ctx = mesh_mod.make_debug_mesh(*shape)       # on the rank's own card
    for name, (state, prompt, prefix) in shared.items():
        t0 = time.perf_counter()
        cfg = mesh_fam_cfg(name)
        whole = model_from_state(torch, cfg, state)
        load_s = time.perf_counter() - t0
        out = mesh_fam_run(torch, ctx, rank, whole, cfg, prompt, prefix,
                           check=rank == 0)
        out["stages"]["load"] = load_s
        del whole, state
        torch.save(out, rank_file(tmp, shape, rank, f"{name}_"))
        del out
        torch.cuda.empty_cache()
    shared.clear()


def mesh_fam_unsharded(torch, api, model, cfg, prompt, prefix,
                       train: bool) -> dict:
    """The unsharded runs each mesh is held to, on the whole ``model``:
    ``generate``'s tokens, launches and time and the prefill logits; with
    ``train`` (last: the steps train the model) MESH_FAM_STEPS PEQA
    steps (metrics, ms, peak)."""
    from repro_torch.configs.base import OptimConfig, TrainConfig
    from repro_torch.core import policies
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import make_optimizer
    from repro_torch.train import step
    from repro_torch.train.serve import Engine
    from repro_torch.train.state import make_state
    if train:
        tcfg = TrainConfig(optim=OptimConfig())
        mask = policies.make_mask(model, cfg)
        opt = make_optimizer(tcfg.optim, tcfg.steps)
        state = make_state(model, opt.init(dict(model.named_parameters()),
                                           mask))
        ts = step.build_train_step(api, cfg, tcfg, mask, opt)
        hist, ms = [], []
        torch.cuda.reset_peak_memory_stats()
        for b in mesh_fam_batches(cfg):
            t0 = time.perf_counter()
            state, m = ts(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append({k: float(v) for k, v in m.items()})
        return {"hist": hist, "step_ms": ms,
                "train_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    eng = Engine(api, model)
    eng.generate(prompt, 2, prefix=prefix)
    torch.cuda.synchronize()
    for k in ops.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = eng.generate(prompt, MESH_FAM_NEW, prefix=prefix)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    out = {"launches": {k.__name__: k.launches for k in ops.KERNELS
                        if k.launches},
           "generate_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    t0 = time.perf_counter()
    out["logits"] = eng.prefill_logits(prompt, prefix=prefix).float().cpu()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out.update(tokens=toks.cpu(), generate_s=gen_s,
               prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=(gen_s - prefill_s) * 1e3
               / (MESH_FAM_NEW - 1))
    if cfg.family in ("ssm", "hybrid"):
        out["state"] = prefill_state(torch, api, model, prompt)
    return out


def mesh_fam_gate(torch, name, cfg, shape, ranks, ref, wall) -> dict:
    """Phase mesh_families' (mesh_recurrent's) gates on one model's rank
    results on one mesh; returns its row."""
    phase = mesh_phase(cfg)
    label = f"{phase} {name} {shape}"
    r0 = ranks[0]
    expect = "nccl" if shape == (1, 1) else "gloo"
    placed = {(r["summary"]["backend"], r["summary"]["device"])
              for r in ranks}
    if placed != {(expect, "cuda:0")}:
        fail(f"{label}: ranks ran over (backend, device) {placed}, "
             f"expected {expect} on cuda:0")
    for r in ranks:
        if not torch.equal(r["tokens"], r0["tokens"]):
            fail(f"{label}: rank {r['rank']}'s tokens differ from rank 0's")
        if r["launches"] != ref["launches"]:
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, the "
                 f"unsharded generate {ref['launches']}")
        if r["swap_collectives"]:
            fail(f"{label}: a task swap made a collective")
        if r["vocab_gathers"] != 0 or r["vocab_gathers_no_logitshard"] < 1:
            fail(f"{label}: vocab-extent gathers {r['vocab_gathers']} under "
                 f"logitshard (want 0), {r['vocab_gathers_no_logitshard']} "
                 f"without (want >= 1)")
        if r["serve"]["tokens"] != r0["serve"]["tokens"]:
            fail(f"{label}: rank {r['rank']} served other tokens")
        if r["hist"] != r0["hist"]:
            fail(f"{label}: rank {r['rank']}'s metrics differ from rank 0's")
        if r["kinds"] != ["all_reduce"] or r["train_vocab_gathers"]:
            fail(f"{label}: a step's collectives {r['kinds']}, "
                 f"{r['train_vocab_gathers']} vocab-extent gathers (want "
                 f"all-reduces only, none)")
        for c in r["collectives"]:
            got = {axis: s["count"] for axis, s in c.items()}
            if got != r["want"]:
                fail(f"{label}: rank {r['rank']} issued {got} all-reduces a "
                     f"step, the formula {r['want']}")
        if not r["codes_frozen"]:
            fail(f"{label}: rank {r['rank']}'s frozen codes changed")
    logits, want = r0["logits"], ref["logits"]
    if not torch.isfinite(logits).all():
        fail(f"{label}: non-finite prefill logits")
    diff = (logits - want).abs().max().item()
    scale = want.abs().max().item()
    if shape == (1, 1):
        if diff != 0.0 or not torch.equal(r0["tokens"], ref["tokens"]):
            fail(f"{label}: the mesh path is not bit-equal to the unsharded "
                 f"engine (logits differ by {diff:.3e})")
        state = r0.pop("state", None)
        if state is not None and (state.keys() != ref["state"].keys() or any(
                not torch.equal(v, ref["state"][k]) for k, v in state.items())):
            fail(f"{label}: the state after the prefill is not bit-equal to "
                 f"the unsharded engine's")
    elif diff > MESH_LOGIT_TOL * scale:
        fail(f"{label}: prefill logits differ from the unsharded engine's "
             f"by {diff:.3e} > {MESH_LOGIT_TOL * scale:.3e}")
    for k, rtol in (("loss", MESH_TRAIN_LOSS_RTOL),
                    ("grad_norm", MESH_TRAIN_GNORM_RTOL)):
        got, ref1 = r0["hist"][0][k], ref["hist"][0][k]
        if not math.isfinite(got) or abs(got - ref1) > rtol * abs(ref1):
            fail(f"{label}: step 1 {k} {got!r} against the unsharded "
                 f"{ref1!r} (rtol {rtol})")
    row = {"world": len(ranks), "backend": expect, "wall_s": wall,
           "kv_share": r0["kv_share"],
           "logits_max_abs_diff": diff, "logits_max_abs": scale,
           "tokens_equal_share_vs_unsharded": (
               r0["tokens"][:, MESH_FAM_PROMPT:]
               == ref["tokens"][:, MESH_FAM_PROMPT:]).float().mean().item(),
           "launches_a_rank": r0["launches"],
           "decode_ms_per_step": [r["decode_ms_per_step"] for r in ranks],
           "unsharded_decode_ms_per_step": ref["decode_ms_per_step"],
           "prefill_ms": [r["prefill_ms"] for r in ranks],
           "unsharded_prefill_ms": ref["prefill_ms"],
           "generate_peak_gb": [r["generate_peak_gb"] for r in ranks],
           "unsharded_generate_peak_gb": ref["generate_peak_gb"],
           "local_gb": [r["local_gb"] for r in ranks],
           "decode_collectives": r0["decode_collectives"],
           "swap_local_bytes": r0["swap_local_bytes"],
           "swap_bytes": r0["swap_bytes"],
           "serve": {k: v for k, v in r0["serve"].items() if k != "tokens"},
           "hist": r0["hist"], "unsharded_hist": ref["hist"],
           "step_ms": [r["step_ms"] for r in ranks],
           "unsharded_step_ms": ref["step_ms"],
           "train_peak_gb": [r["train_peak_gb"] for r in ranks],
           "unsharded_train_peak_gb": ref["train_peak_gb"],
           "collectives_a_step": r0["collectives"][-1],
           "formula": r0["want"],
           "stages_s": [r["stages"] for r in ranks]}
    if "gnorm" in r0:
        row["gnorm"] = [r["gnorm"] for r in ranks]
    if r0["shapes"]:
        row["shapes"] = r0["shapes"]
        kinds = {s["kernel"] for s in r0["shapes"]}
        need = {"quant_gemv", "quant_matmul"}
        if cfg.family != "ssm":             # xlstm has no attention
            need.add("flash_attention")
        if cfg.family not in ("encdec", "ssm", "hybrid"):   # drain only
            need.add("quant_gemv_tasks")
        if not need <= kinds:
            fail(f"{label}: shard shapes checked for {sorted(kinds)}, "
                 f"expected at least {sorted(need)}")
    emit({"phase": f"{phase}_row", "model": name,
          "mesh": f"{shape[0]}x{shape[1]}",
          **{k: row[k] for k in ("backend", "kv_share", "logits_max_abs_diff",
                                 "decode_ms_per_step",
                                 "unsharded_decode_ms_per_step", "step_ms",
                                 "unsharded_step_ms", "train_peak_gb",
                                 "unsharded_train_peak_gb",
                                 "collectives_a_step", "formula")},
          **({"gnorm": row["gnorm"]} if "gnorm" in row else {})})
    return row


def mesh_families_start(torch, models=None, phase="mesh_families") -> dict:
    """Phase mesh_families' (``phase``'s) first part: each model of
    ``models`` ({arch: layers or None}, MESH_FAM by default; MESH_REC for
    mesh_recurrent) built once at full width, then its (1, 2) ranks
    spawned on cuda:0 under gloo in a thread of this process — they read
    its whole models over CUDA IPC and copy only their shards — so that
    they run beside what this process does next (phases that time
    nothing); ``phase_mesh_families`` joins them."""
    import threading
    models = MESH_FAM if models is None else models
    gen = torch.Generator().manual_seed(SEED + 55)
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_")
    built = {}
    for name in models:
        cfg, api, model, _, figs = dense_build(torch, name,
                                               **mesh_fam_kw(name))
        prompt, prefix = mesh_fam_inputs(torch, cfg, gen)
        built[name] = {"cfg": cfg, "api": api, "model": model,
                       "figs": figs, "prompt": prompt, "prefix": prefix}
    spawned = [s for s in MESH_FAM_SHAPES if s != (1, 1)]
    box = {}

    def run_spawned():
        # a failed rank is reported in the joining thread
        try:
            box["walls"] = spawn_meshes(mesh_fam_rank, [(shape, (tmp, {
                n: (b["model"].state_dict(), b["prompt"], b["prefix"])
                for n, b in built.items()})) for shape in spawned])
        except BaseException as e:
            box["error"] = e
    thread = threading.Thread(target=run_spawned)
    thread.start()
    return {"phase": phase, "built": built, "tmp": tmp, "spawned": spawned,
            "box": box, "thread": thread}


def phase_mesh_families(torch, started=None, others=()) -> dict:
    """The vlm and encdec families and a KV head that model ranks share —
    or, ``started`` by ``mesh_families_start(torch, MESH_REC,
    "mesh_recurrent")``, the ssm and hybrid families — on (data, model)
    meshes (module docstring, phases mesh_families and mesh_recurrent):
    the models and their spawned (1, 2) ranks of ``started``
    (``mesh_families_start``, which this calls where it is None) joined
    first, and the ranks of every started phase of ``others`` too, so that
    what this process times runs alone; then (1, 1) over NCCL and the
    unsharded inference in this process, and the unsharded steps last
    (they train the whole models)."""
    import torch.distributed as dist

    from repro_torch.dist import backend
    from repro_torch.launch import mesh as mesh_mod

    started = started or mesh_families_start(torch)
    built, tmp, box = started["built"], started["tmp"], started["box"]
    phase = started["phase"]
    res = {"phase": phase, "batch": BATCH,
           "prompt": MESH_FAM_PROMPT, "new_tokens": MESH_FAM_NEW,
           "train_rows": MESH_FAM_TRAIN_ROWS, "train_seq": MESH_FAM_SEQ,
           "steps": MESH_FAM_STEPS,
           "logit_tolerance_share": MESH_LOGIT_TOL, "models": {}}
    ranks, refs = {}, {}
    try:
        for s in (started, *others):
            s["thread"].join()
        if "error" in box:
            fail(f"{phase}: the spawned meshes failed: {box['error']!r}")
        torch.cuda.ipc_collect()
        for shape in started["spawned"]:
            for name in built:
                ranks[(name, shape)] = ([torch.load(
                    rank_file(tmp, shape, r, f"{name}_"), weights_only=False)
                    for r in range(shape[0] * shape[1])],
                    box["walls"][shape])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    backend.init(0, 1, "cuda", backend.free_port())
    try:
        ctx = mesh_mod.make_debug_mesh(1, 1)
        for name, b in built.items():
            ranks[(name, (1, 1))] = ([mesh_fam_run(
                torch, ctx, 0, b["model"], b["cfg"], b["prompt"],
                b["prefix"], check=False)], time.perf_counter() - t0)
            t0 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    for name, b in built.items():
        refs[name] = mesh_fam_unsharded(
            torch, b["api"], b["model"], b["cfg"], b["prompt"], b["prefix"],
            train=False)
    for name, b in built.items():
        t0 = time.perf_counter()
        ref = dict(refs[name], **mesh_fam_unsharded(
            torch, b["api"], b["model"], b["cfg"], None, None, train=True))
        cfg = b["cfg"]
        row = {"layers": cfg.n_layers, "family": cfg.family,
               "n_kv_heads": cfg.n_kv_heads, "model_gb": b["figs"]["model_gb"],
               "build_s": b["figs"]["build_s"],
               "unsharded_steps_s": time.perf_counter() - t0, "meshes": {}}
        if cfg.family == "encdec":
            row["enc_layers"] = cfg.enc_layers
        for shape in MESH_FAM_SHAPES:
            rs, wall = ranks[(name, shape)]
            row["meshes"][f"{shape[0]}x{shape[1]}"] = mesh_fam_gate(
                torch, name, cfg, shape, rs, ref, wall)
        res["models"][name] = row
        del b["model"], ref
        torch.cuda.empty_cache()
    emit(res)
    return res


# phase mesh_arms: the comparison arms on (data, model) meshes at
# llama3.2-1b's full width and depth (16 layers), each as phase arms runs
# it (``arm_cfg``: 4-bit per-channel, QV4, remat "block"): ``lora`` on its
# float32 backbone (built here from the seed), ``lora_optq`` on phase
# arms' GPTQ backbone, ``qat`` phase arms' trained model, and ``lora_optq``
# under QKVO16 (rank 16 on wq, wk, wv and wo: the row-parallel adapter) on
# a copy of that GPTQ backbone, every adapter fresh.  A fresh adapter's
# lora_b is drawn N(0, MESH_ARMS_B²), so that the adapters move the
# outputs: (1, 2)'s logits and step-1 loss must lie within ADAPTER_SHARE
# of the adapters' own move (the unsharded run against the same run with
# every lora_b zeroed; QKVO16 also with wo's alone zeroed) of the
# unsharded run's, so that a dropped, doubled or unsummed delta fails.  (1, 1) runs over NCCL in this process, (1,
# 2) as gloo ranks on cuda:0 beside phases launch and examples; the
# lockstep prompt, new tokens and training rows are mesh_families'
MESH_ARMS = ("lora", "lora_optq", "qat", "lora_optq_qkvo16")
MESH_ARMS_SHAPES = {"lora": ((1, 1), (1, 2)), "lora_optq": ((1, 1), (1, 2)),
                    "qat": ((1, 1), (1, 2)), "lora_optq_qkvo16": ((1, 2),)}
MESH_ARMS_B = 0.1
ADAPTER_SHARE = 0.25
MESH_ARMS_STEPS = 2
# the dry run's CLI pass over every arch × shape × production mesh and
# tuning mode (CPU, meta tensors), timed beside phases launch and examples
DRYRUN_ARGS = ("--all", "--tuning", "all")


def mesh_arm_cfg(name: str):
    """``name``'s config in phase mesh_arms: ``arm_cfg`` of its arm, QKVO16
    for ``lora_optq_qkvo16``."""
    from repro_torch.configs.base import TuningConfig
    if name == "lora_optq_qkvo16":
        return arm_cfg("lora_optq").replace(tuning=TuningConfig(
            mode="lora_optq", lora_rank=16,
            lora_targets=("wq", "wk", "wv", "wo")))
    return arm_cfg(name)


def fresh_adapters(torch, model, cfg, seed: int):
    """``model``'s adapters replaced by ``cfg``'s, in place: lora_a drawn
    as ``core.lora.add_lora`` draws it, lora_b N(0, MESH_ARMS_B²) (both
    from ``seed``); returns the trainable mask."""
    from repro_torch.core import lora, policies
    from repro_torch.models.linear import Linear
    for mod in model.modules():
        if isinstance(mod, Linear) and mod.has_lora:
            mod.drop_lora()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lora.add_lora(model, gen, cfg.tuning)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Linear) and mod.has_lora:
                mod.lora_b.normal_(0.0, MESH_ARMS_B, generator=gen)
    return policies.make_mask(model, cfg)


def merged_targets(torch, model, tcfg) -> dict:
    """``core.lora.merge_lora`` of a copy of each adapted fp linear of
    ``model`` (the model itself is left as it is): {"<name>.w": the merged
    weight, on the host}."""
    import copy

    from torch import nn

    from repro_torch.core import lora
    from repro_torch.models.linear import Linear
    names = [n for n, m in model.named_modules()
             if isinstance(m, Linear) and m.has_lora and not m.quantized]
    mods = dict(model.named_modules())
    box = nn.ModuleDict({n.replace(".", "_"): copy.deepcopy(mods[n])
                         for n in names})
    lora.merge_lora(box, tcfg)
    return {f"{n}.w": box[n.replace(".", "_")].w.detach().cpu()
            for n in names}


def mesh_arms_data(cfg):
    """The training batches: MESH_FAM_TRAIN_ROWS × MESH_FAM_SEQ rows of a
    seeded synthetic corpus (``pipeline.PackedLM``)."""
    from repro_torch.data import pipeline, synthetic
    return pipeline.PackedLM(synthetic.corpus(
        cfg.vocab_size, 4 * (MESH_ARMS_STEPS + 1) * MESH_FAM_TRAIN_ROWS
        * MESH_FAM_SEQ + 4096, seed=SEED + 60), MESH_FAM_TRAIN_ROWS,
        MESH_FAM_SEQ, seed=SEED)


def mesh_arms_run(torch, ctx, rank: int, whole, cfg, prompt, check: bool,
                  name: str) -> dict:
    """One rank's part of phase mesh_arms for one model on ``ctx``: its
    shard cut from ``whole``; ``generate`` under logitshard (launches
    counted) and without, the prefill logits, the decode step's
    collectives; for an fp backbone its adapters merged (on copies); then
    MESH_ARMS_STEPS steps through ``arm_train``.  ``check``: every new
    call shape held to plain (``CheckedQuantMatmul``)."""
    from repro_torch.core import policies
    from repro_torch.dist import backend, context, sharding
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train.serve import Engine

    shape = (ctx.data_size, ctx.model_size)
    label = f"mesh_arms {name} {shape} rank {rank}"
    checker = CheckedQuantMatmul(ops, label, shapes=True) if check else None

    def checked(what):
        if checker is None:
            return contextlib.nullcontext()
        checker.label = f"{label} {what}"
        return checker

    api = registry.build(cfg)
    t0 = time.perf_counter()
    local = sharding.shard_model(whole, cfg, ctx)
    del whole
    torch.cuda.empty_cache()
    out = {"rank": rank, "coords": (ctx.data_rank, ctx.model_rank),
           "summary": backend.summary(), "cut_s": time.perf_counter() - t0,
           "local_gb": model_bytes(local) / 1e9}
    engine = Engine(api, local, ctx=ctx, logitshard=True)
    with checked("generate"):
        engine.generate(prompt, 2)                 # warm-up, not counted
    torch.cuda.synchronize()
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    toks = engine.generate(prompt, MESH_FAM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    out["launches"] = {k.__name__: k.launches for k in ops.KERNELS
                       if k.launches}
    logits = engine.prefill_logits(prompt)
    base = Engine(api, local, ctx=ctx, logitshard=False)
    if not torch.equal(toks, base.generate(prompt, MESH_FAM_NEW)):
        fail(f"{label}: generate's tokens differ with and without "
             f"logitshard")
    rec = engine.decode_collectives(BATCH, MESH_FAM_PROMPT + MESH_FAM_NEW)
    del base, engine
    out.update(tokens=toks.cpu(), logits=logits.float().cpu(),
               generate_s=gen_s,
               decode_collectives=context.collective_stats(rec),
               decode_row_sums=sum(
                   1 for e in rec if e["kind"] == "all_reduce"
                   and e["axis"] == "model" and e["shape"][-1] == cfg.d_model))
    if cfg.tuning.mode == "lora":
        out["merged"] = merged_targets(torch, local, cfg.tuning)
    mask = policies.make_mask(local, cfg)
    want = {"quant_matmul": 2 * n_quantized(local)} \
        if cfg.tuning.mode == "lora_optq" else {}
    out["train"] = arm_train(
        torch, label, api, cfg, local, mask, mesh_arms_data(cfg),
        MESH_ARMS_STEPS, want, mesh=ctx,
        step1=(lambda: checked("step 1")) if check else None)
    out["shapes"] = [] if checker is None else list(checker.rows.values())
    del local
    torch.cuda.empty_cache()
    return out


def mesh_arms_rank(rank: int, shape: tuple, tmp: str, shared) -> None:
    """One spawned rank of phase mesh_arms: for each model of ``shared``
    ({name: (the parent's whole state dict, the prompt)}) the whole model
    around the parent's own tensors (CUDA IPC), then ``mesh_arms_run``;
    rank 0 holds every new shard shape to plain.  A failed gate exits
    non-zero."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import policies
    from repro_torch.launch import mesh as mesh_mod
    ctx = mesh_mod.make_debug_mesh(*shape)
    for name, (state, prompt) in shared.items():
        cfg = mesh_arm_cfg(name)
        whole = model_from_state(torch, cfg, state)
        policies.make_mask(whole, cfg)
        out = mesh_arms_run(torch, ctx, rank, whole, cfg, prompt,
                            check=rank == 0, name=name)
        del whole, state
        torch.save(out, rank_file(tmp, shape, rank, f"{name}_"))
        del out
        torch.cuda.empty_cache()
    shared.clear()


def mesh_arms_start(torch, arms_models) -> dict:
    """Phase mesh_arms' first part: its four models on the card (phase
    arms' ``lora_optq`` model with fresh adapters and its ``qat`` model,
    the ``lora`` model built from the seed, the QKVO16 ``lora_optq`` on a
    copy of the GPTQ backbone),
    then their (1, 2) ranks spawned on cuda:0 under gloo in a thread of
    this process (reading the models over CUDA IPC) and the dry run's CLI
    pass in a CPU subprocess, both beside what this process does next;
    ``phase_mesh_arms`` joins them."""
    import copy
    import threading

    from repro_torch.core import policies
    from repro_torch.models import registry
    t0 = time.perf_counter()
    built = {}
    cfg = mesh_arm_cfg("lora")
    api = registry.build(cfg)
    model, _ = policies.prepare(api.init(SEED), cfg)
    fresh_adapters(torch, model, cfg, SEED + 61)
    built["lora"] = model
    fresh_adapters(torch, arms_models["lora_optq"], mesh_arm_cfg("lora_optq"),
                   SEED + 64)
    built["lora_optq"] = arms_models["lora_optq"]
    built["qat"] = arms_models["qat"]
    q16 = copy.deepcopy(arms_models["lora_optq"])
    fresh_adapters(torch, q16, mesh_arm_cfg("lora_optq_qkvo16"), SEED + 62)
    built["lora_optq_qkvo16"] = q16
    gen = torch.Generator().manual_seed(SEED + 63)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, MESH_FAM_PROMPT),
                           generator=gen)
    for name, m in built.items():
        policies.make_mask(m, mesh_arm_cfg(name))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_arms_")
    box = {}

    def run_spawned():
        try:
            box["walls"] = spawn_meshes(mesh_arms_rank, [((1, 2), (tmp, {
                n: (m.state_dict(), prompt) for n, m in built.items()}))])
        except BaseException as e:        # reported in the joining thread
            box["error"] = e
    thread = threading.Thread(target=run_spawned)
    thread.start()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(HERE, "src"))
    out = os.path.join(tmp, "dryrun")
    dry = {"t0": time.perf_counter(), "out": out, "proc": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
         "--out", out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)}
    return {"built": built, "prompt": prompt, "tmp": tmp, "box": box,
            "thread": thread, "dryrun": dry,
            "build_s": time.perf_counter() - t0}


def dryrun_gate(dry: dict) -> dict:
    """The dry run's CLI pass joined: exit code 0, a record for every arch
    × shape × production mesh × tuning mode, the roofline over them (the
    H100's constants); its seconds on a line of their own."""
    import glob

    from repro_torch import configs
    from repro_torch.core import policies
    from repro_torch.launch import roofline
    log, _ = dry["proc"].communicate()
    seconds = time.perf_counter() - dry["t0"]
    if dry["proc"].returncode != 0:
        fail(f"dryrun: exit {dry['proc'].returncode}: {log[-2000:]}")
    recs = [json.load(open(f)) for f in glob.glob(
        os.path.join(dry["out"], "*.json"))]
    want = len(configs.all_cells()) * 2 * len(policies.MODES)
    errors = [r for r in recs if "error" in r]
    if len(recs) != want or errors:
        fail(f"dryrun: {len(recs)} records (want {want}), "
             f"{len(errors)} failed: {errors[:1]}")
    rows = roofline.build_table(dry["out"])
    if not rows:
        fail("dryrun: the roofline read no record")
    res = {"phase": "dryrun", "seconds": seconds, "cells": len(recs),
           "ok": sum(bool(r["ok"]) for r in recs),
           "refused": sum(not r["ok"] for r in recs),
           "roofline_rows": len(rows), "card": roofline.CARD}
    emit(res)
    return res


@contextlib.contextmanager
def adapters_zeroed(torch, model, suffix: str = ""):
    """Every adapter's lora_b of ``model`` (of the linears whose name ends
    with ``suffix``) zeroed inside the block, put back after it."""
    from repro_torch.models.linear import Linear
    kept = [(m, m.lora_b.detach().clone()) for n, m in model.named_modules()
            if isinstance(m, Linear) and m.has_lora and n.endswith(suffix)]
    if not kept:
        fail(f"mesh_arms: no adapter ends with {suffix!r}")
    with torch.no_grad():
        for m, _ in kept:
            m.lora_b.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            for m, b in kept:
                m.lora_b.copy_(b)


def mesh_arms_unsharded(torch, api, model, cfg, prompt) -> dict:
    """The unsharded runs each mesh is held to, on the whole ``model``:
    ``generate``'s tokens and launches, the prefill logits, and — where
    it has adapters — the prefill logits and the first training batch's
    loss with and without them (``free``: every lora_b zeroed, and under
    QKVO16 ``.wo``: wo's alone)."""
    from repro_torch.kernels import ops
    from repro_torch.train.serve import Engine
    from repro_torch.train.step import to_device
    eng = Engine(api, model)
    eng.generate(prompt, 2)
    torch.cuda.synchronize()
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    toks = eng.generate(prompt, MESH_FAM_NEW)
    torch.cuda.synchronize()
    out = {"tokens": toks.cpu(), "generate_s": time.perf_counter() - t0,
           "launches": {k.__name__: k.launches for k in ops.KERNELS
                        if k.launches}}
    batch = to_device(mesh_arms_data(cfg).batch_at(0), api.device)

    def read():
        with torch.no_grad():
            return (eng.prefill_logits(prompt).float().cpu(),
                    float(api.loss_fn(model, batch)))
    out["logits"], out["loss"] = read()
    if cfg.tuning.mode in ("lora", "lora_optq"):
        out["free"] = {}
        parts = ("",) + ((".wo",) if "wo" in cfg.tuning.lora_targets
                         else ())
        for part in parts:
            with adapters_zeroed(torch, model, part):
                out["free"][part or "all"] = read()
    return out


def mesh_arms_gate(torch, name, cfg, shape, ranks, ref, wall) -> dict:
    """Phase mesh_arms' gates on one model's rank results on one mesh;
    returns its row."""
    from repro_torch.dist import sharding
    label = f"mesh_arms {name} {shape}"
    r0 = ranks[0]
    expect = "nccl" if shape == (1, 1) else "gloo"
    placed = {(r["summary"]["backend"], r["summary"]["device"])
              for r in ranks}
    if placed != {(expect, "cuda:0")}:
        fail(f"{label}: ranks ran over {placed}, expected {expect} on "
             f"cuda:0")
    for r in ranks:
        if not torch.equal(r["tokens"], r0["tokens"]):
            fail(f"{label}: rank {r['rank']}'s tokens differ from rank 0's")
        if r["launches"] != ref["launches"]:
            fail(f"{label}: rank {r['rank']} launched {r['launches']}, the "
                 f"unsharded generate {ref['launches']}")
        if r["decode_row_sums"] != 2 * cfg.n_layers + 1:
            fail(f"{label}: a decode step made {r['decode_row_sums']} "
                 f"model-axis sums of d_model (want the lookup's and 2 a "
                 f"block: {2 * cfg.n_layers + 1})")
        if r["train"]["hist"] != r0["train"]["hist"]:
            fail(f"{label}: rank {r['rank']}'s metrics differ from rank 0's")
    logits, want = r0["logits"], ref["logits"]
    if not torch.isfinite(logits).all():
        fail(f"{label}: non-finite prefill logits")
    diff = (logits - want).abs().max().item()
    scale = want.abs().max().item()
    loss, loss_ref = r0["train"]["losses"][0], ref["train"]["losses"][0]
    if shape == (1, 1):
        if diff != 0.0 or not torch.equal(r0["tokens"], ref["tokens"]) \
                or loss != loss_ref:
            fail(f"{label}: the mesh path is not bit-equal to the unsharded "
                 f"engine and step (logits differ by {diff:.3e}, step-1 "
                 f"loss {loss!r} against {loss_ref!r})")
    else:
        if diff > MESH_LOGIT_TOL * scale:
            fail(f"{label}: prefill logits differ from the unsharded "
                 f"engine's by {diff:.3e} > {MESH_LOGIT_TOL * scale:.3e}")
        if not math.isfinite(loss) or \
                abs(loss - loss_ref) > MESH_TRAIN_LOSS_RTOL * abs(loss_ref):
            fail(f"{label}: step-1 loss {loss!r} against the unsharded "
                 f"{loss_ref!r} (rtol {MESH_TRAIN_LOSS_RTOL})")
    gaps = {}
    for part, (free_logits, free_loss) in ref.get("free", {}).items():
        gaps[part] = {"logits": (want - free_logits).abs().max().item(),
                      "loss": abs(ref["loss"] - free_loss)}
        if shape != (1, 1) and (
                diff > ADAPTER_SHARE * gaps[part]["logits"]
                or abs(loss - loss_ref) > ADAPTER_SHARE * gaps[part]["loss"]):
            fail(f"{label}: the adapters ({part}) move the unsharded logits "
                 f"by {gaps[part]['logits']:.3e} and the first batch's loss "
                 f"by {gaps[part]['loss']:.3e}; the mesh run lies "
                 f"{diff:.3e} and {abs(loss - loss_ref):.3e} from the "
                 f"unsharded one, more than {ADAPTER_SHARE} of that")
    row = {"world": len(ranks), "backend": expect, "wall_s": wall,
           "logits_max_abs_diff": diff, "logits_max_abs": scale,
           "tokens_equal_share_vs_unsharded": (
               r0["tokens"][:, MESH_FAM_PROMPT:]
               == ref["tokens"][:, MESH_FAM_PROMPT:]).float().mean().item(),
           "launches_a_rank": r0["launches"],
           "generate_s": [r["generate_s"] for r in ranks],
           "unsharded_generate_s": ref["generate_s"],
           "decode_collectives": r0["decode_collectives"],
           "local_gb": [r["local_gb"] for r in ranks],
           "loss_step1": loss, "unsharded_loss_step1": loss_ref,
           "adapter_gap": gaps,
           "step_ms": [r["train"]["step_ms"] for r in ranks],
           "unsharded_step_ms": ref["train"]["step_ms"],
           "peak_mem_gb": [r["train"]["peak_mem_gb"] for r in ranks],
           "unsharded_peak_mem_gb": ref["train"]["peak_mem_gb"],
           "state_bytes": [r["train"]["state_bytes"] for r in ranks],
           "collectives_a_step": r0["train"]["collectives_a_step"],
           "formula": r0["train"]["formula"]}
    if "merged" in r0 and shape != (1, 1):
        got = sharding.unshard([r["merged"] for r in ranks])
        errs = [(got[n] - w).abs().max().item()
                for n, w in ref["merged"].items()]
        big = max(w.abs().max().item() for w in ref["merged"].values())
        if got.keys() != ref["merged"].keys() or max(errs) > 2 ** -20 * big:
            fail(f"{label}: merge_lora on the shards, put back together, is "
                 f"{max(errs):.3e} from the merged whole model (limit "
                 f"{2 ** -20 * big:.3e})")
        row["merge"] = {"linears": len(errs), "max_abs_diff": max(errs),
                        "bit_equal": all(e == 0.0 for e in errs)}
    if r0["shapes"]:
        row["shapes"] = r0["shapes"]
        kinds = {s["kernel"] for s in r0["shapes"]}
        need = {"flash_attention"} | ({"quant_gemv", "quant_matmul"}
                                      if cfg.tuning.mode == "lora_optq"
                                      else set())
        if not need <= kinds:
            fail(f"{label}: shard shapes checked for {sorted(kinds)}, "
                 f"expected at least {sorted(need)}")
    emit({"phase": "mesh_arms_row", "model": name,
          "mesh": f"{shape[0]}x{shape[1]}",
          **{k: row[k] for k in ("backend", "logits_max_abs_diff",
                                 "logits_max_abs", "adapter_gap",
                                 "loss_step1",
                                 "unsharded_loss_step1", "step_ms",
                                 "unsharded_step_ms", "peak_mem_gb",
                                 "collectives_a_step", "formula")},
          **({"merge": row["merge"]} if "merge" in row else {})})
    return row


def phase_mesh_arms(torch, started) -> dict:
    """The comparison arms on (data, model) meshes (module docstring,
    phase mesh_arms): the (1, 2) ranks and the dry run of ``started``
    (``mesh_arms_start``) joined first; then (1, 1) over NCCL and the
    unsharded runs in this process, the unsharded steps last (they train
    the whole models)."""
    import torch.distributed as dist

    from repro_torch.dist import backend
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import registry

    built, tmp, box = started["built"], started["tmp"], started["box"]
    res = {"phase": "mesh_arms", "model": "llama3.2-1b", "batch": BATCH,
           "prompt": MESH_FAM_PROMPT, "new_tokens": MESH_FAM_NEW,
           "train_rows": MESH_FAM_TRAIN_ROWS, "train_seq": MESH_FAM_SEQ,
           "steps": MESH_ARMS_STEPS, "build_s": started["build_s"],
           "logit_tolerance_share": MESH_LOGIT_TOL, "models": {}}
    ranks, refs = {}, {}
    try:
        started["thread"].join()
        res["dryrun"] = dryrun_gate(started["dryrun"])
        if "error" in box:
            fail(f"mesh_arms: the spawned mesh failed: {box['error']!r}")
        torch.cuda.ipc_collect()
        for name in built:
            ranks[(name, (1, 2))] = ([torch.load(
                rank_file(tmp, (1, 2), r, f"{name}_"), weights_only=False)
                for r in range(2)], box["walls"][(1, 2)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    backend.init(0, 1, "cuda", backend.free_port())
    try:
        ctx = mesh_mod.make_debug_mesh(1, 1)
        for name, model in built.items():
            if (1, 1) not in MESH_ARMS_SHAPES[name]:
                continue
            ranks[(name, (1, 1))] = ([mesh_arms_run(
                torch, ctx, 0, model, mesh_arm_cfg(name), started["prompt"],
                check=False, name=name)], time.perf_counter() - t0)
            t0 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    for name, model in built.items():
        cfg = mesh_arm_cfg(name)
        api = registry.build(cfg)
        ref = mesh_arms_unsharded(torch, api, model, cfg, started["prompt"])
        if cfg.tuning.mode == "lora":
            ref["merged"] = merged_targets(torch, model, cfg.tuning)
        refs[name] = ref
    for name, model in built.items():
        cfg = mesh_arm_cfg(name)
        api = registry.build(cfg)
        mask = {n: p.requires_grad for n, p in model.named_parameters()}
        want = {"quant_matmul": 2 * n_quantized(model)} \
            if cfg.tuning.mode == "lora_optq" else {}
        refs[name]["train"] = arm_train(
            torch, f"mesh_arms {name} unsharded", api, cfg, model, mask,
            mesh_arms_data(cfg), MESH_ARMS_STEPS, want, profile=False)
        row = {"arm": cfg.tuning.mode, "lora_rank": cfg.tuning.lora_rank,
               "lora_targets": list(cfg.tuning.lora_targets),
               "layers": cfg.n_layers, "meshes": {}}
        for shape in MESH_ARMS_SHAPES[name]:
            rs, wall = ranks[(name, shape)]
            row["meshes"][f"{shape[0]}x{shape[1]}"] = mesh_arms_gate(
                torch, name, cfg, shape, rs, refs[name], wall)
        res["models"][name] = row
    built.clear()
    torch.cuda.empty_cache()
    emit(res)
    return res


def run_cli(label: str, argv, timeout: float) -> dict:
    """Run ``python -m <argv>`` from the checkout with the port on the path;
    returns its exit code, its output lines, each line's arrival second
    and its wall.  The child is killed at ``timeout`` and never outlives
    this call."""
    import subprocess
    import threading
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["PYTHONUNBUFFERED"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=HERE,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    lines, at = [], []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            at.append(time.perf_counter() - t0)
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"label": label, "rc": rc, "lines": lines, "at": at,
            "wall_s": time.perf_counter() - t0}


def cli_gate(out: dict, *patterns) -> list:
    """Fail unless the CLI exited 0 and printed a line matching each
    pattern; returns each pattern's first match."""
    found = []
    for pat in patterns:
        m = next((re.search(pat, line) for line in out["lines"]
                  if re.search(pat, line)), None)
        found.append(m)
    if out["rc"] != 0 or not all(found):
        tail = "\n".join(out["lines"][-25:])
        fail(f"launch {out['label']}: exit code {out['rc']}, missing "
             f"{[p for p, m in zip(patterns, found) if not m]}; its last "
             f"lines:\n{tail}")
    return found


def phase_launch(torch) -> dict:
    """The two CLIs as subprocesses, each gated on its exit code and its
    own success line: ``launch.train`` at llama3.2-1b's full width and
    depth (10 PEQA steps of 8 × 256, checkpointed, alone: its step walls;
    then 14 steps on the same directory, resumed from step 10), and,
    beside the resumed run, ``launch.serve --continuous`` (the reduced
    config, as its ``--tiny`` forces) resident and speculative on
    bit-planes (fewer target steps than its greedy replay), and
    ``--family-smoke`` for llama3.2-1b — four processes at once, so their
    walls overlap."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    ckpt = os.path.join(tmp, "ckpt")
    train = ["repro_torch.launch.train", "--arch", "llama3.2-1b", "--mode",
             "peqa", "--batch", "8", "--seq", "256", "--ckpt-dir", ckpt]
    res = {"phase": "launch"}
    loss = r"\[launch\] done; final loss=(\S+)"

    first = run_cli("train", [*train, "--steps", "10"], 300)
    done, s1, s10 = cli_gate(first, loss, r"\[train\] step 1/10 ",
                             r"\[train\] step 10/10 ")
    if not math.isfinite(float(done.group(1))):
        fail(f"launch train: final loss {done.group(1)}")
    at = {n: first["at"][next(i for i, line in enumerate(first["lines"])
                              if f"[train] step {n}/10 " in line)]
          for n in (1, 10)}
    res["train"] = {"wall_s": first["wall_s"], "loss": float(done.group(1)),
                    # steps 2–10, on this process's clock as their log
                    # lines arrived (each line follows the step's loss read)
                    "step_ms": (at[10] - at[1]) * 1e3 / 9,
                    "first_step_at_s": at[1]}
    serve = ["repro_torch.launch.serve", "--continuous", "--traffic",
             "poisson", "--tune-steps", "5"]
    jobs = {
        "train resumed": [*train, "--steps", "14"],
        "serve continuous": serve,
        # the speculative gate (fewer target steps than greedy, the same
        # tokens) where the draft accepts: the CLI's tiny model, tuned
        "serve speculative": [*serve, "--layout", "plane", "--scheduler",
                              "speculative"],
        "serve family-smoke": ["repro_torch.launch.serve", "--family-smoke",
                               "--arch", "llama3.2-1b"]}
    with ThreadPoolExecutor(len(jobs)) as pool:
        outs = dict(zip(jobs, pool.map(lambda kv: run_cli(*kv, 300),
                                       jobs.items())))
    again = outs["train resumed"]
    done, _ = cli_gate(again, loss,
                       r"\[train\] resumed from checkpoint step 10$")
    if not math.isfinite(float(done.group(1))):
        fail(f"launch train resumed: final loss {done.group(1)}")
    res["train_resumed"] = {"wall_s": again["wall_s"],
                            "loss": float(done.group(1))}
    cont = outs["serve continuous"]
    cli_gate(cont, r"^\[serve\] continuous OK$",
             r"^\[serve\] continuous\[resident\]:")
    res["serve_continuous"] = {
        "wall_s": cont["wall_s"],
        "summary": next(line for line in cont["lines"]
                        if line.startswith("[serve] continuous["))}
    spec = outs["serve speculative"]
    _, ratio = cli_gate(spec, r"^\[serve\] continuous OK$",
                        r"^\[serve\] speculative == greedy over .*"
                        r"target steps (\d+) vs (\d+) .*acceptance=(\S+)")
    res["serve_speculative"] = {
        "wall_s": spec["wall_s"], "steps": int(ratio.group(1)),
        "greedy_steps": int(ratio.group(2)),
        "acceptance_rate": float(ratio.group(3))}
    smoke = outs["serve family-smoke"]
    cli_gate(smoke, r"family-smoke dense \(tiny-llama3\.2-1b\): .* OK$")
    res["serve_family_smoke"] = {"wall_s": smoke["wall_s"]}
    shutil.rmtree(tmp)
    emit(res)
    return res


def phase_examples(torch) -> dict:
    """The two end-to-end examples in process, at their defaults:
    ``train.instruction_tune.run`` (llama3.2-20m, 300 + 300 steps, 3 bits)
    twice on one checkpoint directory, and ``train.serve_multitask.run``."""
    import shutil
    import tempfile
    from repro_torch.train import instruction_tune, serve_multitask
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    kw = dict(ckpt_dir=os.path.join(tmp, "ckpt"),
              scale_bank=os.path.join(tmp, "bank"), log=quiet)
    res = {"phase": "examples"}

    def counted(fn):
        out, launches, wall, _ = launch_gate(torch, "examples", fn)
        return out, wall, {k: n for k, n in launches.items() if n}

    out, wall, launches = counted(lambda: instruction_tune.run(**kw))
    keys = ("fp_ppl", "fp_instruction_ppl", "rtn_ppl", "tuned_ppl",
            "trainable", "state_bytes", "scale_bytes")
    res["instruction_tune"] = {**{k: out[k] for k in keys},
                               "wall_s": wall, "launches": launches}
    if not out["tuned_ppl"] < out["rtn_ppl"]:
        fail(f"instruction_tune: PEQA-tuned ppl {out['tuned_ppl']} not "
             f"below the RTN 3-bit {out['rtn_ppl']}")
    if not (out["codes_frozen"] and out["export_reloads_equal"]):
        fail(f"instruction_tune: codes frozen {out['codes_frozen']}, "
             f"export reloads equal {out['export_reloads_equal']}")
    if out["resumed_from"] is not None:
        fail(f"instruction_tune: a fresh run resumed from "
             f"{out['resumed_from']}")
    again, wall, _ = counted(lambda: instruction_tune.run(**kw))
    if again["resumed_from"] != 300 or not again["codes_frozen"] \
            or not again["export_reloads_equal"]:
        fail(f"instruction_tune rerun: resumed from "
             f"{again['resumed_from']} (want 300)")
    res["instruction_tune_rerun"] = {"wall_s": wall,
                                     "tuned_ppl": again["tuned_ppl"]}
    out, wall, launches = counted(lambda: serve_multitask.run(log=quiet))
    if not out["tasks_differ"]:
        fail("serve_multitask: the tasks gave the same continuation")
    res["serve_multitask"] = {
        "wall_s": wall, "switch_ms": [s["switch_s"] * 1e3
                                      for s in out["switches"]],
        "scale_bytes": out["scale_bytes"], "launches": launches}
    shutil.rmtree(tmp)
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
    seconds = {}

    def run(name, fn, *args, **kw):
        """Run one phase and print its seconds on a line of its own."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        emit({"phase": "seconds", "of": name, "s": seconds[name]})
        return out

    dev = run("device", phase_device, torch)
    worst_err, attn_prefill, attn_7b, experts, experts_planes = run(
        "kernels", phase_kernels, torch)
    main_path = run("main", phase_main, torch)
    run("profile", phase_profile, torch, main_path)
    plane = run("plane_backbone", plane_backbone, torch, main_path)
    emit({"phase": "plane_backbone", "repack_s": plane["repack_s"]})
    with torch.inference_mode():
        step = run("step", phase_step, torch, main_path["model"],
                   plane["model"])
    serve = run("serve", phase_serve, torch, main_path)
    spec = run("speculative", phase_speculative, torch, plane, serve)
    harness = run("harness", phase_harness, torch, main_path, plane)
    del plane
    # phase mesh saves the whole model once; phase mesh_train's ranks read
    # it too
    mesh_tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mesh = run("mesh", phase_mesh, torch, main_path, mesh_tmp,
                   train=True)
        mesh_train = run("mesh_train", phase_mesh_train, torch, main_path,
                         mesh_tmp)
    finally:
        shutil.rmtree(mesh_tmp, ignore_errors=True)
    conv = run("convert", phase_convert, torch, main_path)
    chunked = run("chunked", phase_chunked, torch, conv, serve,
                  main_path["prompt"])
    steps = {layout: conv[layout]["step"] for layout in conv}
    del conv
    # phases mesh_families' and mesh_recurrent's (1, 2) ranks run beside
    # each other and beside phases invariance and check, which time nothing
    # (the time limit's cut: the ranks' own walls include that load);
    # mesh_families joins both before it times anything
    families = run("mesh_families_start", mesh_families_start, torch)
    recurrent = run("mesh_recurrent_start", mesh_families_start, torch,
                    MESH_REC, "mesh_recurrent")
    run("invariance", phase_invariance, torch, main_path["cfg"])
    run("invariance_starcoder2", phase_invariance, torch,
        dense_cfg("starcoder2-7b"), layouts=("nibble",))
    run("check", phase_check, torch, main_path["cfg"])
    mesh_families = run("mesh_families", phase_mesh_families, torch,
                        families, (recurrent,))
    del families
    mesh_recurrent = run("mesh_recurrent", phase_mesh_families, torch,
                         recurrent)
    del recurrent
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
    mesh_moe = run("mesh_moe", phase_mesh_moe, torch)
    encdec = run("encdec", phase_encdec, torch)
    ssm = run("ssm", phase_ssm, torch)
    hybrid = run("hybrid", phase_hybrid, torch)
    arms = run("arms", phase_arms, torch, prompt, peqa, full)
    arms_models = arms.pop("models")
    del prompt, peqa, full
    torch.cuda.empty_cache()
    # phase mesh_arms' (1, 2) ranks and the dry run's CLI pass run beside
    # phases launch and examples, which gate outputs only; phase launch's
    # CLIs are processes of their own: they run while this process runs
    # phase examples (each one's walls include the others' load), the time
    # limit's cut
    arms_started = run("mesh_arms_start", mesh_arms_start, torch,
                       arms_models)
    del arms_models
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        launching = pool.submit(run, "launch", phase_launch, torch)
        examples = run("examples", phase_examples, torch)
        launch = launching.result()
    mesh_arms = run("mesh_arms", phase_mesh_arms, torch, arms_started)
    del arms_started
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
        "quant_gemv_experts_planes": (
            "quant_gemv", f"{plane_branch} (reached :325) under vmap at "
            "src/repro/models/moe.py:133"),
        "quant_matmul_experts_planes": (
            "quant_matmul", f"{plane_branch} (reached :195) under vmap at "
            "src/repro/models/moe.py:133"),
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
    # their plane forms: launches over deepseek-moe-16b's generate on 4
    # bit-planes (phase moe); ms, bound and library for one deepseek block's
    # three expert linears (gate and up (1408, 2048), down (2048, 1408)) on
    # 4 planes at C = 1 (K1-plane) and C = 120 (K2-plane), phase kernels
    for name in ("quant_gemv_experts_planes", "quant_matmul_experts_planes"):
        launches[name] = moe["deepseek-moe-16b"]["generate"][
            "launches"].get(name, 0)
        up, down = (f[(4, name)] for f in experts_planes["deepseek-moe-16b"])
        times[name] = {k: 2 * up[k] + down[k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "loop_2d_ms")}
        times[name]["bound_by"] = up["bound_by"]
    # whisper-medium's, xlstm-125m's and zamba2-7b's lockstep generate
    # (phases encdec, ssm and hybrid): K2 a prefill, K1 and K4 a decode step
    family_launches = {f"{fam}_launches": r["generate"]["launches"]
                       for fam, r in (("encdec", encdec), ("ssm", ssm),
                                      ("hybrid", hybrid))}
    # phase mesh_moe's path: deepseek-moe-16b's generate at (1, 2) on rank
    # 0 (nibble, and its plane shard), counts set to 0 just before; every
    # shard shape its ranks held to plain, as [E or M, C, N, K, err, ms,
    # plain ms, bound ms, torch.bmm ms] (the dense kernels' without E and
    # the library; K4's as B, Sq, Sk, Hq, Hkv)
    moe_12 = mesh_moe["models"]["deepseek-moe-16b"]["meshes"]["1x2"]
    mesh_moe_launches = dict(moe_12["launches_a_rank"],
                             **moe_12["planes"]["launches"])
    mesh_moe_shapes = {}
    for m in mesh_moe["models"].values():
        for row in m["meshes"].values():
            for sh in row.get("shapes", ()):
                dims = ("E", "C", "N", "K") if "E" in sh else \
                    ("M", "N", "K") if "M" in sh else \
                    ("B", "Sq", "Sk", "Hq", "Hkv")
                mesh_moe_shapes.setdefault(sh["kernel"], []).append(
                    [*(sh[d] for d in dims), sh["max_abs_err"], sh["ms"],
                     sh["plain_ms"], sh["bound_ms"],
                     *((sh["library_ms"],) if "library_ms" in sh else ())])
    # phases mesh_families', mesh_recurrent's and mesh_arms' paths: each
    # model's generate at (1, 2) on rank 0 (counts set to 0 just before
    # each), summed; every shard shape its rank 0 held to plain, as [M, N,
    # K, err, ms, plain ms, bound ms, library ms] (K4's as B, Sq, Sk, Hq,
    # Hkv; K5 and the plane forms have no library call)
    mesh_paths = {}
    for phase, got in (("mesh_families", mesh_families),
                       ("mesh_recurrent", mesh_recurrent),
                       ("mesh_arms", mesh_arms)):
        launched, shapes = mesh_paths.setdefault(phase, ({}, {}))
        for m in got["models"].values():
            row = m["meshes"]["1x2"]
            for k, v in row["launches_a_rank"].items():
                launched[k] = launched.get(k, 0) + v
            for sh in row.get("shapes", ()):
                dims = ("M", "N", "K") if "M" in sh else \
                    ("B", "Sq", "Sk", "Hq", "Hkv")
                shapes.setdefault(sh["kernel"], []).append(
                    [*(sh[d] for d in dims), sh["max_abs_err"], sh["ms"],
                     sh["plain_ms"], sh["bound_ms"], sh.get("library_ms")])
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
               else {}),
            **{key: got[name] for key, got in family_launches.items()
               if name in got},
            "harness_launches": harness["launches"][name],
            **({"mesh_moe_launches": mesh_moe_launches[name]}
               if name in mesh_moe_launches else {}),
            **({"mesh_moe_shapes": mesh_moe_shapes[name]}
               if name in mesh_moe_shapes else {}),
            **{f"{phase}_{what}": got[name]
               for phase, pair in mesh_paths.items()
               for what, got in zip(("launches", "shapes"), pair)
               if name in got}})
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
              "layout", "layers", "build_s", "build_peak_gb", "build_peak_bound_gb",
              "model_gb", "generate")} | {
              "busy_share": {k: moe[m]["profile"][k]["device_busy_share"]
                             for k in ("prefill", "decode_step")},
              "serve_wall_s": moe[m]["serve"]["drain"]["wall_s"],
              "train": {k: moe[m]["train"][k] for k in (
                  "median_step_ms", "peak_mem_gb", "state_bytes",
                  "scales")}} for m in MOE_ARCHS},
          "encdec": {k: encdec[k] for k in (
              "enc_layers", "layers", "build_s", "build_peak_gb",
              "build_peak_bound_gb", "model_gb", "generate")} | {
              "prefill_parts": encdec["prefill_parts"],
              "busy_share": {k: encdec["profile"][k]["device_busy_share"]
                             for k in ("prefill", "decode_step")},
              "serve_wall_s": encdec["serve"]["drain"]["wall_s"],
              "train": {k: encdec["train"][k] for k in (
                  "median_step_ms", "peak_mem_gb", "state_bytes",
                  "scales")}},
          **{fam: {k: r[k] for k in (
              "layers", "build_s", "build_peak_gb", "build_peak_bound_gb",
              "model_gb", "generate")} | {
              "busy_share": {k: r["profile"][k]["device_busy_share"]
                             for k in ("prefill", "decode_step")},
              "serve_wall_s": r["serve"]["drain"]["wall_s"],
              "state_bytes_a_slot": r["serve"]["state_bytes_a_slot"],
              "kv_bytes_a_position": r["serve"]["kv_bytes_a_position"],
              "slstm": r.get("slstm"),
              "train": {k: r["train"][k] for k in (
                  "median_step_ms", "peak_mem_gb", "state_bytes",
                  "scales")}} for fam, r in (("ssm", ssm),
                                             ("hybrid", hybrid))},
          "arms": arms["table"],
          "harness": {k: harness[k] for k in (
              "tune", "resident_poisson", "drain_trace",
              "speculative_poisson", "driver_run_1", "driver_run_2")},
          "mesh": {name: {k: m[k] for k in (
              "backend", "decode_ms_per_step", "peak_gb",
              "decode_collectives", "logits_max_abs_diff")}
              for name, m in mesh["meshes"].items()},
          "mesh_train": {name: {k: m[k] for k in (
              "backend", "step_ms", "peak_gb", "collectives_a_step",
              "formula")} for name, m in mesh_train["meshes"].items()},
          "mesh_moe": {model: {name: {k: m[k] for k in (
              "backend", "decode_ms_per_step",
              "unsharded_decode_ms_per_step", "step_ms", "unsharded_step_ms",
              "train_peak_gb", "unsharded_train_peak_gb",
              "collectives_a_step", "formula", "logits_max_abs_diff")}
              for name, m in r["meshes"].items()}
              for model, r in mesh_moe["models"].items()},
          **{phase: {model: {name: {k: m[k] for k in (
              "backend", "kv_share", "decode_ms_per_step",
              "unsharded_decode_ms_per_step", "step_ms", "unsharded_step_ms",
              "train_peak_gb", "unsharded_train_peak_gb",
              "collectives_a_step", "formula", "logits_max_abs_diff",
              "gnorm") if k in m}
              for name, m in r["meshes"].items()}
              for model, r in got["models"].items()}
              for phase, got in (("mesh_families", mesh_families),
                                 ("mesh_recurrent", mesh_recurrent))},
          "mesh_arms": {model: {name: {k: m[k] for k in (
              "backend", "logits_max_abs_diff", "loss_step1",
              "unsharded_loss_step1", "step_ms", "unsharded_step_ms",
              "peak_mem_gb", "collectives_a_step", "formula", "merge")
              if k in m} for name, m in r["meshes"].items()}
              for model, r in mesh_arms["models"].items()},
          "dryrun": mesh_arms["dryrun"],
          "launch": {k: launch[k] for k in (
              "train", "train_resumed", "serve_continuous",
              "serve_speculative", "serve_family_smoke")},
          "examples": {k: examples[k] for k in (
              "instruction_tune", "instruction_tune_rerun",
              "serve_multitask")}})
    print(dev["gpu"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
