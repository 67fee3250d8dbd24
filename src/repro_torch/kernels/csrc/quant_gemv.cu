// K1: decode GEMV  y = x · Ŵᵀ,  Ŵ = s · (q − z)  from packed 4-bit codes,
// and K5: the same GEMV with per-row task scales,
//   y[m, n] = Σ_k x[m, k] · s[t_m, n, g(k)] · (q[n, k] − z[t_m, n, g(k)]),
//   t_m = task_ids[m],
// and K6a: both read from bit-planes (PLANES = true).
//
// This header describes the SIMT route first; the tensor-core route, which
// every model-shape launch takes, follows below it.
//
// K1 replaces the TPU kernel repro/kernels/quant_matmul.py::quant_gemv_pallas
// (plain branch, _qgemv_kernel).  Same semantics: x (M ≤ 32, K) in bf16 or
// f32, qw (N, K/8) 32-bit words holding 8 nibble codes each (code i in bits
// 4i..4i+3), scale and zero (N, G) f32 with groups of K/G consecutive codes,
// dequantization s·(q − z) in f32 exactly as the plain version computes it,
// f32 accumulation, y (M, N) in x's dtype.
//
// K5 replaces quant_gemv_pallas called with task_ids (_qgemv_tasks_kernel,
// the pallas_call at quant_matmul.py:364): scale and zero are (T, N, G)
// stacks and task_ids (M,) int32 picks each row's task.  The TPU kernel
// computes every row under ALL T tasks and keeps the matching one (T× the
// multiply-adds); here each row gathers its own task's scale and zero.  K5
// is K1's template with TASKS = true: the same MT/R instantiation for a
// given M, the same K chunking and KSPLIT reduction order, and the same
// s·(nib − z) expression feeding fmaf — so row i is bit for bit K1's row i
// under scale_stack[task_ids[i]].  Ids are validated on the host; the
// kernel clamps them into [0, T) so it never reads outside the stack.
//
// What bounds it on an H100: bytes.  At M = 4 each code is used for 4 FMAs,
// far below the ~295 operations per byte where the card turns compute-bound,
// so the kernel is as fast as it streams qw from HBM.  The design:
//   * every packed word is read from device memory exactly once per call,
//     coalesced (a warp reads 32 consecutive words of a row);
//   * each lane holds R rows' words of one K position, so the activations it
//     reads from shared memory (staged once per block as f32) feed R rows;
//   * 4-bit codes become floats with the 2^23 magic-number trick (an OR and a
//     subtract) instead of the slow integer-to-float conversion;
//   * a block's 8 warps split K four ways over two row groups and meet in a
//     shared-memory reduction, so small-N layers still fill the card.
// With f32 FMAs on CUDA cores (as the TPU kernel dots f32 operands), the
// dequantize + FMA instruction count per code sets its pace (8.5× the bytes
// bound at M = 4, 26× at M = 32 on an H100): the kernel below is now the
// SIMT route only, and bf16 x at the model's shapes takes the tensor cores.
// K5 dequantizes each code once per row of x (its scale and zero are the
// row's), not once per MB rows: more FP work per code, but no per-row scale
// registers.  Per-channel scales of the M rows are staged in shared memory
// once per block and read from there per word; grouped scales are read per
// word through the L1.
//
// K6a replaces the plane branch of quant_gemv_pallas (_unpack_planes at
// repro/kernels/quant_matmul.py:98, the prefix read of _qw_layout :114):
// qw is (bits', N, K/32) 32-bit words, plane i holding bit bits'−1−i of
// every code (code i in bit i of its word), and the kernel reads only the
// top `planes` planes — with planes < bits' the low-bit draft of
// self-speculative decoding, whose scale and zero it multiplies by 2^shift
// and 2^−shift as it reads them (exact: powers of two).  The design keeps
// K1 and K5 whole: a lane that handles packed word w (codes 8w..8w+7)
// reads byte w & 3 of plane word w >> 2 in each plane, spreads its 8 bits
// to bits 0, 4, …, 28 and stacks the planes, MSB first — which IS the
// nibble word of the p-bit codes.  From there the body is K1's (or K5's)
// unchanged, so a plane kernel is bit for bit its nibble kernel on those
// codes under the rescaled scales.  Bytes: p/4 of the nibble kernel's code
// stream, each plane byte read once (a warp reads 8 consecutive words of
// each plane: 32-byte sectors, fully used).
//
// Two routes behind the four entry points, chosen by dtype and shape (not a
// fallback on failure):
//
// * The tensor-core route (quant_gemv_tc_kernel): bf16 x, K % 64 == 0 and a
//   group size K/G that is a multiple of 64 (per-channel included) — every
//   llama3.2-1b linear (quant_matmul.tc_route).  A bf16 x and a 4-bit code
//   (0..15; q >> shift for a plane draft) are both exact bf16 operands, so
//   Ŵ is never rounded: per group g
//     y[m,n] = Σ_g s[t_m,n,g]·(Σ_{k∈g} x[m,k]·q[n,k] − z[t_m,n,g]·Σ_{k∈g} x[m,k])
//   The inner sums run on mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//   the operands swapped: A is 16 output channels × 16 codes, B is 16 codes
//   × 8 rows of x.  Σ x is the same product with an A tile of ones.
//   Work: a cluster of S blocks of 8 warps owns 16 channels; warp w of
//   block rank r sums K slice i = 8r + w — the 64-code blocks
//   [i·nb/(8S), (i+1)·nb/(8S)) of the nb = K/64.  S (tc_block_split, 1 to
//   4) follows from (N, K): enough blocks for ~2 on each of the 132 SMs,
//   but never fewer than 8 64-code blocks a warp — the cluster's barriers
//   and exchange cost more than a shorter chain of 4 saves (split over 4
//   and 2 blocks, the k/v and q/o projections took ~1 µs longer at M <= 8:
//   kernels/gemv_variants.py).  Of the llama3.2-1b linears only the down
//   projection (K = 8192, 128 channel tiles) splits, over 2.  M <= 8 is
//   one n-tile of B, M = 32 four, each A fragment reused across them.  A
//   lane (g = lane / 4, t = lane % 4) reads, for channels g and g + 8, 16
//   consecutive codes of each 64-code block (two packed words: one 8-byte
//   load per channel; a quad of lanes reads a channel's 32 contiguous
//   bytes, one sector — or the lane's 16 bits of each plane's word) and
//   the matching 16 bf16 of each x row (two 16-byte loads through L1).
//   The k order inside a block is permuted so that a lane's codes are its
//   own loads, and unpacked in the fewest instructions: each packed word
//   becomes 4 bf16 pairs, pair i = codes (i, i + 4) — a shift, a masked OR
//   into 0x4300|q (= 128 + q) and one bf16x2 fma that subtracts 128
//   (exact) — and k-step s of the block pairs them with the same x
//   elements, which a byte permute pairs likewise.  A and B see the same
//   permutation, so the dot is unchanged.
//   (8-byte code loads, not 16: a lane's 16 codes then stay inside one
//   64-code block, so groups of 64 codes need no exchange between lanes.)
//   At M <= 8 a warp keeps two batches of 2 blocks in registers, the raw
//   words of one in flight while the other is unpacked and multiplied, and
//   reads per-channel scales before the sums; at larger M one batch of
//   4 / NT blocks at a time.
//   A group's partial sums are flushed into the lane's y as s·(A − z·R) at
//   each group boundary and at the slice's end; the 8S slices' partial y
//   then meet through the cluster's shared memory, added in slice order.
//   What the card bounds: bytes.  Every code word is read from HBM once;
//   x (at most 32 × K bf16, in L2) once per 16 channels.  What holds it
//   back (kernels/gemv_variants.py): at M <= 8 the loop without its loads
//   takes two thirds of the time and the loads alone one third, yet
//   neither a third fewer unpack instructions nor half the tensor-core
//   work (Σ x in A's 16th row, 15 channels a block) made it faster — the
//   second was slower; at M = 32 x's L2 traffic, 8× the codes' bytes.
//   The schedule follows from (N, K, G) alone, never from M, and an mma
//   computes each output element from its own row and column only.  So
//   row m's bits do not depend on how many rows share the call (a verify of
//   k+1 tokens gives the bits of k+1 decode steps).  K5 runs the same sums
//   — they do not depend on the task — and reads row m's (s, z) from the
//   stacks only for the flush, in K1's expression: K5's row m is K1's row m
//   under task t_m, bit for bit.  The plane form rebuilds each packed word
//   from the top planes before the unpack: bit for bit the nibble kernel on
//   q >> (bits' − planes) under the rescaled scales.
// * The SIMT route (quant_gemv_kernel, below): f32 x and the other shapes.
//   Its K chunk is the same for every instantiation (KC_FIXED, the M = 32
//   chunk), so lane → word and warp → K slice, and with them a row's sum
//   order, are the same for every M too.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int KSPLIT = 4;                    // warps sharing one row group
constexpr int ROW_GROUPS = 2;                // row groups per block
constexpr int WARPS = KSPLIT * ROW_GROUPS;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_X_FLOATS = 16384;         // 64 KB of staged activations
// the K chunk of every SIMT launch: the M = 32 chunk (a multiple of 8), so
// a row's chunking — and its sum order — does not depend on M
constexpr int KC_FIXED = (SMEM_X_FLOATS / 32) & ~7;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// nibble j of a word as an exact float: 0x4B000000 is 2^23, whose mantissa
// holds the code in its low bits
__device__ __forceinline__ float nib(uint32_t word, int j) {
  return __uint_as_float(0x4B000000u | ((word >> (4 * j)) & 0xFu)) - 8388608.0f;
}

// the 8 bits of a byte moved to bits 0, 4, …, 28
__device__ __forceinline__ uint32_t spread8(uint32_t b) {
  b = (b | (b << 12)) & 0x000F000Fu;
  b = (b | (b << 6)) & 0x03030303u;
  return (b | (b << 3)) & 0x11111111u;
}

// packed word w (codes 8w..8w+7) of row n as nibbles: read from the nibble
// words, or rebuilt from the top `planes` bit-planes (MSB first; the plane
// stride is N·K/32 words, words = K/8)
template <bool PLANES>
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ qw,
                                              int n, int w, int words,
                                              size_t plane_stride, int planes) {
  if constexpr (!PLANES) {
    return __ldg(qw + (size_t)n * words + w);
  } else {
    const uint32_t* src = qw + (size_t)n * (words >> 2) + (w >> 2);
    const int sh = (w & 3) * 8;
    uint32_t out = 0;
#pragma unroll 4
    for (int i = 0; i < planes; ++i)
      out = (out << 1) | spread8((__ldg(src + i * plane_stride) >> sh) & 0xFFu);
    return out;
  }
}

// The expert axis (quant_gemv_experts): one launch over gridDim.z experts,
// each with its own x (M, K), nibble words (N, K/8), scale and zero (N, G)
// and y (M, N), all experts of one shape and stored one after another (an
// MoE block's (E, C, K) rows and its (E, N, …) expert stacks).  Block z
// advances the operands to expert z's slices and then runs the 2-D
// launch's tile code unchanged, so slice z of the result is bit for bit
// the 2-D kernel on expert z's operands; a 2-D launch is z = 0 alone.
#define EXPERT_SLICE(x, qw, scale, zero, y, M, N, K, G)          \
  do {                                                            \
    const size_t e_ = blockIdx.z;                                 \
    x += e_ * (size_t)(M) * (K);                                  \
    qw += e_ * (size_t)(N) * ((K) >> 3);                          \
    scale += e_ * (size_t)(N) * (G);                              \
    zero += e_ * (size_t)(N) * (G);                               \
    y += e_ * (size_t)(M) * (N);                                  \
  } while (0)

// MT: rows of x padded to a power of two; R: output rows per lane;
// MB: rows of x held in registers at a time; TASKS: K5 (scale and zero are
// (T, N, G) stacks, row m reads task task_ids[m]) instead of K1; PLANES:
// the codes are the top `planes` bit-planes, the scales multiplied by
// s_mul and the zeros by z_mul as they are read (K6a)
template <typename T, int MT, int R, bool TASKS, bool PLANES,
          int MB = (MT < 4 ? MT : 4)>
__global__ void __launch_bounds__(THREADS, 2) quant_gemv_kernel(
    const T* __restrict__ x, const uint32_t* __restrict__ qw,
    const float* __restrict__ scale, const float* __restrict__ zero,
    const int* __restrict__ task_ids, T* __restrict__ y,
    int M, int N, int K, int G, int n_tasks, int kc,
    int planes, float s_mul, float z_mul) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);            // [MT][kc]
  __shared__ float red[ROW_GROUPS][KSPLIT][R * MT];
  // K5 only, after xs: per-channel (scale, zero) of the block's rows under
  // each x row's task, [ROW_GROUPS][R][MT]; then each x row's offset into
  // the stacks, t_m·N·G, [MT].  Both are read through volatile pointers,
  // once per use: hoisted out of the word loop they would take R·MT
  // registers (64-bit row pointers for the offsets), which spilled.
  float2* sz_s = reinterpret_cast<float2*>(xs + MT * kc);
  int* tofs_s = reinterpret_cast<int*>(sz_s + ROW_GROUPS * R * MT);
  const volatile float* szv = reinterpret_cast<const volatile float*>(sz_s);
  const volatile int* tofs = tofs_s;

  EXPERT_SLICE(x, qw, scale, zero, y, M, N, K, G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = warp % KSPLIT, rg = warp / KSPLIT;
  const int n0 = (blockIdx.x * ROW_GROUPS + rg) * R;
  const int words = K >> 3;
  const size_t plane_stride = (size_t)N * (K >> 5);
  const int group = K / G;
  const bool word_groups = (group & 7) == 0;              // a word never straddles groups
  // a scale and a zero as the dequantization uses them
  auto lds = [&](const float* p) { return PLANES ? __ldg(p) * s_mul : __ldg(p); };
  auto ldz = [&](const float* p) { return PLANES ? __ldg(p) * z_mul : __ldg(p); };

  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  float s[R], z[R];
  if constexpr (TASKS) {
    // ids clamped into the stack (the host has validated them); padding
    // rows m >= M read task 0 and multiply zeros.  Visible to every thread
    // after the first chunk's __syncthreads.
    for (int t = threadIdx.x; t < MT; t += THREADS)
      tofs_s[t] = (t < M ? min(max(__ldg(task_ids + t), 0), n_tasks - 1) : 0) * N * G;
    if (G == 1) {
      for (int t = threadIdx.x; t < ROW_GROUPS * R * MT; t += THREADS) {
        const int gi = t / (R * MT), idx = t - gi * (R * MT);
        const int r = idx / MT, m = idx - r * MT;
        const int n = min((int)(blockIdx.x * ROW_GROUPS + gi) * R + r, N - 1);
        const int tk = m < M ? min(max(__ldg(task_ids + m), 0), n_tasks - 1) : 0;
        const size_t o = (size_t)tk * N + n;
        sz_s[t] = make_float2(lds(scale + o), ldz(zero + o));
      }
    }
  } else if (G == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = min(n0 + r, N - 1);
      s[r] = lds(scale + n);
      z[r] = ldz(zero + n);
    }
  }

  for (int c0 = 0; c0 < K; c0 += kc) {
    const int clen = min(kc, K - c0);                      // a multiple of 8
    // stage x[:, c0:c0+clen] as f32 in 16-byte vectors, all of a thread's
    // loads in flight together; rows m >= M are zeros
    constexpr int VEC = 16 / sizeof(T);                    // 8 bf16 or 4 f32
    const int nvec = MT * clen / VEC;
#pragma unroll 4
    for (int v = threadIdx.x; v < nvec; v += THREADS) {
      const int e = v * VEC;
      const int m = e / clen, k = e - m * clen;
      float f[8];
      if (m < M) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            x + (size_t)m * K + c0 + k));
        const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = to_f32(t[j]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(xs + m * kc + k);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      if (VEC == 8) dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();

    const int w0 = c0 >> 3, cw = clen >> 3;
    for (int i = kq * 32 + lane; i < cw; i += KSPLIT * 32) {
      const int w = w0 + i;
      const int k0 = w << 3;
      uint32_t q[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        q[r] = (n0 + r < N)
            ? load_word<PLANES>(qw, n0 + r, w, words, plane_stride, planes) : 0u;
      if constexpr (TASKS) {
        // K5: the same per-accumulator order of fmaf's as K1 below, each
        // row of x dequantizing the code with its own task's (s, z)
        if (G != 1 && !word_groups) {
          // j stays a loop (no register array is indexed by it): unrolled,
          // this rarely taken branch set the whole kernel's register
          // budget and spilled
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int n = min(n0 + r, N - 1);
#pragma unroll 1
            for (int j = 0; j < 8; ++j) {
              const int g = (k0 + j) / group;
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                const int o = tofs[m] + n * G + g;
                const float wj = lds(scale + o) * (nib(q[r], j) - ldz(zero + o));
                acc[r][m] = fmaf(xs[m * kc + (i << 3) + j], wj, acc[r][m]);
              }
            }
          }
          continue;
        }
        const int g = G == 1 ? 0 : k0 / group;
#pragma unroll
        for (int mb = 0; mb < MT; mb += MB) {
          float xr[MB][8];
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            const float* src = xs + (mb + m) * kc + (i << 3);
            const float4 a = *reinterpret_cast<const float4*>(src);
            const float4 b = *reinterpret_cast<const float4*>(src + 4);
            xr[m][0] = a.x; xr[m][1] = a.y; xr[m][2] = a.z; xr[m][3] = a.w;
            xr[m][4] = b.x; xr[m][5] = b.y; xr[m][6] = b.z; xr[m][7] = b.w;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int n = min(n0 + r, N - 1);
#pragma unroll
            for (int m = 0; m < MB; ++m) {
              float sv, zv;
              if (G == 1) {
                const int o = 2 * ((rg * R + r) * MT + mb + m);
                sv = szv[o];
                zv = szv[o + 1];
              } else {
                const int o = tofs[mb + m] + n * G + g;
                sv = lds(scale + o);
                zv = ldz(zero + o);
              }
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[r][mb + m] = fmaf(xr[m][j], sv * (nib(q[r], j) - zv),
                                      acc[r][mb + m]);
            }
          }
        }
      } else {
        if (G != 1 && word_groups) {
          const int g = k0 / group;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int n = min(n0 + r, N - 1);
            s[r] = lds(scale + (size_t)n * G + g);
            z[r] = ldz(zero + (size_t)n * G + g);
          }
        }
        if (G != 1 && !word_groups) {
          // groups narrower than a word: look the group up per code
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int n = min(n0 + r, N - 1);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int g = (k0 + j) / group;
              const float wj = lds(scale + (size_t)n * G + g) *
                               (nib(q[r], j) - ldz(zero + (size_t)n * G + g));
#pragma unroll
              for (int m = 0; m < MT; ++m)
                acc[r][m] = fmaf(xs[m * kc + (i << 3) + j], wj, acc[r][m]);
            }
          }
          continue;
        }
        // activations of this word position, MB rows of x at a time: read
        // from shared memory once and reused for all R rows (the dequantized
        // weight is recomputed per MB rows, which costs nothing at MT <= 4)
#pragma unroll
        for (int mb = 0; mb < MT; mb += MB) {
          float xr[MB][8];
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            const float* src = xs + (mb + m) * kc + (i << 3);
            const float4 a = *reinterpret_cast<const float4*>(src);
            const float4 b = *reinterpret_cast<const float4*>(src + 4);
            xr[m][0] = a.x; xr[m][1] = a.y; xr[m][2] = a.z; xr[m][3] = a.w;
            xr[m][4] = b.x; xr[m][5] = b.y; xr[m][6] = b.z; xr[m][7] = b.w;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float wj = s[r] * (nib(q[r], j) - z[r]);
#pragma unroll
              for (int m = 0; m < MB; ++m)
                acc[r][mb + m] = fmaf(xr[m][j], wj, acc[r][mb + m]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // lanes → warp total, then the KSPLIT warps of a row group → output
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = acc[r][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[rg][kq][r * MT + m] = v;
    }
  __syncthreads();
  for (int t = threadIdx.x; t < ROW_GROUPS * R * MT; t += THREADS) {
    const int g = t / (R * MT), idx = t - g * (R * MT);
    const int r = idx / MT, m = idx - r * MT;
    const int n = (blockIdx.x * ROW_GROUPS + g) * R + r;
    if (m < M && n < N) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < KSPLIT; ++q) v += red[g][q][idx];
      store(y + (size_t)m * N + n, v);
    }
  }
}

// dynamic shared memory beyond the staged x: K5's per-channel scales and
// row tasks
template <int MT, int R, bool TASKS>
constexpr size_t extra_smem() {
  return TASKS ? (size_t)ROW_GROUPS * R * MT * sizeof(float2) + MT * sizeof(int) : 0;
}

// the draft rescale of K6a: scale·2^shift, zero·2^−shift (1 and 1 else)
struct Planes {
  int planes = 0, shift = 0;
  float s_mul() const { return (float)(1u << shift); }
  float z_mul() const { return 1.0f / (float)(1u << shift); }
};

template <typename T, int MT, int R, bool TASKS, bool PLANES>
cudaError_t launch(const void* x, const void* qw, const void* scale, const void* zero,
                   const int* task_ids, void* y, int M, int N, int K, int G,
                   int n_tasks, Planes pl, int E, cudaStream_t stream) {
  int kc = KC_FIXED;
  if (kc > K) kc = K;
  const size_t smem = (size_t)MT * kc * sizeof(float) + extra_smem<MT, R, TASKS>();
  auto kern = quant_gemv_kernel<T, MT, R, TASKS, PLANES>;
  // allow the largest chunk any launch of this instantiation stages; the
  // attribute belongs to the device, so it is set once per device
  static unsigned long long set_on = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(set_on >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MT * KC_FIXED * sizeof(float) + extra_smem<MT, R, TASKS>()));
    if (err != cudaSuccess) return err;
    set_on |= 1ull << dev;
  }
  const int rows_per_block = ROW_GROUPS * R;
  const dim3 grid((N + rows_per_block - 1) / rows_per_block, 1, E);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      task_ids, static_cast<T*>(y), M, N, K, G, n_tasks, kc,
      pl.planes, pl.s_mul(), pl.z_mul());
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core route
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 8;                  // warps (K slices) of a block
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_BLOCK_K = 64;               // codes of one 8-byte load a lane
constexpr int TC_MAX_SPLIT = 4;              // blocks (a cluster) splitting K
constexpr int TC_FILL_BLOCKS = 264;          // 2 blocks on each of 132 SMs
constexpr int TC_MIN_WARP_BLOCKS = 8;        // 64-code blocks a warp, at least

// S, the blocks whose K slices one 16-channel tile's sums are split over:
// as many as bring the grid to ~2 blocks an SM, at most TC_MAX_SPLIT, and
// at least TC_MIN_WARP_BLOCKS 64-code blocks for each warp.  From (N, K)
// alone, never M.
int tc_block_split(int N, int K) {
  const int tiles = (N + 15) / 16;
  const int most = K / TC_BLOCK_K / (TC_WARPS * TC_MIN_WARP_BLOCKS);
  int s = TC_FILL_BLOCKS / tiles;
  if (s > TC_MAX_SPLIT) s = TC_MAX_SPLIT;
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}
constexpr uint32_t BF16X2_ONE = 0x3F803F80u, BF16X2_M128 = 0xC300C300u;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 8 nibbles of word w as 4 exact bf16 pairs: pair i holds nibbles i
// (low half) and i + 4 (high half).  0x4300 | q is 128 + q in bf16; one
// bf16x2 fma subtracts 128.
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t (&pr)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = ((w >> (4 * i)) & 0x000F000Fu) | 0x43004300u;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(pr[i]) : "r"(v), "r"(BF16X2_ONE), "r"(BF16X2_M128));
  }
}

// The raw code words lane (g, t) reads for one 64-code block of channel n
// (codes 16t .. 16t+15): two packed nibble words (one 8-byte load), or the
// 32-bit word holding those 16 codes in each of the top `planes` planes
// (MSB plane first).  Kept raw until the block is multiplied, so a batch's
// loads stay in flight while the batch before it is.
template <bool PLANES> struct RawCodes;
template <> struct RawCodes<false> { uint2 w; };
template <> struct RawCodes<true> { uint32_t p[4]; };

template <bool PLANES>
__device__ __forceinline__ void load_codes(RawCodes<PLANES>& rc,
                                           const uint32_t* __restrict__ qw, int n,
                                           int b, int t, int K, size_t plane_stride,
                                           int planes) {
  if constexpr (!PLANES) {
    rc.w = __ldg(reinterpret_cast<const uint2*>(qw + (size_t)n * (K >> 3) + 8 * b) + t);
  } else {
    const uint32_t* src = qw + (size_t)n * (K >> 5) + 2 * b + (t >> 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < planes) rc.p[i] = __ldg(src + i * plane_stride);
  }
}

// the two packed nibble words of the lane's 16 codes: as read, or rebuilt
// from the planes (the lane's 16 bits of each, spread to bits 0, 4, …, 28
// and stacked MSB first)
template <bool PLANES>
__device__ __forceinline__ uint2 code_words(const RawCodes<PLANES>& rc, int t,
                                            int planes) {
  if constexpr (!PLANES) {
    return rc.w;
  } else {
    const int sh = (t & 1) * 16;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < planes) {
        const uint32_t bits = rc.p[i] >> sh;
        lo = (lo << 1) | spread8(bits & 0xFFu);
        hi = (hi << 1) | spread8((bits >> 8) & 0xFFu);
      }
    return make_uint2(lo, hi);
  }
}

// NT: n-tiles of 8 rows of x (M <= 8 · NT); TASKS: K5; PLANES: K6a.
// A cluster of `split` blocks owns 16 channels; warp w of block rank r sums
// K slice 8r + w (64-code blocks [i·nb/(8·split), (i+1)·nb/(8·split)) for
// i = 8r + w) for them, each A fragment (unpacked codes) reused
// across the NT n-tiles.  At NT = 1 (M <= 8) a warp keeps two batches of 2
// blocks in registers, the raw words of one in flight while the other is
// unpacked and multiplied, and reads per-channel scales before the sums;
// at larger NT one batch of 4 / NT blocks at a time (a second batch spilled
// under the 128-register budget of 2 blocks an SM and ran slower:
// kernels/gemv_variants.py).  At the end the 8·split slices' partial y
// meet in the cluster's shared memory, added in slice order; each block
// writes every split-th output.
template <int NT, bool TASKS, bool PLANES>
__global__ void __launch_bounds__(TC_THREADS, 2) quant_gemv_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ qw,
    const float* __restrict__ scale, const float* __restrict__ zero,
    const int* __restrict__ task_ids, __nv_bfloat16* __restrict__ y,
    int M, int N, int K, int G, int n_tasks, int planes, float s_mul,
    float z_mul, int split) {
  constexpr bool PIPE = NT == 1;
  constexpr int UNR = PIPE ? 2 : 4 / NT;      // 64-code blocks a batch
  __shared__ float red[TC_WARPS][16][8 * NT];
  EXPERT_SLICE(x, qw, scale, zero, y, M, N, K, G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % split, n0 = blockIdx.x / split * 16;
  const int nb = K / TC_BLOCK_K, slices = TC_WARPS * split;
  const int slice = rank * TC_WARPS + warp;
  const int beg = slice * nb / slices, end = (slice + 1) * nb / slices;
  const int group = K / G;
  const size_t plane_stride = (size_t)N * (K >> 5);
  // the lane's two channels (clamped: channels >= N compute garbage, never
  // stored); for its outputs (rows 8j + 2t + e) the offset into the scale
  // stacks (K5)
  const int ch[2] = {min(n0 + g, N - 1), min(n0 + g + 8, N - 1)};
  int toff[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * t + e;
      toff[j][e] = TASKS && m < M
          ? min(max(__ldg(task_ids + m), 0), n_tasks - 1) * N * G : 0;
    }
  auto lds = [&](size_t o) { return PLANES ? __ldg(scale + o) * s_mul : __ldg(scale + o); };
  auto ldz = [&](size_t o) { return PLANES ? __ldg(zero + o) * z_mul : __ldg(zero + o); };
  auto sz_off = [&](int j, int e, int gi) {
    return (size_t)toff[j][e & 1] + (size_t)ch[e >> 1] * G + gi;
  };
  // per-channel scales read before the sums (NT = 1), so their latency
  // hides behind the codes'
  float sp[NT][4], zp[NT][4];
  if (PIPE && G == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sp[j][e] = lds(sz_off(j, e, 0));
        zp[j][e] = ldz(sz_off(j, e, 0));
      }
  }

  float yacc[NT][4], acc[NT][4], rs[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = acc[j][e] = rs[j][e] = 0.f;
  // y += s·(A − z·R) for the group `gi` piece just summed, then restart
  auto flush = [&](int gi) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = PIPE && G == 1 ? sp[j][e] : lds(sz_off(j, e, gi));
        const float zv = PIPE && G == 1 ? zp[j][e] : ldz(sz_off(j, e, gi));
        yacc[j][e] += sv * (acc[j][e] - zv * rs[j][e & 1]);
        acc[j][e] = 0.f;
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[j][e] = 0.f;
  };
  const uint32_t ones[4] = {BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE};
  // a batch's operands: per block the lane's raw code words of its 2
  // channels, and 16 bf16 of x row 8j + g for each n-tile j (zero past M)
  struct Batch {
    RawCodes<PLANES> q[UNR][2];
    uint4 xv[UNR][NT][2];
  };
  auto load = [&](Batch& bt, int b0) {
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int b = b0 + u;
      if (b < end) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          load_codes<PLANES>(bt.q[u][r], qw, ch[r], b, t, K, plane_stride, planes);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int m = 8 * j + g;
          if (m < M) {
            const uint4* src = reinterpret_cast<const uint4*>(
                x + (size_t)m * K + b * TC_BLOCK_K + 16 * t);
            bt.xv[u][j][0] = __ldg(src);
            bt.xv[u][j][1] = __ldg(src + 1);
          } else {
            bt.xv[u][j][0] = bt.xv[u][j][1] = make_uint4(0, 0, 0, 0);
          }
        }
      }
    }
  };
  int cur = beg * TC_BLOCK_K / group;
  auto compute = [&](const Batch& bt, int b0) {
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int b = b0 + u;
      if (b >= end) break;
      const int gi = b * TC_BLOCK_K / group;
      if (gi != cur) {
        flush(cur);
        cur = gi;
      }
      // pr[r][h][i]: channel g + 8r, word h (codes 16t + 8h ..), the bf16
      // pair of its codes i and i + 4
      uint32_t pr[2][2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint2 w = code_words<PLANES>(bt.q[u][r], t, planes);
        unpack_word(w.x, pr[r][0]);
        unpack_word(w.y, pr[r][1]);
      }
      // k-step s (word h = s / 2, i = 2 (s % 2)): mma columns 2t, 2t+1 are
      // the lane's codes 8h + i and 8h + i + 4, columns 2t+8, 2t+9 codes
      // 8h + i + 1 and 8h + i + 5; B takes the same x elements, paired by
      // a byte permute
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int h = s >> 1, i = 2 * (s & 1);
        const uint32_t a[4] = {pr[0][h][i], pr[1][h][i], pr[0][h][i + 1],
                               pr[1][h][i + 1]};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint4& v = bt.xv[u][j][h];
          const uint32_t lo = (s & 1) ? v.y : v.x, hi = (s & 1) ? v.w : v.z;
          const uint32_t b0r = __byte_perm(lo, hi, 0x5410);
          const uint32_t b1r = __byte_perm(lo, hi, 0x7632);
          mma16816(acc[j], a, b0r, b1r);
          mma16816(rs[j], ones, b0r, b1r);
        }
      }
    }
  };
  if constexpr (PIPE) {
    // two batches in registers: while one is multiplied the other loads
    Batch ba, bb;
    if (beg < end) load(ba, beg);
    for (int b0 = beg; b0 < end; b0 += 2 * UNR) {
      if (b0 + UNR < end) load(bb, b0 + UNR);
      compute(ba, b0);
      if (b0 + UNR >= end) break;
      if (b0 + 2 * UNR < end) load(ba, b0 + 2 * UNR);
      compute(bb, b0 + UNR);
    }
  } else {
    for (int b0 = beg; b0 < end; b0 += UNR) {
      Batch bt;
      load(bt, b0);
      compute(bt, b0);
    }
  }
  if (beg < end) flush(cur);

  // the 8·split slices' partial y, summed in slice order (block rank,
  // then warp); block `rank` writes outputs rank, rank + split, ...
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[warp][g + 8 * (e >> 1)][8 * j + 2 * t + (e & 1)] = yacc[j][e];
  float* own = &red[0][0][0];
  if (split > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  for (int i = threadIdx.x * split + rank; i < 16 * 8 * NT;
       i += TC_THREADS * split) {
    const int m = i >> 4, c = i & 15;
    if (m < M && n0 + c < N) {
      float v = 0.f;
      for (int r = 0; r < split; ++r) {
        const float* part =
            split > 1 ? cg::this_cluster().map_shared_rank(own, r) : own;
#pragma unroll
        for (int w = 0; w < TC_WARPS; ++w) v += part[(w * 16 + c) * 8 * NT + m];
      }
      y[(size_t)m * N + n0 + c] = __float2bfloat16_rn(v);
    }
  }
  // no block leaves while another may still read its partial sums
  if (split > 1) cg::this_cluster().sync();
}

template <int NT, bool TASKS, bool PLANES>
cudaError_t launch_tc(const void* x, const void* qw, const void* scale,
                      const void* zero, const int* task_ids, void* y, int M,
                      int N, int K, int G, int n_tasks, Planes pl, int E,
                      cudaStream_t stream) {
  const int split = tc_block_split(N, K);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 15) / 16 * split, 1, E);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, quant_gemv_tc_kernel<NT, TASKS, PLANES>,
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      task_ids, static_cast<__nv_bfloat16*>(y), M, N, K, G, n_tasks,
      pl.planes, pl.s_mul(), pl.z_mul(), split);
}

template <bool TASKS, bool PLANES>
cudaError_t dispatch_tc(const void* x, const void* qw, const void* scale,
                        const void* zero, const int* task_ids, void* y, int M,
                        int N, int K, int G, int n_tasks, Planes pl, int E,
                        cudaStream_t s) {
  if (M <= 8) return launch_tc<1, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
  if (M <= 16) return launch_tc<2, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
  return launch_tc<4, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
}

// the tensor-core route's shapes (quant_matmul.tc_route on the host)
bool tc_route(int x_is_bf16, int K, int G) {
  return x_is_bf16 && K % TC_BLOCK_K == 0 && (K / G) % TC_BLOCK_K == 0;
}

// the (MT, R) instantiation for M rows: K1 and K5, nibble or plane, share
// it, so a row's K chunking and reduction order are the same in all four
template <typename T, bool TASKS, bool PLANES>
cudaError_t dispatch(const void* x, const void* qw, const void* scale, const void* zero,
                     const int* task_ids, void* y, int M, int N, int K, int G,
                     int n_tasks, Planes pl, int E, cudaStream_t s) {
  if (M <= 1) return launch<T, 1, 8, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
  if (M <= 2) return launch<T, 2, 8, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
  if (M <= 4) return launch<T, 4, 8, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
  if (M <= 8) return launch<T, 8, 4, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
  if (M <= 16) return launch<T, 16, 2, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
  return launch<T, 32, 1, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, E, s);
}

template <bool TASKS, bool PLANES>
int run(const void* x, const void* qw, const void* scale, const void* zero,
        const void* task_ids, void* y, int M, int N, int K, int G, int T,
        Planes pl, int x_is_bf16, void* stream, int E = 1) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(task_ids);
  if (tc_route(x_is_bf16, K, G))
    return (int)dispatch_tc<TASKS, PLANES>(x, qw, scale, zero, ids, y, M, N, K, G, T, pl, E, s);
  cudaError_t err = x_is_bf16
      ? dispatch<__nv_bfloat16, TASKS, PLANES>(x, qw, scale, zero, ids, y, M, N, K, G, T, pl, E, s)
      : dispatch<float, TASKS, PLANES>(x, qw, scale, zero, ids, y, M, N, K, G, T, pl, E, s);
  return (int)err;
}

bool bad_dims(int M, int N, int K, int G) {
  return M < 1 || M > 32 || N < 1 || K < 8 || K % 8 || G < 1 || K % G;
}

bool bad_tasks(int N, int G, int T) {
  return T < 1 || (long long)T * N * G > 0x7fffffffLL;  // stack offsets are 32-bit
}

bool bad_planes(int K, Planes pl) {
  return K % 32 || pl.planes < 1 || pl.planes > 4 || pl.shift < 0 || pl.shift > 7;
}

}  // namespace

// Every entry point returns the CUDA error code of the launch (0 on
// success).  The caller has checked shapes, dtypes, devices and
// contiguity; these checks only refuse what would index out of bounds.
extern "C" int quant_gemv(const void* x, const void* qw, const void* scale,
                          const void* zero, void* y, int M, int N, int K, int G,
                          int x_is_bf16, void* stream) {
  if (bad_dims(M, N, K, G)) return (int)cudaErrorInvalidValue;
  return run<false, false>(x, qw, scale, zero, nullptr, y, M, N, K, G, 1,
                           Planes{}, x_is_bf16, stream);
}

// K5: scale and zero are (T, N, G) stacks, task_ids (M,) int32 on the device.
extern "C" int quant_gemv_tasks(const void* x, const void* qw, const void* scale,
                                const void* zero, const void* task_ids, void* y,
                                int M, int N, int K, int G, int T,
                                int x_is_bf16, void* stream) {
  if (bad_dims(M, N, K, G) || bad_tasks(N, G, T)) return (int)cudaErrorInvalidValue;
  return run<true, false>(x, qw, scale, zero, task_ids, y, M, N, K, G, T,
                          Planes{}, x_is_bf16, stream);
}

// K6a, K1's plane branch: qw (bits' >= planes, N, K/32); the top `planes`
// planes are read under scale·2^shift, zero·2^−shift.
extern "C" int quant_gemv_planes(const void* x, const void* qw, const void* scale,
                                 const void* zero, void* y, int M, int N, int K,
                                 int G, int planes, int shift, int x_is_bf16,
                                 void* stream) {
  const Planes pl{planes, shift};
  if (bad_dims(M, N, K, G) || bad_planes(K, pl)) return (int)cudaErrorInvalidValue;
  return run<false, true>(x, qw, scale, zero, nullptr, y, M, N, K, G, 1, pl,
                          x_is_bf16, stream);
}

// K1 over an expert axis: x (E, M, K), qw (E, N, K/8) nibble words, scale
// and zero (E, N, G), y (E, M, N); slice e is quant_gemv on expert e's
// operands, bit for bit (EXPERT_SLICE).
extern "C" int quant_gemv_experts(const void* x, const void* qw, const void* scale,
                                  const void* zero, void* y, int E, int M, int N,
                                  int K, int G, int x_is_bf16, void* stream) {
  if (bad_dims(M, N, K, G) || E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  return run<false, false>(x, qw, scale, zero, nullptr, y, M, N, K, G, 1,
                           Planes{}, x_is_bf16, stream, E);
}

// The tensor-core route's K split over blocks for an (N, K) layer, for the
// tests and the build report.
extern "C" int quant_gemv_tc_split(int N, int K) { return tc_block_split(N, K); }

// K6a, K5's plane branch.
extern "C" int quant_gemv_tasks_planes(const void* x, const void* qw,
                                       const void* scale, const void* zero,
                                       const void* task_ids, void* y, int M, int N,
                                       int K, int G, int T, int planes, int shift,
                                       int x_is_bf16, void* stream) {
  const Planes pl{planes, shift};
  if (bad_dims(M, N, K, G) || bad_tasks(N, G, T) || bad_planes(K, pl))
    return (int)cudaErrorInvalidValue;
  return run<true, true>(x, qw, scale, zero, task_ids, y, M, N, K, G, T, pl,
                         x_is_bf16, stream);
}
