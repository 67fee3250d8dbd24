// K1: decode GEMV  y = x · Ŵᵀ,  Ŵ = s · (q − z)  from packed 4-bit codes,
// and K5: the same GEMV with per-row task scales,
//   y[m, n] = Σ_k x[m, k] · s[t_m, n, g(k)] · (q[n, k] − z[t_m, n, g(k)]),
//   t_m = task_ids[m],
// and K6a: both read from bit-planes (PLANES = true).
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
// dequantize + FMA instruction count per code is close to what the card can
// issue at HBM rate; a later kernel moves to packed bf16 math or tensor cores.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KSPLIT = 4;                    // warps sharing one row group
constexpr int ROW_GROUPS = 2;                // row groups per block
constexpr int WARPS = KSPLIT * ROW_GROUPS;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_X_FLOATS = 16384;         // 64 KB of staged activations

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
                   int n_tasks, Planes pl, cudaStream_t stream) {
  int kc = (SMEM_X_FLOATS / MT) & ~7;
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
        (int)(SMEM_X_FLOATS * sizeof(float) + extra_smem<MT, R, TASKS>()));
    if (err != cudaSuccess) return err;
    set_on |= 1ull << dev;
  }
  const int rows_per_block = ROW_GROUPS * R;
  const dim3 grid((N + rows_per_block - 1) / rows_per_block);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      task_ids, static_cast<T*>(y), M, N, K, G, n_tasks, kc,
      pl.planes, pl.s_mul(), pl.z_mul());
  return cudaGetLastError();
}

// the (MT, R) instantiation for M rows: K1 and K5, nibble or plane, share
// it, so a row's K chunking and reduction order are the same in all four
template <typename T, bool TASKS, bool PLANES>
cudaError_t dispatch(const void* x, const void* qw, const void* scale, const void* zero,
                     const int* task_ids, void* y, int M, int N, int K, int G,
                     int n_tasks, Planes pl, cudaStream_t s) {
  if (M <= 1) return launch<T, 1, 8, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, s);
  if (M <= 2) return launch<T, 2, 8, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, s);
  if (M <= 4) return launch<T, 4, 8, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, s);
  if (M <= 8) return launch<T, 8, 4, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, s);
  if (M <= 16) return launch<T, 16, 2, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, s);
  return launch<T, 32, 1, TASKS, PLANES>(x, qw, scale, zero, task_ids, y, M, N, K, G, n_tasks, pl, s);
}

template <bool TASKS, bool PLANES>
int run(const void* x, const void* qw, const void* scale, const void* zero,
        const void* task_ids, void* y, int M, int N, int K, int G, int T,
        Planes pl, int x_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(task_ids);
  cudaError_t err = x_is_bf16
      ? dispatch<__nv_bfloat16, TASKS, PLANES>(x, qw, scale, zero, ids, y, M, N, K, G, T, pl, s)
      : dispatch<float, TASKS, PLANES>(x, qw, scale, zero, ids, y, M, N, K, G, T, pl, s);
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
