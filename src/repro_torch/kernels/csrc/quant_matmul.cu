// K2: prefill GEMM  y = x · Ŵᵀ,  Ŵ = s · (q − z)  from packed 4-bit codes,
// and K6a's GEMM: the same from bit-planes (PLANES = true).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul_pallas
// (_qmm_kernel).  Same semantics: x (M, K) in bf16 or f32, qw (N, K/8)
// 32-bit words of 8 nibble codes (code i in bits 4i..4i+3), scale and zero
// (N, G) f32 over groups of K/G consecutive codes, dequantization s·(q − z)
// in f32 exactly as the plain version computes it, f32 products and f32
// accumulation (the TPU kernel dots f32 operands), y (M, N) in x's dtype.
//
// What bounds it on an H100: operations.  At M = 1024 every code is used for
// 1024 FMAs; in f32 on CUDA cores the card peaks at 67 TFLOP/s, against
// 989 TFLOP/s for bf16 tensor cores, so this kernel is far from the bf16
// bound by construction (a later kernel moves to wgmma with bf16 operands,
// which changes the numerics).  The design is the classic register-blocked
// SIMT GEMM:
//   * a 256-thread block owns a 128 × 128 output tile and walks K in steps
//     of 16, double-buffered: while the block multiplies one step out of
//     shared memory, each thread already holds the next step's x (16-byte
//     vectors) and packed word in registers;
//   * each step stages the x tile and the dequantized Ŵ tile in shared
//     memory, both transposed to k-major so the inner loop reads them with
//     conflict-free 16-byte loads; the codes are dequantized once per tile,
//     on the way into shared memory, with the (row, k / group) scale — a
//     group may span any number of K steps, there is no alignment rule;
//   * each thread keeps an 8 × 8 block of outputs in registers, so every
//     shared-memory value it loads feeds 8 FMAs;
//   * ragged M, N and K edges are masked with zeros.
//
// K6a replaces the plane branch of quant_matmul_pallas (_unpack_planes at
// repro/kernels/quant_matmul.py:98, reached at :195): qw is (bits', N, K/32)
// bit-planes, MSB plane first, of which the top `planes` are read, under
// scale·2^shift and zero·2^−shift.  As in quant_gemv.cu, the thread that
// loads packed word w of a row rebuilds it from byte w & 3 of plane word
// w >> 2 of each plane, so the tile store and the product are K2's,
// unchanged: bit for bit K2 on the nibble words of those codes under the
// rescaled scales.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;                       // keeps rows 16-byte aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float nib(uint32_t word, int j) {
  return __uint_as_float(0x4B000000u | ((word >> (4 * j)) & 0xFu)) - 8388608.0f;
}

// the 8 bits of a byte moved to bits 0, 4, …, 28
__device__ __forceinline__ uint32_t spread8(uint32_t b) {
  b = (b | (b << 12)) & 0x000F000Fu;
  b = (b | (b << 6)) & 0x03030303u;
  return (b | (b << 3)) & 0x11111111u;
}

// K6a's operands: the planes read and the draft rescale (0 planes: nibbles)
struct Planes {
  int planes;
  float s_mul, z_mul;
};

// packed word w (codes 8w..8w+7) of row n as nibbles: read from the nibble
// words, or rebuilt from the top planes (MSB first; words = K/8, the plane
// stride N·K/32 words)
template <bool PLANES>
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ qw,
                                              int n, int w, int N, int words,
                                              int planes) {
  if constexpr (!PLANES) {
    return __ldg(qw + (size_t)n * words + w);
  } else {
    const size_t plane_stride = (size_t)N * (words >> 2);
    const uint32_t* src = qw + (size_t)n * (words >> 2) + (w >> 2);
    const int sh = (w & 3) * 8;
    uint32_t out = 0;
#pragma unroll 4
    for (int i = 0; i < planes; ++i)
      out = (out << 1) | spread8((__ldg(src + i * plane_stride) >> sh) & 0xFFu);
    return out;
  }
}

// One K step's global operands, held in registers while the previous step
// computes: NX 16-byte vectors of x and one packed word of qw per thread.
template <typename T>
struct Stage {
  static constexpr int VEC = 16 / sizeof(T);              // x elements per vector
  static constexpr int NX = BM * BK / VEC / THREADS;      // vectors per thread
  uint4 xv[NX];
  uint32_t q;
};

template <typename T, bool PLANES>
__device__ __forceinline__ void load_stage(Stage<T>& st, const T* __restrict__ x,
                                           const uint32_t* __restrict__ qw, int m0,
                                           int n0, int k0, int M, int N, int K,
                                           int planes) {
  constexpr int VEC = Stage<T>::VEC, PER_ROW = BK / VEC;
#pragma unroll
  for (int i = 0; i < Stage<T>::NX; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int m = v / PER_ROW, k = (v % PER_ROW) * VEC;
    const int gm = m0 + m, gk = k0 + k;                   // K % 8 == 0: whole vectors
    st.xv[i] = (gm < M && gk < K)
        ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk))
        : make_uint4(0u, 0u, 0u, 0u);
  }
  const int n = threadIdx.x / (BK / 8), wi = threadIdx.x % (BK / 8);
  const int gn = n0 + n, gw = (k0 >> 3) + wi, words = K >> 3;
  st.q = (gn < N && gw < words) ? load_word<PLANES>(qw, gn, gw, N, words, planes)
                                 : 0u;
}

// Registers → shared memory, x transposed to k-major and the codes
// dequantized with their (row, k / group) scale and zero.
template <typename T, bool PLANES>
__device__ __forceinline__ void store_stage(const Stage<T>& st, float (*xs)[BM + PAD],
                                            float (*ws)[BN + PAD],
                                            const float* __restrict__ scale,
                                            const float* __restrict__ zero, int n0,
                                            int k0, int N, int K, int G,
                                            const Planes& pl) {
  constexpr int VEC = Stage<T>::VEC, PER_ROW = BK / VEC;
#pragma unroll
  for (int i = 0; i < Stage<T>::NX; ++i) {
    const int v = threadIdx.x + i * THREADS;
    const int m = v / PER_ROW, k = (v % PER_ROW) * VEC;
    const T* t = reinterpret_cast<const T*>(&st.xv[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) xs[k + j][m] = to_f32(t[j]);
  }
  const int n = threadIdx.x / (BK / 8), wi = threadIdx.x % (BK / 8);
  const int gn = n0 + n, kw = k0 + wi * 8;
  const bool live = gn < N && kw < K;
  const int group = K / G;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v = 0.f;
    if (live) {
      const int g = (kw + j) / group;
      float sv = __ldg(scale + (size_t)gn * G + g);
      float zv = __ldg(zero + (size_t)gn * G + g);
      if constexpr (PLANES) {
        sv *= pl.s_mul;
        zv *= pl.z_mul;
      }
      v = sv * (nib(st.q, j) - zv);
    }
    ws[wi * 8 + j][n] = v;
  }
}

template <typename T, bool PLANES>
__global__ void __launch_bounds__(THREADS, 2) quant_matmul_kernel(
    const T* __restrict__ x, const uint32_t* __restrict__ qw,
    const float* __restrict__ scale, const float* __restrict__ zero,
    T* __restrict__ y, int M, int N, int K, int G, Planes pl) {
  // two buffers: the step being multiplied and the step being staged
  __shared__ __align__(16) float xs[2][BK][BM + PAD];  // xs[k][m]
  __shared__ __align__(16) float ws[2][BK][BN + PAD];  // ws[k][n] = Ŵ[n][k]
  static_assert(BN * BK / 8 == THREADS, "one packed word per thread per step");

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  Stage<T> st;
  load_stage<T, PLANES>(st, x, qw, m0, n0, 0, M, N, K, pl.planes);
  store_stage<T, PLANES>(st, xs[0], ws[0], scale, zero, n0, 0, N, K, G, pl);
  __syncthreads();

  const int steps = (K + BK - 1) / BK;
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < steps;
    if (more) load_stage<T, PLANES>(st, x, qw, m0, n0, (t + 1) * BK, M, N, K, pl.planes);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise with tx
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step t - 1, which every thread
    // finished before the barrier that ended it
    if (more) store_stage<T, PLANES>(st, xs[buf ^ 1], ws[buf ^ 1], scale, zero, n0,
                                     (t + 1) * BK, N, K, G, pl);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn < N) store(y + (size_t)gm * N + gn, acc[i][j]);
    }
  }
}

template <typename T, bool PLANES>
cudaError_t launch(const void* x, const void* qw, const void* scale, const void* zero,
                   void* y, int M, int N, int K, int G, Planes pl,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_kernel<T, PLANES><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<T*>(y), M, N, K, G, pl);
  return cudaGetLastError();
}

template <bool PLANES>
int run(const void* x, const void* qw, const void* scale, const void* zero,
        void* y, int M, int N, int K, int G, Planes pl, int x_is_bf16,
        void* stream) {
  if (M < 1 || M > 65535 * BM || N < 1 || K < 8 || K % 8 || G < 1 || K % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_is_bf16
      ? launch<__nv_bfloat16, PLANES>(x, qw, scale, zero, y, M, N, K, G, pl, s)
      : launch<float, PLANES>(x, qw, scale, zero, y, M, N, K, G, pl, s);
  return (int)err;
}

}  // namespace

// Both entry points return the CUDA error code of the launch (0 on
// success).  The caller has checked shapes, dtypes, devices and
// contiguity; these checks only refuse what would index out of bounds.
extern "C" int quant_matmul(const void* x, const void* qw, const void* scale,
                            const void* zero, void* y, int M, int N, int K, int G,
                            int x_is_bf16, void* stream) {
  return run<false>(x, qw, scale, zero, y, M, N, K, G, Planes{0, 1.f, 1.f},
                    x_is_bf16, stream);
}

// K6a's GEMM: qw (bits' >= planes, N, K/32); the top `planes` planes are
// read under scale·2^shift, zero·2^−shift.
extern "C" int quant_matmul_planes(const void* x, const void* qw, const void* scale,
                                   const void* zero, void* y, int M, int N, int K,
                                   int G, int planes, int shift, int x_is_bf16,
                                   void* stream) {
  if (K % 32 || planes < 1 || planes > 4 || shift < 0 || shift > 7)
    return (int)cudaErrorInvalidValue;
  const Planes pl{planes, (float)(1u << shift), 1.0f / (float)(1u << shift)};
  return run<true>(x, qw, scale, zero, y, M, N, K, G, pl, x_is_bf16, stream);
}
