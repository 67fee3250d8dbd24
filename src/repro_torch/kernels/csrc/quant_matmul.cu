// K2: prefill GEMM  y = x · Ŵᵀ,  Ŵ = s · (q − z)  from packed 4-bit codes,
// and K6a's GEMM: the same from bit-planes (PLANES = true).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul_pallas
// (_qmm_kernel).  Operands: x (M, K) in bf16 or f32, qw (N, K/8) 32-bit
// words of 8 nibble codes (code i in bits 4i..4i+3), scale and zero (N, G)
// f32 over groups of K/G consecutive codes, y (M, N) in x's dtype.
//
// What bounds the function on an H100: operations.  At M = 1024 every code
// is used for 1024 multiply-adds, so the card's tensor cores (989 TFLOP/s in
// bf16, 67 in f32 on the CUDA cores) would set the pace.  Two routes
// behind one entry point:
//
// * The tensor-core route (quant_matmul_tc_kernel): bf16 x, K % 64 == 0 and
//   a group size K/G that is a multiple of 64 (per-channel included) — every
//   llama3.2-1b linear.  A bf16 x and a 4-bit code (0..15; q >> shift for a
//   plane draft) are both exact in bf16, so Ŵ is never rounded: per group g
//       y[m,n] = Σ_g s[n,g] · (Σ_{k∈g} x[m,k]·q[n,k] − z[n,g] · Σ_{k∈g} x[m,k])
//   The first inner sum is a bf16 × bf16 wgmma product (m64nNk16, sm_90a)
//   with f32 accumulators in registers; every product in it is exact.  The
//   second, the row sum of x, is an m64n8k16 wgmma of the same x tile with
//   a constant B tile of ones, issued beside each k-step's product, so each
//   thread holds its own rows' sums beside their dots.  At the end of each
//   group s and z apply once, in registers (per-channel: once, in the
//   epilogue, from global memory), and the accumulators restart.
//   Operand staging: a ring of 4 shared-memory stages filled with cp.async
//   (x tiles of BM × 64 bf16, the packed words — or the top planes — of
//   BN × 64 codes, and, for per-group scales, the scale and zero of the
//   tile's group); each tile's codes are unpacked once in shared memory
//   into bf16 (0x4300 | q is 128 + q; minus 128), K-major (the "TN" case)
//   in the 128-byte swizzle layout, into one of two B tiles while the
//   wgmmas of the tile before run asynchronously on the other.
//   A block is 1 or 2 consumer warpgroups of 64 rows each; the host picks
//   the largest tile whose grid fills 3/4 of a wave on the card's SMs:
//   128 × 256 (per-channel only: one set of accumulators, 128 a thread),
//   128 × 128, else 64 × 64 (the 512-wide k/v projections at M = 1024: 128
//   blocks, not 32).  At M = 1024 that is 128 × 256 for the 8192-wide
//   gate and up projections and 128 × 128 for the 2048-wide ones; the
//   wider tile reads x once for every 256 columns, not 128.  Every loop
//   over a tile's copies, unpack and stores has a fixed trip count (whole
//   rounds of the block's threads), so it compiles to straight-line code.
//   The output tile goes through shared memory so y is written in whole
//   16-byte vectors.  Every tile takes over 48 KB of dynamic shared
//   memory, set once with cudaFuncSetAttribute.  What holds it back
//   (kernels/tc_variants.py): a tile's unpack and the wgmmas of the tile
//   before share the SM's shared memory and barely overlap, so the two
//   costs add.  One producer warpgroup (copies and unpack) feeding the
//   two consumer warpgroups through mbarriers was slower: four warps do
//   not unpack as fast as the tensor cores consume.
// * The SIMT route (quant_matmul_kernel): f32 x (no model path feeds f32 to
//   K2 on the card), K ≡ 8, 16, …, 56 (mod 64), and groups that are not a
//   multiple of 64 codes (the tests' groups of 12 and 32).  Dequantization
//   s·(q − z) in f32 exactly as the plain version computes it, f32 products
//   and f32 accumulation, the classic register-blocked SIMT GEMM:
//     - a 256-thread block owns a 128 × 128 output tile and walks K in steps
//       of 16, double-buffered: while the block multiplies one step out of
//       shared memory, each thread already holds the next step's x (16-byte
//       vectors) and packed word in registers;
//     - each step stages the x tile and the dequantized Ŵ tile in shared
//       memory, both transposed to k-major; the codes are dequantized once
//       per tile with the (row, k / group) scale;
//     - each thread keeps an 8 × 8 block of outputs in registers;
//     - ragged M, N and K edges are masked with zeros.
//
// K6a replaces the plane branch of quant_matmul_pallas (_unpack_planes at
// repro/kernels/quant_matmul.py:98, reached at :195): qw is (bits', N, K/32)
// bit-planes, MSB plane first, of which the top `planes` are read, under
// scale·2^shift and zero·2^−shift.  As in quant_gemv.cu, packed word w of a
// row is rebuilt from byte w & 3 of plane word w >> 2 of each plane before
// the unpack, so the rest of each route is K2's, unchanged: bit for bit K2
// on the nibble words of those codes under the rescaled scales (the tile
// choice depends on M, N and G only).
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

// The expert axis (quant_matmul_experts): one launch over gridDim.z
// experts, each with its own x (M, K), nibble words (N, K/8), scale and
// zero (N, G) and y (M, N), all experts of one shape and stored one after
// another (an MoE block's (E, C, K) rows and its (E, N, …) expert stacks).
// Block z advances the operands to expert z's slices and then runs the 2-D
// launch's tile code unchanged — with the tile shape the 2-D launch of one
// expert would pick —, so slice z of the result is bit for bit the 2-D
// kernel on expert z's operands; a 2-D launch is z = 0 alone.
#define EXPERT_SLICE(x, qw, scale, zero, y, M, N, K, G)          \
  do {                                                            \
    const size_t e_ = blockIdx.z;                                 \
    x += e_ * (size_t)(M) * (K);                                  \
    qw += e_ * (size_t)(N) * ((K) >> 3);                          \
    scale += e_ * (size_t)(N) * (G);                              \
    zero += e_ * (size_t)(N) * (G);                               \
    y += e_ * (size_t)(M) * (N);                                  \
  } while (0)

template <typename T, bool PLANES>
__global__ void __launch_bounds__(THREADS, 2) quant_matmul_kernel(
    const T* __restrict__ x, const uint32_t* __restrict__ qw,
    const float* __restrict__ scale, const float* __restrict__ zero,
    T* __restrict__ y, int M, int N, int K, int G, Planes pl) {
  // two buffers: the step being multiplied and the step being staged
  __shared__ __align__(16) float xs[2][BK][BM + PAD];  // xs[k][m]
  __shared__ __align__(16) float ws[2][BK][BN + PAD];  // ws[k][n] = Ŵ[n][k]
  static_assert(BN * BK / 8 == THREADS, "one packed word per thread per step");

  EXPERT_SLICE(x, qw, scale, zero, y, M, N, K, G);
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
                   void* y, int M, int N, int K, int G, Planes pl, int E,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  quant_matmul_kernel<T, PLANES><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<T*>(y), M, N, K, G, pl);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The tensor-core route
namespace tc {

constexpr int BK = 64;                       // codes a tile row: 8 packed words
constexpr int CH = BK / 8;                   // 16-byte chunks a tile row
constexpr int STAGES = 4;                    // cp.async ring

// K-major operand tile of `rows` rows × BK bf16 in the wgmma 128-byte
// swizzle layout: a row's 64 codes are one 128-byte line, 8-row groups 1024
// bytes apart (the stride byte offset, SBO), and the 16-byte chunk c of row
// r sits at chunk c ^ (r % 8) of its line, so the 8 rows of a core matrix —
// and a quarter warp's stores of one row — fall on 8 different bank quads.
// A tile starts on 1024 bytes; the k-step ks of 16 codes starts 32·ks bytes
// in (the hardware applies the swizzle to the address).
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * 128; }
__host__ __device__ constexpr int align1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }
constexpr int SBO = 1024;
constexpr int ONES_BYTES = tile_bytes(8);    // the B tile of 8 rows of ones

// BM × BN output tiles, one consumer warpgroup a 64-row slice.  GROUPS:
// the tile keeps per-group partial sums (registers for two sets of
// accumulators); the 128 × 256 tile has room for one set only and takes
// per-channel scales alone.
template <int BN_, int WGS_>
struct Cfg {
  static constexpr int BN = BN_, WGS = WGS_;
  static constexpr int BM = 64 * WGS, THREADS = 128 * WGS;
  static constexpr int NR = BN / 2;          // accumulators a thread
  static constexpr bool GROUPS = BN < 256;
  static constexpr int X_BYTES = tile_bytes(BM);
  static constexpr int RAW_BYTES = BN * 32;  // 8 nibble words, or 4 × 2 plane words, a row
  static constexpr int SZ_BYTES = GROUPS ? 2 * BN * 4 : 0;  // the tile's group's scale and zero
  static constexpr int STAGE_BYTES = align1k(X_BYTES + RAW_BYTES + SZ_BYTES);
  static constexpr int B_BYTES = tile_bytes(BN);
  static constexpr int Y_LD = BN + 8;        // output tile row in shared memory, bf16
  // + 1 KB: the dynamic shared memory is aligned to 1024 bytes by hand
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * B_BYTES + ONES_BYTES + 1024;
  static_assert(BM * Y_LD * 2 <= STAGES * STAGE_BYTES, "the output tile reuses the ring");
  // every thread makes the same number of copies, unpacks and stores
  static_assert((2 * BN) % THREADS == 0 && (BM * 8) % THREADS == 0 && (BN * 8) % THREADS == 0,
                "whole rounds of the block's threads");
};
using Small = Cfg<64, 1>;
using Big = Cfg<128, 2>;
using Wide = Cfg<256, 2>;

__device__ __forceinline__ int chunk_off(int r, int c) {
  return (r >> 3) * SBO + (r & 7) * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address and SBO in 16-byte
// units, LBO 1 (not read for a swizzled K-major tile), base offset 0 (tiles
// start on 1024 bytes), layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(SBO >> 4) << 32) | (1ull << 62);
}

// 16 or 8 or 4 bytes global → shared, zero-filled when !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 8 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across the wgmmas
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// D (64 × N, f32, in registers) += A (64 × 16) · B (N × 16)ᵀ, both bf16
// K-major in shared memory (the descriptors); N / 2 accumulators a thread
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256) wgmma_n256(d, da, db);
  else if constexpr (N == 128) wgmma_n128(d, da, db);
  else wgmma_n64(d, da, db);
}

// one tile's cp.async copies (tile t, codes k0 = t·BK) into a stage: x,
// the codes, and (per-group scales only) the scale and zero of the tile's
// group for the block's BN columns
template <class C, bool PLANES>
__device__ __forceinline__ void load_tile(uint8_t* stage, const __nv_bfloat16* __restrict__ x,
                                          const uint32_t* __restrict__ qw,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ zero, int m0, int n0,
                                          int k0, int M, int N, int K, int G, int planes) {
  uint8_t* xs = stage;
  uint8_t* raw = stage + C::X_BYTES;
  if constexpr (C::GROUPS) {
    if (G > 1) {
      float* sz = reinterpret_cast<float*>(raw + C::RAW_BYTES);
      const int g = k0 / (K / G);
#pragma unroll
      for (int j = 0; j < 2 * C::BN / C::THREADS; ++j) {
        const int i = threadIdx.x + j * C::THREADS;
        const int n = i % C::BN, gn = n0 + n;
        cp4(sz + i, (i < C::BN ? scale : zero) + (size_t)(gn < N ? gn : 0) * G + g, gn < N);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < C::BM * CH / C::THREADS; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    const int r = i / CH, c = i % CH, gm = m0 + r;
    cp16(xs + chunk_off(r, c), x + (size_t)(gm < M ? gm : 0) * K + k0 + c * 8, gm < M);
  }
  if constexpr (!PLANES) {
    const int words = K >> 3;
#pragma unroll
    for (int j = 0; j < C::BN * 2 / C::THREADS; ++j) {
      const int i = threadIdx.x + j * C::THREADS;
      const int n = i >> 1, h = i & 1, gn = n0 + n;
      cp16(raw + n * 32 + h * 16, qw + (size_t)(gn < N ? gn : 0) * words + (k0 >> 3) + h * 4,
           gn < N);
    }
  } else {
    const int pw = K >> 5;                   // plane words a row
    const size_t plane_stride = (size_t)N * pw;
    for (int pl = 0; pl < planes; ++pl)
#pragma unroll
      for (int j = 0; j < (C::BN + C::THREADS - 1) / C::THREADS; ++j) {
        const int n = threadIdx.x + j * C::THREADS, gn = n0 + n;
        if (C::BN % C::THREADS == 0 || n < C::BN)
          cp8(raw + (pl * C::BN + n) * 8,
              qw + pl * plane_stride + (size_t)(gn < N ? gn : 0) * pw + (k0 >> 5), gn < N);
      }
  }
}

// 8 nibble codes (code i in bits 4i..4i+3) → 8 bf16, in order: 0x4300 | q
// is the bf16 128 + q, exactly, and 128 + q − 128 = q exactly
__device__ __forceinline__ uint4 codes_bf16(uint32_t word) {
  const __nv_bfloat162 b128 = __floats2bfloat162_rn(128.f, 128.f);
  uint4 v;
  uint32_t* o = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t t = word >> (8 * j);
    const uint32_t u = (t & 0xFu) | ((t & 0xF0u) << 12) | 0x43004300u;
    const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u), b128);
    o[j] = *reinterpret_cast<const uint32_t*>(&q);
  }
  return v;
}

// a stage's packed codes → bf16 B tile: one 32-bit word of 8 codes is one
// 16-byte chunk.  Plane words are first rebuilt into those words: a thread
// takes one plane word of each plane (32 codes) and rebuilds its 4 packed
// words, byte b of a plane word holding codes 8b..8b+7.
template <class C, bool PLANES>
__device__ __forceinline__ void unpack_tile(const uint8_t* raw, uint8_t* wb, int planes) {
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(raw);
  if constexpr (!PLANES) {
#pragma unroll
    for (int j = 0; j < C::BN * CH / C::THREADS; ++j) {
      const int i = threadIdx.x + j * C::THREADS;
      const int n = i / CH, w = i % CH;
      *reinterpret_cast<uint4*>(wb + chunk_off(n, w)) = codes_bf16(rw[n * 8 + w]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < C::BN * 2 / C::THREADS; ++j) {
      const int i = threadIdx.x + j * C::THREADS;
      const int n = i >> 1, h = i & 1;
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      for (int p = 0; p < planes; ++p) {     // MSB plane first
        const uint32_t v = rw[(p * C::BN + n) * 2 + h];
#pragma unroll
        for (int b = 0; b < 4; ++b) words[b] = (words[b] << 1) | spread8((v >> (8 * b)) & 0xFFu);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
        *reinterpret_cast<uint4*>(wb + chunk_off(n, 4 * h + b)) = codes_bf16(words[b]);
    }
  }
}

template <class C, bool PLANES>
__global__ void __launch_bounds__(C::THREADS, 1) quant_matmul_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ qw,
    const float* __restrict__ scale, const float* __restrict__ zero,
    __nv_bfloat16* __restrict__ y, int M, int N, int K, int G, Planes pl) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* wb = smem + STAGES * C::STAGE_BYTES;        // two unpacked B tiles
  uint8_t* ones = wb + 2 * C::B_BYTES;                 // 8 B rows of ones: Σ x
  EXPERT_SLICE(x, qw, scale, zero, y, M, N, K, G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;             // warpgroup, warp in it
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int tiles = K / BK, group_tiles = (K / G) / BK;
  const auto stage = [&](int t) { return smem + (t % STAGES) * C::STAGE_BYTES; };
  const auto load = [&](int t) {
    load_tile<C, PLANES>(stage(t), x, qw, scale, zero, m0, n0, t * BK, M, N, K, G, pl.planes);
  };

  for (int i = tid; i < ONES_BYTES / 16; i += C::THREADS)    // bf16 1.0 = 0x3F80
    reinterpret_cast<uint4*>(ones)[i] = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                                                   0x3F803F80u);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_commit();
  }
  cp_wait<STAGES - 2>();
  __syncthreads();                     // tile 0 is in
  unpack_tile<C, PLANES>(stage(0) + C::X_BYTES, wb, pl.planes);
  fence_proxy_async();
  __syncthreads();

  // acc: Σ x·q of the current group; rs: Σ x of it (all 8 columns of the
  // ones product hold it; accumulator h·2 is row lane/4 + 8h); out: the
  // finished groups (per-group scales only)
  float acc[C::NR], rs[4], out[C::GROUPS ? C::NR : 1];
#pragma unroll
  for (int i = 0; i < C::NR; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) rs[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (C::GROUPS ? C::NR : 1); ++i) out[i] = 0.f;

  // Tile t: its wgmmas run while the block issues the copies of tile
  // t + STAGES − 1 and unpacks tile t + 1 into the other B tile.  Every
  // warpgroup waits for its wgmmas before the barrier that ends the step,
  // so a stage or B tile is rewritten only after the wgmmas that read it.
  for (int t = 0; t < tiles; ++t) {
    const uint8_t* xs = stage(t);
    const uint8_t* bt = wb + (t & 1) * C::B_BYTES;
#pragma unroll
    for (int i = 0; i < C::NR; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(rs[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = desc(xs + wg * 8 * SBO + 32 * ks);
      wgmma_tile<C::BN>(acc, da, desc(bt + 32 * ks));
      wgmma_n8(rs, da, desc(ones + 32 * ks));
    }
    wgmma_commit();

    if (t + STAGES - 1 < tiles) load(t + STAGES - 1);
    cp_commit();
    if (t + 1 < tiles) {
      cp_wait<STAGES - 2>();
      __syncthreads();                 // tile t + 1 is in
      unpack_tile<C, PLANES>(stage(t + 1) + C::X_BYTES, wb + ((t + 1) & 1) * C::B_BYTES,
                             pl.planes);
      fence_proxy_async();
    }

    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < C::NR; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(rs[i]);

    if constexpr (C::GROUPS) {
      if (G > 1 && (t + 1) % group_tiles == 0) {   // the group ends: s·(Σ x·q − z·Σ x)
        const float* ss = reinterpret_cast<const float*>(xs + C::X_BYTES + C::RAW_BYTES);
        // accumulator j·4 + h·2 + c holds row wq·16 + lane/4 + 8h, column
        // j·8 + (lane % 4)·2 + c
#pragma unroll
        for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = j * 8 + (lane & 3) * 2 + c;
            float sv = ss[col], zv = ss[C::BN + col];
            if constexpr (PLANES) {
              sv *= pl.s_mul;
              zv *= pl.z_mul;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = j * 4 + h * 2 + c;
              out[i] = fmaf(sv, fmaf(-zv, rs[h * 2], acc[i]), out[i]);
            }
          }
#pragma unroll
        for (int i = 0; i < C::NR; ++i) acc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) rs[i] = 0.f;
      }
    }
    __syncthreads();                   // tile t + 1 unpacked; tile t consumed
  }

  // The epilogue: per-channel scales apply here, s·(Σ x·q − z·Σ x); the
  // tile goes through shared memory (the ring, now free) so that y is
  // written in whole 16-byte vectors, a warp's stores contiguous.
  cp_wait<0>();
  __syncthreads();
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    float sv[2] = {0.f, 0.f}, zv[2] = {0.f, 0.f};
    if (G == 1) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int gn = n0 + col + c;
        if (gn < N) {
          sv[c] = __ldg(scale + gn);
          zv[c] = __ldg(zero + gn);
          if constexpr (PLANES) {
            sv[c] *= pl.s_mul;
            zv[c] *= pl.z_mul;
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = j * 4 + h * 2 + c;
        if (C::GROUPS && G > 1) v[c] = out[C::GROUPS ? i : 0];
        else v[c] = fmaf(sv[c], fmaf(-zv[c], rs[h * 2], acc[i]), 0.f);
      }
      const int r = wg * 64 + wq * 16 + (lane >> 2) + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(ys + r * C::Y_LD + col) =
          __floats2bfloat162_rn(v[0], v[1]);
    }
  }
  __syncthreads();
  const bool vec = N % 8 == 0;         // rows of y start on 16 bytes
#pragma unroll 4
  for (int j = 0; j < C::BM * (C::BN / 8) / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / (C::BN / 8), c8 = (i % (C::BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + c8;
    if (gm >= M || gn >= N) continue;
    const __nv_bfloat16* src = ys + r * C::Y_LD + c8;
    __nv_bfloat16* dst = y + (size_t)gm * N + gn;
    if (vec && gn + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gn + e < N; ++e) dst[e] = src[e];
    }
  }
}

template <class C, bool PLANES>
cudaError_t launch(const void* x, const void* qw, const void* scale, const void* zero,
                   void* y, int M, int N, int K, int G, Planes pl, int E,
                   cudaStream_t stream) {
  static bool sized = false;           // the dynamic shared-memory limit, once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_matmul_tc_kernel<C, PLANES>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, E);
  quant_matmul_tc_kernel<C, PLANES><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<__nv_bfloat16*>(y), M, N, K, G, pl);
  return cudaGetLastError();
}

// the tensor-core route takes bf16 x with whole 64-code tiles and groups
bool takes(int K, int G, int x_is_bf16) {
  return x_is_bf16 && K % BK == 0 && (K / G) % BK == 0;
}

// The largest tile whose grid fills at least 3/4 of a wave on the card's
// SMs: 128 × 256 (per-channel scales only), 128 × 128, else 64 × 64 — the
// grid of one expert's (M, N), so an expert-axis launch tiles each expert
// as its own 2-D launch would.
template <bool PLANES>
cudaError_t launch_tiled(const void* x, const void* qw, const void* scale, const void* zero,
                         void* y, int M, int N, int K, int G, Planes pl, int E,
                         cudaStream_t s) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const auto fills = [&](int bm, int bn) {
    return 4L * ((M + bm - 1) / bm) * ((N + bn - 1) / bn) >= 3L * sms;
  };
  if (G == 1 && fills(Wide::BM, Wide::BN))
    return tc::launch<Wide, PLANES>(x, qw, scale, zero, y, M, N, K, G, pl, E, s);
  if (fills(Big::BM, Big::BN))
    return tc::launch<Big, PLANES>(x, qw, scale, zero, y, M, N, K, G, pl, E, s);
  return tc::launch<Small, PLANES>(x, qw, scale, zero, y, M, N, K, G, pl, E, s);
}

}  // namespace tc

template <bool PLANES>
int run(const void* x, const void* qw, const void* scale, const void* zero,
        void* y, int M, int N, int K, int G, Planes pl, int x_is_bf16,
        void* stream, int E = 1) {
  if (M < 1 || M > 65535 * BM || N < 1 || K < 8 || K % 8 || G < 1 || K % G ||
      E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc::takes(K, G, x_is_bf16)) {
    if (M > 65535 * tc::Small::BM) return (int)cudaErrorInvalidValue;
    return (int)tc::launch_tiled<PLANES>(x, qw, scale, zero, y, M, N, K, G, pl, E, s);
  }
  cudaError_t err = x_is_bf16
      ? launch<__nv_bfloat16, PLANES>(x, qw, scale, zero, y, M, N, K, G, pl, E, s)
      : launch<float, PLANES>(x, qw, scale, zero, y, M, N, K, G, pl, E, s);
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

// K2 over an expert axis: x (E, M, K), qw (E, N, K/8) nibble words, scale
// and zero (E, N, G), y (E, M, N); slice e is quant_matmul on expert e's
// operands, bit for bit (EXPERT_SLICE).
extern "C" int quant_matmul_experts(const void* x, const void* qw, const void* scale,
                                    const void* zero, void* y, int E, int M, int N,
                                    int K, int G, int x_is_bf16, void* stream) {
  return run<false>(x, qw, scale, zero, y, M, N, K, G, Planes{0, 1.f, 1.f},
                    x_is_bf16, stream, E);
}

// Dynamic shared memory of the tensor-core route's tile shapes (tile 0:
// 64 × 64, 1: 128 × 128, 2: 128 × 256), for the build report.
extern "C" int quant_matmul_tc_smem(int tile) {
  return tile == 2 ? tc::Wide::SMEM : tile == 1 ? tc::Big::SMEM : tc::Small::SMEM;
}
