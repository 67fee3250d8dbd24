// K1: decode GEMV  y = x · Ŵᵀ,  Ŵ = s · (q − z)  from packed 4-bit codes.
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_gemv_pallas
// (plain branch, _qgemv_kernel).  Same semantics: x (M ≤ 32, K) in bf16 or
// f32, qw (N, K/8) 32-bit words holding 8 nibble codes each (code i in bits
// 4i..4i+3), scale and zero (N, G) f32 with groups of K/G consecutive codes,
// dequantization s·(q − z) in f32 exactly as the plain version computes it,
// f32 accumulation, y (M, N) in x's dtype.
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

// MT: rows of x padded to a power of two; R: output rows per lane;
// MB: rows of x held in registers at a time
template <typename T, int MT, int R, int MB = (MT < 4 ? MT : 4)>
__global__ void __launch_bounds__(THREADS, 2) quant_gemv_kernel(
    const T* __restrict__ x, const uint32_t* __restrict__ qw,
    const float* __restrict__ scale, const float* __restrict__ zero,
    T* __restrict__ y, int M, int N, int K, int G, int kc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);            // [MT][kc]
  __shared__ float red[ROW_GROUPS][KSPLIT][R * MT];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kq = warp % KSPLIT, rg = warp / KSPLIT;
  const int n0 = (blockIdx.x * ROW_GROUPS + rg) * R;
  const int words = K >> 3;
  const int group = K / G;
  const bool word_groups = (group & 7) == 0;              // a word never straddles groups

  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  float s[R], z[R];
  if (G == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = min(n0 + r, N - 1);
      s[r] = __ldg(scale + n);
      z[r] = __ldg(zero + n);
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
        q[r] = (n0 + r < N) ? __ldg(qw + (size_t)(n0 + r) * words + w) : 0u;
      if (G != 1 && word_groups) {
        const int g = k0 / group;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int n = min(n0 + r, N - 1);
          s[r] = __ldg(scale + (size_t)n * G + g);
          z[r] = __ldg(zero + (size_t)n * G + g);
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
            const float wj = __ldg(scale + (size_t)n * G + g) *
                             (nib(q[r], j) - __ldg(zero + (size_t)n * G + g));
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

template <typename T, int MT, int R>
cudaError_t launch(const void* x, const void* qw, const void* scale, const void* zero,
                   void* y, int M, int N, int K, int G, cudaStream_t stream) {
  int kc = (SMEM_X_FLOATS / MT) & ~7;
  if (kc > K) kc = K;
  const size_t smem = (size_t)MT * kc * sizeof(float);
  auto kern = quant_gemv_kernel<T, MT, R>;
  // allow the largest chunk any launch of this instantiation stages; the
  // attribute belongs to the device, so it is set once per device
  static unsigned long long set_on = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(set_on >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(SMEM_X_FLOATS * sizeof(float)));
    if (err != cudaSuccess) return err;
    set_on |= 1ull << dev;
  }
  const int rows_per_block = ROW_GROUPS * R;
  const dim3 grid((N + rows_per_block - 1) / rows_per_block);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<T*>(y), M, N, K, G, kc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* qw, const void* scale, const void* zero,
                     void* y, int M, int N, int K, int G, cudaStream_t stream) {
  if (M <= 1) return launch<T, 1, 8>(x, qw, scale, zero, y, M, N, K, G, stream);
  if (M <= 2) return launch<T, 2, 8>(x, qw, scale, zero, y, M, N, K, G, stream);
  if (M <= 4) return launch<T, 4, 8>(x, qw, scale, zero, y, M, N, K, G, stream);
  if (M <= 8) return launch<T, 8, 4>(x, qw, scale, zero, y, M, N, K, G, stream);
  if (M <= 16) return launch<T, 16, 2>(x, qw, scale, zero, y, M, N, K, G, stream);
  return launch<T, 32, 1>(x, qw, scale, zero, y, M, N, K, G, stream);
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  The caller has
// checked shapes, dtypes, devices and contiguity; these checks only refuse
// what would index out of bounds.
extern "C" int quant_gemv(const void* x, const void* qw, const void* scale,
                          const void* zero, void* y, int M, int N, int K, int G,
                          int x_is_bf16, void* stream) {
  if (M < 1 || M > 32 || N < 1 || K < 8 || K % 8 || G < 1 || K % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_is_bf16
      ? dispatch<__nv_bfloat16>(x, qw, scale, zero, y, M, N, K, G, s)
      : dispatch<float>(x, qw, scale, zero, y, M, N, K, G, s);
  return (int)err;
}
