// The earlier design of K3 / K6b (csrc/rtn_pack.cu), one block per row,
// kept only so that kernels/rtn_variants.py can time it beside the
// committed kernel in one run ("legacy").  Nothing on the port's path
// builds or calls it; its entry points and results are the committed
// kernel's.
//
// K3: min/max round-to-nearest quantization of a weight matrix, packed into
// nibble words, and K6b: the same quantization packed into bit-planes.
//
// K3 replaces the TPU kernel repro/kernels/rtn_pack.py::rtn_pack_pallas,
// nibble branch (_rtn_pack_kernel, the pallas_call at rtn_pack.py:124);
// K6b its plane branch (_rtn_pack_planes_kernel, the pallas_call at :107).
// Same semantics: w (N, K) in bf16 or f32, read in its own dtype and
// widened to f32; per (row, group of K/G consecutive codes)
//   lo = min(w, 0), hi = max(w, 0)
//   s  = max((hi − lo) / levels, 1e-12),   z = −lo / s
//   q  = clip(round(w / s + z), 0, levels)          (round half to even)
// with scale and zero (N, G) f32 out, and the codes packed either
//   * as nibbles: (N, K/8) 32-bit words, code i of a word at bits 4i..4i+3;
//   * as bit-planes: (bits, N, K/32) words, plane p holding bit bits−1−p of
//     every code (MSB plane first), code i of a word at bit i.
// Every step is the plain version's IEEE f32 operation in its order — the
// divisions as divisions (__fdiv_rn, never a reciprocal multiply), the add
// uncontracted (__fadd_rn), round half to even (rintf, not roundf) — so
// codes, scales and zeros are bit for bit the plain version's
// (kernels/ref.py::rtn_pack_ref with n_grid = 1).  The range search of the
// plain rtn_quantize (n_grid > 1) is not here, as it is not in the TPU
// kernel: this is the conversion path.  min and max ignore NaN (the plain
// version propagates it); weights hold none.
//
// What bounds it on an H100: bytes.  Each weight is read from device memory
// once and a code is 4 bits, so the least time is the weight bytes plus
// the code and scale bytes at HBM rate; the arithmetic is a few operations
// per weight.  The design:
//   * one block per row: its 8 warps first reduce each group's min and
//     max — a warp per group when the row has at least 8 groups (group
//     128: 4 values per lane), the whole block per group otherwise
//     (per-channel: one group of K, up to 8192) — and keep (s, z) of
//     every group of the row in shared memory;
//   * then each warp quantizes 32 consecutive codes at a time, one per
//     lane, re-reading the row (from L2: it was read a moment ago), and
//     packs them without shared memory: nibbles by OR-ing 8 lanes' shifted
//     codes with three xor-shuffles, bit-planes with one __ballot_sync per
//     plane (lane i's bit lands at bit i, as the layout wants).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GROUPS = 4096;             // (s, z) of a row: 32 KB of shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void warp_range(float& lo, float& hi) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(~0u, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(~0u, hi, o));
  }
}

// (s, z) of a group from its range (lo <= 0 <= hi), as the plain version
// computes them
__device__ __forceinline__ void group_params(float lo, float hi, int levels,
                                             float& s, float& z) {
  s = fmaxf(__fdiv_rn(__fsub_rn(hi, lo), (float)levels), 1e-12f);
  z = __fdiv_rn(-lo, s);
}

__device__ __forceinline__ uint32_t rtn_code(float w, float s, float z, int levels) {
  const float t = rintf(__fadd_rn(__fdiv_rn(w, s), z));
  return (uint32_t)fminf(fmaxf(t, 0.f), (float)levels);
}

template <typename T, bool PLANES>
__global__ void __launch_bounds__(THREADS) rtn_pack_kernel(
    const T* __restrict__ w, uint32_t* __restrict__ qw, float* __restrict__ scale,
    float* __restrict__ zero, int N, int K, int G, int bits) {
  extern __shared__ float sz[];               // s of the row's groups, then z
  __shared__ float part[2][WARPS];
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = K / G, levels = (1 << bits) - 1;
  const T* row = w + (size_t)n * K;

  // pass 1: each group's range; starting from 0 gives min(w, 0), max(w, 0)
  if (G >= WARPS) {
    for (int g = warp; g < G; g += WARPS) {
      const T* src = row + (size_t)g * group;
      float lo = 0.f, hi = 0.f;
      for (int i = lane; i < group; i += 32) {
        const float v = to_f32(src[i]);
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      warp_range(lo, hi);
      if (lane == 0) {
        float s, z;
        group_params(lo, hi, levels, s, z);
        sz[g] = s;
        sz[G + g] = z;
        scale[(size_t)n * G + g] = s;
        zero[(size_t)n * G + g] = z;
      }
    }
  } else {
    for (int g = 0; g < G; ++g) {
      const T* src = row + (size_t)g * group;
      float lo = 0.f, hi = 0.f;
      for (int i = threadIdx.x; i < group; i += THREADS) {
        const float v = to_f32(src[i]);
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      warp_range(lo, hi);
      if (lane == 0) {
        part[0][warp] = lo;
        part[1][warp] = hi;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int i = 1; i < WARPS; ++i) {
          lo = fminf(lo, part[0][i]);
          hi = fmaxf(hi, part[1][i]);
        }
        float s, z;
        group_params(lo, hi, levels, s, z);
        sz[g] = s;
        sz[G + g] = z;
        scale[(size_t)n * G + g] = s;
        zero[(size_t)n * G + g] = z;
      }
      __syncthreads();                        // part is reused by the next group
    }
  }
  __syncthreads();

  // pass 2: 32 consecutive codes per warp and step, one per lane; the loop
  // bound depends on the warp only, so every lane takes part in the
  // shuffles and ballots
  for (int base = warp * 32; base < K; base += THREADS) {
    const int c = base + lane;
    uint32_t q = 0;
    if (c < K) {
      const int g = c / group;
      q = rtn_code(to_f32(row[c]), sz[g], sz[G + g], levels);
    }
    if constexpr (PLANES) {                   // K % 32 == 0: every lane holds a code
      const size_t words = (size_t)(K >> 5);
      uint32_t mine = 0;
      for (int p = 0; p < bits; ++p) {
        const uint32_t word = __ballot_sync(~0u, (q >> (bits - 1 - p)) & 1u);
        if (lane == p) mine = word;
      }
      if (lane < bits)
        qw[(size_t)lane * N * words + (size_t)n * words + (base >> 5)] = mine;
    } else {                                  // K % 8 == 0: a word's 8 lanes are all in
      uint32_t word = q << (4 * (lane & 7));
      word |= __shfl_xor_sync(~0u, word, 1);
      word |= __shfl_xor_sync(~0u, word, 2);
      word |= __shfl_xor_sync(~0u, word, 4);
      if ((lane & 7) == 0 && c < K) qw[(size_t)n * (K >> 3) + (c >> 3)] = word;
    }
  }
}

template <bool PLANES>
int run(const void* w, void* qw, void* scale, void* zero, int N, int K, int G,
        int bits, int w_is_bf16, void* stream) {
  if (N < 1 || K < 8 || K % (PLANES ? 32 : 8) || G < 1 || K % G ||
      G > MAX_GROUPS || bits < 2 || bits > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * (size_t)G * sizeof(float);
  if (w_is_bf16)
    rtn_pack_kernel<__nv_bfloat16, PLANES><<<N, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<uint32_t*>(qw),
        static_cast<float*>(scale), static_cast<float*>(zero), N, K, G, bits);
  else
    rtn_pack_kernel<float, PLANES><<<N, THREADS, smem, s>>>(
        static_cast<const float*>(w), static_cast<uint32_t*>(qw),
        static_cast<float*>(scale), static_cast<float*>(zero), N, K, G, bits);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points return the CUDA error code of the launch (0 on
// success).  The caller has checked shapes, dtypes, devices and
// contiguity; these checks only refuse what would index out of bounds.
// K3: qw (N, K/8) nibble words.
extern "C" int rtn_pack(const void* w, void* qw, void* scale, void* zero, int N,
                        int K, int G, int bits, int w_is_bf16, void* stream) {
  return run<false>(w, qw, scale, zero, N, K, G, bits, w_is_bf16, stream);
}

// K6b: qw (bits, N, K/32) bit-planes, MSB plane first.
extern "C" int rtn_pack_planes(const void* w, void* qw, void* scale, void* zero,
                               int N, int K, int G, int bits, int w_is_bf16,
                               void* stream) {
  return run<true>(w, qw, scale, zero, N, K, G, bits, w_is_bf16, stream);
}
