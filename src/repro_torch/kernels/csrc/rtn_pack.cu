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
// uncontracted (__fadd_rn), round half to even — so codes, scales and zeros
// are bit for bit the plain version's (kernels/ref.py::rtn_pack_ref with
// n_grid = 1).  The clamp is the saturating float-to-unsigned conversion
// with round to nearest even (cvt.rni.u32: negatives and NaN give 0) and a
// min with levels: the same code as rint, max 0, min levels.  The range
// search of the plain rtn_quantize (n_grid > 1) is not here, as it is not
// in the TPU kernel: this is the conversion path.  min and max ignore NaN
// (the plain version propagates it); weights hold none.
//
// What bounds it on an H100: bytes.  Each weight is read from device memory
// once and a code is 4 bits, so the least time is the weight bytes plus the
// code and scale bytes at HBM rate.  The arithmetic is not free: an IEEE
// division, an add, a conversion, a min and a pack per weight, about a
// dozen instructions — near half of what the SMs can execute in the time an
// f32 weight's bytes take, and all of it for bf16 — so it has to run under
// the loads.
// The design:
//   * A block's tile is whole rows, 8192 codes (R = 8192 / K rows, at most
//     N, or one row when K is larger): 32 KB of f32 weights, 16 KB of
//     bf16.  The block stages it in shared memory with 16-byte cp.async
//     copies, consecutive threads on consecutive vectors, so every weight
//     crosses HBM once; the range and the quantization both read shared
//     memory.
//     One tile a block and 4 blocks an SM (55 registers a thread): one
//     block's loads run under the others' arithmetic.
//   * A thread takes 32 consecutive codes at a time, a chunk: one word of
//     each plane, or four nibble words (8 codes, one word, when K is no
//     multiple of 32).  A chunk is 8 (f32) or 4 (bf16) 16-byte vectors.
//     Shared memory holds vector i at i ^ ((i / 8) mod 8) — each 128-byte
//     line's vectors permuted by the line's index — so the 8 threads of a
//     16-byte access phase, reading vector t of 8 consecutive chunks, hit 8
//     distinct bank quads (f32: line c, slot t ^ c; bf16 and f32 nibble-8
//     chunks alike), and a linear read stays conflict-free too.
//   * Range: each thread takes its chunks' min and max into a partial per
//     chunk; then each (row, group) reduces its chunks' partials — a warp
//     when the group has 32 chunks or more (per-channel rows), a thread
//     otherwise (group 128: 4 chunks) — and writes (s, z) to shared memory
//     and to device memory.  A group whose size is no multiple of the chunk
//     takes a thread over its values, and each code its own group's (s, z).
//   * Quantize: each thread reads its chunk again and builds its words in
//     registers: nibbles by shifted adds; bit-planes by spreading each
//     code's 4 bits to the 4 bytes of a word (q·0x204081 & 0x01010101),
//     shifted to the code's bit of its byte, then gathering byte b of the
//     chunk's four such words into the word of bit b with byte permutes.
//     Stores: four nibble words as one 16-byte store, or one word a plane,
//     consecutive threads on consecutive words.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_CODES = 8192;             // codes a tile, in whole rows
constexpr int MAX_GROUPS = 4096;
constexpr int SMEM_LIMIT = 227 * 1024;       // dynamic shared memory a block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// where the tile's 16-byte vector i sits in shared memory
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 7); }

// the values of a 16-byte vector, widened to f32 (bf16 exactly: its bits
// are the top half of the f32's)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void get(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void get(const uint4& u, float (&v)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

// value i of the tile
template <typename T>
__device__ __forceinline__ float value(const uint4* tile, int i) {
  const T x = reinterpret_cast<const T*>(tile + swz(i / Vec<T>::N))[i % Vec<T>::N];
  if constexpr (sizeof(T) == 4)
    return x;
  else
    return __bfloat162float(x);
}

__device__ __forceinline__ void warp_range(float& lo, float& hi) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(~0u, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(~0u, hi, o));
  }
}

__device__ __forceinline__ uint32_t rtn_code(float w, float s, float z, uint32_t levels) {
  return min(__float2uint_rn(__fadd_rn(__fdiv_rn(w, s), z)), levels);
}

// The words of chunk c: acc[w] holds codes 8w..8w+7 — as a nibble word, or
// (PLANES) with bit b of code 8w + i at bit i of byte b.  WHOLE: the chunk
// lies in one group, (s, z); else each code reads its own group's.
template <typename T, bool PLANES, int CW, bool WHOLE>
__device__ __forceinline__ void chunk_codes(const uint4* tile, int c, float s, float z,
                                            const float* sz, int max_groups, int gs,
                                            uint32_t levels, uint32_t (&acc)[CW / 8]) {
  constexpr int VN = Vec<T>::N, NQ = CW / VN;
#pragma unroll
  for (int i = 0; i < CW / 8; ++i) acc[i] = 0u;
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    float v[VN];
    Vec<T>::get(tile[swz(c * NQ + t)], v);
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      const int j = t * VN + e;              // the code's place in the chunk
      if constexpr (!WHOLE) {
        const int g = (c * CW + j) / gs;
        s = sz[g];
        z = sz[max_groups + g];
      }
      const uint32_t q = rtn_code(v[e], s, z, levels);
      if constexpr (PLANES)                  // bit b of q to bit j % 8 of byte b
        acc[j >> 3] += ((q * 0x204081u) & 0x01010101u) << (j & 7);
      else
        acc[j >> 3] += q << (4 * (j & 7));
    }
  }
}

struct Params {
  const void* w;
  uint32_t* qw;
  float* scale;
  float* zero;
  int N, K, G, bits, R;                      // R: rows a tile
};

// Shared memory of a block: the tile (R·K values, whole 128-byte lines),
// then a (min, max) partial a chunk, then (s, z) a group of the tile.
__host__ __device__ constexpr int tile_bytes(int R, int K, int elt) {
  return (R * K * elt + 127) / 128 * 128;
}
__host__ __device__ constexpr int smem_bytes(int R, int K, int G, int elt, int cw) {
  return tile_bytes(R, K, elt) + 2 * (R * K / cw) * 4 + 2 * R * G * 4;
}

template <typename T, bool PLANES, int CW>
__global__ void __launch_bounds__(THREADS, 4) rtn_pack_kernel(Params p) {
  constexpr int VN = Vec<T>::N;              // values a 16-byte vector
  constexpr int NQ = CW / VN;                // vectors a chunk
  extern __shared__ __align__(128) uint4 tile[];
  const int K = p.K, G = p.G, gs = K / G;
  const uint32_t levels = (1u << p.bits) - 1u;
  const int n0 = blockIdx.x * p.R, rows = min(p.R, p.N - n0);
  const int chunks = rows * K / CW, groups = rows * G;
  const int max_chunks = p.R * K / CW, max_groups = p.R * G;
  float* part = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(tile) +
                                         tile_bytes(p.R, K, sizeof(T)));
  float* sz = part + 2 * max_chunks;
  const bool whole = gs % CW == 0;           // every chunk inside one group
  const int per = gs / CW;                   // chunks a group, when whole
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // stage the tile: every weight read from device memory once
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const T*>(p.w) +
                                                    (size_t)n0 * K);
  const int vecs = rows * K / VN;
  for (int i = threadIdx.x; i < vecs; i += THREADS) cp_async16(tile + swz(i), src + i);
  cp_async_wait_all();
  __syncthreads();

  // (s, z) of group g of the tile from its range (lo <= 0 <= hi), as the
  // plain version computes them
  const auto set_group = [&](int g, float lo, float hi) {
    const float s = fmaxf(__fdiv_rn(__fsub_rn(hi, lo), (float)levels), 1e-12f);
    const float z = __fdiv_rn(-lo, s);
    sz[g] = s;
    sz[max_groups + g] = z;
    p.scale[(size_t)n0 * G + g] = s;
    p.zero[(size_t)n0 * G + g] = z;
  };

  // the range of each group; starting from 0 gives min(w, 0), max(w, 0)
  if (whole) {
    for (int c = threadIdx.x; c < chunks; c += THREADS) {
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        float v[VN];
        Vec<T>::get(tile[swz(c * NQ + t)], v);
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          lo = fminf(lo, v[e]);
          hi = fmaxf(hi, v[e]);
        }
      }
      part[c] = lo;
      part[max_chunks + c] = hi;
    }
    __syncthreads();
    if (per >= 32) {                         // a warp a group
      for (int g = warp; g < groups; g += WARPS) {
        float lo = 0.f, hi = 0.f;
        for (int i = g * per + lane; i < (g + 1) * per; i += 32) {
          lo = fminf(lo, part[i]);
          hi = fmaxf(hi, part[max_chunks + i]);
        }
        warp_range(lo, hi);
        if (lane == 0) set_group(g, lo, hi);
      }
    } else {                                 // a thread a group
      for (int g = threadIdx.x; g < groups; g += THREADS) {
        float lo = 0.f, hi = 0.f;
        for (int i = g * per; i < (g + 1) * per; ++i) {
          lo = fminf(lo, part[i]);
          hi = fmaxf(hi, part[max_chunks + i]);
        }
        set_group(g, lo, hi);
      }
    }
  } else {                                   // a thread a group, value by value
    for (int g = threadIdx.x; g < groups; g += THREADS) {
      float lo = 0.f, hi = 0.f;
      for (int i = g * gs; i < (g + 1) * gs; ++i) {
        const float v = value<T>(tile, i);
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      set_group(g, lo, hi);
    }
  }
  __syncthreads();

  // quantize and pack, a chunk at a time
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    uint32_t acc[CW / 8];
    if (whole) {
      const int g = c / per;
      chunk_codes<T, PLANES, CW, true>(tile, c, sz[g], sz[max_groups + g], sz,
                                       max_groups, gs, levels, acc);
    } else {
      chunk_codes<T, PLANES, CW, false>(tile, c, 0.f, 0.f, sz, max_groups, gs,
                                        levels, acc);
    }
    if constexpr (PLANES) {
      const size_t words = (size_t)(K >> 5);
      uint32_t* dst = p.qw + (size_t)n0 * words + c;
      for (int pl = 0; pl < p.bits; ++pl) {  // plane pl holds bit bits − 1 − pl
        const uint32_t b = (uint32_t)(p.bits - 1 - pl), sel = b | ((b + 4) << 4);
        const uint32_t lo = __byte_perm(acc[0], acc[1], sel);
        const uint32_t hi = __byte_perm(acc[2], acc[3], sel);
        dst[(size_t)pl * p.N * words] = __byte_perm(lo, hi, 0x5410);
      }
    } else if constexpr (CW == 32) {
      reinterpret_cast<uint4*>(p.qw + (size_t)n0 * (K >> 3))[c] =
          make_uint4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      p.qw[(size_t)n0 * (K >> 3) + c] = acc[0];
    }
  }
}

template <typename T, bool PLANES, int CW>
cudaError_t launch(const Params& p, int smem, cudaStream_t s) {
  static bool sized = false;                 // above 48 KB from K ≈ 11500 f32: once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(rtn_pack_kernel<T, PLANES, CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_LIMIT);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rtn_pack_kernel<T, PLANES, CW>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  rtn_pack_kernel<T, PLANES, CW><<<(p.N + p.R - 1) / p.R, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool PLANES>
int run(const void* w, void* qw, void* scale, void* zero, int N, int K, int G,
        int bits, int w_is_bf16, void* stream) {
  const int elt = w_is_bf16 ? 2 : 4, cw = PLANES || K % 32 == 0 ? 32 : 8;
  if (N < 1 || K < 8 || K % (PLANES ? 32 : 8) || G < 1 || K % G ||
      G > MAX_GROUPS || bits < 2 || bits > 4 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const int R = K >= TILE_CODES ? 1 : (N < TILE_CODES / K ? N : TILE_CODES / K);
  const int smem = smem_bytes(R, K, G, elt, cw);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const Params p{w, static_cast<uint32_t*>(qw), static_cast<float*>(scale),
                 static_cast<float*>(zero), N, K, G, bits, R};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (PLANES)
    e = w_is_bf16 ? launch<__nv_bfloat16, true, 32>(p, smem, s)
                  : launch<float, true, 32>(p, smem, s);
  else if (w_is_bf16)
    e = cw == 32 ? launch<__nv_bfloat16, false, 32>(p, smem, s)
                 : launch<__nv_bfloat16, false, 8>(p, smem, s);
  else
    e = cw == 32 ? launch<float, false, 32>(p, smem, s) : launch<float, false, 8>(p, smem, s);
  return (int)e;
}

}  // namespace

// Both entry points return the CUDA error code of the launch (0 on
// success).  The caller has checked shapes, dtypes, devices, contiguity,
// alignment and that a tile fits in shared memory
// (kernels/rtn_pack.py::smem_bytes); these checks only refuse what would
// index out of bounds.
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
