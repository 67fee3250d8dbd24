// K4: attention forward with an online softmax over key tiles,
//   o[b, i, h] = Σ_j softmax_j(scale · q[b, i, h] · k[b, j, h / rep]) · v[b, j, h / rep]
// over the keys j visible to query i: causal (j ≤ i_abs) and, with a
// window, j > i_abs − window, where i_abs = offset + i and key j sits at
// absolute position j.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_fa_kernel, the pallas_call at
// flash_attention.py:113).  Same semantics: q scaled in f32 before the dot,
// logits, running max, running sum and accumulator in f32, expf (not the
// fast __expf), the output in q's dtype.  Two differences of interface: the
// layout is the port's, q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) read
// through their strides (a layer's slice of the stacked KV cache is read in
// place), with GQA handled without repeating the KV heads; and the offset
// is a scalar or a (B,) int64 device tensor — every row of the slot pool at
// its own depth — read by the kernel, so a decode step makes no host sync.
// One difference of result: a query that sees no key returns 0, as the
// port's plain version (kernels/ref.py::flash_attention_ref) does; the TPU
// kernel masks with a finite −1e30 and returns the mean of V for such a
// row.  No path of the model makes one.
//
// What bounds it on an H100: at the model's shapes, operations for the
// prefill (Sq = Sk = 256: 2·D f32 multiply-adds per visible (query, key)
// pair against 4·D bytes of K and V per key, shared by Sq·rep queries) and
// bytes for a decode step (Sq ≤ 4: each visible key's K and V row is read
// for rep·Sq queries).  This first kernel is SIMT f32, not tensor cores:
//   * a block owns one (batch row, KV head) and 16 consecutive (query
//     position, head) rows of its rep = Hq/Hkv query heads, so each K/V
//     tile it stages in shared memory serves every query head of the group;
//   * tiles of 32 keys are loaded in 16-byte vectors, every load of a
//     thread issued before the first is stored (one memory round trip a
//     tile), and staged as f32; K rows padded to 132 floats, so the lane
//     that owns key j reads its row in 16-byte pieces without bank
//     conflicts; tiles past the last key any of the block's queries can see
//     — or before the first, with a window — are never loaded: a decode at
//     position 40 in a 512-slot cache reads 41 keys;
//   * each warp owns 4 rows; per tile, lane j computes the logit of key j
//     for each row (a D-long dot from shared memory, in order of d), the
//     warp reduces each row's max and sum with shuffles, and each lane then
//     accumulates its D/32 output dims of all 4 rows, reading each V value
//     once and broadcasting each key's weight with __shfl_sync.
// Operands must start on 16 bytes with strides of whole 16-byte vectors
// (the wrapper checks; the model's tensors and cache slices are).
// wgmma and TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;                       // rows per warp
constexpr int ROWS = WARPS * RPW;            // (query position, head) rows per block
constexpr int BK = 32;                       // keys per tile: one per lane
constexpr int D_MAX = 128;
constexpr int KLD = D_MAX + 4;               // K rows: 16-byte aligned, and the 8
                                             // lanes of a 16-byte access phase
                                             // start on distinct bank quads
constexpr int CHUNK = 4;                     // 16-byte loads in flight per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                                   // (B, Sq, Hq, D), contiguous
  const long long* offsets;                  // (B,) or null
  long long qs_b, qs_s, qs_h;                // strides, in elements
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  int B, Sq, Sk, Hq, Hkv, D;
  int offset;                                // query 0's position without offsets
  int causal, window;                        // window 0: none
  float scale;
};

// 16-byte vector → E = 16 / sizeof(T) floats
__device__ __forceinline__ void widen(const uint4& u, float* out, float) {
  const float* t = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = t[e];
}
__device__ __forceinline__ void widen(const uint4& u, float* out, __nv_bfloat16) {
  const __nv_bfloat16* t = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(t[e]);
}

// `rows` rows of D elements (D / E 16-byte vectors each) from a strided
// source into a float shared array of row stride LD, each value times `mul`
// in f32: up to CHUNK 16-byte loads of every thread are issued before any
// is stored, so a tile costs one memory round trip, not one per element.
// src(r) is row r's first element, or null for a row past the end (zeros).
template <typename T, int LD, typename Src>
__device__ __forceinline__ void stage_rows(float* dst, int rows, int D, float mul,
                                           Src src) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = D / E, n = rows * per_row;
  for (int base = 0; base < n; base += CHUNK * THREADS) {
    uint4 buf[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int i = base + c * THREADS + threadIdx.x;
      buf[c] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n) {
        const T* row = src(i / per_row);
        if (row) buf[c] = __ldg(reinterpret_cast<const uint4*>(row + (i % per_row) * E));
      }
    }
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const int i = base + c * THREADS + threadIdx.x;
      if (i < n) {
        float f[E];
        widen(buf[c], f, T());
        float4* out = reinterpret_cast<float4*>(dst + (i / per_row) * LD + (i % per_row) * E);
#pragma unroll
        for (int e = 0; e < E / 4; ++e)
          out[e] = make_float4(f[4 * e] * mul, f[4 * e + 1] * mul, f[4 * e + 2] * mul,
                               f[4 * e + 3] * mul);
      }
    }
  }
}

// DL: output dims per lane, ceil(D / 32) — 2 at the model's D = 64
template <typename T, int DL>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(Params p) {
  __shared__ __align__(16) float qs[ROWS][D_MAX];
  __shared__ __align__(16) float ks[BK][KLD];
  __shared__ __align__(16) float vs[BK][D_MAX];
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rep = p.Hq / p.Hkv, rows = p.Sq * rep, D = p.D;
  const int r0 = blockIdx.x * ROWS;
  const T* q = static_cast<const T*>(p.q) + b * p.qs_b;
  const T* k = static_cast<const T*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  const int off = p.offsets ? (int)p.offsets[b] : p.offset;

  // the block's rows, scaled in f32: row r = query position r / rep, head
  // kvh·rep + r % rep
  stage_rows<T, D_MAX>(&qs[0][0], ROWS, D, p.scale, [&](int r) -> const T* {
    const int rr = r0 + r;
    return rr < rows ? q + (rr / rep) * p.qs_s + (kvh * rep + rr % rep) * p.qs_h
                     : nullptr;
  });

  // the keys any of the block's queries can see: [j_begin, j_end)
  const int last = min(r0 + ROWS, rows) - 1;
  const int i_lo = off + r0 / rep, i_hi = off + last / rep;
  const int j_end = p.causal ? min(p.Sk, max(i_hi + 1, 0)) : p.Sk;
  const int j_begin = p.window > 0 ? max(0, i_lo - p.window + 1) : 0;

  float m[RPW], l[RPW], acc[RPW][DL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[i][t] = 0.f;
  }

  for (int j0 = (j_begin / BK) * BK; j0 < j_end; j0 += BK) {
    __syncthreads();                         // the last tile is consumed, qs staged
    stage_rows<T, KLD>(&ks[0][0], BK, D, 1.f, [&](int j) -> const T* {
      return j0 + j < p.Sk ? k + (j0 + j) * p.ks_s : nullptr;
    });
    stage_rows<T, D_MAX>(&vs[0][0], BK, D, 1.f, [&](int j) -> const T* {
      return j0 + j < p.Sk ? v + (j0 + j) * p.vs_s : nullptr;
    });
    __syncthreads();
    const int jj = j0 + lane;                // this lane's key
    const float4* kr = reinterpret_cast<const float4*>(ks[lane]);
    float pj[RPW];                           // this lane's key's weight, per row
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      pj[i] = 0.f;
      const int r = warp + i * WARPS, rr = r0 + r;
      if (rr >= rows) continue;              // uniform across the warp
      const int ia = off + rr / rep;
      const bool vis = jj < p.Sk && (!p.causal || jj <= ia) &&
                       (p.window <= 0 || jj > ia - p.window);
      float s = -INFINITY;
      if (vis) {
        const float4* qr = reinterpret_cast<const float4*>(qs[r]);
        float dot = 0.f;
#pragma unroll 4
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 a = qr[d4], c = kr[d4];
          dot = fmaf(a.x, c.x, dot);
          dot = fmaf(a.y, c.y, dot);
          dot = fmaf(a.z, c.z, dot);
          dot = fmaf(a.w, c.w, dot);
        }
        s = dot;
      }
      float mt = s;
#pragma unroll
      for (int o = 16; o; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(~0u, mt, o));
      const float m_new = fmaxf(m[i], mt);
      if (m_new == -INFINITY) continue;      // no key of this row seen yet
      pj[i] = vis ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);  // 0 while m[i] is −inf
      float ps = pj[i];
#pragma unroll
      for (int o = 16; o; o >>= 1) ps += __shfl_xor_sync(~0u, ps, o);
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int t = 0; t < DL; ++t) acc[i][t] *= corr;
      m[i] = m_new;
    }
    // acc += Σ_j p_j · v_j, keys in order, each V value read once for the
    // warp's rows (a weight of 0 — a row past the end or with no key seen
    // — leaves its sums exactly as they are)
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float vv[DL];
#pragma unroll
      for (int t = 0; t < DL; ++t) {
        const int d = lane + 32 * t;
        vv[t] = d < D ? vs[j][d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pb = __shfl_sync(~0u, pj[i], j);
#pragma unroll
        for (int t = 0; t < DL; ++t) acc[i][t] = fmaf(pb, vv[t], acc[i][t]);
      }
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rr = r0 + warp + i * WARPS;
    if (rr >= rows) continue;
    const int qi = rr / rep, h = kvh * rep + rr % rep;
    T* dst = o + (((size_t)b * p.Sq + qi) * p.Hq + h) * D;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      const int d = lane + 32 * t;
      if (d < D) store(dst + d, l[i] > 0.f ? acc[i][t] / l[i] : 0.f);
    }
  }
}

template <typename T>
void launch(dim3 grid, const Params& p, cudaStream_t s) {
  if (p.D <= 32)
    flash_attention_kernel<T, 1><<<grid, THREADS, 0, s>>>(p);
  else if (p.D <= 64)
    flash_attention_kernel<T, 2><<<grid, THREADS, 0, s>>>(p);
  else
    flash_attention_kernel<T, 4><<<grid, THREADS, 0, s>>>(p);
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  The caller
// has checked shapes, dtypes, devices and strides; these checks only
// refuse what would index out of bounds.  offsets: (B,) int64 on the
// device, or null to use `offset` for every batch row; window 0: none.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               const void* offsets, long long qs_b, long long qs_s,
                               long long qs_h, long long ks_b, long long ks_s,
                               long long ks_h, long long vs_b, long long vs_s,
                               long long vs_h, int B, int Sq, int Sk, int Hq, int Hkv,
                               int D, int offset, int causal, int window, float scale,
                               int is_bf16, void* stream) {
  const int E = is_bf16 ? 8 : 4;               // elements per 16-byte vector
  const auto aligned = [E](const void* ptr, long long sb, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % E == 0 && ss % E == 0 &&
           sh % E == 0;
  };
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || Hkv < 1 || Hkv > 65535 ||
      Hq % Hkv || D < 8 || D > D_MAX || D % 8 || window < 0 ||
      !aligned(q, qs_b, qs_s, qs_h) || !aligned(k, ks_b, ks_s, ks_h) ||
      !aligned(v, vs_b, vs_s, vs_h))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, static_cast<const long long*>(offsets),
                 qs_b, qs_s, qs_h, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h,
                 B, Sq, Sk, Hq, Hkv, D, offset, causal, window, scale};
  const int rows = Sq * (Hq / Hkv);
  const dim3 grid((rows + ROWS - 1) / ROWS, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(grid, p, s);
  else
    launch<float>(grid, p, s);
  return (int)cudaGetLastError();
}
