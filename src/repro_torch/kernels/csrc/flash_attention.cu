// K4: attention forward with an online softmax over key tiles,
//   o[b, i, h] = Σ_j softmax_j(scale · q[b, i, h] · k[b, j, h / rep]) · v[b, j, h / rep]
// over the keys j visible to query i: causal (j ≤ i_abs) and, with a
// window, j > i_abs − window, where i_abs = offset + i and key j sits at
// absolute position j.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_fa_kernel, the pallas_call at
// flash_attention.py:113).  Logits, running max, running sum and
// accumulator in f32, expf (not the fast __expf), the output in q's dtype.
// Two differences of interface: the layout is the port's, q (B, Sq, Hq, D)
// and k, v (B, Sk, Hkv, D) read through their strides (a layer's slice of
// the stacked KV cache is read in place), with GQA handled without
// repeating the KV heads; and the offset is a scalar or a (B,) int64 device
// tensor — every row of the slot pool at its own depth — read by the
// kernel, so a decode step makes no host sync.  One difference of result:
// a query that sees no key returns 0, as the port's plain version
// (kernels/ref.py::flash_attention_ref) does; the TPU kernel masks with a
// finite −1e30 and returns the mean of V for such a row.  No path of the
// model makes one.
//
// What bounds it on an H100: operations for the prefill (Sq = Sk = 256:
// 2·D multiply-adds per visible (query, key) pair and product against 4·D
// bytes of K and V per key, shared by Sq·rep queries) and bytes for a
// decode step (Sq ≤ 4: each visible key's K and V row is read for rep·Sq
// queries).  Two kernels behind one entry point:
//
// * bf16 (every model path): flash_attention_tc_kernel, tensor cores.
//   - A block owns one (batch row, KV head) and 16 (query position, head)
//     rows a warp, 1 to 4 warps, so each K/V tile it stages serves every
//     query head of the group.  Key tiles of 64, double-buffered in shared
//     memory with cp.async (rows padded to D + 8 so ldmatrix is
//     conflict-free); D is padded with zeros to a multiple of 64.
//   - q·kᵀ is mma.sync.m16n8k16 bf16 with f32 accumulation (every product
//     of two bf16 values is exact in f32); the scale multiplies the f32
//     logits — for D = 64 (scale 2⁻³) exactly what scaling q first gives,
//     for other scales one more f32 rounding.
//   - P·V: P is f32 in [0, 1]; it is split into hi = bf16(P) and lo =
//     bf16(P − hi) and both go through the tensor cores against the same V
//     fragments (two MMAs), so each weight keeps 16 significant bits
//     (relative error ≤ 2⁻¹⁶) instead of bf16's 8.
//   - Decode and verify (Sq ≤ 4): the key range is split across blocks
//     ("flash-decoding"), every split the same constant number of keys
//     (the wrapper's SPLIT_KEYS, a whole number of 64-key tiles), so
//     ceil(Sk / chunk) splits whose boundaries do not depend on Sk.  Each
//     block writes its partial (max, sum, unnormalised accumulator) to a
//     workspace; a second launch (flash_attention_combine_kernel) rescales
//     and sums them in split order, skipping empty partials.  Which keys a
//     block sees follows from the offsets read on the device, so a block
//     whose chunk is past the last visible key only writes an empty
//     partial: a longer cache (a pool of larger capacity) adds exactly
//     nothing, and a call whose keys fit one split (no combine: o / l)
//     gives the bits of the split path (weight e⁰ = 1, fmaf(o, 1, 0) = o).
//     The wrapper counts one launch per call.
//   - The logsumexp of each row's logits, lse = m + log(l) in natural units
//     (m is the running max of the scaled f32 logits, l the sum of
//     e^(logit − m)), is written to lse (B, Hq, Sq) f32 when the caller
//     passes that buffer (the training backward reads it): by the one-split
//     epilogue where it divides by l, or by the combine from the combined
//     max and sum; −inf for a row that sees no key.  It is a second output
//     only: o's bits are the same with and without it.
//   - Tiles past the last key any of a block's queries can see — or before
//     the first, with a window — are never loaded.
// * f32 (only the tests feed it on the card): flash_attention_kernel, SIMT
//   f32, the first design:
//   - a block owns one (batch row, KV head) and 16 consecutive rows;
//   - tiles of 32 keys are loaded in 16-byte vectors and staged as f32;
//   - each warp owns 4 rows; per tile, lane j computes the logit of key j
//     for each row, the warp reduces each row's max and sum with shuffles,
//     and each lane then accumulates its D/32 output dims of all 4 rows.
// Operands must start on 16 bytes with strides of whole 16-byte vectors
// (the wrapper checks; the model's tensors and cache slices are).
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
  float* lse;                                // (B, Hq, Sq) logsumexp, or null
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
    if (p.lse && lane == 0)
      p.lse[((size_t)b * p.Hq + h) * p.Sq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
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


// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16)
namespace tc {

constexpr int BKEY = 64;                    // keys a tile
constexpr int MAX_WARPS = 4;                // 16 rows a warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c (16 × 8, f32) += a (16 × 16, bf16, row-major) · b (16 × 8, bf16, col-major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Split {
  float* part_o;                             // (B, Hkv, splits, rows, D) or null
  float* part_ml;                            // (B, Hkv, splits, rows, 2): max, sum
  int splits, chunk;                         // keys a split: a multiple of BKEY
};

// row stride of the shared tiles, in bf16: D padded to DP, + 8 so the 8
// rows of an ldmatrix fall on distinct bank quads
template <int DP>
constexpr int LDS = DP + 8;

template <int DP>
__host__ __device__ constexpr int smem_bytes(int warps) {
  return (16 * warps + 4 * BKEY) * LDS<DP> * 2;
}

template <int DP>
__global__ void __launch_bounds__(MAX_WARPS * 32) flash_attention_tc_kernel(Params p,
                                                                           Split sp) {
  constexpr int LD = LDS<DP>, KD = DP / 16, NB = BKEY / 8, DB = DP / 8;
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const int nw = blockDim.x >> 5, rows_b = 16 * nw;
  __nv_bfloat16* qs = sm;                              // [rows_b][LD]
  __nv_bfloat16* kvs = sm + rows_b * LD;               // [2][K, V][BKEY][LD]
  const int b = blockIdx.z, kvh = blockIdx.y / sp.splits, split = blockIdx.y % sp.splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rep = p.Hq / p.Hkv, rows = p.Sq * rep, D = p.D, dc = D / 8;
  const int r0 = blockIdx.x * rows_b;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qs_b;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  const int off = p.offsets ? (int)p.offsets[b] : p.offset;

  // the keys any of the block's queries can see, within this split
  const int last = min(r0 + rows_b, rows) - 1;
  const int i_lo = off + r0 / rep, i_hi = off + last / rep;
  const int cb = split * sp.chunk, ce = min(p.Sk, cb + sp.chunk);
  const int jb = max(cb, p.window > 0 ? max(0, i_lo - p.window + 1) : 0);
  const int je = min(ce, p.causal ? max(i_hi + 1, 0) : p.Sk);

  // the block's rows: row r = query position r / rep, head kvh·rep + r % rep
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < rows_b * (DP / 8); i += blockDim.x) {
    const int r = i / (DP / 8), c = i % (DP / 8), rr = r0 + r;
    __nv_bfloat16* dst = qs + r * LD + c * 8;
    if (c < dc)
      cp16(dst, q + (rr < rows ? (rr / rep) * p.qs_s + (kvh * rep + rr % rep) * p.qs_h : 0) +
                    c * 8, rr < rows);
    else
      *reinterpret_cast<uint4*>(dst) = zero4;
  }
  if (dc < DP / 8)                                     // K/V dims D..DP: zeros
    for (int i = threadIdx.x; i < 4 * BKEY * (DP / 8 - dc); i += blockDim.x) {
      const int r = i / (DP / 8 - dc), c = dc + i % (DP / 8 - dc);
      *reinterpret_cast<uint4*>(kvs + r * LD + c * 8) = zero4;
    }
  const auto load_kv = [&](int j0, int buf) {
    __nv_bfloat16* ks = kvs + buf * 2 * BKEY * LD;
    __nv_bfloat16* vs = ks + BKEY * LD;
    for (int i = threadIdx.x; i < BKEY * dc; i += blockDim.x) {
      const int j = i / dc, c = i % dc, jj = j0 + j;
      const bool in = jj < p.Sk;
      cp16(ks + j * LD + c * 8, k + (in ? jj : 0) * p.ks_s + c * 8, in);
      cp16(vs + j * LD + c * 8, v + (in ? jj : 0) * p.vs_s + c * 8, in);
    }
  };
  const int t0 = (jb / BKEY) * BKEY;
  if (t0 < je) load_kv(t0, 0);
  cp_commit();

  const int g = lane >> 2, t4 = lane & 3;              // fragment row, column pair
  const int rw = r0 + warp * 16;                       // the warp's first row
  const bool live = rw < rows;
  int ia[2];                                           // absolute positions of rows g, g + 8
  bool rok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = rw + g + 8 * h;
    rok[h] = rr < rows;
    ia[h] = off + rr / rep;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  uint32_t qf[KD][4];

  int buf = 0;
  for (int j0 = t0; j0 < je; j0 += BKEY, buf ^= 1) {
    if (j0 + BKEY < je) load_kv(j0 + BKEY, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (j0 == t0 && live) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kd * 16 +
                            (lane >> 4) * 8);
    }
    if (live) {
      const __nv_bfloat16* ks = kvs + buf * 2 * BKEY * LD;
      const __nv_bfloat16* vs = ks + BKEY * LD;
      // S = q · kᵀ: 16 rows × 64 keys
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2)
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t kf[4];
          ldsm_x4(kf, ks + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kd * 16 +
                          ((lane >> 3) & 1) * 8);
          mma(s[2 * n2], qf[kd], kf[0], kf[1]);
          mma(s[2 * n2 + 1], qf[kd], kf[2], kf[3]);
        }
      // scale, mask, online softmax per row (rows g and g + 8 of the warp)
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, jj = j0 + n * 8 + t4 * 2 + (e & 1);
          const bool vis = rok[h] && jj >= jb && jj < je && (!p.causal || jj <= ia[h]) &&
                           (p.window <= 0 || jj > ia[h] - p.window);
          s[n][e] = vis ? s[n][e] * p.scale : -INFINITY;
          mt[h] = fmaxf(mt[h], s[n][e]);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(~0u, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(~0u, mt[h], 2));
        const float m_new = fmaxf(m[h], mt[h]);
        corr[h] = m_new == -INFINITY ? 1.f : expf(m[h] - m_new);   // 0 while m is −inf
        m[h] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          s[n][e] = s[n][e] == -INFINITY ? 0.f : expf(s[n][e] - m[h]);
          ps[h] += s[n][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(~0u, ps[h], 1);
        ps[h] += __shfl_xor_sync(~0u, ps[h], 2);
        l[h] = l[h] * corr[h] + ps[h];
      }
#pragma unroll
      for (int d = 0; d < DB; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }
      // o += P · V, P = hi + lo in bf16
#pragma unroll
      for (int kk = 0; kk < BKEY / 16; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* src = s[2 * kk + (e >> 1)] + (e & 1) * 2;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(src[0], src[1]);
          ah[e] = *reinterpret_cast<const uint32_t*>(&hi);
          al[e] = pack2(src[0] - __low2float(hi), src[1] - __high2float(hi));
        }
#pragma unroll
        for (int d2 = 0; d2 < DB / 2; ++d2) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + d2 * 16 +
                            (lane >> 4) * 8);
          mma(o[2 * d2], ah, vf[0], vf[1]);
          mma(o[2 * d2], al, vf[0], vf[1]);
          mma(o[2 * d2 + 1], ah, vf[2], vf[3]);
          mma(o[2 * d2 + 1], al, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                                   // the buffer is consumed
  }

  if (!live) return;
  const int bh = b * p.Hkv + kvh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rok[h]) continue;
    const int rr = rw + g + 8 * h;
    if (sp.splits > 1) {
      const size_t base = ((size_t)bh * sp.splits + split) * rows + rr;
      float* po = sp.part_o + base * D;
#pragma unroll
      for (int d = 0; d < DB; ++d)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int dd = d * 8 + t4 * 2 + c;
          if (dd < D) po[dd] = o[d][h * 2 + c];
        }
      if (t4 == 0) {
        sp.part_ml[base * 2] = m[h];
        sp.part_ml[base * 2 + 1] = l[h];
      }
    } else {
      const int qi = rr / rep, hh = kvh * rep + rr % rep;
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.o) +
                           (((size_t)b * p.Sq + qi) * p.Hq + hh) * D;
#pragma unroll
      for (int d = 0; d < DB; ++d)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int dd = d * 8 + t4 * 2 + c;
          if (dd < D) dst[dd] = __float2bfloat16_rn(l[h] > 0.f ? o[d][h * 2 + c] / l[h] : 0.f);
        }
      if (p.lse && t4 == 0)
        p.lse[((size_t)b * p.Hq + hh) * p.Sq + qi] = l[h] > 0.f ? m[h] + logf(l[h]) : -INFINITY;
    }
  }
}

// the splits' partials → the output: o = Σ_s o_s·e^(m_s − M) / Σ_s l_s·e^(m_s − M),
// M = max_s m_s; 0 for a row that saw no key.  One thread an output value.
__global__ void flash_attention_combine_kernel(Params p, Split sp) {
  const int rep = p.Hq / p.Hkv, rows = p.Sq * rep, D = p.D;
  const long long n = (long long)p.B * p.Hkv * rows * D;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d = (int)(i % D);
  const long long rest = i / D;
  const int rr = (int)(rest % rows);
  const int bh = (int)(rest / rows), b = bh / p.Hkv, kvh = bh % p.Hkv;
  const size_t base = (size_t)bh * sp.splits * rows + rr;
  float mx = -INFINITY;
  for (int s = 0; s < sp.splits; ++s) mx = fmaxf(mx, sp.part_ml[(base + (size_t)s * rows) * 2]);
  float num = 0.f, den = 0.f;
  if (mx != -INFINITY)
    for (int s = 0; s < sp.splits; ++s) {
      const size_t at = base + (size_t)s * rows;
      const float ms = sp.part_ml[at * 2];
      if (ms == -INFINITY) continue;
      const float w = expf(ms - mx);
      num = fmaf(sp.part_o[at * D + d], w, num);
      den = fmaf(sp.part_ml[at * 2 + 1], w, den);
    }
  const int qi = rr / rep, h = kvh * rep + rr % rep;
  static_cast<__nv_bfloat16*>(p.o)[(((size_t)b * p.Sq + qi) * p.Hq + h) * D + d] =
      __float2bfloat16_rn(den > 0.f ? num / den : 0.f);
  if (p.lse && d == 0)
    p.lse[((size_t)b * p.Hq + h) * p.Sq + qi] = den > 0.f ? mx + logf(den) : -INFINITY;
}

template <int DP>
cudaError_t launch(const Params& p, const Split& sp, cudaStream_t s) {
  const int rows = p.Sq * (p.Hq / p.Hkv);
  const int warps = min(MAX_WARPS, (rows + 15) / 16);
  static bool sized = false;                 // above 48 KB at DP = 128: once
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_attention_tc_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<DP>(MAX_WARPS));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((rows + 16 * warps - 1) / (16 * warps), p.Hkv * sp.splits, p.B);
  flash_attention_tc_kernel<DP><<<grid, warps * 32, smem_bytes<DP>(warps), s>>>(p, sp);
  if (sp.splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long n = (long long)p.B * p.Hkv * rows * p.D;
    flash_attention_combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, sp);
  }
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  The caller
// has checked shapes, dtypes, devices and strides; these checks only
// refuse what would index out of bounds.  offsets: (B,) int64 on the
// device, or null to use `offset` for every batch row; window 0: none.
// splits > 1 (bf16 only): the key range split across blocks, chunk keys
// each (a multiple of 64, splits = ceil(Sk / chunk)), partials in part_o
// (B, Hkv, splits, Sq·Hq/Hkv, D) and part_ml (…, 2) f32, then combined by a
// second launch.  lse: (B, Hq, Sq) f32 for each row's logsumexp, or null.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               const void* offsets, long long qs_b, long long qs_s,
                               long long qs_h, long long ks_b, long long ks_s,
                               long long ks_h, long long vs_b, long long vs_s,
                               long long vs_h, int B, int Sq, int Sk, int Hq, int Hkv,
                               int D, int offset, int causal, int window, float scale,
                               int is_bf16, int splits, int chunk, void* part_o,
                               void* part_ml, void* lse, void* stream) {
  const int E = is_bf16 ? 8 : 4;               // elements per 16-byte vector
  const auto aligned = [E](const void* ptr, long long sb, long long ss, long long sh) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % E == 0 && ss % E == 0 &&
           sh % E == 0;
  };
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || Hkv < 1 || Hkv > 65535 ||
      Hq % Hkv || D < 8 || D > D_MAX || D % 8 || window < 0 ||
      !aligned(q, qs_b, qs_s, qs_h) || !aligned(k, ks_b, ks_s, ks_h) ||
      !aligned(v, vs_b, vs_s, vs_h) || splits < 1 || (splits > 1 && !is_bf16) ||
      (splits > 1 && (!part_o || !part_ml || chunk < 1 || chunk % tc::BKEY ||
                      (Sk + chunk - 1) / chunk != splits ||
                      (long long)Hkv * splits > 65535)))
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, static_cast<const long long*>(offsets),
                 static_cast<float*>(lse), qs_b, qs_s, qs_h, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h,
                 B, Sq, Sk, Hq, Hkv, D, offset, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // one split: every key in it
    const tc::Split sp{static_cast<float*>(part_o), static_cast<float*>(part_ml), splits,
                       splits > 1 ? chunk : Sk};
    return (int)(D <= 64 ? tc::launch<64>(p, sp, s) : tc::launch<128>(p, sp, s));
  }
  const int rows = Sq * (Hq / Hkv);
  const dim3 grid((rows + ROWS - 1) / ROWS, Hkv, B);
  launch<float>(grid, p, s);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a 4-warp block of the tensor-core kernel at
// head dims padded to dp (64 or 128), for the build report.
extern "C" int flash_attention_tc_smem(int dp) {
  return dp <= 64 ? tc::smem_bytes<64>(tc::MAX_WARPS) : tc::smem_bytes<128>(tc::MAX_WARPS);
}
