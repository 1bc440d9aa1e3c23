// The gradient of online-softmax attention (GQA, causal, sliding window)
// for Hopper (sm_90a): dq, dk, dv from q, k, v, the forward's output o and
// log-sum-exp lse, and the output's gradient do.
//
// Replaces the gradient of the reference's LM-path attention, the lax.scan
// of src/repro/models/layers.py:75 (differentiated by JAX; the reference has
// no backward Pallas kernel), and computes what kernels/ref.py's
// flash_attention_bwd computes:
//
//   q, do (B, Sq, Hq, Dh), k, v (B, Sk, Hkv, Dh), o (B, Sq, Hq, Dh), bf16,
//   contiguous; lse (B, Hq, Sq) f32 in natural log (flash_attention.cu writes
//   it).  Query head h reads kv head h / G; key j is visible to query i when
//   j < Sk, and (causal) j <= i, and (window > 0) i - j < window.
//   s = bf16(q * scale) . k in f32, p = exp(s - lse) (0 where masked),
//   D = rowsum(do * o), dv = p^T do, dp = do v^T, ds = p * (dp - D),
//   dk = ds^T bf16(q * scale), dq = (ds k) * scale.
//
// Rounding points: q * scale is rounded to bf16 (the scale itself is the
// bf16-rounded one the wrapper passes), as the forward rounds it; p is
// rounded to bf16 before p^T do, as the forward rounds p before p . v; ds
// is rounded to bf16 before ds^T q and ds k (the tensor cores' operand;
// the plain version keeps it f32); every product accumulates in f32; dq is
// multiplied by the scale once, at the end, and dq, dk and dv are each
// rounded to bf16 once.
//
// Bound on this card: operations.  The useful work is 5 products of 2 * Dh
// flops per visible (query, key) pair and query head (s, dp, dv, dk, dq):
// 343.7 GFLOP for a global gemma3-1b layer at 4 x 4096, 0.348 ms at 989
// TFLOP/s, against about 117 MB of bytes (0.035 ms).
//
// Design (a simple, deterministic kernel first; a wgmma/TMA backward is
// later work): FA2's split into three launches on mma.sync.m16n8k16 bf16
// with f32 accumulators, no atomics, so two calls give the same bits.
//
// 1. flash_bwd_delta: D = rowsum(do * o) in f32, one warp per row.
// 2. flash_bwd_dkdv: one CTA of 8 warps per (b, kv head, 64-key tile).  K
//    and V stay in shared memory; the CTA walks the G query heads of its kv
//    head and, for each, only the 64-query tiles that can see its keys
//    (from the tile's first key, causal, up to its last key + window - 1).
//    Per query tile, warp (kw, hw) computes s^T and dp^T for keys 16 kw ..
//    16 kw + 15 and queries 32 hw .. 32 hw + 31, writes p^T and ds^T (bf16)
//    to shared memory, and after a barrier accumulates dv and dk for its 16
//    keys and the hw-th half of the head dim (so at Dh 256 a thread holds
//    64 + 64 f32 accumulators, not 256).  GQA needs no atomics: one CTA
//    owns every query head of its keys.
// 3. flash_bwd_dq: one CTA of 8 warps per (b, query head, 64-query tile),
//    walking the key tiles its rows can see; the same split (s and dp for
//    16 queries x 32 keys, ds through shared memory, dq for 16 queries and
//    half the head dim).
//
// The split pays two extra products (s and dp are computed in both
// kernels: 7 against 5) for determinism.  Dh: any multiple of 16 up to 256
// (templates for Dh <= 64, 128, 256; rows padded by 8 elements in shared
// memory so that fragment loads are free of bank conflicts).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // queries per query tile, keys per key tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdP = kTile + 8;  // padded row of the p^T / ds tiles

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ bool visible(int i, int j, int Sk, int causal,
                                        int window) {
  return j < Sk && (!causal || j <= i) && (window <= 0 || i - j < window);
}

// The A fragment (16 x 16, row-major) of a bf16 tile with row stride ld:
// this thread's rows r and r + 8 (r = the fragment's first row + lane / 4)
// and columns c + 2 * (lane % 4) and 8 past them.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* t,
                                       int ld, int r, int c) {
  const int tig = threadIdx.x & 3;
  const __nv_bfloat16* p = t + r * ld + c + tig * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// kTile rows of a (B, S, H, Dh) tensor, from row r0 of one (b, head), into
// shared memory with row stride ld; rows past S are zero.  With `scaled`
// each value becomes bf16(x * scale), as the reference rounds q * scale.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* base,
                                          size_t step, int r0, int S, int Dh,
                                          bool scaled, float scale) {
  const int chunks = Dh / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < kTile * chunks; e += kThreads) {
    const int r = e / chunks, c = (e % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(base + (r0 + r) * step + c);
    if (scaled) {
      __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// kTile entries of one (b, head)'s row statistic (lse or D), 0 past S.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = r0 + r < S ? src[r0 + r] : 0.f;
}

// acc (16 rows x DMAX / 2 columns from c0) += A (16 rows x kTile, bf16 in
// shared memory with stride kLdP; r is this thread's row, as for load_a)
// B (kTile rows x the columns, bf16 in shared memory with stride ld, read
// transposed by ldmatrix).
template <int DMAX>
__device__ __forceinline__ void acc_product(float (&acc)[DMAX / 16][4],
                                            const __nv_bfloat16* A, int r,
                                            const __nv_bfloat16* Bt, int ld,
                                            int c0, int Dh) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t a[4];
    load_a(a, A, kLdP, r, kk * 16);
#pragma unroll
    for (int n = 0; n < DMAX / 16; n += 2) {
      if (c0 + n * 8 < Dh) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Bt + (kk * 16 + (mat & 1) * 8 + mr) * ld + c0 +
                                 (n + (mat >> 1)) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }
}

// X (16 rows from r0) . Y^T (32 rows from r1) over Dh for two
// pairs at once: s = X1 Y1^T and t = X2 Y2^T, each 16 x 32 in the
// accumulator layout (n-tile n holds columns 8n + 2 (lane % 4) + {0, 1}).
template <int DMAX>
__device__ __forceinline__ void two_products(
    float (&s)[4][4], float (&t)[4][4], const __nv_bfloat16* X1,
    const __nv_bfloat16* Y1, const __nv_bfloat16* X2,
    const __nv_bfloat16* Y2, int ld, int r0, int r1, int Dh) {
  const int g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = t[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk * 16 < Dh) {
      uint32_t a1[4], a2[4];
      load_a(a1, X1, ld, r0 + g, kk * 16);
      load_a(a2, X2, ld, r0 + g, kk * 16);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int off = (r1 + n * 8 + g) * ld + kk * 16 + tig * 2;
        mma_bf16(s[n], a1, ld32(Y1 + off), ld32(Y1 + off + 8));
        mma_bf16(t[n], a2, ld32(Y2 + off), ld32(Y2 + off + 8));
      }
    }
  }
}

// ---------------------------------------------------------------- D ----
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ delta, long long rows, int Sq, int Hq,
                int Dh) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat16* op = o + row * Dh;
  const __nv_bfloat16* dp = dout + row * Dh;
  float acc = 0.f;
  for (int d = 2 * lane; d < Dh; d += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(op + d));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dp + d));
    acc += a.x * b.x + a.y * b.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // rows run over (b, i, h); D is (b, h, i)
    const int h = static_cast<int>(row % Hq);
    const long long bi = row / Hq;
    const int i = static_cast<int>(bi % Sq);
    const long long b = bi / Sq;
    delta[(b * Hq + h) * Sq + i] = acc;
  }
}

// ---------------------------------------------------------- dk, dv ----
template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int Sq, int Sk, int Hq, int Hkv, int Dh, int causal, int window,
               float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 8;  // padded row, in elements
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * ld;
  __nv_bfloat16* Qs = Vs + kTile * ld;
  __nv_bfloat16* dOs = Qs + kTile * ld;
  __nv_bfloat16* Ps = dOs + kTile * ld;  // p^T: keys x queries
  __nv_bfloat16* dSs = Ps + kTile * kLdP;  // ds^T: keys x queries
  float* Ls = reinterpret_cast<float*>(dSs + kTile * kLdP);
  float* Ds = Ls + kTile;

  const int j0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int kw = warp & 3, hw = warp >> 2;
  const int krow = 16 * kw;        // this warp's first key row in the tile
  const int qcol = 32 * hw;        // its first query column of s^T, dp^T
  const int c0 = hw * (DMAX / 2);  // its first accumulator column

  const size_t q_step = static_cast<size_t>(Hq) * Dh;  // between positions
  const size_t kv_step = static_cast<size_t>(Hkv) * Dh;
  load_tile(Ks, ld, k + (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh,
            kv_step, j0, Sk, Dh, false, 0.f);
  load_tile(Vs, ld, v + (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh,
            kv_step, j0, Sk, Dh, false, 0.f);

  // the query tiles that can see a key of this tile
  const int j_last = min(j0 + kTile, Sk) - 1;
  const int i_lo = causal ? j0 : 0;
  long long hi = Sq - 1;
  if (window > 0)
    hi = min(hi, static_cast<long long>(j_last) + window - 1);
  const int t_lo = i_lo / kTile;
  const int t_hi = hi < i_lo ? t_lo - 1 : static_cast<int>(hi / kTile);

  constexpr int NC = DMAX / 16;  // 8-column n-tiles in half the head dim
  float acc_dv[NC][4], acc_dk[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[n][e] = acc_dk[n][e] = 0.f;

  for (int gh = 0; gh < G; ++gh) {
    const int h = hk * G + gh;
    const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * Hq + h) * Dh;
    const __nv_bfloat16* dob =
        dout + (static_cast<size_t>(b) * Sq * Hq + h) * Dh;
    const float* lse_h = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
    const float* delta_h = delta + (static_cast<size_t>(b) * Hq + h) * Sq;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int i0 = t * kTile;
      __syncthreads();  // the previous tile is consumed
      load_tile(Qs, ld, qb, q_step, i0, Sq, Dh, true, scale);
      load_tile(dOs, ld, dob, q_step, i0, Sq, Dh, false, 0.f);
      load_rows(Ls, lse_h, i0, Sq);
      load_rows(Ds, delta_h, i0, Sq);
      __syncthreads();

      // s^T = K Q^T and dp^T = V dO^T: 16 keys x 32 queries
      float s[4][4], dp[4][4];
      two_products<DMAX>(s, dp, Ks, Qs, Vs, dOs, ld, krow, qcol, Dh);
      // p^T = exp(s^T - lse), ds^T = p^T (dp^T - D), into shared memory
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kr = krow + g + 8 * r;
          const int qc = qcol + n * 8 + tig * 2;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + qc + e;
            p[e] = i < Sq && visible(i, j0 + kr, Sk, causal, window)
                       ? expf(s[n][2 * r + e] - Ls[qc + e])
                       : 0.f;
            ds[e] = p[e] * (dp[n][2 * r + e] - Ds[qc + e]);
          }
          *reinterpret_cast<uint32_t*>(Ps + kr * kLdP + qc) =
              pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(dSs + kr * kLdP + qc) =
              pack_bf16(ds[0], ds[1]);
        }
      }
      __syncthreads();
      // dv += p^T dO, dk += ds^T bf16(q * scale) over the tile's 64 queries
      acc_product<DMAX>(acc_dv, Ps, krow + g, dOs, ld, c0, Dh);
      acc_product<DMAX>(acc_dk, dSs, krow + g, Qs, ld, c0, Dh);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + krow + g + 8 * r;
    if (j >= Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * Sk + j) * Hkv + hk) * Dh;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = c0 + n * 8 + tig * 2;
      if (c < Dh) {
        *reinterpret_cast<uint32_t*>(dk + off + c) =
            pack_bf16(acc_dk[n][2 * r], acc_dk[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + c) =
            pack_bf16(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
      }
    }
  }
}

// --------------------------------------------------------------- dq ----
template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv,
             int Dh, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kTile * ld;
  __nv_bfloat16* Ks = dOs + kTile * ld;
  __nv_bfloat16* Vs = Ks + kTile * ld;
  __nv_bfloat16* dSs = Vs + kTile * ld;  // ds: queries x keys
  float* Ls = reinterpret_cast<float*>(dSs + kTile * kLdP);
  float* Ds = Ls + kTile;

  const int i0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int qw = warp & 3, hw = warp >> 2;
  const int qrow = 16 * qw;        // this warp's first query row
  const int kcol = 32 * hw;        // its first key column of s, dp
  const int c0 = hw * (DMAX / 2);  // its first accumulator column

  const size_t q_step = static_cast<size_t>(Hq) * Dh;
  const size_t kv_step = static_cast<size_t>(Hkv) * Dh;
  const size_t q_off = (static_cast<size_t>(b) * Sq * Hq + h) * Dh;
  load_tile(Qs, ld, q + q_off, q_step, i0, Sq, Dh, true, scale);
  load_tile(dOs, ld, dout + q_off, q_step, i0, Sq, Dh, false, 0.f);
  load_rows(Ls, lse + (static_cast<size_t>(b) * Hq + h) * Sq, i0, Sq);
  load_rows(Ds, delta + (static_cast<size_t>(b) * Hq + h) * Sq, i0, Sq);
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh;

  // the key tiles rows [i0, i0 + kTile) can see
  int hi = Sk - 1;
  if (causal) hi = min(hi, i0 + kTile - 1);
  const int lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int t_lo = lo / kTile;
  const int t_hi = hi < lo ? t_lo - 1 : hi / kTile;

  constexpr int NC = DMAX / 16;
  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int j0 = t * kTile;
    __syncthreads();  // the previous tile is consumed
    load_tile(Ks, ld, kb, kv_step, j0, Sk, Dh, false, 0.f);
    load_tile(Vs, ld, vb, kv_step, j0, Sk, Dh, false, 0.f);
    __syncthreads();

    // s = Q K^T and dp = dO V^T: 16 queries x 32 keys
    float s[4][4], dp[4][4];
    two_products<DMAX>(s, dp, Qs, Ks, dOs, Vs, ld, qrow, kcol, Dh);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qr = qrow + g + 8 * r;
        const int kc = kcol + n * 8 + tig * 2;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = visible(i0 + qr, j0 + kc + e, Sk, causal, window)
                              ? expf(s[n][2 * r + e] - Ls[qr])
                              : 0.f;
          ds[e] = p * (dp[n][2 * r + e] - Ds[qr]);
        }
        *reinterpret_cast<uint32_t*>(dSs + qr * kLdP + kc) =
            pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();
    // dq += ds K over the tile's 64 keys
    acc_product<DMAX>(acc, dSs, qrow + g, Ks, ld, c0, Dh);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + qrow + g + 8 * r;
    if (i >= Sq) continue;
    __nv_bfloat16* row = dq + ((static_cast<size_t>(b) * Sq + i) * Hq + h) * Dh;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = c0 + n * 8 + tig * 2;
      if (c < Dh)
        *reinterpret_cast<uint32_t*>(row + c) =
            pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

template <int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                   int Hkv, int Dh, int causal, int window, float scale,
                   cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t smem = (4 * static_cast<size_t>(kTile) * (Dh + 8) +
                       2 * static_cast<size_t>(kTile) * kLdP) * sizeof(bf) +
                      2 * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (Sk > 0) {
    dim3 grid((Sk + kTile - 1) / kTile, Hkv, B);
    flash_bwd_dkdv<DMAX><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
        static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, Hq, Hkv, Dh,
        causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  flash_bwd_dq<DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), Sq, Sk, Hq, Hkv, Dh, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; Dh a multiple of 16 up to 256, every pointer 16-byte aligned
// (the wrapper checks); window <= 0 means unbounded.  delta is scratch of
// B * Hq * Sq floats.  Launches the three kernels on `stream` and returns
// the first launch error.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int Dh, int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return cudaSuccess;
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_bwd_delta<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, rows, Sq, Hq, Dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Dh <= 64)
    return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq,
                      Hkv, Dh, causal, window, scale, st);
  if (Dh <= 128)
    return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq,
                       Hkv, Dh, causal, window, scale, st);
  return launch<256>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq,
                     Hkv, Dh, causal, window, scale, st);
}
