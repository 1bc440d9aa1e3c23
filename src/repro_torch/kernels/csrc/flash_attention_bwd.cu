// The gradient of online-softmax attention (GQA, causal, sliding window)
// for Hopper (sm_90a): dq, dk, dv from q, k, v, the forward's output o and
// log-sum-exp lse, and the output's gradient do.
//
// Replaces the gradient of the reference's LM-path attention, the lax.scan
// of src/repro/models/layers.py:75 (differentiated by JAX; the reference has
// no backward Pallas kernel), and computes what kernels/ref.py's
// flash_attention_bwd computes:
//
//   q, do (B, Sq, Hq, Dh), k, v (B, Sk, Hkv, Dh), o (B, Sq, Hq, Dh), bf16
//   (f32 on the simt route), contiguous; lse (B, Hq, Sq) f32 in natural log (flash_attention.cu writes
//   it).  Query head h reads kv head h / G; query i sits at key position
//   i + shift (shift = q_offset - kv_offset: a mesh position's sequence
//   block, 0 on one card); key j is visible to query i when j < Sk, and
//   (causal) j <= i + shift, and (window > 0) i + shift - j < window.  The
//   shift moves the query and key tile ranges each CTA walks and its masks;
//   the pre-pass and the scratch do not depend on it.
//   s = bf16(q * scale) . k in f32, p = exp(s - lse) (0 where masked),
//   D = rowsum(do * o), dv = p^T do, dp = do v^T, ds = p * (dp - D),
//   dk = ds^T bf16(q * scale), dq = (ds k) * scale.
//
// Rounding points: q * scale is rounded to bf16 (the scale itself is the
// bf16-rounded one the wrapper passes), as the forward rounds it; p is
// rounded to bf16 before p^T do, as the forward rounds p before p . v; on
// both bf16 routes ds stays f32 as in the plain version: the tensor cores
// take it as two bf16 parts, hi = bf16(ds) and lo = bf16(ds - hi) (about
// 16 bits of ds), so ds^T q and ds k are each two products, hi's and lo's,
// into the same f32 accumulator (with ds rounded to bf16 once, the error
// of dk and dq over rows that see a few hundred keys reached 2.6 times the
// plain version's); every product
// accumulates in f32; dq is multiplied by the scale once, at
// the end, and dq, dk and dv are each rounded to bf16 once.
//
// Bound on this card: operations.  The useful work is 5 products of 2 * Dh
// flops per visible (query, key) pair and query head (s, dp, dv, dk, dq):
// 343.7 GFLOP for a global gemma3-1b layer at 4 x 4096, 0.348 ms at 989
// TFLOP/s, against about 117 MB of bytes (0.035 ms).
//
// Three routes, chosen by (dtype, Dh) alone (flash_attention_bwd_route;
// the wrapper's flash_bwd_route states the same rule).  All are deterministic
// (no atomics: two calls give the same bits) and split the work FA2's way
// into dk/dv work that owns a key tile and dq work that owns query rows,
// so s and dp are computed for both (7 products against 5; on wgmma ds's
// two parts make dk and dq two products each, 9).  At Dh 256 a
// fixed-order dq sum inside the dk/dv work would move a 64 x 256 f32
// partial per (key tile, query tile) pair, gigabytes at 4 x 4096.
//
// wgmma (bf16, Dh 64, 80, 128 or 256: gemma3, stablelm, qwen2.5,
// minitron).  Two launches.  Query rows are GQA-packed as in the forward:
// the G query heads of a position are neighbouring rows (row = position *
// G + head), 64 rows to a tile (64 / G positions; a 5-D tensor map over q
// viewed as (B, Sq, Hkv, G, Dh)), so one K/V tile serves all G heads.  A
// tile is Dh / 64 boxes of 64 columns (128-byte swizzle) and, at Dh 80, a
// box of the last 16 columns (32-byte rows, 32-byte swizzle, tensor maps
// of their own): one more k-step in the products over Dh, and an m64n16k16
// into an accumulator of its own beside each m64n64k16 over Dh.
//
// 1. flash_bwd_prep, one warp per two packed rows: D = rowsum(do * o) and
//    lse * log2 e in the packed order (64 floats a tile, so a stage loads
//    them with one bulk copy; rows that are no real (position, head) get
//    lse2 = +inf and D = 0, so their p and ds are 0), and, when the scale
//    is not a power of two (Dh 80, 128), bf16(q * scale) once for both
//    products that read q.  Otherwise the scale is folded into the exp2
//    constant c and into the dk and dq epilogues, which is exact.
//    p = 2^(s c - lse2).
// 2. flash_bwd_wgmma: CTAs of three warpgroups, a producer that gives up
//    registers (setmaxnreg) and issues every TMA load from one thread into
//    rings with full and empty mbarriers, and two consumers that run
//    wgmma.  The first CTAs own a key tile each (dk, dv), the rest two
//    query tiles each (dq), so the SMs that finish their dk/dv tiles take
//    dq tiles while the last dk/dv tiles run; both kinds are ordered
//    heaviest first on causal grids.
//    dk/dv CTA, per (b, kv head, 64-key tile): K and V loaded once; the
//    (Q, dO) tiles of the query tiles that can see the keys, for every
//    head block, stream through a ring (2 stages at Dh 256, 4 below) with
//    their lse2 and D.  Consumer 0 computes S^T = K Q^T (wgmma m64n64k16
//    from shared memory), P^T in registers (masked only on tiles that
//    straddle the causal diagonal, the window or Sk, by the range of
//    columns each key sees), hands the f32 P^T to consumer 1 through a
//    double-buffered 16 KB shared tile, and runs dV += P^T dO with P^T
//    (bf16) as the register operand and dO read transposed (wgmma
//    m64n{Dh}k16).  Consumer 1 computes dP^T = V dO^T, dS^T = P^T (dP^T -
//    D), and dK += dS^T Q the same way, once for each of dS^T's parts.  So
//    each consumer holds one 64 x Dh f32 accumulator (128 registers a
//    thread at Dh 256), not two.  Rows of a tile that TMA never writes (64
//    is not a multiple of G) are zeroed once, so P^T's zeros meet finite
//    rows.
//    dq CTA, per two neighbouring 64-row query tiles, one per consumer: Q
//    and dO loaded once, K and V tiles of the key tiles either tile can see
//    through two rings, so each is loaded once for 128 rows: with 64 rows
//    a CTA, L2 moved about as many bytes as the products took time.  dP =
//    dO V^T first, so the V tile is free at once (1 stage at Dh 256), then
//    S = Q K^T (ss), dS in registers, and dQ += dS K (rs, one product for
//    each of dS's parts, K read transposed; 2 K stages at Dh 256).
//
// Shared memory at Dh 256: a dk/dv CTA 64 KB of K and V + 2 stages x 64 KB
// of Q and dO + 32 KB of P^T + 1 KB of row statistics = 225 KB of the 227
// KB a CTA may use (+ barriers and 1 KB to align); a dq CTA 128 KB of Q and
// dO + 2 K tiles + 1 V tile = 224 KB.
//
// mma.sync (bf16, other Dh: the smoke configs' 16), the first design,
// three launches on mma.sync.m16n8k16 bf16 with f32 accumulators:
//
// 1. flash_bwd_delta: D = rowsum(do * o) in f32, one warp per row.
// 2. flash_bwd_dkdv: one CTA of 8 warps per (b, kv head, 64-key tile).  K
//    and V stay in shared memory; the CTA walks the G query heads of its kv
//    head and, for each, only the 64-query tiles that can see its keys
//    (from the tile's first key, causal, up to its last key + window - 1).
//    Per query tile, warp (kw, hw) computes s^T and dp^T for keys 16 kw ..
//    16 kw + 15 and queries 32 hw .. 32 hw + 31, writes p^T and ds^T's two
//    parts (bf16) to shared memory, and after a barrier accumulates dv and
//    dk (hi's product, then lo's) for its 16 keys and the hw-th half of
//    the head dim (so at Dh 256 a thread holds
//    64 + 64 f32 accumulators, not 256).  GQA needs no atomics: one CTA
//    owns every query head of its keys.
// 3. flash_bwd_dq: one CTA of 8 warps per (b, query head, 64-query tile),
//    walking the key tiles its rows can see; the same split (s and dp for
//    16 queries x 32 keys, ds's two parts through shared memory, dq for 16
//    queries and half the head dim).
//
// Dh: any multiple of 16 up to 256 (templates for Dh <= 64, 128, 256;
// rows padded by 8 elements in shared memory so that fragment loads are
// free of bank conflicts).
//
// simt (f32, any Dh: what autograd through an f32 call needs; no model
// trains in f32, so no main path launches it): the mma.sync route's three
// launches in f32 with every product on the CUDA cores (no tensor cores:
// TF32 would keep about 10 bits of each operand, and the route must match
// the CPU's f32), so nothing is rounded but each f32 operation: s = (q *
// scale) . k, p, ds, dq, dk and dv stay f32.  32-row tiles of Dh + 1
// floats (four of them, 132 KB at Dh 256, plus the p^T and ds^T tiles);
// each thread computes s and dp for one key and 4 queries, and owns 4 rows
// x Dh / 32 columns of the f32 accumulators.  Bound on this card at
// gemma3-1b's f32 shapes: operations at the CUDA cores' f32 rate (about
// 67 TFLOP/s); the design is the simple one (each s and dp term reads a
// shared-memory operand per FMA), made right before it is made fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

using hopper::pack_bf16;

// What rounding x to bf16 drops (exact in f32): ds = bf16(ds) + this.
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Key j is visible to the query at key position i (a query's index plus
// shift = q_offset - kv_offset).
__device__ __forceinline__ bool visible(int i, int j, int Sk, int causal,
                                        int window) {
  return j < Sk && (!causal || j <= i) &&
         (window <= 0 || static_cast<long long>(i) - j < window);
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
               int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 8;  // padded row, in elements
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * ld;
  __nv_bfloat16* Qs = Vs + kTile * ld;
  __nv_bfloat16* dOs = Qs + kTile * ld;
  __nv_bfloat16* Ps = dOs + kTile * ld;  // p^T: keys x queries
  __nv_bfloat16* dSs = Ps + kTile * kLdP;  // bf16(ds)^T: keys x queries
  __nv_bfloat16* dSl = dSs + kTile * kLdP;  // the rest of ds^T (two parts)
  float* Ls = reinterpret_cast<float*>(dSl + kTile * kLdP);
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

  // the query tiles that can see a key of this tile (query i sits at key
  // position i + shift)
  const int j_last = min(j0 + kTile, Sk) - 1;
  const long long i_lo =
      causal ? max(0LL, static_cast<long long>(j0) - shift) : 0;
  long long hi = Sq - 1;
  if (window > 0)
    hi = min(hi, static_cast<long long>(j_last) + window - 1 - shift);
  const int t_lo = hi < i_lo ? 0 : static_cast<int>(i_lo / kTile);
  const int t_hi = hi < i_lo ? -1 : static_cast<int>(hi / kTile);

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
            p[e] = i < Sq && visible(i + shift, j0 + kr, Sk, causal, window)
                       ? expf(s[n][2 * r + e] - Ls[qc + e])
                       : 0.f;
            ds[e] = p[e] * (dp[n][2 * r + e] - Ds[qc + e]);
          }
          *reinterpret_cast<uint32_t*>(Ps + kr * kLdP + qc) =
              pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(dSs + kr * kLdP + qc) =
              pack_bf16(ds[0], ds[1]);
          *reinterpret_cast<uint32_t*>(dSl + kr * kLdP + qc) =
              pack_bf16(bf16_rest(ds[0]), bf16_rest(ds[1]));
        }
      }
      __syncthreads();
      // dv += p^T dO, dk += ds^T bf16(q * scale) over the tile's 64 queries
      // (ds's two parts, hi first, into one accumulator)
      acc_product<DMAX>(acc_dv, Ps, krow + g, dOs, ld, c0, Dh);
      acc_product<DMAX>(acc_dk, dSs, krow + g, Qs, ld, c0, Dh);
      acc_product<DMAX>(acc_dk, dSl, krow + g, Qs, ld, c0, Dh);
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
             int Dh, int causal, int window, int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 8;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kTile * ld;
  __nv_bfloat16* Ks = dOs + kTile * ld;
  __nv_bfloat16* Vs = Ks + kTile * ld;
  __nv_bfloat16* dSs = Vs + kTile * ld;  // bf16(ds): queries x keys
  __nv_bfloat16* dSl = dSs + kTile * kLdP;  // the rest of ds (two parts)
  float* Ls = reinterpret_cast<float*>(dSl + kTile * kLdP);
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

  // the key tiles rows [i0, i0 + kTile) can see (at key positions shifted
  // by shift)
  long long hi = Sk - 1;
  if (causal) hi = min(hi, static_cast<long long>(i0) + kTile - 1 + shift);
  const long long lo =
      window > 0 ? max(0LL, static_cast<long long>(i0) + shift - window + 1)
                 : 0;
  const int t_lo = hi < lo ? 0 : static_cast<int>(lo / kTile);
  const int t_hi = hi < lo ? -1 : static_cast<int>(hi / kTile);

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
          const float p = visible(i0 + qr + shift, j0 + kc + e, Sk, causal,
                                  window)
                              ? expf(s[n][2 * r + e] - Ls[qr])
                              : 0.f;
          ds[e] = p * (dp[n][2 * r + e] - Ds[qr]);
        }
        *reinterpret_cast<uint32_t*>(dSs + qr * kLdP + kc) =
            pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(dSl + qr * kLdP + kc) =
            pack_bf16(bf16_rest(ds[0]), bf16_rest(ds[1]));
      }
    }
    __syncthreads();
    // dq += ds K over the tile's 64 keys (ds's two parts, hi first)
    acc_product<DMAX>(acc, dSs, qrow + g, Ks, ld, c0, Dh);
    acc_product<DMAX>(acc, dSl, qrow + g, Ks, ld, c0, Dh);
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
                   int Hkv, int Dh, int causal, int window, int shift,
                   float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t smem = (4 * static_cast<size_t>(kTile) * (Dh + 8) +
                       3 * static_cast<size_t>(kTile) * kLdP) * sizeof(bf) +
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
        causal, window, shift, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  flash_bwd_dq<DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), Sq, Sk, Hq, Hkv, Dh, causal, window, shift,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------- f32 (simt) route ----
constexpr int kF32Tile = 32;  // keys per key tile, queries per query tile
constexpr int kF32Ld = kF32Tile + 1;  // padded row of the p^T / ds tiles
constexpr int kF32Rows = kF32Tile / (kThreads / 32);  // rows a warp owns: 4
constexpr int kF32Cols = 8;  // Dh <= 256 = 8 x 32 lanes

// D = rowsum(do * o) in f32, one warp per row: lane l sums columns l, l +
// 32, ... in order, then the warp's shuffle tree.
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_f32(const float* __restrict__ o,
                    const float* __restrict__ dout, float* __restrict__ delta,
                    long long rows, int Sq, int Hq, int Dh) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32) acc += o[row * Dh + d] * dout[row * Dh + d];
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

// kF32Tile rows of one (b, head) of a (B, S, H, Dh) f32 tensor, from row
// r0, into shared memory with row stride ld, each value times mul; rows
// past S are zero.
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* base,
                                         size_t step, int r0, int S, int Dh,
                                         float mul) {
  for (int e = threadIdx.x; e < kF32Tile * Dh; e += kThreads) {
    const int r = e / Dh, c = e % Dh;
    dst[r * ld + c] = r0 + r < S ? base[(r0 + r) * step + c] * mul : 0.f;
  }
}

// The f32 backward: the mma.sync route's split (dk/dv CTAs that own a key
// tile, dq CTAs that own query rows, D from the pre-pass) in 32-row tiles
// of f32 in shared memory, every product on the CUDA cores.  Rows are
// padded to Dh + 1 floats, so lane l reading row l is free of bank
// conflicts while the 4 rows a warp owns are read as broadcasts.
//
// dk/dv CTA per (b, kv head, 32-key tile): K and V loaded once; for each of
// the G query heads in order and each 32-query tile that can see the keys,
// in order: s^T = K (q * scale)^T and dp^T = V dO^T for key `lane` and the
// warp's 4 queries (sums over Dh in column order), p^T = exp(s^T - lse) (0
// where masked or past Sq) and ds^T = p^T (dp^T - D) into shared memory,
// then dv += p^T dO and dk += ds^T (q * scale) for the warp's 4 keys and
// columns lane + 32 c, summed over the tile's queries in order.  So dk and
// dv sum over heads, tiles and queries in one fixed order: no atomics.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                   int Dh, int causal, int window, int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 1;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kF32Tile * ld;
  float* Qs = Vs + kF32Tile * ld;  // q * scale
  float* dOs = Qs + kF32Tile * ld;
  float* Ps = dOs + kF32Tile * ld;      // p^T: keys x queries
  float* dSs = Ps + kF32Tile * kF32Ld;  // ds^T
  float* Ls = dSs + kF32Tile * kF32Ld;
  float* Ds = Ls + kF32Tile;

  const int j0 = blockIdx.x * kF32Tile;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = kF32Rows * warp;  // the warp's first query (s^T), key (dk)
  const size_t q_step = static_cast<size_t>(Hq) * Dh;
  const size_t kv_step = static_cast<size_t>(Hkv) * Dh;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh;
  load_f32(Ks, ld, k + kv_off, kv_step, j0, Sk, Dh, 1.f);
  load_f32(Vs, ld, v + kv_off, kv_step, j0, Sk, Dh, 1.f);

  // the query tiles that can see a key of this tile
  const int j_last = min(j0 + kF32Tile, Sk) - 1;
  const long long i_lo =
      causal ? max(0LL, static_cast<long long>(j0) - shift) : 0;
  long long hi = Sq - 1;
  if (window > 0)
    hi = min(hi, static_cast<long long>(j_last) + window - 1 - shift);
  const int t_lo = hi < i_lo ? 0 : static_cast<int>(i_lo / kF32Tile);
  const int t_hi = hi < i_lo ? -1 : static_cast<int>(hi / kF32Tile);

  float acc_dk[kF32Rows][kF32Cols], acc_dv[kF32Rows][kF32Cols];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  for (int gh = 0; gh < G; ++gh) {
    const int h = hk * G + gh;
    const size_t q_off = (static_cast<size_t>(b) * Sq * Hq + h) * Dh;
    const float* lse_h = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
    const float* delta_h = delta + (static_cast<size_t>(b) * Hq + h) * Sq;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int i0 = t * kF32Tile;
      __syncthreads();  // the previous tile is consumed
      load_f32(Qs, ld, q + q_off, q_step, i0, Sq, Dh, scale);
      load_f32(dOs, ld, dout + q_off, q_step, i0, Sq, Dh, 1.f);
      for (int r = threadIdx.x; r < kF32Tile; r += kThreads) {
        Ls[r] = i0 + r < Sq ? lse_h[i0 + r] : 0.f;
        Ds[r] = i0 + r < Sq ? delta_h[i0 + r] : 0.f;
      }
      __syncthreads();

      float s[kF32Rows], dp[kF32Rows];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) s[r] = dp[r] = 0.f;
      for (int d = 0; d < Dh; ++d) {
        const float kd = Ks[lane * ld + d], vd = Vs[lane * ld + d];
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          s[r] += kd * Qs[(r0 + r) * ld + d];
          dp[r] += vd * dOs[(r0 + r) * ld + d];
        }
      }
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const int i = i0 + r0 + r;
        const float p = i < Sq && visible(i + shift, j0 + lane, Sk, causal,
                                          window)
                            ? expf(s[r] - Ls[r0 + r])
                            : 0.f;
        Ps[lane * kF32Ld + r0 + r] = p;
        dSs[lane * kF32Ld + r0 + r] = p * (dp[r] - Ds[r0 + r]);
      }
      __syncthreads();
      for (int qq = 0; qq < kF32Tile; ++qq) {
        float qv[kF32Cols], dov[kF32Cols];
#pragma unroll
        for (int c = 0; c < kF32Cols; ++c) {
          const int d = lane + 32 * c;
          qv[c] = d < Dh ? Qs[qq * ld + d] : 0.f;
          dov[c] = d < Dh ? dOs[qq * ld + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float p = Ps[(r0 + r) * kF32Ld + qq];
          const float ds = dSs[(r0 + r) * kF32Ld + qq];
#pragma unroll
          for (int c = 0; c < kF32Cols; ++c) {
            acc_dv[r][c] += p * dov[c];
            acc_dk[r][c] += ds * qv[c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int j = j0 + r0 + r;
    if (j >= Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * Sk + j) * Hkv + hk) * Dh;
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) {
        dk[off + d] = acc_dk[r][c];
        dv[off + d] = acc_dv[r][c];
      }
    }
  }
}

// dq CTA per (b, query head, 32-query tile): q * scale and dO loaded once;
// for each key tile its rows can see, in order: s and dp for the warp's 4
// queries and key `lane`, ds = p (dp - D) into shared memory, then dq += ds
// K for the warp's 4 queries and columns lane + 32 c, summed over the
// tile's keys in order; dq times the scale once, at the end.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int Sq, int Sk, int Hq, int Hkv, int Dh, int causal,
                 int window, int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 1;
  float* Qs = reinterpret_cast<float*>(smem);  // q * scale
  float* dOs = Qs + kF32Tile * ld;
  float* Ks = dOs + kF32Tile * ld;
  float* Vs = Ks + kF32Tile * ld;
  float* dSs = Vs + kF32Tile * ld;  // ds: queries x keys
  float* Ls = dSs + kF32Tile * kF32Ld;
  float* Ds = Ls + kF32Tile;

  const int i0 = blockIdx.x * kF32Tile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = kF32Rows * warp;  // the warp's first query row
  const size_t q_step = static_cast<size_t>(Hq) * Dh;
  const size_t kv_step = static_cast<size_t>(Hkv) * Dh;
  const size_t q_off = (static_cast<size_t>(b) * Sq * Hq + h) * Dh;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh;
  load_f32(Qs, ld, q + q_off, q_step, i0, Sq, Dh, scale);
  load_f32(dOs, ld, dout + q_off, q_step, i0, Sq, Dh, 1.f);
  const float* lse_h = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
  const float* delta_h = delta + (static_cast<size_t>(b) * Hq + h) * Sq;
  for (int r = threadIdx.x; r < kF32Tile; r += kThreads) {
    Ls[r] = i0 + r < Sq ? lse_h[i0 + r] : 0.f;
    Ds[r] = i0 + r < Sq ? delta_h[i0 + r] : 0.f;
  }

  // the key tiles rows [i0, i0 + kF32Tile) can see
  long long hi = Sk - 1;
  if (causal)
    hi = min(hi, static_cast<long long>(i0) + kF32Tile - 1 + shift);
  const long long lo =
      window > 0 ? max(0LL, static_cast<long long>(i0) + shift - window + 1)
                 : 0;
  const int t_lo = hi < lo ? 0 : static_cast<int>(lo / kF32Tile);
  const int t_hi = hi < lo ? -1 : static_cast<int>(hi / kF32Tile);

  float acc[kF32Rows][kF32Cols];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) acc[r][c] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int j0 = t * kF32Tile;
    __syncthreads();  // the previous tile is consumed
    load_f32(Ks, ld, k + kv_off, kv_step, j0, Sk, Dh, 1.f);
    load_f32(Vs, ld, v + kv_off, kv_step, j0, Sk, Dh, 1.f);
    __syncthreads();

    float s[kF32Rows], dp[kF32Rows];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) s[r] = dp[r] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float kd = Ks[lane * ld + d], vd = Vs[lane * ld + d];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        s[r] += Qs[(r0 + r) * ld + d] * kd;
        dp[r] += dOs[(r0 + r) * ld + d] * vd;
      }
    }
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const int i = i0 + r0 + r;
      const float p = i < Sq && visible(i + shift, j0 + lane, Sk, causal,
                                        window)
                          ? expf(s[r] - Ls[r0 + r])
                          : 0.f;
      dSs[(r0 + r) * kF32Ld + lane] = p * (dp[r] - Ds[r0 + r]);
    }
    __syncthreads();
    for (int kk = 0; kk < kF32Tile; ++kk) {
      float kv[kF32Cols];
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < Dh ? Ks[kk * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const float ds = dSs[(r0 + r) * kF32Ld + kk];
#pragma unroll
        for (int c = 0; c < kF32Cols; ++c) acc[r][c] += ds * kv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int i = i0 + r0 + r;
    if (i >= Sq) continue;
    float* row = dq + ((static_cast<size_t>(b) * Sq + i) * Hq + h) * Dh;
#pragma unroll
    for (int c = 0; c < kF32Cols; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) row[d] = acc[r][c] * scale;
    }
  }
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* o, const float* dout, const float* lse,
                       float* delta, float* dq, float* dk, float* dv, int B,
                       int Sq, int Sk, int Hq, int Hkv, int Dh, int causal,
                       int window, int shift, float scale,
                       cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_bwd_delta_f32<<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(o, dout, delta, rows, Sq, Hq, Dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // four 32-row tiles of Dh + 1 floats, the p^T and ds^T tiles (the dq CTA
  // uses one), the row statistics
  const size_t smem =
      (4 * static_cast<size_t>(kF32Tile) * (Dh + 1) + 2 * kF32Tile * kF32Ld +
       2 * kF32Tile) * sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (Sk > 0) {
    dim3 grid((Sk + kF32Tile - 1) / kF32Tile, Hkv, B);
    flash_bwd_dkdv_f32<<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, Sq, Sk, Hq, Hkv, Dh, causal,
        window, shift, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Sq + kF32Tile - 1) / kF32Tile, Hq, B);
  flash_bwd_dq_f32<<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, Hq, Hkv, Dh, causal, window,
      shift, scale);
  return cudaGetLastError();
}

// -------------------------------------------------------- wgmma route ----
constexpr int kWgThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kRows = 64;        // packed query rows per Q / dO tile
constexpr int kKeys = 64;        // keys per K / V tile
constexpr int kBox = 64 * 128;   // a 64-row box of 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// A 64-row tile: DH / 64 boxes of 64 columns, then (Dh 80) a box of the
// last 16 columns, 64 rows of 32 bytes (32B swizzle).
template <int DH>
struct WgTile {
  static constexpr int kChunks = DH / 64;        // 64-column boxes per row
  static constexpr int kTail = DH % 64;          // 0 or 16 columns
  static_assert(kTail == 0 || kTail == 16, "Dh is 64 n or 64 n + 16");
  static constexpr int kTailAt = kChunks * kBox;  // the tail box's offset
  static constexpr int kBytes = kTailAt + kRows * kTail * 2;  // one tile
  static constexpr int kRowBytes = kChunks * 128 + kTail * 2;  // bf16 row
};

// A dk/dv CTA's shared memory: K, V, the (Q, dO) ring, two P^T tiles (64 x
// 64 f32), each stage's lse2 and D rows, the barriers.
template <int DH>
struct DkdvSmem {
  using T = WgTile<DH>;
  static constexpr int kStages = DH == 256 ? 2 : 4;  // of Q and dO
  static constexpr int kK = 0;
  static constexpr int kV = T::kBytes;
  static constexpr int kQ = 2 * T::kBytes;  // stage s: Q, then dO
  static constexpr int kX = kQ + 2 * kStages * T::kBytes;
  static constexpr int kStat = kX + 2 * kKeys * kRows * 4;
  static constexpr int kBar = kStat + kStages * 2 * kRows * 4;
  static constexpr int kSmem = kBar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kSmem <= 232448, "dk/dv shared memory");
};

// A dq CTA's: two 64-row tiles of Q and of dO (one per consumer), a ring
// of K tiles and one of V tiles, the barriers.  V is free after dP, K only
// after dQ, so K gets the deeper ring (2 stages against 1 at Dh 256).
template <int DH>
struct DqSmem {
  using T = WgTile<DH>;
  static constexpr int kKStages = DH == 256 ? 2 : 4;
  static constexpr int kVStages = DH == 256 ? 1 : 4;
  static constexpr int kQ = 0;  // consumer w's tile w * kBytes further
  static constexpr int kDo = 2 * T::kBytes;
  static constexpr int kK = 4 * T::kBytes;
  static constexpr int kV = kK + kKStages * T::kBytes;
  static constexpr int kBar = kV + kVStages * T::kBytes;
  static constexpr int kSmem =
      kBar + (1 + 2 * kKStages + 2 * kVStages) * 8 + 1024;
  static_assert(kSmem <= 232448, "dq shared memory");
};

struct WgParams {
  int B, Sq, Sk, Hkv, G;
  int Gt;      // heads packed per tile: min(G, 64)
  int HB;      // head blocks per kv head: ceil(G / Gt)
  int P;       // positions per tile: 64 / Gt
  int ntiles;  // query tiles per (b, kv head, head block): ceil(Sq / P)
  int causal, window;
  int shift;      // q_offset - kv_offset: query i sits at key position
                  // i + shift
  int dkdv_ctas;  // CTAs of flash_bwd_wgmma that own a key tile
  float c;       // multiplies q . k into the exp2 domain
  float dk_mul;  // the scale where it is folded into c, else 1
  float dq_mul;  // the scale
  // packed row statistics, index ((((b Hkv + hk) HB + hb) ntiles + tile)
  // 64 + row)
  const float* lse2;   // lse * log2 e; +inf for rows that are no real row
  const float* delta;  // rowsum(do * o); 0 for those rows
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// D (64 x 64) = A (64 rows x DH) B^T (B: 64 rows x DH), both 64-row tiles
// (WgTile) in shared memory (K-major): the k-th 16 columns of a box start
// 32 bytes further inside each 128-byte row; the tail is one more k-step.
template <int DH>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t b) {
  using T = WgTile<DH>;
#pragma unroll
  for (int i = 0; i < 32; ++i) hopper::reg_fence(d[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * T::kChunks; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    hopper::wgmma_ss_m64n64k16(d, hopper::sw128_desc(a + off, 16),
                               hopper::sw128_desc(b + off, 16), kk > 0);
  }
  if constexpr (T::kTail != 0)
    hopper::wgmma_ss_m64n64k16(d, hopper::sw32_desc(a + T::kTailAt),
                               hopper::sw32_desc(b + T::kTailAt), 1);
  hopper::wgmma_commit();
#pragma unroll
  for (int i = 0; i < 32; ++i) hopper::reg_fence(d[i]);
}

// Every product this warpgroup issued is done; d and the tail's dt may be
// read.
template <int NC>
__device__ __forceinline__ void wait_all(float (&d)[NC][32], float (&dt)[8]) {
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) hopper::reg_fence(d[c][i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) hopper::reg_fence(dt[i]);
}

// d (+)= A B with B a 64-row tile (WgTile) read transposed: its boxes and
// its tail, one group of products, issued and not waited for.
template <int DH>
__device__ __forceinline__ void issue_rs(float (&d)[DH / 64][32],
                                         float (&dt)[8],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
  using T = WgTile<DH>;
  hopper::wgmma_rs_tile<T::kChunks, T::kTail != 0>(d, dt, a, b,
                                                    b + T::kTailAt);
}

// Row j of a (.., DH) bf16 output from the accumulators of its 64-column
// boxes and its tail, times mul: this thread's columns 8 nn + cb, cb + 1
// of every 8 (half r of the accumulator layout: rows r0, r0 + 8).
template <int DH>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&d)[DH / 64][32],
                                          const float (&dt)[8], int r,
                                          int cb, float mul) {
#pragma unroll
  for (int c = 0; c < DH / 64; ++c)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
      *reinterpret_cast<uint32_t*>(row + 64 * c + 8 * nn + cb) =
          pack_bf16(d[c][4 * nn + 2 * r] * mul, d[c][4 * nn + 2 * r + 1] * mul);
  if constexpr (DH % 64 != 0)
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
      *reinterpret_cast<uint32_t*>(row + DH / 64 * 64 + 8 * nn + cb) =
          pack_bf16(dt[4 * nn + 2 * r] * mul, dt[4 * nn + 2 * r + 1] * mul);
}

// Row statistics in the wgmma route's packed order, and bf16(q * scale)
// when qs is not null.  One warp per kPrepRows packed rows, every load of
// them issued before any sum (16 bytes a lane: Dh <= 256).
constexpr int kPrepRows = 2;

__global__ void __launch_bounds__(kThreads)
flash_bwd_prep(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lse2,
               float* __restrict__ delta, __nv_bfloat16* __restrict__ qs,
               long long rows, const WgParams prm, int Dh, float scale) {
  const int e0 = static_cast<int>((blockIdx.x * kThreads + threadIdx.x) >> 5) *
                 kPrepRows;  // rows < 2^31 (launch_wgmma checks)
  const int lane = threadIdx.x & 31;
  const int Hq = prm.Hkv * prm.G;
  const bool has_chunk = 8 * lane < Dh;
  size_t row[kPrepRows];
  bool ok[kPrepRows];
  float l[kPrepRows];
  uint4 xo[kPrepRows], xd[kPrepRows], xq[kPrepRows];
#pragma unroll
  for (int k = 0; k < kPrepRows; ++k) {
    const int e = e0 + k;
    const int r = e % kRows;
    int rest = e / kRows;
    const int tile = rest % prm.ntiles;
    rest /= prm.ntiles;
    const int hb = rest % prm.HB;
    rest /= prm.HB;
    const int hk = rest % prm.Hkv;
    const int b = rest / prm.Hkv;
    const int pos = tile * prm.P + r / prm.Gt, gh = hb * prm.Gt + r % prm.Gt;
    ok[k] = e < rows && r < prm.P * prm.Gt && pos < prm.Sq && gh < prm.G;
    const int h = hk * prm.G + gh;
    row[k] = (static_cast<size_t>(b) * prm.Sq + pos) * Hq + h;
    l[k] = 0.f;
    xo[k] = xd[k] = xq[k] = make_uint4(0, 0, 0, 0);
    if (ok[k]) {
      l[k] = lse[(static_cast<size_t>(b) * Hq + h) * prm.Sq + pos];
      if (has_chunk) {
        xo[k] = *reinterpret_cast<const uint4*>(o + row[k] * Dh + 8 * lane);
        xd[k] = *reinterpret_cast<const uint4*>(dout + row[k] * Dh + 8 * lane);
        if (qs != nullptr)
          xq[k] = *reinterpret_cast<const uint4*>(q + row[k] * Dh + 8 * lane);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPrepRows; ++k) {
    const int e = e0 + k;
    if (e >= rows) break;
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xo[k]);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&xd[k]);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(x2[i]);
      const float2 c = __bfloat1622float2(y2[i]);
      acc += a.x * c.x + a.y * c.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (ok[k] && qs != nullptr && has_chunk) {
      __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&xq[k]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * scale);
      *reinterpret_cast<uint4*>(qs + row[k] * Dh + 8 * lane) = xq[k];
    }
    if (lane == 0) {  // rows that are no real row: p and ds come out 0
      lse2[e] = ok[k] ? l[k] * kLog2e : INFINITY;
      delta[e] = ok[k] ? acc : 0.f;
    }
  }
}

// ----------------------------------------------- dk, dv (wgmma) CTA ----
template <int DH>
__device__ __forceinline__ void dkdv_cta(unsigned char* smem, int cta,
                                         const CUtensorMap* maps,
                                         const WgParams& prm) {
  using T = WgTile<DH>;
  using L = DkdvSmem<DH>;
  constexpr int NC = T::kChunks, ST = L::kStages, TL = T::kTail;
  float* stat = reinterpret_cast<float*>(smem + L::kStat);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + ST;

  // This CTA's key tile: causal grids take the lowest (the heaviest) first.
  const int per = prm.B * prm.Hkv;
  const int kt = cta / per;
  const int hk = (cta % per) % prm.Hkv;
  const int b = (cta % per) / prm.Hkv;
  const int j0 = kt * kKeys;
  const int j_last = min(j0 + kKeys, prm.Sk) - 1;
  // the positions that see a key of the tile (position p at key position
  // p + shift), and their tiles
  const long long lo =
      prm.causal ? max(0LL, static_cast<long long>(j0) - prm.shift) : 0;
  long long hi = prm.Sq - 1;
  if (prm.window > 0)
    hi = min(hi, static_cast<long long>(j_last) + prm.window - 1 - prm.shift);
  const int t_lo = hi < lo ? 0 : static_cast<int>(lo / prm.P);
  const int nt = hi < lo ? 0 : static_cast<int>(hi / prm.P) - t_lo + 1;
  const int n = nt * prm.HB;  // (Q, dO) stages: every head block's tiles

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], 2 * 128);  // every consumer thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n > 0) {
      hopper::mbar_expect_tx(kv_full, 2 * T::kBytes);
#pragma unroll
      for (int c = 0; c < NC + (TL != 0); ++c) {  // the boxes, the tail
        const int x = c < NC ? 0 : 4;  // the tail's maps follow the four
        hopper::tma_load_4d(smem + L::kK + c * kBox, &maps[2 + x], kv_full,
                            64 * c, hk, j0, b);
        hopper::tma_load_4d(smem + L::kV + c * kBox, &maps[3 + x], kv_full,
                            64 * c, hk, j0, b);
      }
      // bytes of one (Q or dO) tile
      const uint32_t box = T::kRowBytes * prm.Gt * prm.P;
      for (int i = 0; i < n; ++i) {
        const int hb = i / nt, t = t_lo + i % nt, st = i % ST;
        hopper::mbar_wait(&q_empty[st], ((i / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&q_full[st], 2 * box + 2 * kRows * 4);
        unsigned char* qs = smem + L::kQ + 2 * st * T::kBytes;
#pragma unroll
        for (int c = 0; c < NC + (TL != 0); ++c) {
          const int x = c < NC ? 0 : 4;
          hopper::tma_load_5d(qs + c * kBox, &maps[x], &q_full[st], 64 * c,
                              hb * prm.Gt, hk, t * prm.P, b);
          hopper::tma_load_5d(qs + T::kBytes + c * kBox, &maps[1 + x],
                              &q_full[st], 64 * c, hb * prm.Gt, hk, t * prm.P,
                              b);
        }
        const size_t row =
            ((static_cast<size_t>(b) * prm.Hkv + hk) * prm.HB + hb) *
                prm.ntiles + t;
        hopper::bulk_load(stat + st * 2 * kRows, prm.lse2 + row * kRows,
                          kRows * 4, &q_full[st]);
        hopper::bulk_load(stat + st * 2 * kRows + kRows,
                          prm.delta + row * kRows, kRows * 4, &q_full[st]);
      }
    }
  } else {
    // ---- consumers: 0 makes P^T and owns dV, 1 makes dS^T and owns dK --
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;  // keys r0 and r0 + 8
    const int cb = 2 * (lane & 3);  // first query column of each 8-block

    // Rows of a tile that no TMA box fills (64 is not a multiple of Gt) are
    // zeroed once: a 0 of P^T or dS^T must meet finite values there.
    const int used = prm.P * prm.Gt;
    if (used < kRows) {
      // 16-byte chunks of the rows past `used`, in each of a tile's boxes
      // (128-byte rows) and in its tail box (TL * 2-byte rows)
      const int per_box = (kRows - used) * 128 / 16;
      const int per_tail = (kRows - used) * TL * 2 / 16;
      const int per_tile = NC * per_box + per_tail;
      for (int e = threadIdx.x - 128; e < 2 * ST * per_tile; e += 256) {
        const int x = e % per_tile;
        unsigned char* tile = smem + L::kQ + (e / per_tile) * T::kBytes;
        unsigned char* at =
            x < NC * per_box
                ? tile + (x / per_box) * kBox + used * 128 + (x % per_box) * 16
                : tile + T::kTailAt + used * TL * 2 + (x - NC * per_box) * 16;
        *reinterpret_cast<uint4*>(at) = make_uint4(0, 0, 0, 0);
      }
      hopper::fence_proxy_async();
    }
    hopper::named_sync(1, 256);

    float acc[NC][32], acc_t[8];  // acc_t: the tail's 16 columns (Dh 80)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_t[i] = 0.f;
    const uint32_t k_base = hopper::smem_addr(smem + L::kK);
    const uint32_t v_base = hopper::smem_addr(smem + L::kV);
    const uint32_t ring = hopper::smem_addr(smem + L::kQ);
    float4* X = reinterpret_cast<float4*>(smem + L::kX);

    if (n > 0) hopper::mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % ST, xb = i & 1;
      // the tile's first position, at its key position
      const int pp0 = (t_lo + i % nt) * prm.P + prm.shift;
      const uint32_t q_base = ring + 2 * st * T::kBytes;
      const uint32_t do_base = q_base + T::kBytes;
      const float* lse2 = stat + st * 2 * kRows;
      hopper::mbar_wait(&q_full[st], (i / ST) & 1);
      // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1)
      float s[32];
      issue_ss<DH>(s, w ? v_base : k_base, w ? do_base : q_base);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) hopper::reg_fence(s[e]);
      if (w == 0) {
        // p = 2^(s c - lse2) where key and query row see each other, else 0
        const bool all_seen =
            j0 + kKeys <= prm.Sk && (!prm.causal || j0 + kKeys - 1 <= pp0) &&
            (prm.window <= 0 ||
             static_cast<long long>(pp0) + prm.P - 1 - j0 < prm.window);
        // key j sees the rows (columns) [clo, chi) of the tile: position
        // pp0 + col / Gt in [j, j + window) (causal), or below j + window
        int clo[2], chi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long j = j0 + r0 + 8 * r;
          const long long lo = prm.causal ? prm.Gt * (j - pp0) : -1;
          const long long hi =
              j >= prm.Sk ? -1
              : prm.window > 0 ? prm.Gt * (j + prm.window - pp0) : kRows;
          clo[r] = static_cast<int>(max(-1ll, min(lo, 64ll)));
          chi[r] = static_cast<int>(max(-1ll, min(hi, 64ll)));
        }
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const float2 l =
              *reinterpret_cast<const float2*>(lse2 + 8 * nn + cb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = hopper::ex2(
                fmaf(s[4 * nn + e], prm.c, -(e & 1 ? l.y : l.x)));
            if (!all_seen) {
              const int col = 8 * nn + cb + (e & 1), r = e >> 1;
              p = col >= clo[r] && col < chi[r] ? p : 0.f;
            }
            s[4 * nn + e] = p;
          }
        }
        // the f32 P^T to consumer 1, in two tiles: it reads tile i & 1
        // while this consumer writes the other
        if (i >= 2) hopper::named_sync(2 + xb, 256);
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          X[xb * 1024 + nn * 128 + tid] = make_float4(
              s[4 * nn], s[4 * nn + 1], s[4 * nn + 2], s[4 * nn + 3]);
        hopper::named_arrive(4 + xb, 256);
      } else {
        // dS^T = P^T (dP^T - D)
        const float* dl = lse2 + kRows;
        hopper::named_sync(4 + xb, 256);
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const float4 p = X[xb * 1024 + nn * 128 + tid];
          const float2 d = *reinterpret_cast<const float2*>(dl + 8 * nn + cb);
          s[4 * nn] = p.x * (s[4 * nn] - d.x);
          s[4 * nn + 1] = p.y * (s[4 * nn + 1] - d.y);
          s[4 * nn + 2] = p.z * (s[4 * nn + 2] - d.x);
          s[4 * nn + 3] = p.w * (s[4 * nn + 3] - d.y);
        }
        if (i + 2 < n) hopper::named_arrive(2 + xb, 256);
      }
      // dV += P^T dO (consumer 0), dK += dS^T Q (consumer 1: dS^T's hi
      // part's product, then its lo part's, into the same accumulator; both
      // operands made before either is issued, as the products read them
      // from registers until the wait)
      uint32_t a[4][4], lo[4][4];
      hopper::acc_to_a(s, a);
      if (w) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = bf16_rest(s[e]);
        hopper::acc_to_a(s, lo);
      }
      issue_rs<DH>(acc, acc_t, a, w ? q_base : do_base);
      if (w) issue_rs<DH>(acc, acc_t, lo, q_base);
      wait_all<NC>(acc, acc_t);
      hopper::mbar_arrive(&q_empty[st]);
    }

    const float mul = w ? prm.dk_mul : 1.f;
    __nv_bfloat16* out = w ? prm.dk : prm.dv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + r0 + 8 * r;
      if (j >= prm.Sk) continue;
      store_row<DH>(
          out + ((static_cast<size_t>(b) * prm.Sk + j) * prm.Hkv + hk) * DH,
          acc, acc_t, r, cb, mul);
    }
  }
}

// --------------------------------------------------- dq (wgmma) CTA ----
// Two neighbouring 64-row query tiles, one per consumer; both walk the key
// tiles either tile can see, so each K and V tile is loaded once for 128
// rows.
template <int DH>
__device__ __forceinline__ void dq_cta(unsigned char* smem, int cta,
                                       const CUtensorMap* maps,
                                       const WgParams& prm) {
  using T = WgTile<DH>;
  using L = DqSmem<DH>;
  constexpr int NC = T::kChunks, KS = L::kKStages, VS = L::kVStages,
                TL = T::kTail;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = qd_full + 1;
  uint64_t* k_empty = k_full + KS;
  uint64_t* v_full = k_empty + KS;
  uint64_t* v_empty = v_full + VS;

  // This CTA's tiles 2 u and 2 u + 1: causal grids take the last (the
  // heaviest) first.
  const int per = prm.B * prm.Hkv * prm.HB;
  const int pairs = (prm.ntiles + 1) / 2;
  const int x = cta % per;
  const int uu = cta / per;
  const int u = prm.causal ? pairs - 1 - uu : uu;
  const int hb = x % prm.HB;
  const int hk = (x / prm.HB) % prm.Hkv;
  const int b = x / (prm.HB * prm.Hkv);
  const int tiles = min(2, prm.ntiles - 2 * u);  // 1 for an odd last pair
  const int p0 = 2 * u * prm.P;
  const int p_last = min(p0 + tiles * prm.P - 1, prm.Sq - 1);
  // the key tiles some row of the CTA can see (at key positions shifted by
  // prm.shift)
  long long hi = prm.Sk - 1;
  if (prm.causal) hi = min(hi, static_cast<long long>(p_last) + prm.shift);
  const long long lo =
      prm.window > 0
          ? max(0LL, static_cast<long long>(p0) + prm.shift - prm.window + 1)
          : 0;
  const int t_lo = hi < lo ? 0 : static_cast<int>(lo / kKeys);
  const int n = hi < lo ? 0 : static_cast<int>(hi / kKeys) - t_lo + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < KS; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_empty[s], 2 * 128);  // every consumer thread
    }
    for (int s = 0; s < VS; ++s) {
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_empty[s], 2 * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n > 0) {
      hopper::mbar_expect_tx(qd_full,
                             tiles * 2 * T::kRowBytes * prm.Gt * prm.P);
      for (int w = 0; w < tiles; ++w)
#pragma unroll
        for (int c = 0; c < NC + (TL != 0); ++c) {  // the boxes, the tail
          const int pw = p0 + w * prm.P, x = c < NC ? 0 : 4;
          hopper::tma_load_5d(smem + L::kQ + w * T::kBytes + c * kBox,
                              &maps[x], qd_full, 64 * c, hb * prm.Gt, hk, pw,
                              b);
          hopper::tma_load_5d(smem + L::kDo + w * T::kBytes + c * kBox,
                              &maps[1 + x], qd_full, 64 * c, hb * prm.Gt, hk,
                              pw, b);
        }
      for (int i = 0; i < n; ++i) {
        const int j0 = (t_lo + i) * kKeys, ks = i % KS, vs = i % VS;
        hopper::mbar_wait(&v_empty[vs], ((i / VS) & 1) ^ 1);
        hopper::mbar_expect_tx(&v_full[vs], T::kBytes);
#pragma unroll
        for (int c = 0; c < NC + (TL != 0); ++c)
          hopper::tma_load_4d(smem + L::kV + vs * T::kBytes + c * kBox,
                              &maps[c < NC ? 3 : 7], &v_full[vs], 64 * c, hk,
                              j0, b);
        hopper::mbar_wait(&k_empty[ks], ((i / KS) & 1) ^ 1);
        hopper::mbar_expect_tx(&k_full[ks], T::kBytes);
#pragma unroll
        for (int c = 0; c < NC + (TL != 0); ++c)
          hopper::tma_load_4d(smem + L::kK + ks * T::kBytes + c * kBox,
                              &maps[c < NC ? 2 : 6], &k_full[ks], 64 * c, hk,
                              j0, b);
      }
    }
  } else {
    // ---- consumers: 64 rows each, every key tile of the CTA ----
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4, r1 = r0 + 8;
    const int cb = 2 * (lane & 3);
    const int tile = 2 * u + w;
    const bool real = w < tiles;  // an odd last pair has no second tile
    const int pt = tile * prm.P;  // the tile's first position
    const size_t srow =
        (((static_cast<size_t>(b) * prm.Hkv + hk) * prm.HB + hb) *
             prm.ntiles + tile) * kRows;
    const float l0 = real ? prm.lse2[srow + r0] : INFINITY;
    const float l1 = real ? prm.lse2[srow + r1] : INFINITY;
    const float d0 = real ? prm.delta[srow + r0] : 0.f;
    const float d1 = real ? prm.delta[srow + r1] : 0.f;
    const int pos0 = pt + r0 / prm.Gt, pos1 = pt + r1 / prm.Gt;
    // keys [jlo, jhi) are visible to a row (at key position pos + shift:
    // in int32, as the wrapper checks shift + Sq and shift - window)
    const int at0 = pos0 + prm.shift, at1 = pos1 + prm.shift;
    const int jlo0 = prm.window > 0 ? at0 - prm.window + 1 : INT_MIN;
    const int jlo1 = prm.window > 0 ? at1 - prm.window + 1 : INT_MIN;
    const int jhi0 = prm.causal ? min(prm.Sk, at0 + 1) : prm.Sk;
    const int jhi1 = prm.causal ? min(prm.Sk, at1 + 1) : prm.Sk;
    // every row of the tile sees all keys in [lo_all, hi_all)
    const int pt_last = min(pt + prm.P - 1, prm.Sq - 1) + prm.shift;
    const int lo_all = prm.window > 0 ? pt_last - prm.window + 1 : INT_MIN;
    const int hi_all = prm.causal ? min(prm.Sk, pt + prm.shift + 1) : prm.Sk;

    float acc[NC][32], acc_t[8];  // acc_t: the tail's 16 columns (Dh 80)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_t[i] = 0.f;
    const uint32_t q_base = hopper::smem_addr(smem + L::kQ + w * T::kBytes);
    const uint32_t do_base = hopper::smem_addr(smem + L::kDo + w * T::kBytes);

    if (n > 0) hopper::mbar_wait(qd_full, 0);
    for (int i = 0; i < n; ++i) {
      const int ks = i % KS, vs = i % VS, j0 = (t_lo + i) * kKeys;
      const uint32_t k_st = hopper::smem_addr(smem + L::kK + ks * T::kBytes);
      float s[32], dp[32];
      hopper::mbar_wait(&v_full[vs], (i / VS) & 1);
      issue_ss<DH>(dp, do_base,
                   hopper::smem_addr(smem + L::kV + vs * T::kBytes));
      hopper::mbar_wait(&k_full[ks], (i / KS) & 1);
      issue_ss<DH>(s, q_base, k_st);
      hopper::wgmma_wait<1>();  // dP: the V tile is free
#pragma unroll
      for (int e = 0; e < 32; ++e) hopper::reg_fence(dp[e]);
      hopper::mbar_arrive(&v_empty[vs]);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) hopper::reg_fence(s[e]);
      // dS = P (dP - D), p = 2^(s c - lse2) where the key is visible
      const bool masked = j0 < lo_all || j0 + kKeys > hi_all;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi_row = e >= 2;
          float p =
              hopper::ex2(fmaf(s[4 * nn + e], prm.c, -(hi_row ? l1 : l0)));
          if (masked) {
            const int j = j0 + 8 * nn + cb + (e & 1);
            const bool vis = hi_row ? (j >= jlo1 && j < jhi1)
                                    : (j >= jlo0 && j < jhi0);
            p = vis ? p : 0.f;
          }
          s[4 * nn + e] = p * (dp[4 * nn + e] - (hi_row ? d1 : d0));
        }
      // dQ += dS K: dS's hi part's product, then its lo part's (both
      // operands made before either is issued)
      uint32_t a[4][4], lo[4][4];
      hopper::acc_to_a(s, a);
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = bf16_rest(s[e]);
      hopper::acc_to_a(s, lo);
      issue_rs<DH>(acc, acc_t, a, k_st);
      issue_rs<DH>(acc, acc_t, lo, k_st);
      wait_all<NC>(acc, acc_t);
      hopper::mbar_arrive(&k_empty[ks]);
    }

    // dq = dQ * scale, for the tile's real rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      const int pos = r ? pos1 : pos0, gh = hb * prm.Gt + row % prm.Gt;
      if (!real || row >= prm.P * prm.Gt || pos >= prm.Sq || gh >= prm.G)
        continue;
      store_row<DH>(prm.dq + ((static_cast<size_t>(b) * prm.Sq + pos) *
                                  prm.Hkv * prm.G + hk * prm.G + gh) * DH,
                    acc, acc_t, r, cb, prm.dq_mul);
    }
  }
}

// One launch for both: the first dkdv_ctas CTAs own a key tile each, the
// rest two query tiles each, so the SMs that finish their dk/dv tiles take
// dq tiles while the last dk/dv tiles run.
// The tensor maps: q (or bf16(q * scale)), do, k, v over their 64-column
// boxes (128B swizzle), then (Dh 80) the same four over the 16-column tail
// (32B swizzle; copies of the first four otherwise, unused).
struct WgMaps {
  CUtensorMap m[8];
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_wgmma(const __grid_constant__ WgMaps maps, const WgParams prm) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int cta = static_cast<int>(blockIdx.x);
  if (cta < prm.dkdv_ctas)
    dkdv_cta<DH>(smem, cta, maps.m, prm);
  else
    dq_cta<DH>(smem, cta - prm.dkdv_ctas, maps.m, prm);
}

// Device scratch (bytes) a launch on `route` needs: on mma.sync (1) and
// simt (2) D, B * Hq * Sq floats; on wgmma (0) lse2 and D for each packed
// row (B * Hkv * ceil(G / 64) * ceil(Sq / P) * 64 rows, P = 64 / min(G,
// 64)) and, when the scale is not a power of two, bf16(q * scale).
long long scratch_need(int route, int B, int Sq, int Hq, int Hkv, int Dh,
                       float scale) {
  if (route != 0) return 4LL * B * Sq * Hq;
  const int G = Hq / Hkv, gt = min(G, kRows), P = kRows / gt;
  const long long rows = static_cast<long long>(B) * Hkv *
                         ((G + gt - 1) / gt) * ((Sq + P - 1) / P) * kRows;
  int ex;
  const bool pow2 = frexpf(scale, &ex) == 0.5f;  // exact to fold
  return 8 * rows + (pow2 ? 0 : 2LL * B * Sq * Hq * Dh);
}

template <int DH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         void* scratch, long long scratch_bytes, void* dq,
                         void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                         int Hkv, int causal, int window, int shift,
                         float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int G = Hq / Hkv;
  WgParams prm;
  prm.B = B;
  prm.Sq = Sq;
  prm.Sk = Sk;
  prm.Hkv = Hkv;
  prm.G = G;
  prm.Gt = min(G, kRows);
  prm.HB = (G + prm.Gt - 1) / prm.Gt;
  prm.P = kRows / prm.Gt;
  prm.ntiles = (Sq + prm.P - 1) / prm.P;
  prm.causal = causal;
  prm.window = window;
  prm.shift = shift;
  int ex;
  const bool pow2 = frexpf(scale, &ex) == 0.5f;  // exact to fold
  prm.c = pow2 ? scale * kLog2e : kLog2e;
  prm.dk_mul = pow2 ? scale : 1.f;
  prm.dq_mul = scale;
  // scratch: lse2 and D (4 bytes each per packed row), then bf16(q * scale)
  // when the scale is not a power of two
  const long long rows = static_cast<long long>(B) * Hkv * prm.HB *
                         prm.ntiles * kRows;
  if (scratch_bytes < scratch_need(0, B, Sq, Hq, Hkv, DH, scale))
    return cudaErrorInvalidValue;
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + rows;
  bf* qs = pow2 ? nullptr : reinterpret_cast<bf*>(delta + rows);
  prm.lse2 = lse2;
  prm.delta = delta;
  prm.dq = static_cast<bf*>(dq);
  prm.dk = static_cast<bf*>(dk);
  prm.dv = static_cast<bf*>(dv);
  const long long nkt = (Sk + kKeys - 1) / kKeys;
  const long long dkdv_ctas = static_cast<long long>(B) * Hkv * nkt;
  const long long grid = dkdv_ctas + static_cast<long long>(B) * Hkv *
                                         prm.HB * ((prm.ntiles + 1) / 2);
  const long long prep_blocks =
      ((rows + kPrepRows - 1) / kPrepRows * 32 + kThreads - 1) / kThreads;
  if (grid > INT_MAX || rows + kPrepRows > INT_MAX)
    return cudaErrorInvalidConfiguration;
  prm.dkdv_ctas = static_cast<int>(dkdv_ctas);
  // TMA and the bulk copies read 16-byte aligned global memory
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(scratch)) % 16)
    return cudaErrorMisalignedAddress;

  flash_bwd_prep<<<static_cast<unsigned>(prep_blocks), kThreads, 0,
                   stream>>>(static_cast<const bf*>(q),
                             static_cast<const bf*>(o),
                             static_cast<const bf*>(dout), lse, lse2, delta,
                             qs, rows, prm, DH, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // q (or bf16(q * scale)) and do viewed as (B, Sq, Hkv, G, Dh): a box is
  // P positions x Gt heads x 64 columns; k and v as (B, Sk, Hkv, Dh): 64
  // keys x 64 columns.
  const cuuint64_t e = 2, Dh = DH;
  const cuuint64_t qdim[5] = {Dh, static_cast<cuuint64_t>(G),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(Sq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t qstr[4] = {Dh * e, G * Dh * e, Hq * Dh * e,
                              static_cast<cuuint64_t>(Sq) * Hq * Dh * e};
  const cuuint32_t qbox[5] = {64, static_cast<cuuint32_t>(prm.Gt), 1,
                              static_cast<cuuint32_t>(prm.P), 1};
  const cuuint64_t kdim[4] = {Dh, static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(Sk),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t kstr[3] = {Dh * e, Hkv * Dh * e,
                              static_cast<cuuint64_t>(Sk) * Hkv * Dh * e};
  const cuuint32_t kbox[4] = {64, 1, kKeys, 1};
  const void* qp = pow2 ? q : qs;
  WgMaps maps;
  CUtensorMap &tq = maps.m[0], &tdo = maps.m[1], &tk = maps.m[2],
              &tv = maps.m[3];
  if (!hopper::encode_bf16(&tq, qp, 5, qdim, qstr, qbox) ||
      !hopper::encode_bf16(&tdo, dout, 5, qdim, qstr, qbox) ||
      !hopper::encode_bf16(&tk, k, 4, kdim, kstr, kbox) ||
      !hopper::encode_bf16(&tv, v, 4, kdim, kstr, kbox))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) maps.m[4 + i] = maps.m[i];
  if (WgTile<DH>::kTail != 0) {  // Dh 80: the last 16 columns, 32B-swizzled
    const cuuint32_t qbox_t[5] = {WgTile<DH>::kTail, qbox[1], 1, qbox[3], 1};
    const cuuint32_t kbox_t[4] = {WgTile<DH>::kTail, 1, kKeys, 1};
    const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_32B;
    if (!hopper::encode_bf16(&maps.m[4], qp, 5, qdim, qstr, qbox_t, sw) ||
        !hopper::encode_bf16(&maps.m[5], dout, 5, qdim, qstr, qbox_t, sw) ||
        !hopper::encode_bf16(&maps.m[6], k, 4, kdim, kstr, kbox_t, sw) ||
        !hopper::encode_bf16(&maps.m[7], v, 4, kdim, kstr, kbox_t, sw))
      return cudaErrorInvalidValue;
  }

  const int smem = max(DkdvSmem<DH>::kSmem, DqSmem<DH>::kSmem);
  err = cudaFuncSetAttribute(flash_bwd_wgmma<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  flash_bwd_wgmma<DH><<<static_cast<unsigned>(grid), kWgThreads, smem,
                        stream>>>(maps, prm);
  return cudaGetLastError();
}

}  // namespace

// The route (dtype: 0 = f32, 1 = bf16; Dh) takes: 0 = wgmma (bf16, Dh 64,
// 80, 128 or 256), 1 = mma.sync (bf16, other head dims), 2 = simt (f32,
// any head dim), -1 = none (another dtype).  kernels/flash_attention.py's
// flash_bwd_route states the same rule.
extern "C" int flash_attention_bwd_route(int dtype, int Dh) {
  if (dtype == 0) return 2;
  if (dtype != 1) return -1;
  return Dh == 64 || Dh == 80 || Dh == 128 || Dh == 256 ? 0 : 1;
}

// The device scratch a launch on `route` (0 = wgmma, 1 = mma.sync, 2 =
// simt) needs, in *bytes: the rule flash_attention_bwd checks its scratch
// against.  kernels/flash_attention.py's bwd_scratch_bytes asks here.
extern "C" int flash_attention_bwd_scratch_bytes(int route, int B, int Sq,
                                                 int Hq, int Hkv, int Dh,
                                                 float scale,
                                                 long long* bytes) {
  if (route < 0 || route > 2 || B < 0 || Sq < 0 || Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  *bytes = scratch_need(route, B, Sq, Hq, Hkv, Dh, scale);
  return cudaSuccess;
}

// bf16 on wgmma and mma.sync, f32 on simt (the route names the type: the
// wrapper passes f32 tensors to simt only); every pointer 16-byte aligned
// and Dh a multiple of 16 up to 256 (the wrapper checks); window <= 0
// means unbounded; shift = q_offset - kv_offset (query i sits at key
// position i + shift; shift + Sq and shift - window fit in int32, which
// the wrapper checks).  route: the wrapper's choice (flash_bwd_route),
// refused where it does not apply.  scratch: scratch_bytes of device
// memory, at least what flash_attention_bwd_scratch_bytes gives.  Launches
// the route's kernels (three on mma.sync and simt, two on wgmma) on
// `stream` and returns the first launch error.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   void* scratch, long long scratch_bytes,
                                   void* dq, void* dk, void* dv, int route,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int Dh, int causal, int window, int shift,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (route == 0) {
    if (flash_attention_bwd_route(1, Dh) != 0) return cudaErrorInvalidValue;
    if (Dh == 64)
      return launch_wgmma<64>(q, k, v, o, dout, lse, scratch, scratch_bytes,
                              dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, window,
                              shift, scale, st);
    if (Dh == 80)
      return launch_wgmma<80>(q, k, v, o, dout, lse, scratch, scratch_bytes,
                              dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, window,
                              shift, scale, st);
    if (Dh == 128)
      return launch_wgmma<128>(q, k, v, o, dout, lse, scratch, scratch_bytes,
                               dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, window,
                               shift, scale, st);
    return launch_wgmma<256>(q, k, v, o, dout, lse, scratch, scratch_bytes,
                             dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, window,
                             shift, scale, st);
  }
  if (route != 1 && route != 2) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(B) * Sq * Hq;
  if (scratch_bytes < scratch_need(route, B, Sq, Hq, Hkv, Dh, scale))
    return cudaErrorInvalidValue;
  float* delta = static_cast<float*>(scratch);
  if (route == 2)
    return launch_f32(static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v),
                      static_cast<const float*>(o),
                      static_cast<const float*>(dout), lse, delta,
                      static_cast<float*>(dq), static_cast<float*>(dk),
                      static_cast<float*>(dv), B, Sq, Sk, Hq, Hkv, Dh, causal,
                      window, shift, scale, st);
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  flash_bwd_delta<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, rows, Sq, Hq, Dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Dh <= 64)
    return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq,
                      Hkv, Dh, causal, window, shift, scale, st);
  if (Dh <= 128)
    return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq,
                       Hkv, Dh, causal, window, shift, scale, st);
  return launch<256>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq,
                     Hkv, Dh, causal, window, shift, scale, st);
}
