// Causal (or full) online-softmax attention forward with GQA and a
// per-call sliding window, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:64) and computes what the LM path's
// chunked attention computes (src/repro/models/layers.py:75):
//
//   q (B, Sq, Hq, Dh), k and v (B, Sk, Hkv, Dh), contiguous; query head h
//   reads kv head h / G (G = Hq / Hkv).  Query i sits at position
//   q_offset + i and key j at kv_offset + j (the reference's offsets; a
//   mesh prefill's query rows start at their shard's sequence offset), and
//   the kernels take only their difference, shift = q_offset - kv_offset:
//   key j is visible to query i when j < Sk, and (causal) j <= i + shift,
//   and (window > 0) i + shift - j < window.  Scores
//   are bf16(q * scale) . k in f32, the running max m, sum l and
//   accumulator are f32, p is rounded to bf16 before p . v while l sums the
//   f32 p, masked scores are -1e30 as in the reference (so a tile that a
//   row cannot see is reset by the next visible one through alpha = 0), and
//   out = acc / max(l, 1e-30) in the input type.
//
//   lse (optional, null for none; training asks for it, serving does not):
//   each row's log-sum-exp in natural log, m + log(l) from the running max
//   and sum the loop keeps, as f32 (B, Hq, Sq); the wgmma route converts its
//   base-2 statistic, (m2 + log2(l)) * ln 2.  flash_attention_bwd.cu
//   recomputes p = exp(s - lse) from it.
//
// Bound on this card: at the LM prefill shapes, operations (4 * Dh flops
// per visible (query, key) pair and query head; 137 GFLOP for a global
// gemma3-1b layer at 4 x 4096, 0.14 ms at 989 TFLOP/s) rather than bytes
// (84 MB, 0.025 ms).  So the design is about keeping the tensor cores fed.
//
// Three routes, chosen by (dtype, Dh) alone (flash_attention_route; the
// wrapper passes its choice, and may force mma.sync on any bf16 call):
//
// wgmma (bf16, Dh 64, 80, 128 or 256: gemma3, stablelm, qwen2.5,
//   minitron).  A CTA of
//   three warpgroups owns 128 packed query rows of one kv head: GQA's G
//   query heads of a position are neighbouring rows (row = position *
//   G + head), so one K/V tile serves all of them (gemma3: 32 positions x 4
//   heads).  Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg) and one thread issues TMA loads -- Q once (a 5-D map over
//   q viewed as (B, Sq, Hkv, G, Dh)), then K and V tiles of 64 keys (4-D
//   maps over (B, Sk, Hkv, Dh)) into a ring of stages with full and empty
//   mbarriers, so loads stay in flight while the tensor cores work.  Boxes
//   are 64 columns wide (128-byte swizzle), Dh / 64 boxes per tile; at Dh
//   80 the last 16 columns are one more box of 32-byte rows (32-byte
//   swizzle, maps of their own).  TMA's zero fill covers ragged Sq and Sk
//   inside each batch row.
//   Warpgroups 1 and 2 are consumers of 64 rows each: S = Q K^T by wgmma
//   m64n64k16 from shared memory (the tail: one more k-step), scaled into
//   the exp2 domain (log2 e, and the scale when it is a power of two; for
//   Dh 80 and 128 the consumers round q * scale into shared memory once,
//   as the reference rounds it), the
//   online softmax in registers, P rounded to bf16 in registers and O +=
//   P V by wgmma with P as the register operand and V read transposed.
//   P V is one wgmma m64n{Dh}k16 per 16 keys (Dh 80: an m64n64k16 and an
//   m64n16k16 into an accumulator of its own).  The next tile's Q K^T is
//   issued before the softmax of the current one, and the two consumers
//   take turns issuing their products (named barriers), so the tensor
//   cores work while a softmax runs.  The output goes through the Q tile's
//   shared memory to one TMA store per box.  A CTA visits only the key
//   tiles its rows can see, and causal CTAs start heaviest first.
//
// mma.sync (bf16, other Dh: the smoke configs' 16): one CTA
//   of 4 warps per (64-query tile, query head), mma.sync m16n8k16, K and V
//   tiles staged through padded shared memory.
//
// SIMT (f32, the TPU kernel's second type, off the LM path): one warp per
//   query row, 4 rows per CTA, 32-key tiles in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kThreads = 128;      // 4 warps

// ------------------------------------------------------ bf16, mma.sync ----
constexpr int kBM = 64;  // query rows per CTA (16 per warp)
constexpr int kBN = 64;  // keys per tile

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

__device__ __forceinline__ bool visible(int i, int j, int Sk, int causal,
                                        int window) {
  return j < Sk && (!causal || j <= i) && (window <= 0 || i - j < window);
}

// The first and last key tile that rows at positions [q0, q0 + rows) can
// see (q0 already shifted into the keys' positions).
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sk, int bn,
                                          int causal, int window, int* t_lo,
                                          int* t_hi) {
  int hi = Sk - 1;
  if (causal) hi = min(hi, q0 + rows - 1);
  int lo = 0;
  if (window > 0) lo = max(0, q0 - window + 1);
  *t_lo = lo / bn;
  *t_hi = hi < lo ? *t_lo - 1 : hi / bn;
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int Sq, int Sk, int Hq, int Hkv, int Dh, int causal,
               int window, int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 8;  // padded row, in elements
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBM * ld;
  __nv_bfloat16* Vs = Ks + kBN * ld;

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int chunks = Dh / 8;  // 16-byte chunks per row

  const size_t q_step = static_cast<size_t>(Hq) * Dh;  // between positions
  const size_t kv_step = static_cast<size_t>(Hkv) * Dh;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * Hq + h) * Dh;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh;

  for (int e = tid; e < kBM * chunks; e += kThreads) {
    const int r = e / chunks, c = (e % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_step + c);
    __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * scale);
    *reinterpret_cast<uint4*>(Qs + r * ld + c) = val;
  }

  int t_lo, t_hi;
  key_tiles(q0 + shift, kBM, Sk, kBN, causal, window, &t_lo, &t_hi);

  constexpr int NO = DMAX / 8;  // output n-tiles (8 columns each)
  constexpr int NS = kBN / 8;   // score n-tiles
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int t = t_lo; t <= t_hi; ++t) {
    const int j0 = t * kBN;
    __syncthreads();  // the previous tile's K and V are consumed
    for (int e = tid; e < kBN * chunks; e += kThreads) {
      const int r = e / chunks, c = (e % chunks) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (j0 + r) * kv_step + c);
        vv = *reinterpret_cast<const uint4*>(vb + (j0 + r) * kv_step + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * ld + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * ld + c) = vv;
    }
    __syncthreads();

    // S = (Q * scale) K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < Dh) {
        const __nv_bfloat16* qa = Qs + row0 * ld + kk * 16 + tig * 2;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(qa);
        a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * ld);
        a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * ld + 8);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const __nv_bfloat16* kbp = Ks + (n * 8 + g) * ld + kk * 16 + tig * 2;
          mma_bf16(s[n], a, *reinterpret_cast<const uint32_t*>(kbp),
                   *reinterpret_cast<const uint32_t*>(kbp + 8));
        }
      }
    }

    // Mask, then the online-softmax update of this thread's two rows.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = q0 + row0 + (e >= 2 ? 8 : 0);
        const int j = j0 + n * 8 + tig * 2 + (e & 1);
        if (!visible(i + shift, j, Sk, causal, window)) s[n][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 (the score fragments of two neighbouring
    // n-tiles are the A fragment of one 16-key step).
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int mat = lane >> 3, r = lane & 7;
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        if (n * 8 < Dh) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(
              bfr, Vs + (kk * 16 + (mat & 1) * 8 + r) * ld + (n + (mat >> 1)) * 8);
          mma_bf16(o[n], a, bfr[0], bfr[1]);
          mma_bf16(o[n + 1], a, bfr[2], bfr[3]);
        }
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + row0 + r * 8;
    if (i >= Sq) continue;
    if (lse != nullptr && tig == 0)  // l is the row's whole sum in each thread
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + i] = m[r] + logf(l[r]);
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Sq + i) * Hq + h) * Dh;
    const float inv = r ? inv1 : inv0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 < Dh)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + tig * 2) =
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// ----------------------------------------------------------------- f32 ----
constexpr int kRows = 4;    // query rows per CTA, one per warp
constexpr int kTileK = 32;  // keys per tile, one per lane
constexpr int kMaxChunks = 8;  // Dh <= 256 = 8 x 32 lanes

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int Dh,
              int causal, int window, int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = Dh + 1;  // odd stride: lane j reads row j without conflicts
  float* Qs = reinterpret_cast<float*>(smem);  // kRows x Dh
  float* Ks = Qs + kRows * Dh;                  // kTileK x ld
  float* Vs = Ks + kTileK * ld;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i = q0 + warp;
  const size_t q_step = static_cast<size_t>(Hq) * Dh;
  const size_t kv_step = static_cast<size_t>(Hkv) * Dh;
  const float* qb = q + (static_cast<size_t>(b) * Sq * Hq + h) * Dh;
  const float* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh;
  const float* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * Dh;

  for (int e = tid; e < kRows * Dh; e += kThreads) {
    const int r = e / Dh, c = e % Dh;
    Qs[e] = q0 + r < Sq ? qb[(q0 + r) * q_step + c] * scale : 0.f;
  }
  int t_lo, t_hi;
  key_tiles(q0 + shift, kRows, Sk, kTileK, causal, window, &t_lo, &t_hi);

  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int j0 = t * kTileK;
    __syncthreads();
    for (int e = tid; e < kTileK * Dh; e += kThreads) {
      const int r = e / Dh, c = e % Dh;
      const bool ok = j0 + r < Sk;
      Ks[r * ld + c] = ok ? kb[(j0 + r) * kv_step + c] : 0.f;
      Vs[r * ld + c] = ok ? vb[(j0 + r) * kv_step + c] : 0.f;
    }
    __syncthreads();
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s += Qs[warp * Dh + d] * Ks[lane * ld + d];
    if (!visible(i + shift, j0 + lane, Sk, causal, window)) s = kNegInf;
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) acc[c] *= alpha;
    for (int j = 0; j < kTileK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) acc[c] += pj * Vs[j * ld + d];
      }
    }
  }
  if (i >= Sq) return;
  if (lse != nullptr && lane == 0)
    lse[(static_cast<size_t>(b) * Hq + h) * Sq + i] = m + logf(l);
  float* orow = out + ((static_cast<size_t>(b) * Sq + i) * Hq + h) * Dh;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    if (d < Dh) orow[d] = acc[c] * inv;
  }
}

// -------------------------------------------------------- bf16, wgmma ----
constexpr int kWgThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kRowsPerCta = 128;  // packed (position, head) rows
constexpr int kKeys = 64;         // keys per K/V tile
constexpr int kBoxBytes = 64 * 128;  // 64 rows of 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct WgTile {
  static constexpr int kChunks = DH / 64;  // 64-column boxes per row
  // the columns past them: 0, or 16 (Dh 80) in a box of 32-byte rows
  static constexpr int kTail = DH % 64;
  static_assert(kTail == 0 || kTail == 16, "Dh is 64 n or 64 n + 16");
  // K and V tiles in flight: 64 KB of Q and 2 x (32 + 32) KB at Dh 256
  static constexpr int kStages = DH == 256 ? 2 : 4;
  static constexpr int kQTail = kChunks * kRowsPerCta * 128;  // Q's tail box
  static constexpr int kQBytes = kQTail + kRowsPerCta * kTail * 2;
  static constexpr int kKvTail = kChunks * kBoxBytes;  // in a K or V stage
  static constexpr int kKvBytes = kKvTail + kKeys * kTail * 2;  // one stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKvBytes;
  // tiles, 1 + 4 * stages barriers, and slack to align the base to 1024
  static constexpr int kSmem = kBarOffset + (1 + 4 * kStages) * 8 + 1024;
};

struct WgParams {
  int B, Sq, Sk, Hkv;
  int G;       // query heads per kv head
  float* lse;  // (B, Hkv * G, Sq) f32, or null
  int Gt;      // heads packed per tile: min(G, 128)
  int HB;      // head blocks per kv head: ceil(G / Gt)
  int P;       // positions per tile: 128 / Gt
  int ntiles;  // query tiles: ceil(Sq / P)
  int causal, window;
  int shift;      // q_offset - kv_offset: a row's position in the keys'
  float c;        // multiplies q . k into the exp2 domain
  int rescale_q;  // 1: round q * scale into shared memory first
  float scale;
};

// S (this warpgroup's 64 rows x 64 keys) = Q K^T over Dh, from shared
// memory: the k-th 16 columns of a 64-column box start 32 bytes further
// inside each 128-byte swizzled row; a 16-column tail (q_tail: this
// warpgroup's rows of Q's tail box) is one more k-step.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_base,
                                         uint32_t q_tail, uint32_t k_base) {
  using T = WgTile<DH>;
#pragma unroll
  for (int i = 0; i < 32; ++i) hopper::reg_fence(s[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * T::kChunks; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    hopper::wgmma_ss_m64n64k16(
        s,
        hopper::sw128_desc(q_base + (kk / 4) * kRowsPerCta * 128 + off, 16),
        hopper::sw128_desc(k_base + (kk / 4) * kBoxBytes + off, 16), kk > 0);
  }
  if constexpr (T::kTail != 0)
    hopper::wgmma_ss_m64n64k16(s, hopper::sw32_desc(q_tail),
                               hopper::sw32_desc(k_base + T::kKvTail), 1);
  hopper::wgmma_commit();
#pragma unroll
  for (int i = 0; i < 32; ++i) hopper::reg_fence(s[i]);
}

// The online-softmax step of one tile for this thread's two rows (the
// accumulator layout: s[4n + e] is row r0 (e < 2) or r0 + 8 (e >= 2), key
// 8n + 2 * (lane % 4) + (e % 2)).  Scores go to the exp2 domain, masked
// ones to -1e30; m is updated and alpha = 2^(m_old - m_new) returned; s is
// overwritten by p = 2^(s - m) and `sum` gets each row's partial sum.
__device__ __forceinline__ void softmax_tile(float (&s)[32], bool masked,
                                             int j0, int jlo0, int jhi0,
                                             int jlo1, int jhi1, float c,
                                             float (&m)[2], float (&alpha)[2],
                                             float (&sum)[2]) {
  const int jt = j0 + 2 * (threadIdx.x & 3);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e] * c;
      if (masked) {
        const int j = jt + 8 * n + (e & 1);
        const bool vis = e < 2 ? (j >= jlo0 && j < jhi0)
                               : (j >= jlo1 && j < jhi1);
        x = vis ? x : kNegInf;
      }
      s[4 * n + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = hopper::ex2(m[r] - m_new);
    m[r] = m_new;
    sum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = hopper::ex2(s[i] - m[r]);
    sum[r] += s[i];
  }
}

// The maps: q, k, v, out over their first 64 NC columns (64-column boxes,
// 128B swizzle), then (Dh 80) the same four over the 16-column tail (32B
// swizzle; unused otherwise).
template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to,
                const __grid_constant__ CUtensorMap tq_t,
                const __grid_constant__ CUtensorMap tk_t,
                const __grid_constant__ CUtensorMap tv_t,
                const __grid_constant__ CUtensorMap to_t, const WgParams prm) {
  using T = WgTile<DH>;
  constexpr int NC = T::kChunks, ST = T::kStages, TL = T::kTail;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + T::kQBytes;
  unsigned char* Vs = Ks + ST * T::kKvBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;

  // This CTA's tile: heaviest (last) query tiles first when causal.
  const int per = prm.B * prm.Hkv * prm.HB;
  const int u = blockIdx.x % per;
  const int t = blockIdx.x / per;
  const int tile = prm.causal ? prm.ntiles - 1 - t : t;
  const int hb = u % prm.HB;
  const int hk = (u / prm.HB) % prm.Hkv;
  const int b = u / (prm.HB * prm.Hkv);
  const int p0 = tile * prm.P;
  const int p_last = min(p0 + prm.P - 1, prm.Sq - 1);

  // The key tiles some row of the CTA can see (rows at positions shifted
  // by prm.shift into the keys').
  int hi = prm.Sk - 1;
  if (prm.causal) hi = min(hi, p_last + prm.shift);
  const int lo =
      prm.window > 0 ? max(0, p0 + prm.shift - prm.window + 1) : 0;
  const int t_lo = lo / kKeys;
  const int n = hi < lo ? 0 : hi / kKeys - t_lo + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 2 * 128);  // every consumer thread
      hopper::mbar_init(&v_empty[s], 2 * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_full,
                             (NC * 128 + TL * 2) * prm.Gt * prm.P);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        hopper::tma_load_5d(Qs + c * kRowsPerCta * 128, &tq, q_full, 64 * c,
                            hb * prm.Gt, hk, p0, b);
      if constexpr (TL != 0)
        hopper::tma_load_5d(Qs + T::kQTail, &tq_t, q_full, 64 * NC,
                            hb * prm.Gt, hk, p0, b);
      for (int i = 0; i < n; ++i) {
        const int j0 = (t_lo + i) * kKeys, st = i % ST;
        const uint32_t ph = ((i / ST) & 1) ^ 1;  // the first pass is free
        unsigned char* ks = Ks + st * T::kKvBytes;
        unsigned char* vs = Vs + st * T::kKvBytes;
        hopper::mbar_wait(&k_empty[st], ph);
        hopper::mbar_expect_tx(&k_full[st], T::kKvBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(ks + c * kBoxBytes, &tk, &k_full[st], 64 * c,
                              hk, j0, b);
        if constexpr (TL != 0)
          hopper::tma_load_4d(ks + T::kKvTail, &tk_t, &k_full[st], 64 * NC,
                              hk, j0, b);
        hopper::mbar_wait(&v_empty[st], ph);
        hopper::mbar_expect_tx(&v_full[st], T::kKvBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(vs + c * kBoxBytes, &tv, &v_full[st], 64 * c,
                              hk, j0, b);
        if constexpr (TL != 0)
          hopper::tma_load_4d(vs + T::kKvTail, &tv_t, &v_full[st], 64 * NC,
                              hk, j0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    hopper::setmaxnreg_inc<240>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = 64 * w + 16 * warp + lane / 4, r1 = r0 + 8;
    // the rows' positions in the keys' frame
    const int pos0 = p0 + prm.shift + r0 / prm.Gt;
    const int pos1 = p0 + prm.shift + r1 / prm.Gt;
    // keys [jlo, jhi) are visible to a row
    const int jlo0 = prm.window > 0 ? pos0 - prm.window + 1 : INT_MIN;
    const int jlo1 = prm.window > 0 ? pos1 - prm.window + 1 : INT_MIN;
    const int jhi0 = prm.causal ? min(prm.Sk, pos0 + 1) : prm.Sk;
    const int jhi1 = prm.causal ? min(prm.Sk, pos1 + 1) : prm.Sk;
    // every row of the CTA sees all keys in [lo_all, hi_all)
    const int lo_all =
        prm.window > 0 ? p_last + prm.shift - prm.window + 1 : INT_MIN;
    const int hi_all = prm.causal ? min(prm.Sk, p0 + prm.shift + 1) : prm.Sk;

    const uint32_t q_base = hopper::smem_addr(Qs) + w * 64 * 128;
    const uint32_t q_tail = hopper::smem_addr(Qs + T::kQTail) + w * 64 * TL * 2;
    const uint32_t k_base = hopper::smem_addr(Ks);
    const uint32_t v_base = hopper::smem_addr(Vs);

    hopper::mbar_wait(q_full, 0);
    if (prm.rescale_q) {
      // bf16(q * scale), as the reference rounds it, on this warpgroup's
      // 64 rows of every box; then visible to wgmma (the async proxy).
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        uint4* rows = reinterpret_cast<uint4*>(Qs + c * kRowsPerCta * 128 +
                                               w * 64 * 128);
        for (int e = tid; e < 64 * 128 / 16; e += 128) {
          uint4 val = rows[e];
          __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            x[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * prm.scale);
          rows[e] = val;
        }
      }
      if constexpr (TL != 0) {
        uint4* rows = reinterpret_cast<uint4*>(Qs + T::kQTail +
                                               w * 64 * TL * 2);
        for (int e = tid; e < 64 * TL * 2 / 16; e += 128) {
          uint4 val = rows[e];
          __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            x[i] = __float2bfloat16_rn(__bfloat162float(x[i]) * prm.scale);
          rows[e] = val;
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + w, 128);
    }

    float o[NC][32], ot[8];  // ot: the tail's 16 columns (Dh 80)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ot[i] = 0.f;
    float s[32];
    uint32_t p[4][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f}, sum[2];
    // O *= alpha, row by row (the accumulator layout's rows r0 and r0 + 8)
    auto rescale = [&] {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
      if constexpr (TL != 0)
#pragma unroll
        for (int e = 0; e < 8; ++e) ot[e] *= alpha[(e >> 1) & 1];
    };
    // O += P V from stage vs (issued, not waited for)
    auto issue_pv = [&](int vs) {
      const uint32_t vb = v_base + vs * T::kKvBytes;
      hopper::wgmma_rs_tile<NC, TL != 0>(o, ot, p, vb, vb + T::kKvTail);
    };
    // the products into O are done
    auto wait_o = [&] {
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) hopper::reg_fence(o[c][e]);
#pragma unroll
      for (int e = 0; e < 8; ++e) hopper::reg_fence(ot[e]);
    };

    // The two consumer warpgroups take turns issuing their products
    // (named barriers 3 and 4, consumer 0 first), so that one's softmax
    // runs while the other's products have the tensor cores.
    if (w == 1) hopper::named_arrive(3, 256);
    auto turn_begin = [&] { hopper::named_sync(3 + w, 256); };
    auto turn_end = [&] { hopper::named_arrive(4 - w, 256); };
    auto masked = [&](int j0) { return j0 < lo_all || j0 + kKeys > hi_all; };
    if (n > 0) {
      // tile 0: S, softmax, P
      hopper::mbar_wait(&k_full[0], 0);
      turn_begin();
      issue_qk<DH>(s, q_base, q_tail, k_base);
      turn_end();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) hopper::reg_fence(s[i]);
      hopper::mbar_arrive(&k_empty[0]);
      int j0 = t_lo * kKeys;
      softmax_tile(s, masked(j0), j0, jlo0, jhi0, jlo1, jhi1, prm.c, m, alpha,
                   sum);
      l[0] = sum[0];
      l[1] = sum[1];
      hopper::acc_to_a(s, p);
      for (int i = 1; i < n; ++i) {
        const int ks = i % ST, vs = (i - 1) % ST;  // K of i, V of i - 1
        // S of tile i on the tensor cores ...
        hopper::mbar_wait(&k_full[ks], (i / ST) & 1);
        turn_begin();
        issue_qk<DH>(s, q_base, q_tail, k_base + ks * T::kKvBytes);
        // ... O rescaled for tile i - 1 and its P V behind it ...
        rescale();
        hopper::mbar_wait(&v_full[vs], ((i - 1) / ST) & 1);
        issue_pv(vs);
        turn_end();
        // ... while the softmax of tile i runs once its S is in
        hopper::wgmma_wait<1>();
#pragma unroll
        for (int e = 0; e < 32; ++e) hopper::reg_fence(s[e]);
        hopper::mbar_arrive(&k_empty[ks]);
        j0 = (t_lo + i) * kKeys;
        softmax_tile(s, masked(j0), j0, jlo0, jhi0, jlo1, jhi1, prm.c, m,
                     alpha, sum);
        wait_o();
        hopper::mbar_arrive(&v_empty[vs]);
        l[0] = l[0] * alpha[0] + sum[0];
        l[1] = l[1] * alpha[1] + sum[1];
        hopper::acc_to_a(s, p);
      }
      const int vs = (n - 1) % ST;
      rescale();
      hopper::mbar_wait(&v_full[vs], ((n - 1) / ST) & 1);
      turn_begin();
      issue_pv(vs);
      turn_end();
      wait_o();
      hopper::mbar_arrive(&v_empty[vs]);
    }
    if (w == 0) hopper::named_sync(3, 256);  // the other's last turn_end

    // out = O / max(l, 1e-30); l summed over the row's 4 threads.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    if (prm.lse != nullptr && (lane & 3) == 0) {
      // natural-log lse of each real (position, head) row: the exp2
      // domain's m2 + log2(l), times ln 2.  Rows past P * Gt (128 is not a
      // multiple of G) are no row: their position would be the next tile's
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? r1 : r0;
        const int pos = p0 + row / prm.Gt, gh = hb * prm.Gt + row % prm.Gt;
        if (row < prm.P * prm.Gt && pos < prm.Sq && gh < prm.G)
          prm.lse[(static_cast<size_t>(b) * prm.Hkv * prm.G + hk * prm.G +
                   gh) * prm.Sq + pos] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
    // Into this warpgroup's Q rows (their products are done), in the
    // swizzled layout of the Q box, then one TMA store of the whole tile:
    // it clips rows past Sq and heads past G.
    const int g = lane / 4;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        unsigned char* chunk = Qs + c * kRowsPerCta * 128 +
                               ((nn ^ g) * 16) + 4 * (lane & 3);
        *reinterpret_cast<uint32_t*>(chunk + r0 * 128) =
            pack_bf16(o[c][4 * nn] * inv[0], o[c][4 * nn + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(chunk + r1 * 128) =
            pack_bf16(o[c][4 * nn + 2] * inv[1], o[c][4 * nn + 3] * inv[1]);
      }
    if constexpr (TL != 0) {
      // the tail box's 32-byte rows: 16-byte chunk nn sits at nn ^ bit 2
      // of the row (the 32B swizzle)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? r1 : r0;
          *reinterpret_cast<uint32_t*>(
              Qs + T::kQTail + row * 32 + ((nn ^ ((row >> 2) & 1)) * 16) +
              4 * (lane & 3)) = pack_bf16(ot[4 * nn + 2 * r] * inv[r],
                                          ot[4 * nn + 2 * r + 1] * inv[r]);
        }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(5, 256);
    if (threadIdx.x == 128) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        hopper::tma_store_5d(&to, Qs + c * kRowsPerCta * 128, 64 * c,
                             hb * prm.Gt, hk, p0, b);
      if constexpr (TL != 0)
        hopper::tma_store_5d(&to_t, Qs + T::kQTail, 64 * NC, hb * prm.Gt, hk,
                             p0, b);
      hopper::tma_store_wait();
    }
  }
}

template <int DH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Sk, int Hq,
                         int Hkv, int causal, int window, int shift,
                         float scale, cudaStream_t stream) {
  using T = WgTile<DH>;
  const int G = Hq / Hkv;
  WgParams prm;
  prm.B = B;
  prm.Sq = Sq;
  prm.Sk = Sk;
  prm.Hkv = Hkv;
  prm.G = G;
  prm.lse = lse;
  prm.Gt = min(G, kRowsPerCta);
  prm.HB = (G + prm.Gt - 1) / prm.Gt;
  prm.P = kRowsPerCta / prm.Gt;
  prm.ntiles = (Sq + prm.P - 1) / prm.P;
  prm.causal = causal;
  prm.window = window;
  prm.shift = shift;
  int ex;
  const bool pow2 = frexpf(scale, &ex) == 0.5f;  // exact to fold into c
  prm.c = pow2 ? scale * kLog2e : kLog2e;
  prm.rescale_q = !pow2;
  prm.scale = scale;
  const long long grid = static_cast<long long>(B) * Hkv * prm.HB * prm.ntiles;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  // TMA reads 16-byte aligned global memory
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out) |
       (Sk > 0 ? reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)
               : 0)) % 16)
    return cudaErrorMisalignedAddress;

  // q viewed as (B, Sq, Hkv, G, Dh): a box is P positions x Gt heads x 64
  // columns; k and v as (B, Sk, Hkv, Dh): 64 keys x 64 columns.  With
  // Sk = 0 no key tile is loaded (the map only has to be valid).
  const cuuint64_t e = 2, Dh = DH;
  CUtensorMap tq, tk, tv, to;
  const cuuint64_t qdim[5] = {Dh, static_cast<cuuint64_t>(G),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(Sq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t qstr[4] = {Dh * e, G * Dh * e, Hq * Dh * e,
                              static_cast<cuuint64_t>(Sq) * Hq * Dh * e};
  const cuuint32_t qbox[5] = {64, static_cast<cuuint32_t>(prm.Gt), 1,
                              static_cast<cuuint32_t>(prm.P), 1};
  const cuuint64_t sk = Sk > 0 ? Sk : 1;
  const cuuint64_t kdim[4] = {Dh, static_cast<cuuint64_t>(Hkv), sk,
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t kstr[3] = {Dh * e, Hkv * Dh * e, sk * Hkv * Dh * e};
  const cuuint32_t kbox[4] = {64, 1, kKeys, 1};
  const void* kp = Sk > 0 ? k : q;
  const void* vp = Sk > 0 ? v : q;
  if (!hopper::encode_bf16(&tq, q, 5, qdim, qstr, qbox) ||
      !hopper::encode_bf16(&to, out, 5, qdim, qstr, qbox) ||
      !hopper::encode_bf16(&tk, kp, 4, kdim, kstr, kbox) ||
      !hopper::encode_bf16(&tv, vp, 4, kdim, kstr, kbox))
    return cudaErrorInvalidValue;
  // Dh 80: the last 16 columns through maps of their own, 32B-swizzled
  CUtensorMap tq_t = tq, tk_t = tk, tv_t = tv, to_t = to;
  if (T::kTail != 0) {
    const cuuint32_t qbox_t[5] = {T::kTail, qbox[1], 1, qbox[3], 1};
    const cuuint32_t kbox_t[4] = {T::kTail, 1, kKeys, 1};
    const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_32B;
    if (!hopper::encode_bf16(&tq_t, q, 5, qdim, qstr, qbox_t, sw) ||
        !hopper::encode_bf16(&to_t, out, 5, qdim, qstr, qbox_t, sw) ||
        !hopper::encode_bf16(&tk_t, kp, 4, kdim, kstr, kbox_t, sw) ||
        !hopper::encode_bf16(&tv_t, vp, 4, kdim, kstr, kbox_t, sw))
      return cudaErrorInvalidValue;
  }

  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<DH><<<static_cast<unsigned>(grid), kWgThreads, T::kSmem,
                        stream>>>(tq, tk, tv, to, tq_t, tk_t, tv_t, to_t,
                                  prm);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int Sq, int Sk, int Hq,
                        int Hkv, int Dh, int causal, int window, int shift,
                        float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBM + 2 * kBN) * (Dh + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBM - 1) / kBM, Hq, B);
  flash_fwd_bf16<DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, Sq, Sk, Hq, Hkv, Dh, causal, window, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// The route (dtype, Dh) takes: 0 = SIMT (f32), 1 = mma.sync (bf16),
// 2 = wgmma (bf16, Dh 64, 80, 128 or 256).  kernels/flash_attention.py's
// flash_route states the same rule.
extern "C" int flash_attention_route(int dtype, int Dh) {
  if (dtype != 1) return 0;
  return Dh == 64 || Dh == 80 || Dh == 128 || Dh == 256 ? 2 : 1;
}

// dtype: 0 = float32, 1 = bfloat16.  route: the wrapper's choice
// (flash_route), refused where it does not apply: SIMT takes f32 only,
// mma.sync any bf16 head dim (so a caller may force it where the rule
// gives wgmma), wgmma the bf16 head dims of the rule.  Dh a multiple of 16
// up to 256 (the wrapper checks); window <= 0 means unbounded; shift =
// q_offset - kv_offset (0: query i and key j at positions i and j); lse
// null or (B, Hq, Sq) f32.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, int dtype, int route,
                               int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
                               int causal, int window, int shift, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((route == 0) != (dtype == 0) || route < 0 || route > 2 ||
      (route == 2 && flash_attention_route(dtype, Dh) != 2))
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  switch (route) {
    case 2:
      if (Dh == 64)
        return launch_wgmma<64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv,
                                causal, window, shift, scale, st);
      if (Dh == 80)
        return launch_wgmma<80>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv,
                                causal, window, shift, scale, st);
      if (Dh == 128)
        return launch_wgmma<128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv,
                                 causal, window, shift, scale, st);
      return launch_wgmma<256>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal,
                               window, shift, scale, st);
    case 1:
      if (Dh <= 64)
        return launch_bf16<64>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, Dh,
                               causal, window, shift, scale, st);
      if (Dh <= 128)
        return launch_bf16<128>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, Dh,
                                causal, window, shift, scale, st);
      return launch_bf16<256>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, Dh,
                              causal, window, shift, scale, st);
    default:
      break;
  }
  const size_t smem = (static_cast<size_t>(kRows) * Dh
                       + 2 * static_cast<size_t>(kTileK) * (Dh + 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_fwd_f32<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk, Hq,
      Hkv, Dh, causal, window, shift, scale);
  return cudaGetLastError();
}
