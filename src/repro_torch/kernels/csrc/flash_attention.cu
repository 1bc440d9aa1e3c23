// Causal (or full) online-softmax attention forward with GQA and a
// per-call sliding window, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:64) and computes what the LM path's
// chunked attention computes (src/repro/models/layers.py:75):
//
//   q (B, Sq, Hq, Dh), k and v (B, Sk, Hkv, Dh), contiguous; query head h
//   reads kv head h / (Hq / Hkv).  Key j is visible to query i when j < Sk,
//   and (causal) j <= i, and (window > 0) i - j < window.  Scores are
//   (q * scale) . k in f32, the running max m, sum l and accumulator are
//   f32, masked scores are -1e30 as in the reference (so a block that a row
//   cannot see is reset by the next visible one through alpha = 0), and
//   out = acc / max(l, 1e-30) in the input type.
//
// bf16 (the LM path): one CTA of 4 warps per (64-query tile, query head,
// batch row).  Q (pre-scaled and rounded to bf16, as the reference rounds
// q * scale), and 64-key K and V tiles are staged in shared memory with
// rows padded by 16 bytes so that the fragment loads of 8 rows fall in 8
// different bank groups (Dh = 256: 3 x 33 KB).  Each warp owns 16 query
// rows: S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate), P is rounded to bf16 before P V as the
// reference rounds it, V's fragments come from ldmatrix.trans.  The CTA
// visits only the key tiles its rows can see (from q0 - window + 1 to the
// diagonal), so a local layer costs S * window work, not S^2.
//
// f32 (the TPU kernel's second type, off the LM path): a plain SIMT kernel,
// one warp per query row, 4 rows per CTA, 32-key tiles in shared memory.
//
// Bound on this card: at the LM prefill shapes, operations (4 * Dh flops
// per visible (query, key) pair and head) rather than bytes.  The bf16
// design keeps scores and probabilities in registers (nothing but q, k, v
// and out touches device memory); it does not yet use wgmma or TMA, so it
// is far from the tensor cores' peak (a later PR's work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kThreads = 128;      // 4 warps

// ---------------------------------------------------------------- bf16 ----
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(int i, int j, int Sk, int causal,
                                        int window) {
  return j < Sk && (!causal || j <= i) && (window <= 0 || i - j < window);
}

// The first and last key tile that rows [q0, q0 + rows) can see.
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
               __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq,
               int Hkv, int Dh, int causal, int window, float scale) {
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
  key_tiles(q0, kBM, Sk, kBN, causal, window, &t_lo, &t_hi);

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
        if (!visible(i, j, Sk, causal, window)) s[n][e] = kNegInf;
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
              const float* __restrict__ v, float* __restrict__ out, int Sq,
              int Sk, int Hq, int Hkv, int Dh, int causal, int window,
              float scale) {
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
  key_tiles(q0, kRows, Sk, kTileK, causal, window, &t_lo, &t_hi);

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
    if (!visible(i, j0 + lane, Sk, causal, window)) s = kNegInf;
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
  float* orow = out + ((static_cast<size_t>(b) * Sq + i) * Hq + h) * Dh;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    if (d < Dh) orow[d] = acc[c] * inv;
  }
}

template <int DMAX>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                        int Dh, int causal, int window, float scale,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBM + 2 * kBN) * (Dh + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBM - 1) / kBM, Hq, B);
  flash_fwd_bf16<DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, Hq, Hkv, Dh, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Dh a multiple of 16 up to 256 (the
// wrapper checks); window <= 0 means unbounded.  Returns the launch's
// cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int Sq, int Sk,
                               int Hq, int Hkv, int Dh, int causal, int window,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (dtype == 1) {
    if (Dh <= 64)
      return launch_bf16<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh, causal,
                             window, scale, st);
    if (Dh <= 128)
      return launch_bf16<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh, causal,
                              window, scale, st);
    return launch_bf16<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh, causal,
                            window, scale, st);
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
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, Hq, Hkv,
      Dh, causal, window, scale);
  return cudaGetLastError();
}
