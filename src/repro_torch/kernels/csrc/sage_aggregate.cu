// Fused gather + weighted sum: out[b] = sum_f w[b, f] * table[idx[b, f]].
//
// Replaces the TPU kernel sage_aggregate_pallas
// (src/repro/kernels/sage_agg.py:32).  A pad (idx < 0) is weighted 0 and
// reads row 0 (so a non-finite row 0 gives NaN, as in the plain version);
// an index past the end reads the last row.  The sum is f32, taken in the
// order f = 0, 1, ... with one rounded multiply and one rounded add per term
// (__fmul_rn / __fadd_rn: no contraction into an FMA), which is what the
// plain version computes in separate PyTorch operations, so the two agree
// bit for bit; the result is rounded to the table's type.  The (B, F, D)
// rows are never written.
//
// Bound on this card: bytes.  At the GraphSAGE training shape (200,000 rows
// of 10 random neighbours over a 213 MB f32 table, four times the 50 MB L2)
// almost every gathered row comes from device memory, so what limits the
// kernel is how many bytes each SM keeps in flight (enough, and not so many
// that in-flight misses crowd L2) and how much of the table L2 still holds
// when a row is gathered again.  Two routes, chosen by the
// wrapper (sage_agg.sage_route) from the row's width and the table's address:
//
//  * vec (rows of a multiple of 16 bytes on a 16-byte aligned table): a
//    group of G lanes (32, 16 or 8, the fewest that cover the row, 512 bytes
//    at a time) owns an output row, each lane 16 contiguous bytes of it.  The
//    group's lanes load the row's indices and weights once, coalesced, and
//    broadcast them by shuffle; the next row's are loaded while this row's
//    gathers are in flight.  A lane issues the gathers of in_flight(G)
//    neighbours into registers before the first add.  Table rows are read
//    through the read-only path, not allocated in L1, under an L2
//    evict-last policy (createpolicy + ld.global.nc.L2::cache_hint, which
//    ptxas keeps: LDG.E.NA.128.CONSTANT with a policy descriptor), and the
//    output is stored evict-first (st.global.cs), so the 102 MB of output
//    of the training shape does not push table rows out of L2.  A
//    persistent grid (resident blocks x SMs) walks the rows.  A ring of
//    shared-memory stages fed by 1-D bulk copies (cp.async.bulk, one row per
//    copy) was no faster at the training shape (tools/sage_lab.cu).
//  * scalar (any width and alignment): one warp per output row, lanes over D
//    with one element per load (the first port's design).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* o, float x) { *o = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

// ------------------------------------------------------------- scalar ----
constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
sage_scalar_kernel(const T* __restrict__ table,
                   const int32_t* __restrict__ idx,
                   const float* __restrict__ w, T* __restrict__ out,
                   int64_t N, int64_t D, int64_t B, int64_t F) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t b = blockIdx.x * static_cast<int64_t>(kWarps)
                   + (threadIdx.x >> 5);
       b < B; b += warps) {
    const int32_t* ib = idx + b * F;
    const float* wb = w + b * F;
    for (int64_t d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int64_t f = 0; f < F; ++f) {
        const int32_t i = ib[f];
        const float wf = i >= 0 ? wb[f] : 0.f;
        const int64_t r = i < 0 ? 0 : (i >= N ? N - 1 : i);
        acc = __fadd_rn(acc, __fmul_rn(to_f32(table[r * D + d]), wf));
      }
      from_f32(&out[b * D + d], acc);
    }
  }
}

template <typename T>
cudaError_t launch_scalar(const void* table, const void* idx, const void* w,
                          void* out, int64_t N, int64_t D, int64_t B,
                          int64_t F, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough CTAs to fill the card several times over; the grid-stride loop
  // covers the rest
  const int64_t want = (B + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sms) * 32;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  sage_scalar_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), N, D, B, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- vec ----
constexpr int kVecThreads = 256;
// Neighbours whose gathers a lane issues before the first add: 4 for a
// 32-lane group, 3 for narrower ones (a warp then works on 2 or 4 rows).
// The fastest depths at the training shape (tools/sage_lab.py: 2, 3, 5, 8
// and 16 were slower in f32, 4, 5, 8 and 16 in bf16); misses in flight hold
// L2 lines too.
__host__ __device__ constexpr int in_flight(int G) {
  return G == 32 ? 4 : 3;
}

// 16 bytes of a row as f32 values, and back
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kVals = 4;
  __device__ static void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kVals = 8;
  // a 32-bit word holds two bf16, the first in its low half; widening a
  // bf16 to f32 is exact
  __device__ static void unpack(const uint4& u, float (&v)[8]) {
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      words[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(words[0], words[1], words[2], words[3]);
  }
};

// An L2 policy that keeps the lines it touches over others (evict-last).
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// 16 bytes of a table row through the read-only path, not allocated in L1,
// under an L2 policy; no load at all when !pred (the registers are then
// left undefined and not used).
__device__ __forceinline__ uint4 ld_row16(const uint4* p, uint64_t policy,
                                          bool pred) {
  uint4 v;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 "
      "{%0, %1, %2, %3}, [%4], %6;\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"(static_cast<int>(pred)), "l"(policy));
  return v;
}

// 16 bytes of an output row, stored evict-first (streaming).
__device__ __forceinline__ void st_row16(uint4* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// table (N, V) and out (B, V) in 16-byte vectors; idx and w (B, F).
template <typename T, int G>
__global__ void __launch_bounds__(kVecThreads)
sage_vec_kernel(const uint4* __restrict__ table,
                const int32_t* __restrict__ idx, const float* __restrict__ w,
                uint4* __restrict__ out, int64_t N, int64_t V, int64_t B,
                int F) {
  constexpr int kVals = Pack<T>::kVals;
  constexpr int kRows = 32 / G;  // output rows a warp works on at once
  constexpr int K = in_flight(G);
  const int lane = threadIdx.x & 31;
  const int g = lane % G;  // lane within the row's group
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * (kVecThreads / 32)
                       + (threadIdx.x >> 5);
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * (kVecThreads / 32) * kRows;
  const uint64_t policy = evict_last_policy();
  int64_t b = warp * kRows + lane / G;
  // this lane's slot of its row's first chunk of indices and weights,
  // loaded a row ahead
  int32_t next_i = 0;
  float next_w = 0.f;
  if (b < B && g < F) {
    next_i = __ldg(idx + b * F + g);
    next_w = __ldg(w + b * F + g);
  }
  // the whole warp walks while any of its groups has a row, so every
  // shuffle sees all 32 lanes
  for (int64_t base = warp * kRows; base < B; base += stride, b += stride) {
    const bool row_ok = b < B;
    const int32_t first_i = next_i;
    const float first_w = next_w;
    if (b + stride < B && g < F) {
      next_i = __ldg(idx + (b + stride) * F + g);
      next_w = __ldg(w + (b + stride) * F + g);
    }
    for (int64_t c = 0; c < V; c += G) {  // 512 bytes of the row at a time
      const int64_t v = c + g;
      const bool lane_ok = row_ok && v < V;
      float acc[kVals];
#pragma unroll
      for (int e = 0; e < kVals; ++e) acc[e] = 0.f;
      for (int f0 = 0; f0 < F; f0 += G) {  // G indices at a time
        int32_t i = first_i;
        float wf = first_w;
        if (f0 > 0) {
          i = 0;
          wf = 0.f;
          if (row_ok && f0 + g < F) {
            i = __ldg(idx + b * F + f0 + g);
            wf = __ldg(w + b * F + f0 + g);
          }
        }
        const int32_t r =
            i < 0 ? 0 : (i >= N ? static_cast<int32_t>(N - 1) : i);
        wf = i < 0 ? 0.f : wf;
        const int n = F - f0 < G ? F - f0 : G;
        for (int j0 = 0; j0 < n; j0 += K) {
          uint4 buf[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int32_t rj = __shfl_sync(0xffffffffu, r, j0 + j, G);
            buf[j] = ld_row16(table + static_cast<int64_t>(rj) * V + v,
                              policy, lane_ok && j0 + j < n);
          }
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float wj = __shfl_sync(0xffffffffu, wf, j0 + j, G);
            if (j0 + j < n) {
              float x[kVals];
              Pack<T>::unpack(buf[j], x);
#pragma unroll
              for (int e = 0; e < kVals; ++e)
                acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e], wj));
            }
          }
        }
      }
      if (lane_ok)
        st_row16(out + b * V + v, Pack<T>::pack(acc));
    }
  }
}

template <typename T, int G>
cudaError_t launch_vec(const void* table, const void* idx, const void* w,
                       void* out, int64_t N, int64_t V, int64_t B, int64_t F,
                       cudaStream_t stream) {
  int dev = 0, sms = 0, resident = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, sage_vec_kernel<T, G>, kVecThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t rows = kVecThreads / G;  // output rows of a block at once
  const int64_t want = (B + rows - 1) / rows;
  const int64_t cap =
      static_cast<int64_t>(sms) * (resident > 0 ? resident : 1);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  sage_vec_kernel<T, G><<<blocks, kVecThreads, 0, stream>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<uint4*>(out), N, V, B,
      static_cast<int>(F));
  return cudaGetLastError();
}

// The fewest lanes (32, 16 or 8) whose 16-byte vectors cover a row of V.
template <typename T>
cudaError_t launch_vec_for(const void* table, const void* idx, const void* w,
                           void* out, int64_t N, int64_t V, int64_t B,
                           int64_t F, cudaStream_t stream) {
  if (V > 16)
    return launch_vec<T, 32>(table, idx, w, out, N, V, B, F, stream);
  if (V > 8)
    return launch_vec<T, 16>(table, idx, w, out, N, V, B, F, stream);
  return launch_vec<T, 8>(table, idx, w, out, N, V, B, F, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; route: 0 = vec, 1 = scalar.  The vec
// route needs rows of a multiple of 16 bytes on a 16-byte aligned table
// (anything else returns cudaErrorInvalidValue).  Returns the launch's
// cudaError_t.
extern "C" int sage_aggregate(const void* table, const void* idx,
                              const void* w, void* out, int dtype, int route,
                              int64_t N, int64_t D, int64_t B, int64_t F,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || D == 0) return cudaSuccess;
  if (route == 1) {
    if (dtype == 1)
      return launch_scalar<__nv_bfloat16>(table, idx, w, out, N, D, B, F, st);
    return launch_scalar<float>(table, idx, w, out, N, D, B, F, st);
  }
  const int64_t row_bytes = D * (dtype == 1 ? 2 : 4);
  if (route != 0 || row_bytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 || F > INT32_MAX)
    return cudaErrorInvalidValue;
  const int64_t V = row_bytes / 16;
  if (dtype == 1)
    return launch_vec_for<__nv_bfloat16>(table, idx, w, out, N, V, B, F, st);
  return launch_vec_for<float>(table, idx, w, out, N, V, B, F, st);
}
