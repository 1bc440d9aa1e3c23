// Design variants of the sage_aggregate kernel, for tools/sage_lab.py.
//
// Includes the kernel's own source for its row packing, and adds copies of
// its vec route with other L2 hints and depths of loads in flight than the
// ones it ships, and the alternative it was measured against: Hopper's 1-D
// bulk copy (cp.async.bulk, one table row per copy, completion counted on
// an mbarrier) filling a ring of shared-memory stages from one producer
// warp while consumer warps reduce each output row from shared memory.
#include "../src/repro_torch/kernels/csrc/sage_aggregate.cu"
#include "../src/repro_torch/kernels/csrc/hopper.cuh"

namespace {

// L2 hints of a variant: bits 0-1 the table's policy (0 none, 1 evict-last,
// 2 evict-last for half the accesses and evict-first for the rest, 3 the
// same with a quarter), bit 2 output stores evict-first, bit 3 index and
// weight loads evict-first.  The shipped kernel is 1 | 4.
constexpr int kStreamOut = 4;
constexpr int kStreamIdx = 8;

template <int kPolicy>
__device__ __forceinline__ uint64_t lab_policy() {
  uint64_t p = 0;
  if constexpr (kPolicy == 1)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(p));
  if constexpr (kPolicy == 2)
    asm volatile(
        "createpolicy.fractional.L2::evict_last.L2::evict_first.b64 %0, "
        "0.5;\n"
        : "=l"(p));
  if constexpr (kPolicy == 3)
    asm volatile(
        "createpolicy.fractional.L2::evict_last.L2::evict_first.b64 %0, "
        "0.25;\n"
        : "=l"(p));
  return p;
}

template <bool kPolicy>
__device__ __forceinline__ uint4 lab_ld_row16(const uint4* p, uint64_t policy,
                                              bool pred) {
  if (kPolicy) return ld_row16(p, policy, pred);
  uint4 v;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

template <bool kStream>
__device__ __forceinline__ void lab_st_row16(uint4* p, const uint4& v) {
  if (kStream)
    st_row16(p, v);
  else
    *p = v;
}

template <typename U, bool kStream>
__device__ __forceinline__ U lab_ld_small(const U* p) {
  return kStream ? __ldcs(p) : __ldg(p);
}

// sage_vec_kernel with K neighbours in flight a lane and hints kHint.
template <typename T, int G, int K, int kHint>
__global__ void __launch_bounds__(kVecThreads)
lab_vec_kernel(const uint4* __restrict__ table,
               const int32_t* __restrict__ idx, const float* __restrict__ w,
               uint4* __restrict__ out, int64_t N, int64_t V, int64_t B,
               int F) {
  constexpr int kVals = Pack<T>::kVals;
  constexpr int kRows = 32 / G;
  constexpr int kPolicy = kHint & 3;
  constexpr bool kStream = (kHint & kStreamIdx) != 0;
  constexpr bool kStreamStores = (kHint & kStreamOut) != 0;
  const int lane = threadIdx.x & 31;
  const int g = lane % G;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * (kVecThreads / 32)
                       + (threadIdx.x >> 5);
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * (kVecThreads / 32) * kRows;
  const uint64_t policy = lab_policy<kPolicy>();
  int64_t b = warp * kRows + lane / G;
  int32_t next_i = 0;
  float next_w = 0.f;
  if (b < B && g < F) {
    next_i = lab_ld_small<int32_t, kStream>(idx + b * F + g);
    next_w = lab_ld_small<float, kStream>(w + b * F + g);
  }
  for (int64_t base = warp * kRows; base < B; base += stride, b += stride) {
    const bool row_ok = b < B;
    const int32_t first_i = next_i;
    const float first_w = next_w;
    if (b + stride < B && g < F) {
      next_i = lab_ld_small<int32_t, kStream>(idx + (b + stride) * F + g);
      next_w = lab_ld_small<float, kStream>(w + (b + stride) * F + g);
    }
    for (int64_t c = 0; c < V; c += G) {
      const int64_t v = c + g;
      const bool lane_ok = row_ok && v < V;
      float acc[kVals];
#pragma unroll
      for (int e = 0; e < kVals; ++e) acc[e] = 0.f;
      for (int f0 = 0; f0 < F; f0 += G) {
        int32_t i = first_i;
        float wf = first_w;
        if (f0 > 0) {
          i = 0;
          wf = 0.f;
          if (row_ok && f0 + g < F) {
            i = lab_ld_small<int32_t, kStream>(idx + b * F + f0 + g);
            wf = lab_ld_small<float, kStream>(w + b * F + f0 + g);
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
            buf[j] = lab_ld_row16<kPolicy != 0>(
                table + static_cast<int64_t>(rj) * V + v, policy,
                lane_ok && j0 + j < n);
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
        lab_st_row16<kStreamStores>(out + b * V + v, Pack<T>::pack(acc));
    }
  }
}

template <typename T, int G, int K, int kHint>
cudaError_t launch_lab_vec(const void* table, const void* idx, const void* w,
                           void* out, int64_t N, int64_t V, int64_t B,
                           int64_t F, cudaStream_t stream) {
  int dev = 0, sms = 0, resident = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, lab_vec_kernel<T, G, K, kHint>, kVecThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t rows = kVecThreads / G;
  const int64_t want = (B + rows - 1) / rows;
  const int64_t cap =
      static_cast<int64_t>(sms) * (resident > 0 ? resident : 1);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  lab_vec_kernel<T, G, K, kHint><<<blocks, kVecThreads, 0, stream>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<uint4*>(out), N, V, B,
      static_cast<int>(F));
  return cudaGetLastError();
}

template <bool kPolicy>
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar,
                                         uint64_t policy) {
  if (kPolicy)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(
            hopper::smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(hopper::smem_addr(bar)), "l"(policy)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(hopper::smem_addr(bar))
        : "memory");
}

// One output row per stage: the producer warp copies its F table rows into
// the stage, a consumer warp (stage % kConsumers) sums them in the order
// f = 0, 1, ... and frees the stage.  F <= 32, rows of a multiple of 16
// bytes, at most 32 16-byte vectors a row (one per lane).
template <typename T, int kStages, int kPolicy, int kConsumers>
__global__ void __launch_bounds__((kConsumers + 1) * 32)
sage_bulk_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                 const float* __restrict__ w, uint4* __restrict__ out,
                 int64_t N, int64_t V, int64_t B, int F) {
  static_assert(kStages % kConsumers == 0, "a stage has one consumer");
  constexpr int kVals = Pack<T>::kVals;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t row_bytes = static_cast<uint32_t>(V * 16);
  const uint32_t stage_bytes = row_bytes * F;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (warp == kConsumers) {  // producer
    const uint64_t policy = lab_policy<kPolicy>();
    int k = 0;
    for (int64_t b = blockIdx.x; b < B; b += gridDim.x, ++k) {
      const int s = k % kStages;
      if (k >= kStages) hopper::mbar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
      if (lane == 0) hopper::mbar_expect_tx(&full[s], stage_bytes);
      __syncwarp();
      if (lane < F) {
        const int32_t i = __ldcs(idx + b * F + lane);
        const int64_t r = i < 0 ? 0 : (i >= N ? N - 1 : i);
        bulk_row<kPolicy != 0>(smem + s * stage_bytes + lane * row_bytes,
                               table + r * V * kVals, row_bytes, &full[s],
                               policy);
      }
    }
    return;
  }
  int k = warp;
  for (int64_t b = blockIdx.x + static_cast<int64_t>(warp) * gridDim.x; b < B;
       b += static_cast<int64_t>(kConsumers) * gridDim.x, k += kConsumers) {
    const int s = k % kStages;
    int32_t i = 0;
    float wf = 0.f;
    if (lane < F) {
      i = __ldcs(idx + b * F + lane);
      wf = i < 0 ? 0.f : __ldcs(w + b * F + lane);
    }
    hopper::mbar_wait(&full[s], (k / kStages) & 1);
    float acc[kVals];
#pragma unroll
    for (int e = 0; e < kVals; ++e) acc[e] = 0.f;
    const uint4* rows = reinterpret_cast<const uint4*>(smem + s * stage_bytes);
    for (int f = 0; f < F; ++f) {
      const float wj = __shfl_sync(0xffffffffu, wf, f);
      if (lane < V) {
        float x[kVals];
        Pack<T>::unpack(rows[f * V + lane], x);
#pragma unroll
        for (int e = 0; e < kVals; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e], wj));
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (lane < V) st_row16(out + b * V + lane, Pack<T>::pack(acc));
  }
}

template <typename T, int kStages, int kPolicy, int kConsumers>
cudaError_t launch_bulk(const void* table, const void* idx, const void* w,
                        void* out, int64_t N, int64_t V, int64_t B, int64_t F,
                        cudaStream_t stream) {
  if (F < 1 || F > 32 || V > 32) return cudaErrorInvalidValue;
  const size_t smem = kStages * (V * 16 * F) + 2 * kStages * sizeof(uint64_t);
  auto kernel = sage_bulk_kernel<T, kStages, kPolicy, kConsumers>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, resident = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kernel, (kConsumers + 1) * 32, smem);
  if (err != cudaSuccess) return err;
  const int64_t cap =
      static_cast<int64_t>(sms) * (resident > 0 ? resident : 1);
  const int blocks = static_cast<int>(B < cap ? B : cap);
  kernel<<<blocks, (kConsumers + 1) * 32, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<uint4*>(out), N, V, B,
      static_cast<int>(F));
  return cudaGetLastError();
}

#define SAGE_VEC_VARIANTS(G)                                              \
  switch (variant) {                                                     \
    case 0: return launch_lab_vec<T, G, 4, 1 | 4>(ARGS);                     \
    case 1: return launch_lab_vec<T, G, 3, 1 | 4>(ARGS);                     \
    case 2: return launch_lab_vec<T, G, 4, 1>(ARGS);                         \
    case 3: return launch_lab_vec<T, G, 4, 1 | 4 | 8>(ARGS);                 \
    case 4: return launch_lab_vec<T, G, 4, 0>(ARGS);                         \
    case 5: return launch_lab_vec<T, G, 4, 2 | 4>(ARGS);                     \
    case 6: return launch_lab_vec<T, G, 4, 3 | 4>(ARGS);                     \
    case 7: return launch_lab_vec<T, G, 2, 1 | 4>(ARGS);                     \
    case 8: return launch_lab_vec<T, G, 5, 1 | 4>(ARGS);                     \
    case 9: return launch_lab_vec<T, G, 8, 1 | 4>(ARGS);                     \
    case 10: return launch_lab_vec<T, G, 16, 1 | 4>(ARGS);                   \
  }
#define ARGS table, idx, w, out, N, V, B, F, st

template <typename T>
cudaError_t vec_variant(int variant, const void* table, const void* idx,
                        const void* w, void* out, int64_t N, int64_t V,
                        int64_t B, int64_t F, cudaStream_t st) {
  // the training shape's rows: 512 bytes in f32, 256 in bf16
  if (V == 32) SAGE_VEC_VARIANTS(32)
  if (V == 16) SAGE_VEC_VARIANTS(16)
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bulk_variant(int variant, const void* table, const void* idx,
                         const void* w, void* out, int64_t N, int64_t V,
                         int64_t B, int64_t F, cudaStream_t st) {
  switch (variant) {
    case 11: return launch_bulk<T, 4, 0, 4>(ARGS);
    case 12: return launch_bulk<T, 2, 0, 2>(ARGS);
    case 13: return launch_bulk<T, 8, 0, 4>(ARGS);
    case 14: return launch_bulk<T, 8, 0, 8>(ARGS);
    case 15: return launch_bulk<T, 4, 1, 4>(ARGS);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// variant: 0-10 the vec route's copy as (loads in flight a lane, hints;
// see kStreamOut above): (4, evict-last + stores evict-first), (3, the same),
// (4, evict-last), (4, evict-last + stores and idx/w evict-first), (4,
// none), (4, evict-last for half the accesses, evict-first for the rest +
// stores evict-first), (4, the same with a quarter), then (2, 5, 8 and 16,
// evict-last + stores evict-first); 11-15 the bulk-copy ring as (stages,
// consumer warps) of a block: (4, 4), (2, 2), (8, 4), (8, 8), and (4, 4)
// with the table evict-last.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int sage_lab(const void* table, const void* idx, const void* w,
                        void* out, int dtype, int variant, int64_t N,
                        int64_t D, int64_t B, int64_t F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t row_bytes = D * (dtype == 1 ? 2 : 4);
  if (B == 0 || row_bytes % 16 != 0) return cudaErrorInvalidValue;
  const int64_t V = row_bytes / 16;
  if (variant >= 11) {
    if (dtype == 1)
      return bulk_variant<__nv_bfloat16>(variant, table, idx, w, out, N, V,
                                         B, F, st);
    return bulk_variant<float>(variant, table, idx, w, out, N, V, B, F, st);
  }
  if (dtype == 1)
    return vec_variant<__nv_bfloat16>(variant, table, idx, w, out, N, V, B,
                                      F, st);
  return vec_variant<float>(variant, table, idx, w, out, N, V, B, F, st);
}
