// Fused gather + weighted sum: out[b] = sum_f w[b, f] * table[idx[b, f]].
//
// Replaces the TPU kernel sage_aggregate_pallas
// (src/repro/kernels/sage_agg.py:32).  A pad (idx < 0) is weighted 0 and
// reads row 0; an index past the end reads the last row.  The sum is f32,
// taken in the order f = 0, 1, ... with one rounded multiply and one
// rounded add per term (__fmul_rn / __fadd_rn: no contraction into an FMA),
// which is what the plain version computes in separate PyTorch operations,
// so the two agree bit for bit; the result is rounded to the table's type.
//
// One warp per output row, lanes over D, so each gathered row is read in
// coalesced 128-byte pieces; the (B, F, D) rows are never written.  Bound
// on this card: bytes (the gathered rows, idx, w and out once each).
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

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
sage_aggregate_kernel(const T* __restrict__ table,
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
cudaError_t launch(const void* table, const void* idx, const void* w,
                   void* out, int64_t N, int64_t D, int64_t B, int64_t F,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough CTAs to fill the card several times over; the grid-stride loop
  // covers the rest
  const int64_t want = (B + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sms) * 32;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  sage_aggregate_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), N, D, B, F);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int sage_aggregate(const void* table, const void* idx,
                              const void* w, void* out, int dtype, int64_t N,
                              int64_t D, int64_t B, int64_t F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || D == 0) return cudaSuccess;
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, idx, w, out, N, D, B, F, st);
  return launch<float>(table, idx, w, out, N, D, B, F, st);
}
