// Row gather from a device table for Hopper (sm_90a).
//
// Replaces the TPU kernel `gather_rows_pallas` of the reference package
// (src/repro/kernels/gather.py), which scalar-prefetches the indices so each
// grid step's BlockSpec index map DMAs one table row (one 128-lane tile of
// it) into VMEM and zero-fills it where the index is negative.
//
//   out[i] = table[min(idx[i], N - 1)]  if idx[i] >= 0
//          = 0                          otherwise (cache miss)
//
// What bounds it: device-memory bytes.  It does no arithmetic: every output
// row is one row copy or one zero fill.  On the training path's unfused
// finalize (GraphSAGE, batch 8000, fanouts (25, 10), PA at 1M vertices) it
// gathers about 413k ids, about 290k of them cache hits, of 128 f32: it
// reads about 150 MB of table rows and 1.7 MB of indices and writes 211 MB,
// or about 0.11 ms at the H100's 3.35 TB/s.
//
// Design: one warp per output row, grid-stride over rows, the same shape as
// fused_gather_overlay.cu.  The warp reads its row's index itself (the
// TPU's scalar prefetch has no counterpart here) and copies the row's bytes
// with 16-byte vector loads and stores when the row width and both base
// pointers allow it, else 4-byte words, else single bytes.  Because it
// copies bytes it serves any element type by its size: f32 and bf16
// feature tables and the int32 D = 1 CSR column take the same code.  The
// index map is flat; the wrapper reshapes the output to the index's shape.
// Indices past the end clamp to the last row, as XLA's gather clamps them,
// so the kernel and the plain version agree bit for bit on any input.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
// Grid cap, in blocks per SM: each warp's copy waits on a dependent load
// (index, then row), so many warps in flight hide that latency; the
// grid-stride loop covers larger gathers within the cap.
constexpr int kBlocksPerSm = 64;

template <typename V>
__global__ void gather_rows_kernel(const char* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   char* __restrict__ out, int64_t n_rows,
                                   int64_t n_table, int64_t row_bytes) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t n_vec = row_bytes / (int64_t)sizeof(V);
  for (int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_rows; row += warps) {
    const int32_t slot = __ldg(idx + row);
    V* dst = reinterpret_cast<V*>(out + row * row_bytes);
    if (slot >= 0) {
      const V* s = reinterpret_cast<const V*>(
          table + (int64_t)min(slot, (int32_t)(n_table - 1)) * row_bytes);
      for (int64_t j = lane; j < n_vec; j += 32) dst[j] = __ldg(s + j);
    } else {
      const V zero{};
      for (int64_t j = lane; j < n_vec; j += 32) dst[j] = zero;
    }
  }
}

template <typename V>
cudaError_t launch(const void* table, const void* idx, void* out,
                   int64_t n_rows, int64_t n_table, int64_t row_bytes,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t want = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  gather_rows_kernel<V><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const char*>(table), static_cast<const int32_t*>(idx),
      static_cast<char*>(out), n_rows, n_table, row_bytes);
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t a) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)a == 0;
}

}  // namespace

// C entry point, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); the caller raises on anything else.  n_table must be
// >= 1; the caller checks shapes, types and contiguity.
extern "C" int gather_rows(const void* table, const void* idx, void* out,
                           int64_t n_rows, int64_t n_table, int64_t row_bytes,
                           void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fits = [&](int64_t w) {
    return row_bytes % w == 0 && aligned(table, w) && aligned(out, w);
  };
  if (fits(16))
    return (int)launch<uint4>(table, idx, out, n_rows, n_table, row_bytes, s);
  if (fits(4))
    return (int)launch<uint32_t>(table, idx, out, n_rows, n_table, row_bytes,
                                 s);
  return (int)launch<uint8_t>(table, idx, out, n_rows, n_table, row_bytes, s);
}
