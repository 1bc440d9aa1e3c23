// Fused cached-row gather + miss overlay for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_gather_overlay_pallas` of the reference
// package (src/repro/kernels/fused_batch.py), which stages one candidate
// row from each source per grid step through scalar-prefetched maps and
// selects between them in VMEM.
//
//   out[i] = miss_rows[miss_inv[i]]  if miss_inv[i] >= 0
//          = table[idx[i]]           else if idx[i] >= 0
//          = 0                       otherwise (bucket padding)
//
// What bounds it: device-memory bytes.  It does no arithmetic; every output
// row is one row copy or one zero fill.  At the serving shape (B = 70,656
// rows of 128 f32, about 28k of them real) it reads about 14.4 MB of source
// rows and 0.57 MB of indices and writes 36.2 MB: about 51 MB, or about
// 15 us at the H100's 3.35 TB/s.
//
// Design: one warp per output row, grid-stride over rows.  The warp reads
// its row's two map entries itself (the TPU's scalar prefetch has no
// counterpart here), picks the one source row — or none — and copies the
// row's bytes with 16-byte vector loads and stores when the row width and
// every base pointer allow it, else 4-byte words, else single bytes.  Only
// the chosen source is read (the TPU kernel streamed both).  Because it
// copies bytes it serves any element type (f32, bf16) by element size, and
// any width (D = 100 included).  Indices are clamped into range as XLA's
// gather clamps them, so the kernel and the plain version agree bit for bit
// on any input.  The miss source wins when both maps claim a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
// Grid cap, in blocks per SM.  Each warp's copy waits on a dependent load
// (map entry, then source row), so many warps in flight hide that latency:
// 64 blocks of 8 warps per SM give the serving shape (~70k rows on 132 SMs)
// about one row per warp, while the grid-stride loop keeps larger batches
// within the cap.
constexpr int kBlocksPerSm = 64;

template <typename V>
__global__ void fused_gather_overlay_kernel(
    const char* __restrict__ table, const char* __restrict__ miss_rows,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ miss_inv,
    char* __restrict__ out, int64_t n_rows, int64_t n_table, int64_t n_miss,
    int64_t row_bytes) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t n_vec = row_bytes / (int64_t)sizeof(V);
  for (int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_rows; row += warps) {
    const int32_t inv = __ldg(miss_inv + row);
    const int32_t slot = __ldg(idx + row);
    const char* src = nullptr;
    if (inv >= 0) {
      src = miss_rows + (int64_t)min(inv, (int32_t)(n_miss - 1)) * row_bytes;
    } else if (slot >= 0) {
      src = table + (int64_t)min(slot, (int32_t)(n_table - 1)) * row_bytes;
    }
    V* dst = reinterpret_cast<V*>(out + row * row_bytes);
    if (src != nullptr) {
      const V* s = reinterpret_cast<const V*>(src);
      for (int64_t j = lane; j < n_vec; j += 32) dst[j] = __ldg(s + j);
    } else {
      const V zero{};
      for (int64_t j = lane; j < n_vec; j += 32) dst[j] = zero;
    }
  }
}

template <typename V>
cudaError_t launch(const void* table, const void* miss_rows, const void* idx,
                   const void* miss_inv, void* out, int64_t n_rows,
                   int64_t n_table, int64_t n_miss, int64_t row_bytes,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t want = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  fused_gather_overlay_kernel<V><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const char*>(table), static_cast<const char*>(miss_rows),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(miss_inv),
      static_cast<char*>(out), n_rows, n_table, n_miss, row_bytes);
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t a) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)a == 0;
}

}  // namespace

// C entry point, loaded with ctypes.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); the caller raises on anything else.  n_table and n_miss
// must be >= 1; the caller checks shapes, types and contiguity.
extern "C" int fused_gather_overlay(const void* table, const void* miss_rows,
                                    const void* idx, const void* miss_inv,
                                    void* out, int64_t n_rows, int64_t n_table,
                                    int64_t n_miss, int64_t row_bytes,
                                    void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fits = [&](int64_t w) {
    return row_bytes % w == 0 && aligned(table, w) && aligned(miss_rows, w) &&
           aligned(out, w);
  };
  if (fits(16))
    return (int)launch<uint4>(table, miss_rows, idx, miss_inv, out, n_rows,
                              n_table, n_miss, row_bytes, s);
  if (fits(4))
    return (int)launch<uint32_t>(table, miss_rows, idx, miss_inv, out, n_rows,
                                 n_table, n_miss, row_bytes, s);
  return (int)launch<uint8_t>(table, miss_rows, idx, miss_inv, out, n_rows,
                              n_table, n_miss, row_bytes, s);
}
