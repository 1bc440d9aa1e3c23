// Functional row scatter into a fresh table for Hopper (sm_90a).
//
// Replaces the TPU kernel `scatter_rows_pallas` of the reference package
// (src/repro/kernels/scatter.py), the online cache refresh's write path.
// That kernel runs table-side: XLA first builds an inverse map
// inv[r] -> source row (or -1), then each grid step copies either the
// admitted row or the old table row into a new buffer.
//
//   out[r] = rows[inv[r]]  if inv[r] >= 0
//          = table[r]      otherwise
//   inv[r] = i for every valid idx[i] == r (0 <= idx[i] < N), else -1
//
// The input table is never written: the cache double-buffers across
// refresh epochs, and in-flight batches keep gathering from it.
//
// What bounds it: device-memory bytes.  A refresh of the GraphSAGE cell's
// feature cache (498,046 rows of 128 f32, 255 MB) reads every row once,
// from the old table or from the admitted rows, and writes every row once:
// about 510 MB, or about 0.15 ms at the H100's 3.35 TB/s.  The inverse map
// adds 4 bytes a row (2 MB written, 2 MB read).
//
// Design: three steps on the caller's stream, one C call.  (1) memset the
// inverse map to -1; (2) one thread per scatter entry writes its index into
// inv[idx[i]] when the index is in range (valid indices are unique by
// contract, so no two threads write one slot; negatives and indices >= N are
// dropped here); (3) one warp per table row, grid-stride, reads inv[r] and
// copies the one source row with 16-byte vector moves when the row width and
// all three base pointers allow it, else 4-byte words, else single bytes, so
// f32 and bf16 at any width take the same code.  Iterating the table side
// keeps the write set dense and every output row written exactly once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
// Grid cap, in blocks per SM (see gather_rows.cu): many warps in flight hide
// the dependent load of inv[r] before the row copy.
constexpr int kBlocksPerSm = 64;
constexpr int kInvThreads = 256;

__global__ void build_inverse_kernel(const int32_t* __restrict__ idx,
                                     int32_t* __restrict__ inv, int64_t n_idx,
                                     int64_t n_table) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_idx;
       i += stride) {
    const int32_t r = idx[i];
    if (r >= 0 && (int64_t)r < n_table) inv[r] = (int32_t)i;
  }
}

template <typename V>
__global__ void scatter_rows_kernel(const char* __restrict__ table,
                                    const char* __restrict__ rows,
                                    const int32_t* __restrict__ inv,
                                    char* __restrict__ out, int64_t n_table,
                                    int64_t row_bytes) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t n_vec = row_bytes / (int64_t)sizeof(V);
  for (int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < n_table; r += warps) {
    const int32_t src = __ldg(inv + r);
    const V* s = reinterpret_cast<const V*>(
        src >= 0 ? rows + (int64_t)src * row_bytes : table + r * row_bytes);
    V* dst = reinterpret_cast<V*>(out + r * row_bytes);
    for (int64_t j = lane; j < n_vec; j += 32) dst[j] = __ldg(s + j);
  }
}

int sm_count(cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename V>
cudaError_t launch_copy(const void* table, const void* rows, const void* inv,
                        void* out, int64_t n_table, int64_t row_bytes, int sms,
                        cudaStream_t stream) {
  const int64_t want = (n_table + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  scatter_rows_kernel<V><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const char*>(table), static_cast<const char*>(rows),
      static_cast<const int32_t*>(inv), static_cast<char*>(out), n_table,
      row_bytes);
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t a) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)a == 0;
}

}  // namespace

// C entry point, loaded with ctypes.  `inv` is caller-allocated scratch of
// n_table int32.  Returns the first failing cudaError_t of the three steps
// (0 = cudaSuccess); the caller raises on anything else.  n_table and n_idx
// must be >= 1 (the caller returns the input table for an empty update) and
// `rows` must hold n_idx rows; the caller checks shapes, types and
// contiguity.
extern "C" int scatter_rows(const void* table, const void* idx,
                            const void* rows, void* inv, void* out,
                            int64_t n_table, int64_t n_idx, int64_t row_bytes,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(inv, 0xff, n_table * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n_idx + kInvThreads - 1) / kInvThreads;
  const int64_t cap = (int64_t)sms * 8;
  build_inverse_kernel<<<(int)(want < cap ? want : cap), kInvThreads, 0, s>>>(
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(inv), n_idx,
      n_table);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto fits = [&](int64_t w) {
    return row_bytes % w == 0 && aligned(table, w) && aligned(rows, w) &&
           aligned(out, w);
  };
  if (fits(16))
    return (int)launch_copy<uint4>(table, rows, inv, out, n_table, row_bytes,
                                   sms, s);
  if (fits(4))
    return (int)launch_copy<uint32_t>(table, rows, inv, out, n_table,
                                      row_bytes, sms, s);
  return (int)launch_copy<uint8_t>(table, rows, inv, out, n_table, row_bytes,
                                   sms, s);
}
